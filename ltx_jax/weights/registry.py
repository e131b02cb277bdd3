"""Model registry: component status checks + hardware-based recommendation.

Reference: Sources/LTXVideo/Configuration/LTXModelRegistry.swift — the Swift
registry exposes per-component directories and expected files, isDownloaded /
missingFiles status checks (:92-136), and a system-RAM-based recommendedModel
(:139-153, dev at >= 32 GB else distilled). Here the recommendation is by
device memory x mesh size: 19B bf16 (38 GB) needs that much pooled memory
with room to spare; smaller pools run distilled int4.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ltx_jax.core.config import LTXModel
from ltx_jax.weights.download import (
    AUDIO_VAE_FILE,
    CONNECTOR_FILE,
    DISTILLED_LORA_FILE,
    UPSCALER_FILE,
    VAE_CONFIG,
    VAE_FILE,
    VOCODER_FILE,
    default_models_dir,
)

# 19B transformer in bf16 (ops/latents.py param counts) + activations
_BF16_19B_GB = 38.0


def component_inventory(
    model: LTXModel = LTXModel.DISTILLED,
) -> Dict[str, Tuple[str, List[str]]]:
    """{component: (subdir, expected filenames)} — mirrors
    download_all_components' destination layout (weights/download.py:83-117;
    reference: LTXModelRegistry.transformerFiles/vaeFiles/textEncoderFiles)."""
    fn = Path
    return {
        "gemma": ("vlm-gemma", ["config.json", "tokenizer.json"]),
        "unified": (f"ltx-{model.value}", [model.unified_weights_filename]),
        "connector": ("ltx-connector", [fn(CONNECTOR_FILE).name]),
        "vae": ("ltx-vae", [fn(VAE_FILE).name, fn(VAE_CONFIG).name]),
        "upscaler": ("ltx-upscaler", [fn(UPSCALER_FILE).name]),
        "distilled_lora": ("ltx-lora", [fn(DISTILLED_LORA_FILE).name]),
        "audio_vae": ("ltx-audio-vae", [fn(AUDIO_VAE_FILE).name]),
        "vocoder": ("ltx-vocoder", [fn(VOCODER_FILE).name]),
    }


def missing_files(component: str, models_dir: Optional[str] = None,
                  model: LTXModel = LTXModel.DISTILLED) -> List[str]:
    """Expected-but-absent files for a component
    (reference: LTXModelRegistry.missingFiles, :115-136)."""
    subdir, files = component_inventory(model)[component]
    base = Path(models_dir or default_models_dir()) / subdir
    missing = [f for f in files if not (base / f).exists()]
    if component == "gemma" and not missing:
        # the sharded safetensors snapshot has no fixed filename
        if not any(base.glob("*.safetensors")):
            missing.append("*.safetensors")
    return missing


def is_downloaded(component: str, models_dir: Optional[str] = None,
                  model: LTXModel = LTXModel.DISTILLED) -> bool:
    """Reference: LTXModelRegistry.isDownloaded (:92-113)."""
    return not missing_files(component, models_dir, model)


def recommended_model(n_devices: Optional[int] = None,
                      memory_per_device_gb: Optional[float] = None,
                      ) -> Tuple[LTXModel, Optional[str]]:
    """(model, transformer_quant or None) for the available hardware.

    Reference analog: LTXModelRegistry.recommendedModel (:146-153) picks
    dev vs distilled by system RAM. Here the budget is device memory x mesh
    size: bf16 19B + workspace needs a pool that clears ~38 GB with a
    quarter to spare; otherwise run the distilled model quantized.
    memory_per_device_gb defaults to the device's own limit; a device
    that reports none needs it passed.
    """
    from ltx_jax.utils.device_memory import memory_budget_gb

    if n_devices is None:
        import jax

        n_devices = len(jax.devices())
    per_device = memory_budget_gb(memory_per_device_gb)
    if n_devices * per_device >= _BF16_19B_GB * 1.25:
        return LTXModel.DEV, None
    return LTXModel.DISTILLED, "int4"
