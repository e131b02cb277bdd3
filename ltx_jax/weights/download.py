"""HuggingFace weight downloads with the reference's per-component layout.

Reference: Sources/LTXVideo/Utils/ModelDownloader.swift:52-555 — per-component
subdirectories under a cache dir, skip-if-exists. Uses huggingface_hub.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

from ltx_jax.core.config import LTXModel

# Component files on the HF hub (reference: ModelDownloader.swift:147-530;
# filename constants pinned against the Swift source in
# tests/test_download.py::test_hub_filenames_match_reference)
LTX_REPO = "Lightricks/LTX-2"
GEMMA_REPO = "mlx-community/gemma-3-12b-it-qat-4bit"   # :311
CONNECTOR_FILE = "connectors/diffusion_pytorch_model.safetensors"   # :175
VAE_FILE = "vae/diffusion_pytorch_model.safetensors"   # :204
VAE_CONFIG = "vae/config.json"                         # :215
UPSCALER_FILE = "latent_upsampler/diffusion_pytorch_model.safetensors"  # :473
DISTILLED_LORA_FILE = "ltx-2-19b-distilled-lora-384.safetensors"        # :476
AUDIO_VAE_FILE = "audio_vae/diffusion_pytorch_model.safetensors"        # :244
VOCODER_FILE = "vocoder/diffusion_pytorch_model.safetensors"            # :270


def default_models_dir() -> str:
    return os.environ.get(
        "LTX_MODELS_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "ltx-jax"),
    )


def _download_file(repo: str, filename: str, dest_dir: Path,
                   token: Optional[str], force: bool) -> Path:
    from huggingface_hub import hf_hub_download

    local = dest_dir / Path(filename).name
    if local.exists() and not force:
        return local
    dest_dir.mkdir(parents=True, exist_ok=True)
    try:
        path = Path(hf_hub_download(repo_id=repo, filename=filename,
                                    token=token, local_dir=str(dest_dir)))
    except Exception as e:  # network/auth/not-found from hf_hub
        from ltx_jax.core.errors import DownloadFailedError

        raise DownloadFailedError(f"{repo}/{filename}: {e}") from e
    # hf_hub_download(local_dir=...) preserves the hub filename's SUBPATH
    # ("vae/diffusion_pytorch_model.safetensors" lands at dest_dir/vae/...),
    # but the registry and loaders use the reference's FLAT per-component
    # layout (LTXModelRegistry.swift:92-136 — one file per component dir,
    # registry.py::component_inventory). Flatten into place so the
    # skip-if-exists check above also hits on the next run.
    if path != local:
        os.replace(path, local)
        parent = path.parent
        while parent != dest_dir and parent.is_relative_to(dest_dir):
            try:
                parent.rmdir()  # prune now-empty nested dirs
            except OSError:
                break
            parent = parent.parent
    return local


def download_gemma(models_dir: Optional[str] = None,
                   hf_token: Optional[str] = None,
                   force: bool = False) -> Path:
    """Snapshot the shared 4-bit QAT VLM Gemma
    (reference: ModelDownloader.swift:311-392)."""
    from huggingface_hub import snapshot_download

    base = Path(models_dir or default_models_dir()) / "vlm-gemma"
    if base.exists() and not force and any(base.glob("*.safetensors")):
        return base
    try:
        snapshot_download(repo_id=GEMMA_REPO, token=hf_token,
                          local_dir=str(base))
    except Exception as e:
        from ltx_jax.core.errors import DownloadFailedError

        raise DownloadFailedError(f"{GEMMA_REPO}: {e}") from e
    return base


def download_all_components(
    model: LTXModel,
    models_dir: Optional[str] = None,
    hf_token: Optional[str] = None,
    force: bool = False,
    include_audio: bool = False,
    include_upscaler: bool = True,
) -> Dict[str, Path]:
    """Download everything a generation run needs
    (reference: ModelDownloader.swift:435-468)."""
    base = Path(models_dir or default_models_dir())
    variant_dir = base / f"ltx-{model.value}"
    out: Dict[str, Path] = {}

    out["gemma"] = download_gemma(models_dir, hf_token, force)
    # standalone connector + VAE files are downloaded IN ADDITION to the
    # unified file (reference: ModelDownloader.swift:435-456) — the loader
    # falls back to them when the unified split lacks those components
    out["connector"] = _download_file(
        LTX_REPO, CONNECTOR_FILE, base / "ltx-connector", hf_token, force
    )
    out["vae"] = _download_file(
        LTX_REPO, VAE_FILE, base / "ltx-vae", hf_token, force
    )
    out["unified"] = _download_file(
        LTX_REPO, model.unified_weights_filename, variant_dir, hf_token, force
    )
    out["vae_config"] = _download_file(
        LTX_REPO, VAE_CONFIG, base / "ltx-vae", hf_token, force
    )
    if include_upscaler:
        out["upscaler"] = _download_file(
            LTX_REPO, UPSCALER_FILE, base / "ltx-upscaler", hf_token, force
        )
    out["distilled_lora"] = _download_file(
        LTX_REPO, DISTILLED_LORA_FILE, base / "ltx-lora", hf_token, force
    )
    if include_audio:
        out["audio_vae"] = _download_file(
            LTX_REPO, AUDIO_VAE_FILE, base / "ltx-audio-vae", hf_token, force
        )
        out["vocoder"] = _download_file(
            LTX_REPO, VOCODER_FILE, base / "ltx-vocoder", hf_token, force
        )
    return out


def load_safetensors(path, to_numpy: bool = True) -> dict:
    """Load a safetensors file as {key: np.ndarray} (mmap'd, zero-copy)."""
    from safetensors import safe_open

    out = {}
    with safe_open(str(path), framework="numpy") as f:
        for key in f.keys():
            out[key] = f.get_tensor(key)
    return out


def load_safetensors_dir(directory) -> dict:
    """Merge all *.safetensors in a directory (sharded checkpoints).

    Skips `*.qcache.safetensors` — those are ltx_jax's own quantized-weight
    caches (weights/qcache.py), not checkpoint shards."""
    out = {}
    for p in sorted(Path(directory).glob("*.safetensors")):
        if p.name.endswith(".qcache.safetensors"):
            continue
        out.update(load_safetensors(p))
    return out
