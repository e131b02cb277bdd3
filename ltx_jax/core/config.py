"""Model and generation configuration dataclasses.

Mirrors the reference's configuration surface
(reference: Sources/LTXVideo/Configuration/LTXConfig.swift:16-362) as frozen
dataclasses so they can be closed over by jit-compiled functions as static
values.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple


class LTXModel(str, enum.Enum):
    """LTX-2 model variants (reference: LTXConfig.swift:16-78)."""

    DEV = "dev"
    DISTILLED = "distilled"

    @property
    def is_distilled(self) -> bool:
        return self is LTXModel.DISTILLED

    @property
    def default_steps(self) -> int:
        return 8 if self.is_distilled else 40

    @property
    def default_guidance(self) -> float:
        return 1.0 if self.is_distilled else 4.0

    @property
    def huggingface_repo(self) -> str:
        return "Lightricks/LTX-2"

    @property
    def unified_weights_filename(self) -> str:
        return f"ltx-2-19b-{self.value}.safetensors"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """DiT architecture constants (reference: LTXConfig.swift:83-177).

    The same config is used for dev and distilled; only weights differ.
    """

    num_layers: int = 48
    num_heads: int = 32
    head_dim: int = 128
    in_channels: int = 128
    out_channels: int = 128
    cross_attention_dim: int = 4096
    caption_channels: int = 3840
    rope_theta: float = 10000.0
    max_pos: Tuple[int, ...] = (20, 2048, 2048)
    timestep_scale_multiplier: float = 1000.0
    norm_eps: float = 1e-6
    ffn_mult: int = 4
    # Audio stream (dual AV transformer; reference: LTXConfig.swift:158-173)
    audio_num_heads: int = 32
    audio_head_dim: int = 64
    audio_in_channels: int = 128
    audio_out_channels: int = 128
    audio_max_pos: Tuple[int, ...] = (20,)

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ffn_dim(self) -> int:
        return self.inner_dim * self.ffn_mult

    @property
    def audio_inner_dim(self) -> int:
        return self.audio_num_heads * self.audio_head_dim

    @property
    def audio_cross_attention_dim(self) -> int:
        return self.audio_inner_dim

    def tiny(self) -> "TransformerConfig":
        """A CPU-test-sized config with the same structure."""
        return dataclasses.replace(
            self,
            num_layers=2,
            num_heads=4,
            head_dim=32,
            in_channels=16,
            out_channels=16,
            cross_attention_dim=128,
            caption_channels=48,
            audio_num_heads=4,
            audio_head_dim=16,
            audio_in_channels=16,
            audio_out_channels=16,
        )


# Pixel <-> latent scale factors (reference: VideoLatentShape.swift).
TEMPORAL_SCALE = 8
SPATIAL_SCALE = 32
LATENT_CHANNELS = 128


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """All generation knobs (reference: LTXConfig.swift:216-362)."""

    width: int = 704
    height: int = 480
    num_frames: int = 121
    num_steps: int = 8
    cfg_scale: float = 1.0
    seed: Optional[int] = None
    negative_prompt: Optional[str] = None
    guidance_rescale: float = 0.0
    cross_attention_scale: float = 1.0
    ge_gamma: float = 0.0
    stg_scale: float = 0.0
    stg_blocks: Tuple[int, ...] = (29,)
    two_stage: bool = False
    enhance_prompt: bool = False
    # prompt-lookup speculative decoding for enhancement (drafts per
    # verify step; 0 = sequential). Distribution-preserving — see
    # models/gemma3.py module comment; an addition with no reference
    # analog (the Swift decode loop is eager per-token).
    enhancement_spec_k: int = 8
    image_path: Optional[str] = None
    image_cond_noise_scale: float = 0.0
    fps: float = 24.0
    # custom sigma table (Turbo-style LoRA scheduler overrides,
    # lora.fuse.LoRASchedulerOverrides.apply_to); None = model schedule
    sigmas_override: Optional[Tuple[float, ...]] = None

    def validate(self) -> None:
        """Reference: LTXConfig.swift:310-353; raises the typed taxonomy
        (LTXVideo.swift:66-141) instead of bare ValueError."""
        from ltx_jax.core.errors import (
            InvalidConfigurationError,
            InvalidDimensionsError,
            InvalidFrameCountError,
        )

        if self.width % 32 != 0 or self.height % 32 != 0:
            raise InvalidDimensionsError(self.width, self.height)
        if (self.num_frames - 1) % 8 != 0:
            raise InvalidFrameCountError(self.num_frames)
        if not (64 <= self.width <= 2048):
            raise InvalidConfigurationError(
                f"Width must be in [64, 2048], got {self.width}")
        if not (64 <= self.height <= 2048):
            raise InvalidConfigurationError(
                f"Height must be in [64, 2048], got {self.height}")
        if not (9 <= self.num_frames <= 257):
            raise InvalidConfigurationError(
                f"num_frames must be in [9, 257], got {self.num_frames}")
        if not (1 <= self.num_steps <= 100):
            raise InvalidConfigurationError(
                f"num_steps must be in [1, 100], got {self.num_steps}")
        if not (1.0 <= self.cfg_scale <= 20.0):
            raise InvalidConfigurationError(
                f"cfg_scale must be in [1.0, 20.0], got {self.cfg_scale}")
        if self.two_stage and (self.width % 64 or self.height % 64):
            raise InvalidConfigurationError(
                "Two-stage requires width and height divisible by 64. "
                f"Got {self.width}x{self.height}")

    @property
    def latent_width(self) -> int:
        return self.width // SPATIAL_SCALE

    @property
    def latent_height(self) -> int:
        return self.height // SPATIAL_SCALE

    @property
    def latent_frames(self) -> int:
        return (self.num_frames - 1) // TEMPORAL_SCALE + 1

    @property
    def num_latent_tokens(self) -> int:
        return self.latent_frames * self.latent_height * self.latent_width


def adjust_dimensions(frames: int, height: int, width: int) -> Tuple[int, int, int]:
    """Snap dims to valid LTX-2 values (reference: LatentUtils.swift:265-289)."""
    rem = (frames - 1) % 8
    if rem != 0:
        frames = frames - rem if rem < 4 else frames + (8 - rem)
        if frames < 1:
            frames = 9
    height = ((height + 15) // 32) * 32
    width = ((width + 15) // 32) * 32
    return frames, max(height, 32), max(width, 32)


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Weight-only quantization of the transformer
    (reference: LTXQuantizationConfig.swift:19-115)."""

    # "w8a8": per-channel int8 weights + dynamic int8 activations through
    # an s8 x s8 dot at 1 byte/weight; activation quantization is a
    # numerics change the reference doesn't have, so it is opt-in (quality
    # unvalidated against real weights).
    mode: str = "bf16"  # "bf16" | "qint8" | "int4" | "w8a8"
    group_size: int = 64

    @property
    def bits(self) -> Optional[int]:
        return {"bf16": None, "qint8": 8, "int4": 4, "w8a8": 8}[self.mode]


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Device-memory knobs.

    The reference's eval-pacing/cache-limit dance
    (MemoryOptimizationConfig.swift:27-122) is Apple-unified-memory-specific;
    on an accelerator with its own memory the equivalents are remat over the
    block scan, buffer donation and VAE temporal tiling, so only the
    semantically shared knobs survive.
    """

    vae_tile_size: int = 0  # latent frames per decode tile; 0 = no tiling
    vae_tile_overlap: int = 1  # latent-frame overlap between tiles
    # Tiled-decode device->host wire format: "uint8" (RGB, 4x fewer bytes
    # than f32, max error 1/255) or "yuv420" (BT.601 4:2:0 packed I420,
    # 8x — the chroma subsample the MP4 encoder applies anyway, moved
    # before the wire). Its speed on a GPU host is not measured; uint8 is
    # the default.
    decode_transfer: str = "uint8"
    remat_blocks: bool = False  # jax.checkpoint over the DiT block scan
    offload_text_encoder: bool = True  # drop Gemma weights after encoding
    # Keep host (numpy) originals and place each component into device
    # memory only for its phase, releasing afterwards (utils/staging.py) —
    # for devices whose memory cannot hold every phase's weights at once
    # (the CLI applies it when the estimate exceeds the device's limit).
    phase_staging: bool = False

    @classmethod
    def preset(cls, name: str) -> "MemoryConfig":
        """Presets mirroring the reference's disabled/light/moderate/
        aggressive tiers (MemoryOptimizationConfig.swift:69-121), translated
        to the knobs that actually matter here."""
        presets = {
            "disabled": cls(vae_tile_size=0, remat_blocks=False,
                            offload_text_encoder=False),
            "light": cls(vae_tile_size=0, remat_blocks=False,
                         offload_text_encoder=True),
            "moderate": cls(vae_tile_size=8, vae_tile_overlap=1,
                            remat_blocks=False, offload_text_encoder=True,
                            phase_staging=True),
            "aggressive": cls(vae_tile_size=6, vae_tile_overlap=1,
                              remat_blocks=True, offload_text_encoder=True,
                              phase_staging=True),
        }
        if name not in presets:
            raise ValueError(f"unknown memory preset: {name} "
                             f"(choose from {sorted(presets)})")
        return presets[name]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Flow-matching schedule knobs (reference: LTXScheduler.swift:74-82)."""

    num_train_timesteps: int = 1000
    max_shift: float = 2.05
    base_shift: float = 0.95
    stretch: bool = True
    terminal: float = 0.1


# Verbatim from the reference (LTXPipeline.swift:19-31), which matches the
# Python mlx-video DEFAULT_NEGATIVE_PROMPT exactly. Checkpoint-defined
# behavioral data, not code.
DEFAULT_NEGATIVE_PROMPT = (
    "blurry, out of focus, overexposed, underexposed, low contrast, washed "
    "out colors, excessive noise, grainy texture, poor lighting, flickering, "
    "motion blur, distorted proportions, unnatural skin tones, deformed "
    "facial features, asymmetrical face, missing facial features, extra "
    "limbs, disfigured hands, wrong hand count, artifacts around text, "
    "inconsistent perspective, camera shake, incorrect depth of field, "
    "background too sharp, background clutter, distracting reflections, "
    "harsh shadows, inconsistent lighting direction, color banding, "
    "cartoonish rendering, 3D CGI look, unrealistic materials, uncanny "
    "valley effect, incorrect ethnicity, wrong gender, exaggerated "
    "expressions, wrong gaze direction, mismatched lip sync, silent or "
    "muted audio, distorted voice, robotic voice, echo, background noise, "
    "off-sync audio, incorrect dialogue, added dialogue, repetitive speech, "
    "jittery movement, awkward pauses, incorrect timing, unnatural "
    "transitions, inconsistent framing, tilted camera, flat lighting, "
    "inconsistent tone, cinematic oversaturation, stylized filters, or AI "
    "artifacts."
)
