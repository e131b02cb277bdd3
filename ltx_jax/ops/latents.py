"""Latent-space utilities: patchify, CFG, guidance rescale, AdaIN, noise.

Pure jnp functions that trace into the compiled denoise step.
Reference behavior: Sources/LTXVideo/Pipeline/LatentUtils.swift and
Sources/LTXVideo/Pipeline/VideoLatentShape.swift.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ltx_jax.core.config import LATENT_CHANNELS, SPATIAL_SCALE, TEMPORAL_SCALE


@dataclasses.dataclass(frozen=True)
class VideoLatentShape:
    """Latent geometry (reference: VideoLatentShape.swift:10-181)."""

    batch: int
    channels: int
    frames: int
    height: int
    width: int

    @classmethod
    def from_pixels(
        cls, batch: int, num_frames: int, height: int, width: int,
        channels: int = LATENT_CHANNELS,
    ) -> "VideoLatentShape":
        return cls(
            batch=batch,
            channels=channels,
            frames=(num_frames - 1) // TEMPORAL_SCALE + 1,
            height=height // SPATIAL_SCALE,
            width=width // SPATIAL_SCALE,
        )

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.batch, self.channels, self.frames, self.height, self.width)

    @property
    def token_count(self) -> int:
        return self.frames * self.height * self.width

    @property
    def pixel_frames(self) -> int:
        return TEMPORAL_SCALE * (self.frames - 1) + 1

    def validate(self) -> None:
        if self.channels != LATENT_CHANNELS:
            raise ValueError(f"latent channels must be {LATENT_CHANNELS}")
        if self.frames < 1 or self.height < 1 or self.width < 1:
            raise ValueError(f"invalid latent dims: {self.shape}")


def patchify(latent):
    """(B, C, F, H, W) -> (B, T, C) with row-major (F, H, W) token order
    (reference: LatentUtils.swift:20-34)."""
    b, c, f, h, w = latent.shape
    return latent.transpose(0, 2, 3, 4, 1).reshape(b, f * h * w, c)


def unpatchify(x, shape: VideoLatentShape):
    """(B, T, C) -> (B, C, F, H, W) (reference: LatentUtils.swift:42-54)."""
    b, c, f, h, w = shape.shape
    return x.reshape(b, f, h, w, c).transpose(0, 4, 1, 2, 3)


def generate_noise(key: jax.Array, shape: VideoLatentShape, dtype=jnp.float32):
    """Initial latent noise in float32 (reference: LatentUtils.swift:69-83).

    JAX threefry != MLX Philox, so bitwise noise parity with the reference is
    impossible by construction; parity tests inject precomputed noise instead
    (the reference's own PrecomputedEmbeddings methodology, SURVEY.md §4).
    """
    return jax.random.normal(key, shape.shape, dtype=dtype)


def apply_cfg(uncond, cond, guidance_scale: float):
    """cond + (scale - 1) * (cond - uncond) — this exact algebraic form, not
    the equivalent uncond + scale*(cond-uncond), so bf16 rounding matches the
    validated Python implementation (reference: LatentUtils.swift:131-141)."""
    scale_m1 = jnp.asarray(guidance_scale - 1.0, cond.dtype)
    return cond + scale_m1 * (cond - uncond)


def apply_guidance_rescale(cfg_output, cond_output, phi: float):
    """Rescale CFG output std toward the conditional output's std, blended by
    phi (reference: LatentUtils.swift:164-183). Std over all non-batch axes.
    """
    if phi <= 0.0:
        return cfg_output
    eps = 1e-8
    axes = tuple(range(1, cfg_output.ndim))
    cfg_std = jnp.sqrt(jnp.var(cfg_output, axis=axes, keepdims=True) + eps)
    cond_std = jnp.sqrt(jnp.var(cond_output, axis=axes, keepdims=True) + eps)
    rescaled = cfg_output * (cond_std / cfg_std)
    return phi * rescaled + (1.0 - phi) * cfg_output


def adain_filter_latent(latent, reference, factor: float = 1.0):
    """Per-channel AdaIN toward the reference latent's stats
    (reference: LatentUtils.swift:201-227). Shapes (B, C, F, H, W); spatial
    dims may differ between latent and reference."""
    if factor <= 0:
        return latent
    axes = (2, 3, 4)
    l_mean = jnp.mean(latent, axis=axes, keepdims=True)
    l_std = jnp.sqrt(jnp.var(latent, axis=axes, keepdims=True))
    r_mean = jnp.mean(reference, axis=axes, keepdims=True)
    r_std = jnp.sqrt(jnp.var(reference, axis=axes, keepdims=True))
    result = (latent - l_mean) / (l_std + 1e-8) * r_std + r_mean
    if factor >= 1.0:
        return result
    return factor * result + (1.0 - factor) * latent


def normalize_latent(latent, eps: float = 1e-6):
    """Zero-mean unit-var per channel (reference: LatentUtils.swift:232-239)."""
    axes = (2, 3, 4)
    mean = jnp.mean(latent, axis=axes, keepdims=True)
    std = jnp.sqrt(jnp.var(latent, axis=axes, keepdims=True) + eps)
    return (latent - mean) / std


def denormalize_latent(latent, mean, std):
    """latent * std + mean with (C,) stats (reference: LatentUtils.swift:242-252)."""
    return latent * std.reshape(1, -1, 1, 1, 1) + mean.reshape(1, -1, 1, 1, 1)


# ---------------------------------------------------------------------------
# Memory estimation (reference: LatentUtils.swift:294-319)
# ---------------------------------------------------------------------------

# Parameter counts from the transcribed checkpoint inventories
# (tests/weight_fixtures.py, asserted exactly in test_weight_contract.py):
# video-only DiT 13.04e9; the dual audio+video DiT ("19B") 18.88e9.
_DIT_PARAMS = 13.04e9
_AV_DIT_PARAMS = 18.88e9


def estimate_memory_gb(shape: VideoLatentShape, guidance_rows: int = 1,
                       dit_bits=None, vae_tile_size: int = 0,
                       audio: bool = False) -> float:
    """Rough peak device-memory estimate (GB) for one denoise+decode
    generation.

    The reference estimates unified-memory need to pick presets
    (LatentUtils.swift:294-319); here the budget is one device's memory and
    the phases are staged, so the peak is max(denoise phase, decode phase).
    Conservative by design — used for warnings, never hard limits.
    """
    bytes_per_param = {4: 0.625, 8: 1.125, None: 2.0}[dit_bits]
    n_params = _AV_DIT_PARAMS if audio else _DIT_PARAMS
    params_gb = n_params * bytes_per_param / 1e9

    # denoise working set: a handful of live (rows, tokens, dim|ffn) f32
    # tensors (XLA fuses most; flash attention keeps attention linear)
    tokens = shape.token_count
    act_gb = guidance_rows * tokens * 16384 * 4 * 6 / 1e9
    denoise_gb = params_gb + act_gb

    # decode working set: decoder params (~1 GB bf16) + largest intermediate
    # (tile frames at 1/16 spatial x 128 ch, a few copies) + pixel tiles.
    # Tiled decodes double-buffer (decode_video dispatches tile i+1 before
    # pulling tile i), so TWO tiles are device-resident at peak.
    tiled = vae_tile_size > 0 and shape.frames > vae_tile_size
    frames = min(shape.frames, vae_tile_size + 1) if tiled else shape.frames
    px = 8 * (frames - 1) + 1
    spatial = (shape.height * 8) * (shape.width * 8)  # quarter-res grid
    tile_copies = 2 if tiled else 1
    decode_gb = 1.0 + tile_copies * px * spatial * 128 * 2 * 4 / 1e9
    return round(max(denoise_gb, decode_gb), 2)


def recommended_memory_preset(shape: VideoLatentShape,
                              guidance_rows: int = 1,
                              dit_bits=None, audio: bool = False,
                              budget_gb=None) -> str:
    """Pick the lightest MemoryConfig preset whose estimate fits one device
    (reference analog: MemoryOptimizationConfig.forAvailableRAM). The
    budget is `budget_gb` or, when None, the device's own limit
    (utils/device_memory.py)."""
    from ltx_jax.utils.device_memory import memory_budget_gb

    budget = memory_budget_gb(budget_gb)
    for preset, tile in (("light", 0), ("moderate", 8), ("aggressive", 6)):
        if estimate_memory_gb(shape, guidance_rows, dit_bits,
                              vae_tile_size=tile,
                              audio=audio) <= budget:
            return preset
    return "aggressive"
