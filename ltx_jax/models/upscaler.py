"""Spatial latent upscaler (2x) for the two-stage pipeline.

Reference: Sources/LTXVideo/Models/Upscaler/SpatialUpscaler.swift:15-383.
Channels-last NDHWC throughout with native XLA 3D convs:
  initial Conv3d 128->1024 + GroupNorm(32, f32 stats) + SiLU;
  4x ResBlock3D (conv-norm-silu-conv-norm, SiLU AFTER the residual add);
  per-frame Conv2d 1024->4096 + PixelShuffle(2);
  4x ResBlock3D; final Conv3d 1024->128.
Public interface (B, C, F, H, W) -> (B, C, F, 2H, 2W).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ltx_jax.models.common import silu
from ltx_jax.ops.normalization import group_norm_f32


@dataclasses.dataclass(frozen=True)
class UpscalerConfig:
    in_channels: int = 128
    mid_channels: int = 1024
    blocks_per_stage: int = 4
    num_groups: int = 32
    eps: float = 1e-5

    def tiny(self) -> "UpscalerConfig":
        return dataclasses.replace(self, in_channels=8, mid_channels=64,
                                   blocks_per_stage=1, num_groups=4)


def _conv3d(p, x):
    """Same-padded 3D conv, NDHWC; w: (kt, kh, kw, ci, co)."""
    out = lax.conv_general_dilated(
        x, p["w"].astype(x.dtype), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
    return out + p["b"].astype(x.dtype)


def _conv2d(p, x):
    """Same-padded 2D conv, NHWC; w: (kh, kw, ci, co)."""
    out = lax.conv_general_dilated(
        x, p["w"].astype(x.dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
    return out + p["b"].astype(x.dtype)


def pixel_shuffle_2d(x, r: int = 2):
    """(N, H, W, C*r*r) -> (N, Hr, Wr, C), channel order (c, rh, rw)
    (reference: SpatialUpscaler.swift:112-125)."""
    n, h, w, c = x.shape
    oc = c // (r * r)
    out = x.reshape(n, h, w, oc, r, r)
    out = out.transpose(0, 1, 4, 2, 5, 3)  # (n, h, r, w, r, oc)
    return out.reshape(n, h * r, w * r, oc)


def _res_block(p, x, cfg: UpscalerConfig):
    """conv-norm-silu-conv-norm, SiLU AFTER residual add
    (reference: SpatialUpscaler.swift:66-106)."""
    h = _conv3d(p["conv1"], x)
    h = group_norm_f32(h, p["norm1"]["w"], p["norm1"]["b"], cfg.num_groups,
                       cfg.eps)
    h = silu(h)
    h = _conv3d(p["conv2"], h)
    h = group_norm_f32(h, p["norm2"]["w"], p["norm2"]["b"], cfg.num_groups,
                       cfg.eps)
    return silu(h + x)


def upscaler_forward(params, latent, cfg: UpscalerConfig = UpscalerConfig()):
    """(B, C, F, H, W) -> (B, C, F, 2H, 2W)
    (reference: SpatialUpscaler.swift:229-258)."""
    x = latent.transpose(0, 2, 3, 4, 1)  # NDHWC
    x = _conv3d(params["initial_conv"], x)
    x = group_norm_f32(x, params["initial_norm"]["w"],
                       params["initial_norm"]["b"], cfg.num_groups, cfg.eps)
    x = silu(x)
    for blk in params["res_blocks"]:
        x = _res_block(blk, x, cfg)
    # per-frame 2D conv + pixel shuffle
    b, f, h, w, c = x.shape
    frames = x.reshape(b * f, h, w, c)
    frames = _conv2d(params["upsampler"]["conv"], frames)
    frames = pixel_shuffle_2d(frames, 2)
    x = frames.reshape(b, f, h * 2, w * 2, c)
    for blk in params["post_upsample_res_blocks"]:
        x = _res_block(blk, x, cfg)
    x = _conv3d(params["final_conv"], x)
    return x.transpose(0, 4, 1, 2, 3)


def upsample_latents(params, latent, mean, std,
                     cfg: UpscalerConfig = UpscalerConfig()):
    """denormalize -> upscale -> renormalize
    (reference: SpatialUpscaler.swift:363-383)."""
    m = mean.reshape(1, -1, 1, 1, 1).astype(jnp.float32)
    s = std.reshape(1, -1, 1, 1, 1).astype(jnp.float32)
    x = latent.astype(jnp.float32) * s + m
    x = upscaler_forward(params, x, cfg)
    return (x.astype(jnp.float32) - m) / s


# ---------------------------------------------------------------------------
# Init + weights
# ---------------------------------------------------------------------------


def init_params(key, cfg: UpscalerConfig = UpscalerConfig(), dtype=jnp.float32):
    ks = iter(jax.random.split(key, 64))
    mid = cfg.mid_channels

    def conv3(ci, co):
        scale = (ci * 27) ** -0.5
        return {
            "w": (jax.random.normal(next(ks), (3, 3, 3, ci, co), jnp.float32)
                  * scale).astype(dtype),
            "b": jnp.zeros((co,), dtype),
        }

    def norm():
        return {"w": jnp.ones((mid,), dtype), "b": jnp.zeros((mid,), dtype)}

    def res():
        return {"conv1": conv3(mid, mid), "norm1": norm(),
                "conv2": conv3(mid, mid), "norm2": norm()}

    return {
        "initial_conv": conv3(cfg.in_channels, mid),
        "initial_norm": norm(),
        "res_blocks": [res() for _ in range(cfg.blocks_per_stage)],
        "upsampler": {"conv": {
            "w": (jax.random.normal(next(ks), (3, 3, mid, 4 * mid), jnp.float32)
                  * (mid * 9) ** -0.5).astype(dtype),
            "b": jnp.zeros((4 * mid,), dtype),
        }},
        "post_upsample_res_blocks": [res() for _ in range(cfg.blocks_per_stage)],
        "final_conv": conv3(mid, cfg.in_channels),
    }


def load_params(tensors: Dict[str, np.ndarray]) -> dict:
    """Safetensors -> pytree. PyTorch conv layouts transpose to channels-last
    ((O,I,D,H,W) -> (D,H,W,I,O); (O,I,H,W) -> (H,W,I,O)); `blur_down` keys
    are skipped (reference: SpatialUpscaler.swift:271-349)."""

    def c3(prefix):
        w = tensors[f"{prefix}.weight"]
        return {
            "w": jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)), jnp.float32),
            "b": jnp.asarray(tensors[f"{prefix}.bias"], jnp.float32),
        }

    def c2(prefix):
        w = tensors[f"{prefix}.weight"]
        return {
            "w": jnp.asarray(np.transpose(w, (2, 3, 1, 0)), jnp.float32),
            "b": jnp.asarray(tensors[f"{prefix}.bias"], jnp.float32),
        }

    def norm(prefix):
        return {"w": jnp.asarray(tensors[f"{prefix}.weight"], jnp.float32),
                "b": jnp.asarray(tensors[f"{prefix}.bias"], jnp.float32)}

    def res(prefix):
        return {"conv1": c3(f"{prefix}.conv1"), "norm1": norm(f"{prefix}.norm1"),
                "conv2": c3(f"{prefix}.conv2"), "norm2": norm(f"{prefix}.norm2")}

    def blocks(prefix):
        out = []
        i = 0
        while f"{prefix}.{i}.conv1.weight" in tensors:
            out.append(res(f"{prefix}.{i}"))
            i += 1
        return out

    return {
        "initial_conv": c3("initial_conv"),
        "initial_norm": norm("initial_norm"),
        "res_blocks": blocks("res_blocks"),
        "upsampler": {"conv": c2("upsampler.conv")},
        "post_upsample_res_blocks": blocks("post_upsample_res_blocks"),
        "final_conv": c3("final_conv"),
    }


# Compiled entry point for the pipeline's two-stage upscale phase (see
# gemma3.forward_hidden_states_jit for why eager is the wrong default here)
upsample_latents_jit = jax.jit(upsample_latents, static_argnums=4)
