"""Normalization primitives with the reference's exact dtype semantics.

The DiT uses *weightless* RMSNorm (identity weight created in the input
dtype — reference: Sources/LTXVideo/Models/Transformer/LTXAttention.swift:30-33)
for AdaLN and an affine-free LayerNorm for the output head
(reference: LTXTransformer.swift:97). Statistics accumulate in float32 and
the result is cast back to the input dtype, matching MLX's fused kernels.

Plain jnp by design: XLA fuses the normalize->scale chain into one kernel
on its own.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm with float32 statistics.

    weight=None is the weightless variant (identity scale in input dtype).
    """
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    inv = lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    out = xf * inv
    if weight is not None:
        out = out * weight.astype(jnp.float32)
    return out.astype(dtype)


def layer_norm_no_affine(x, eps: float = 1e-6):
    """Affine-free LayerNorm with float32 statistics (DiT output head)."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean((xf - mean) ** 2, axis=-1, keepdims=True)
    return ((xf - mean) * lax.rsqrt(var + eps)).astype(dtype)


def adaln(x, scale, shift, eps: float = 1e-6):
    """Weightless RMSNorm then affine modulation: norm(x) * (1 + scale) + shift
    (reference: LTXTransformerBlock.swift:72-83)."""
    return rms_norm(x, eps=eps) * (1 + scale) + shift


def pixel_norm(x, axis: int = 1, eps: float = 1e-8):
    """Per-pixel channel RMS normalization used by the video VAE
    (reference: Sources/LTXVideo/Models/VAE/VideoConvolution.swift:28-41)."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    inv = lax.rsqrt(jnp.mean(xf * xf, axis=axis, keepdims=True) + eps)
    return (xf * inv).astype(dtype)


def group_norm_f32(x, weight, bias, num_groups: int, eps: float = 1e-6):
    """GroupNorm over the channel (last) axis with float32 statistics.

    x: (..., C) channels-last. Used by the spatial upscaler
    (reference: SpatialUpscaler.swift:15-60, float32 stats).
    """
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    *lead, c = xf.shape
    g = num_groups
    xg = xf.reshape(*lead, g, c // g)
    axes = tuple(range(len(lead))) + (len(lead) + 1,)
    # Stats per group over all non-group axes except batch: GroupNorm norms
    # per sample, so reduce over every axis except batch(0) and group.
    red_axes = tuple(i for i in range(xg.ndim) if i not in (0, xg.ndim - 2))
    mean = jnp.mean(xg, axis=red_axes, keepdims=True)
    var = jnp.var(xg, axis=red_axes, keepdims=True)
    xg = (xg - mean) * lax.rsqrt(var + eps)
    out = xg.reshape(*lead, c)
    out = out * weight.astype(jnp.float32) + bias.astype(jnp.float32)
    return out.astype(dtype)
