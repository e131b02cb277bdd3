"""Shared parameter/layer helpers for functional pytree models.

All models in ltx_jax are pure functions over parameter pytrees (nested
dicts of jnp arrays). Weights use the JAX (in, out) layout so application is
`x @ w + b`; the safetensors loaders transpose from PyTorch's (out, in).
This keeps models trivially shardable: TP is just NamedSharding on leaves.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def linear(params, x, precision=None):
    """x @ w + b with f32 accumulation."""
    out = jnp.dot(x, params["w"], preferred_element_type=jnp.float32,
                  precision=precision)
    if "b" in params:
        out = out + params["b"].astype(jnp.float32)
    return out.astype(x.dtype)


def linear_init(key, d_in: int, d_out: int, dtype=jnp.bfloat16, bias: bool = True,
                scale: Optional[float] = None):
    if scale is None:
        scale = d_in**-0.5
    kw, _ = jax.random.split(key)
    p = {"w": (jax.random.normal(kw, (d_in, d_out), jnp.float32) * scale).astype(dtype)}
    if bias:
        p["b"] = jnp.zeros((d_out,), dtype)
    return p


def gelu_tanh(x):
    """GELU with tanh approximation (reference: LTXFeedForward.swift:13-15)."""
    return jax.nn.gelu(x, approximate=True)


def silu(x):
    return jax.nn.silu(x)


def param_count(params) -> int:
    return sum(p.size for p in jax.tree.leaves(params))


def cast_floating(params, dtype):
    """Cast floating-point leaves to dtype (weights load f32 -> bf16)."""
    def _cast(p):
        if jnp.issubdtype(p.dtype, jnp.floating):
            return p.astype(dtype)
        return p
    return jax.tree.map(_cast, params)
