"""Scaled-dot-product attention dispatch.

One op signature, several implementations:
  * "xla"    — dot_general + softmax with float32 logits/probs accumulation.
               Runs everywhere; materializes the (B, H, Tq, Tk) logits.
  * "cudnn"  — cuDNN's fused flash attention through
               `jax.nn.dot_product_attention` (GPU, bf16/fp16). Asked for
               with a key bias, it broadcasts the bias to the
               (B, 1, Tq, Tk) bias cuDNN takes.
  * "pallas" — this repository's flash-attention kernel
               (ltx_jax.kernels.flash_attention, Pallas on the Triton route),
               which needs a GPU; asked for anywhere else it raises. It also
               returns the softmax statistics ring attention merges.
  * "ring"   — sequence-parallel ring attention over the mesh set by
               `set_sequence_parallel`.
  * "auto"   — `choose_impl`: on a GPU for long sequences, cuDNN without a
               mask and the kernel with a key bias; xla everywhere else.

This replaces the reference's dependency on MLXFast.scaledDotProductAttention
(Metal) — reference use sites: LTXAttention.swift:209, LTXTextEncoder.swift:260,
Gemma3Model.swift:99 (GQA).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

# Below this many query or key tokens the (Tq, Tk) logits are small and
# XLA's fused softmax attention is as fast as the kernel.
_FLASH_MIN_SEQ = 1024

# Sequence-parallel context: set by the pipeline when a mesh is active so
# sdpa(impl="ring") can route self-attention through ring attention without
# threading the mesh through every model signature.
_SP_CONTEXT = {"mesh": None, "axis": "model"}


def set_sequence_parallel(mesh, axis: str = "model"):
    """Enable (mesh) or disable (None) ring-attention dispatch for
    sdpa(impl='ring'). Self-attention shards the token axis; cross-attention
    (tq != tk) keeps replicated text keys and falls back to XLA."""
    _SP_CONTEXT["mesh"] = mesh
    _SP_CONTEXT["axis"] = axis


def _xla_sdpa(q, k, v, bias=None, scale=None):
    """(B, H, Tq, D) x (B, H, Tk, D) attention with f32 softmax."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    logits = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * jnp.float32(scale)
    if bias is not None:
        logits = logits + bias.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum(
        "bhqk,bhkd->bhqd", probs.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    )
    return out.astype(q.dtype)


def _gqa_sdpa(q, k, v, bias=None, scale=None):
    """Grouped-query attention WITHOUT materializing repeated K/V.

    q: (B, H, Tq, D); k, v: (B, Hkv, Tk, D), H = G * Hkv. jnp.repeat of the
    KV tensors costs two (B, H, Tk, D) copies per call — ~25 MB/layer in the
    Gemma decode loop — where a grouped einsum reads the (B, Hkv, Tk, D)
    cache directly. bias broadcasts over heads ((B, 1, Tq, Tk) or
    (B, 1, 1, Tk))."""
    b, h, tq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    qg = q.reshape(b, hkv, g, tq, d)
    logits = jnp.einsum(
        "bkgqd,bksd->bkgqs", qg, k, preferred_element_type=jnp.float32
    ) * jnp.float32(scale)
    if bias is not None:
        if bias.shape[1] not in (1, h):
            raise ValueError(f"bias heads {bias.shape[1]} != 1 or {h}")
        bias5 = (bias.reshape(b, hkv, g, *bias.shape[2:])
                 if bias.shape[1] == h else bias[:, :, None])
        logits = logits + bias5.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum(
        "bkgqs,bksd->bkgqd", probs.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(b, h, tq, d).astype(q.dtype)


def _is_key_bias(bias) -> bool:
    return bias is None or bias.ndim == 2 or (
        bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)


def choose_impl(q_shape, k_shape, bias=None, dtype=jnp.bfloat16,
                platform=None) -> str:
    """The implementation sdpa(impl="auto") takes: "cudnn", "pallas" or
    "xla".

    On a GPU, when both sequences reach _FLASH_MIN_SEQ: with no mask,
    cuDNN for bf16/fp16 and head dim <= 128; with a key bias (text padding,
    ring padding), or where cuDNN does not apply, the Triton kernel for a
    power-of-two head dim in [16, 256]. On an H100 cuDNN was the faster of
    the two without a mask (forward and backward) and the kernel with a
    key bias, which cuDNN only takes broadcast to (B, 1, Tq, Tk) (PERF.md).
    Everything else — the CPU, short text sequences, Gemma's causal
    (Tq, Tk) masks — takes XLA.
    """
    platform = platform or jax.default_backend()
    d = q_shape[-1]
    if (platform != "gpu" or q_shape[2] < _FLASH_MIN_SEQ
            or k_shape[2] < _FLASH_MIN_SEQ or not _is_key_bias(bias)):
        return "xla"
    if (bias is None and jnp.dtype(dtype) in (jnp.bfloat16, jnp.float16)
            and d <= 128):
        return "cudnn"
    if 16 <= d <= 256 and d & (d - 1) == 0:
        return "pallas"
    return "xla"


def _cudnn_sdpa(q, k, v, bias=None, scale=None):
    """cuDNN fused attention on (B, H, T, D) operands; jax.nn takes
    (B, T, H, D), and XLA folds the transposes into the layouts."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    if bias is not None:
        bias = jnp.broadcast_to(
            bias.reshape(bias.shape[0], 1, 1, tk).astype(q.dtype),
            (b, 1, tq, tk))
    out = jax.nn.dot_product_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), bias=bias, scale=scale,
        implementation="cudnn")
    return out.transpose(0, 2, 1, 3)


def _per_head_shard(q, k, v, bias, scale, mesh, axis):
    """sdpa(impl="auto") under shard_map, heads split over `axis`."""
    from jax.sharding import PartitionSpec as P

    heads = P(None, axis, None, None)
    if bias is None:
        return jax.shard_map(
            lambda q_, k_, v_: sdpa(q_, k_, v_, scale=scale),
            mesh=mesh, in_specs=(heads,) * 3, out_specs=heads,
            check_vma=False)(q, k, v)
    bias_spec = P(None, axis) if bias.shape[1] == q.shape[1] else P()
    return jax.shard_map(
        lambda q_, k_, v_, b_: sdpa(q_, k_, v_, bias=b_, scale=scale),
        mesh=mesh, in_specs=(heads,) * 3 + (bias_spec,), out_specs=heads,
        check_vma=False)(q, k, v, bias)


def sdpa(q, k, v, bias=None, scale: Optional[float] = None, impl: str = "auto"):
    """Scaled dot-product attention.

    q: (B, H, Tq, D); k, v: (B, Hkv, Tk, D) with Hkv == H or H % Hkv == 0
    (GQA: kv heads are repeated). bias: additive float mask broadcastable to
    (B, H, Tq, Tk) — the reference's (1-m) * -10000 convention arrives here
    already additive.
    """
    if k.shape[1] != q.shape[1]:
        # GQA: the XLA path computes grouped attention directly from the
        # (B, Hkv, Tk, D) cache; pallas/ring paths still expand KV.
        if impl in ("xla", "auto"):
            return _gqa_sdpa(q, k, v, bias=bias, scale=scale)
        rep = q.shape[1] // k.shape[1]
        k = jnp.repeat(k, rep, axis=1)
        v = jnp.repeat(v, rep, axis=1)

    if impl == "xla":
        return _xla_sdpa(q, k, v, bias=bias, scale=scale)

    if impl == "ring":
        mesh = _SP_CONTEXT["mesh"]
        # ring applies to self-attention (Tq == Tk) with no bias or a KEY
        # bias (which rotates with k/v around the ring). Non-divisible
        # sequences pad to the ring (-1e30 bias on pad keys; padded q rows
        # are sliced off). Full (Tq, Tk) biases and cross-attention take
        # the single-device choice below.
        n = 1 if mesh is None else mesh.shape[_SP_CONTEXT["axis"]]
        ringable = n > 1 and q.shape[2] == k.shape[2] and _is_key_bias(bias)
        if ringable:
            key_bias = (None if bias is None else
                        bias.reshape(bias.shape[0], bias.shape[-1])
                        .astype(jnp.float32))
            from ltx_jax.parallel.ring_attention import (
                sequence_parallel_sdpa,
            )

            t = q.shape[2]
            pad = (-t) % n
            if pad:
                widths = [(0, 0), (0, 0), (0, pad), (0, 0)]
                q_p = jnp.pad(q, widths)
                k_p = jnp.pad(k, widths)
                v_p = jnp.pad(v, widths)
                if key_bias is None:
                    key_bias = jnp.zeros((q.shape[0], t), jnp.float32)
                key_bias = jnp.pad(key_bias, [(0, 0), (0, pad)],
                                   constant_values=-1e30)
            else:
                q_p, k_p, v_p = q, k, v
            out = sequence_parallel_sdpa(
                q_p, k_p, v_p, mesh, bias=key_bias, scale=scale,
                seq_axis=_SP_CONTEXT["axis"])
            return out[:, :, :t] if pad else out
        if n > 1 and q.shape[1] % n == 0:
            # not ringable (cross-attention, full masks): the single-device
            # choice per head shard — TP shards heads over the same axis,
            # so no operand moves, and a kernel never sees global shapes
            return _per_head_shard(q, k, v, bias, scale, mesh,
                                   _SP_CONTEXT["axis"])
        impl = "auto"

    if impl == "auto":
        impl = choose_impl(q.shape, k.shape, bias, q.dtype)
        if impl == "xla":
            return _xla_sdpa(q, k, v, bias=bias, scale=scale)

    if impl == "cudnn":
        return _cudnn_sdpa(q, k, v, bias=bias, scale=scale)

    if impl == "pallas":
        platform = jax.default_backend()
        if platform != "gpu":
            raise ValueError(
                "sdpa impl='pallas' runs the Triton flash kernel, which "
                f"needs a GPU; the default backend is {platform!r}")
        if not _is_key_bias(bias):
            raise ValueError(
                "the flash kernel takes a (B, Tk) or (B, 1, 1, Tk) key "
                f"bias, got {bias.shape}")
        from ltx_jax.kernels.flash_attention import (
            BLOCK_K, BLOCK_Q, flash_attention_vjp,
        )

        # the vjp wrapper's primal IS flash_attention; routing through it
        # makes the path differentiable (FA-2 backward kernels — no
        # (Tq, Tk) remat buffer)
        return flash_attention_vjp(q, k, v, bias, scale, BLOCK_Q, BLOCK_K,
                                   False)

    raise ValueError(f"unknown sdpa impl: {impl}")


def prepare_additive_mask(mask, dtype=jnp.float32):
    """(B, S) {0,1} validity mask -> (B, 1, 1, S) additive bias with
    0 = attend, -10000 = pad (reference: LTXTransformer.swift:141-156)."""
    if mask is None:
        return None
    if jnp.issubdtype(mask.dtype, jnp.floating):
        return mask
    bias = (1 - mask.astype(jnp.float32)) * -10000.0
    return bias.reshape(mask.shape[0], 1, 1, mask.shape[-1]).astype(dtype)
