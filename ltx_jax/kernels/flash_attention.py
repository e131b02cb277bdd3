"""Flash attention for Hopper GPUs: Pallas kernels on the Triton route.

The DiT's self-attention runs over 1.5k-20k video tokens where materializing
the (B, H, Tq, Tk) f32 logits costs up to 4 bytes * 32 * 19840^2 = 50 GB —
more than the card holds. The reference leans on MLXFast's Metal flash
attention for the same reason
(reference: Sources/LTXVideo/Models/Transformer/LTXAttention.swift:209).

Design (FlashAttention-2, online softmax):
  forward  grid = (B*H, Tq/block_q). Each program keeps its q tile, walks the
           k/v blocks with a `lax.fori_loop`, and carries the running row-max
           m, normalizer l and f32 accumulator in registers. Logits accumulate
           in f32 on the tensor cores; p is cast to the value dtype for the
           PV product (the same numerics as the XLA path in ops/attention.py).
  backward two kernels, no atomics: dq over grid (B*H, Tq/block_q) with a
           loop over k blocks, and dk/dv over grid (B*H, Tk/block_k) with a
           loop over q blocks. Each rebuilds p = exp(s - lse) tile by tile, so
           the (Tq, Tk) logits never reach device memory.

Mask support: an optional additive KEY bias (B, Tk), loaded per k block — the
only mask the video pipeline needs (text key padding for cross-attention,
ring padding). Full (Tq, Tk) biases stay on the XLA path.

`interpret=True` runs the same kernels in the Pallas interpreter, which is
how the CPU test suite checks their arithmetic.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Tiles are powers of two (Triton's requirement); 128 query rows per program
# keep the H100's 132 SMs busy down to T=1536 (32 heads x 12 q tiles per row).
# 8 warps and a 3-deep k/v pipeline were the fastest forward of the sweep in
# scripts/kernel_bench.py at T=6144 on an H100 (PERF.md).
BLOCK_Q = 128
BLOCK_K = 64
NUM_WARPS = 8
NUM_STAGES = 3
BWD_BLOCK_Q = 64
BWD_BLOCK_K = 64
BWD_NUM_WARPS = 4
BWD_NUM_STAGES = 2
_MIN_BLOCK = 16  # smallest tile a Triton dot accepts
_NEG_INF = -1e30  # finite: exp(-inf - -inf) would be nan on padded rows


def _block(block: int, t: int) -> int:
    """The tile for a sequence of t tokens: `block`, or the next power of
    two above t when the whole sequence is shorter."""
    return max(_MIN_BLOCK, min(block, pl.next_power_of_2(t)))


def _pad_to(x, axis, multiple, value=0.0):
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def _key_bias(bias, b, tk, tk_p):
    """-> None or (B, tk_p) f32 key bias; padded keys get _NEG_INF."""
    if bias is not None:
        if bias.ndim == 4:
            if bias.shape[1] != 1 or bias.shape[2] != 1:
                raise ValueError(
                    "flash_attention takes a key bias (B, Tk) or "
                    f"(B, 1, 1, Tk), got {bias.shape}")
            bias = bias[:, 0, 0]
        bias = jnp.broadcast_to(bias.astype(jnp.float32), (b, tk))
    if tk_p == tk:
        return bias
    if bias is None:
        bias = jnp.zeros((b, tk), jnp.float32)
    return jnp.pad(bias, ((0, 0), (0, tk_p - tk)), constant_values=_NEG_INF)


def _call(kernel, grid, in_specs, out_specs, out_shape, num_warps,
          num_stages, interpret, name):
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name=name,
    )


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _fwd_kernel(q_ref, k_ref, v_ref, bias_ref, o_ref, m_ref, l_ref, *,
                scale, block_k, num_k):
    q = q_ref[...]
    bq, d = q.shape

    def body(i, carry):
        acc, m, l = carry
        ks = pl.ds(i * block_k, block_k)
        s = pl.dot(q, k_ref[ks, :], trans_b=True) * scale   # (bq, bk) f32
        if bias_ref is not None:
            s = s + bias_ref[ks][None, :]
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[:, None])
        l = l * alpha + jnp.sum(p, axis=1)
        v = v_ref[ks, :]
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l

    init = (jnp.zeros((bq, d), jnp.float32),
            jnp.full((bq,), _NEG_INF, jnp.float32),
            jnp.zeros((bq,), jnp.float32))
    acc, m, l = lax.fori_loop(0, num_k, body, init)
    # l >= 1: the row max contributes exp(0)
    o_ref[...] = (acc / l[:, None]).astype(o_ref.dtype)
    if m_ref is not None:
        m_ref[...] = m
        l_ref[...] = l


@functools.partial(
    jax.jit, static_argnames=("scale", "block_q", "block_k", "interpret",
                              "return_stats"))
def flash_attention(q, k, v, bias=None, scale: Optional[float] = None,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                    interpret: bool = False, return_stats: bool = False):
    """q: (B, H, Tq, D); k, v: (B, H, Tk, D); bias: None, (B, Tk) additive
    key bias, or (B, 1, 1, Tk). Returns (B, H, Tq, D) in q.dtype.

    return_stats=True also returns the f32 softmax statistics (m, l), each
    (B, H, Tq). The output is still normalized (acc / l); a caller merging
    partial attentions (ring attention) un-normalizes with l.
    """
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    block_q = _block(block_q, tq)
    block_k = _block(block_k, tk)
    qp = _pad_to(q, 2, block_q)
    kp = _pad_to(k, 2, block_k)
    vp = _pad_to(v, 2, block_k)
    tq_p, tk_p = qp.shape[2], kp.shape[2]
    key_bias = _key_bias(bias, b, tk, tk_p)

    bh = b * h
    grid = (bh, tq_p // block_q)
    kv_spec = pl.BlockSpec((None, tk_p, d), lambda i, j: (i, 0, 0))
    in_specs = [pl.BlockSpec((None, block_q, d), lambda i, j: (i, j, 0)),
                kv_spec, kv_spec]
    inputs = [qp.reshape(bh, tq_p, d), kp.reshape(bh, tk_p, d),
              vp.reshape(bh, tk_p, d)]
    if key_bias is not None:
        in_specs.append(pl.BlockSpec((None, tk_p), lambda i, j: (i // h, 0)))
        inputs.append(key_bias)
    o_spec = pl.BlockSpec((None, block_q, d), lambda i, j: (i, j, 0))
    o_shape = jax.ShapeDtypeStruct((bh, tq_p, d), q.dtype)
    if return_stats:
        row_spec = pl.BlockSpec((None, block_q), lambda i, j: (i, j))
        row_shape = jax.ShapeDtypeStruct((bh, tq_p), jnp.float32)
        out_specs = [o_spec, row_spec, row_spec]
        out_shape = [o_shape, row_shape, row_shape]
    else:
        out_specs, out_shape = o_spec, o_shape

    base = functools.partial(_fwd_kernel, scale=float(scale),
                             block_k=block_k, num_k=tk_p // block_k)
    has_bias = key_bias is not None

    def kernel(*refs):
        q_ref, k_ref, v_ref = refs[:3]
        rest = refs[3:]
        bias_ref = rest[0] if has_bias else None
        outs = rest[1:] if has_bias else rest
        m_ref, l_ref = (outs[1], outs[2]) if return_stats else (None, None)
        base(q_ref, k_ref, v_ref, bias_ref, outs[0], m_ref, l_ref)

    out = _call(kernel, grid, in_specs, out_specs, out_shape, NUM_WARPS,
                NUM_STAGES, interpret, "flash_attention_fwd")(*inputs)
    if not return_stats:
        return out.reshape(b, h, tq_p, d)[:, :, :tq]
    o, m, l = out
    return (o.reshape(b, h, tq_p, d)[:, :, :tq],
            m.reshape(b, h, tq_p)[:, :, :tq],
            l.reshape(b, h, tq_p)[:, :, :tq])


# ---------------------------------------------------------------------------
# Backward (FA-2). With delta = rowsum(dO * O):
#   p  = exp(scale * q k^T + bias - lse)
#   dv = p^T dO
#   ds = p * (dO v^T - delta) * scale
#   dq = ds k ;  dk = ds^T q
# ---------------------------------------------------------------------------


def _dq_kernel(q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, bias_ref,
               dq_ref, *, scale, block_k, num_k):
    q = q_ref[...]
    do = do_ref[...]
    lse = lse_ref[...]
    delta = delta_ref[...]

    def body(i, dq):
        ks = pl.ds(i * block_k, block_k)
        k = k_ref[ks, :]
        s = pl.dot(q, k, trans_b=True) * scale
        if bias_ref is not None:
            s = s + bias_ref[ks][None, :]
        p = jnp.exp(s - lse[:, None])
        dp = pl.dot(do, v_ref[ks, :], trans_b=True)
        ds = p * (dp - delta[:, None]) * scale
        return dq + pl.dot(ds.astype(k.dtype), k)

    dq = lax.fori_loop(0, num_k, body, jnp.zeros(q.shape, jnp.float32))
    dq_ref[...] = dq.astype(dq_ref.dtype)


def _dkv_kernel(q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, bias_ref,
                dk_ref, dv_ref, *, scale, block_q, num_q):
    k = k_ref[...]
    v = v_ref[...]
    bias = bias_ref[...] if bias_ref is not None else None

    def body(i, carry):
        dk, dv = carry
        qs = pl.ds(i * block_q, block_q)
        q = q_ref[qs, :]
        do = do_ref[qs, :]
        s = pl.dot(q, k, trans_b=True) * scale
        if bias is not None:
            s = s + bias[None, :]
        p = jnp.exp(s - lse_ref[qs][:, None])
        dv = dv + pl.dot(p.astype(do.dtype), do, trans_a=True)
        dp = pl.dot(do, v, trans_b=True)
        ds = p * (dp - delta_ref[qs][:, None]) * scale
        dk = dk + pl.dot(ds.astype(q.dtype), q, trans_a=True)
        return dk, dv

    zeros = jnp.zeros(k.shape, jnp.float32)
    dk, dv = lax.fori_loop(0, num_q, body, (zeros, zeros))
    dk_ref[...] = dk.astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def flash_backward(q, k, v, bias, o, lse, g, scale,
                   block_q: int = BWD_BLOCK_Q, block_k: int = BWD_BLOCK_K,
                   interpret: bool = False):
    """(dq, dk, dv) of flash attention given the forward's output o and
    log-sum-exp lse (B, H, Tq); bias as flash_attention's. The lse may come
    from a larger softmax than this k/v block (ring attention passes the
    global one), which makes the partial gradients sum to the exact ones."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    delta = jnp.sum(g.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    block_q = _block(block_q, tq)
    block_k = _block(block_k, tk)
    qp = _pad_to(q, 2, block_q)
    dop = _pad_to(g.astype(q.dtype), 2, block_q)
    lsep = _pad_to(lse.astype(jnp.float32), 2, block_q)
    deltap = _pad_to(delta, 2, block_q)
    kp = _pad_to(k, 2, block_k)
    vp = _pad_to(v, 2, block_k)
    tq_p, tk_p = qp.shape[2], kp.shape[2]
    key_bias = _key_bias(bias, b, tk, tk_p)
    has_bias = key_bias is not None

    bh = b * h
    q3, do3 = qp.reshape(bh, tq_p, d), dop.reshape(bh, tq_p, d)
    k3, v3 = kp.reshape(bh, tk_p, d), vp.reshape(bh, tk_p, d)
    lse2, delta2 = lsep.reshape(bh, tq_p), deltap.reshape(bh, tq_p)
    inputs = [q3, k3, v3, do3, lse2, delta2]
    if has_bias:
        inputs.append(key_bias)

    def with_bias(fn):
        def kernel(*refs):
            bias_ref = refs[6] if has_bias else None
            outs = refs[7:] if has_bias else refs[6:]
            fn(*refs[:6], bias_ref, *outs)
        return kernel

    # dq: one program per (b*h, q block), loop over k blocks
    q_blk = pl.BlockSpec((None, block_q, d), lambda i, j: (i, j, 0))
    row_blk = pl.BlockSpec((None, block_q), lambda i, j: (i, j))
    k_all = pl.BlockSpec((None, tk_p, d), lambda i, j: (i, 0, 0))
    specs = [q_blk, k_all, k_all, q_blk, row_blk, row_blk]
    if has_bias:
        specs.append(pl.BlockSpec((None, tk_p), lambda i, j: (i // h, 0)))
    dq = _call(
        with_bias(functools.partial(_dq_kernel, scale=float(scale),
                                    block_k=block_k,
                                    num_k=tk_p // block_k)),
        (bh, tq_p // block_q), specs, q_blk,
        jax.ShapeDtypeStruct((bh, tq_p, d), q.dtype),
        BWD_NUM_WARPS, BWD_NUM_STAGES, interpret,
        "flash_attention_dq")(*inputs)

    # dk/dv: one program per (b*h, k block), loop over q blocks
    k_blk = pl.BlockSpec((None, block_k, d), lambda i, j: (i, j, 0))
    q_all = pl.BlockSpec((None, tq_p, d), lambda i, j: (i, 0, 0))
    row_all = pl.BlockSpec((None, tq_p), lambda i, j: (i, 0))
    specs = [q_all, k_blk, k_blk, q_all, row_all, row_all]
    if has_bias:
        specs.append(pl.BlockSpec((None, block_k), lambda i, j: (i // h, j)))
    dk, dv = _call(
        with_bias(functools.partial(_dkv_kernel, scale=float(scale),
                                    block_q=block_q,
                                    num_q=tq_p // block_q)),
        (bh, tk_p // block_k), specs, [k_blk, k_blk],
        [jax.ShapeDtypeStruct((bh, tk_p, d), k.dtype),
         jax.ShapeDtypeStruct((bh, tk_p, d), v.dtype)],
        BWD_NUM_WARPS, BWD_NUM_STAGES, interpret,
        "flash_attention_dkv")(*inputs)

    return (dq.reshape(b, h, tq_p, d)[:, :, :tq],
            dk.reshape(b, h, tk_p, d)[:, :, :tk],
            dv.reshape(b, h, tk_p, d)[:, :, :tk])


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def flash_attention_vjp(q, k, v, bias, scale, block_q, block_k, interpret):
    """Differentiable flash attention (same primal as flash_attention).

    bias is a (B, Tk) / (B, 1, 1, Tk) additive KEY mask — an input, not a
    parameter: its cotangent is zeros. scale/blocks/interpret are static.
    """
    return flash_attention(q, k, v, bias=bias, scale=scale, block_q=block_q,
                           block_k=block_k, interpret=interpret)


def _flash_vjp_fwd(q, k, v, bias, scale, block_q, block_k, interpret):
    o, m, l = flash_attention(q, k, v, bias=bias, scale=scale,
                              block_q=block_q, block_k=block_k,
                              interpret=interpret, return_stats=True)
    return o, (q, k, v, bias, o, m + jnp.log(l))


def _flash_vjp_bwd(scale, block_q, block_k, interpret, res, g):
    q, k, v, bias, o, lse = res
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dq, dk, dv = flash_backward(
        q, k, v, bias, o, lse, g, scale,
        block_q=min(block_q, BWD_BLOCK_Q), block_k=min(block_k, BWD_BLOCK_K),
        interpret=interpret)
    dbias = None if bias is None else jnp.zeros_like(bias)
    return dq, dk, dv, dbias


flash_attention_vjp.defvjp(_flash_vjp_fwd, _flash_vjp_bwd)
