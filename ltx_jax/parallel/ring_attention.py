"""Sequence-parallel ring attention — forward AND backward.

The reference has NO sequence parallelism — its only long-video mechanisms
are VAE decode tiling and memory pacing, and its DiT always attends over the
full token sequence on one device (SURVEY.md §5.7). This module is new
capability: shard the video token axis across the mesh and rotate
K/V (+ key bias) around the ring with `jax.lax.ppermute`, merging partial
attention with flash-style running (m, l, acc) statistics. Attention memory
and K/V residency become O(T / n_devices) per device; compute overlaps the
K/V transfers across ring steps.

DIFFERENTIABLE (round 4, VERDICT r3 #2): a custom VJP rings the FA-2
backward — each device holds its local q/do/o/lse shard, K/V blocks make a
second full loop, and per-block dK/dV accumulators TRAVEL WITH their block
(home again after n hops). Per-device backward memory stays O(Tq_local x
block_k) on the flash path — long-sequence training can shard the token
axis instead of rematerializing (T, T) logits. TrainConfig.sdpa_impl="ring"
routes the flow-match loss through it.

Use under `jax.shard_map` with q/k/v sharded on the sequence axis:

    attn = shard_map(
        lambda q, k, v: ring_attention(q, k, v, axis_name="seq"),
        mesh=mesh,
        in_specs=P(None, None, "seq", None),
        out_specs=P(None, None, "seq", None),
    )(q, k, v)
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


def _partial_attn(q, k_blk, v_blk, bias_blk, scale: float, use_flash: bool,
                  interpret: bool):
    """One ring step's partial attention -> (m_cur, l_cur, pv) f32 stats."""
    if use_flash:
        from ltx_jax.kernels.flash_attention import flash_attention

        out_i, m_cur, l_cur = flash_attention(
            q, k_blk, v_blk, bias=bias_blk, scale=scale,
            interpret=interpret, return_stats=True)
        # un-normalize: the carry accumulates acc = sum(p @ v)
        pv = out_i.astype(jnp.float32) * l_cur[..., None]
        return m_cur, l_cur, pv
    qf = q.astype(jnp.float32) * jnp.float32(scale)
    s = jnp.einsum("bhqd,bhkd->bhqk", qf, k_blk.astype(jnp.float32),
                   preferred_element_type=jnp.float32)
    if bias_blk is not None:
        s = s + bias_blk[:, None, None, :].astype(jnp.float32)
    m_cur = jnp.max(s, axis=-1)                      # (B, H, Tq)
    p = jnp.exp(s - m_cur[..., None])
    l_cur = jnp.sum(p, axis=-1)
    pv = jnp.einsum("bhqk,bhkd->bhqd", p.astype(v_blk.dtype), v_blk,
                    preferred_element_type=jnp.float32)
    return m_cur, l_cur, pv


def _ring_forward(q, k, v, bias, axis_name: str, scale: float,
                  use_flash: bool, interpret: bool):
    """-> (out, m, l): merged output + final flash statistics."""
    n = lax.psum(1, axis_name)
    b, h, tq, d = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]

    def body(carry):
        m, l, acc, k_blk, v_blk, bias_blk = carry
        m_cur, l_cur, pv = _partial_attn(q, k_blk, v_blk, bias_blk, scale,
                                         use_flash, interpret)
        m_new = jnp.maximum(m, m_cur)
        alpha = jnp.exp(m - m_new)
        beta = jnp.exp(m_cur - m_new)
        l_new = l * alpha + l_cur * beta
        acc_new = acc * alpha[..., None] + pv * beta[..., None]
        # rotate K/V (+bias) to the next device; last rotation is harmless
        k_nxt = lax.ppermute(k_blk, axis_name, perm)
        v_nxt = lax.ppermute(v_blk, axis_name, perm)
        b_nxt = (lax.ppermute(bias_blk, axis_name, perm)
                 if bias_blk is not None else None)
        return m_new, l_new, acc_new, k_nxt, v_nxt, b_nxt

    m0 = jnp.full((b, h, tq), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((b, h, tq), jnp.float32)
    acc0 = jnp.zeros((b, h, tq, d), jnp.float32)

    # unrolled python loop over ring steps: n is static under shard_map
    carry = (m0, l0, acc0, k, v, bias)
    for _ in range(n):
        carry = body(carry)
    m, l, acc = carry[0], carry[1], carry[2]
    safe_l = jnp.where(l == 0, 1.0, l)
    return (acc / safe_l[..., None]).astype(q.dtype), m, l


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def _ring_attention_diff(q, k, v, bias, axis_name, scale, use_flash,
                         interpret):
    out, _, _ = _ring_forward(q, k, v, bias, axis_name, scale, use_flash,
                              interpret)
    return out


def _ring_diff_fwd(q, k, v, bias, axis_name, scale, use_flash, interpret):
    out, m, l = _ring_forward(q, k, v, bias, axis_name, scale, use_flash,
                              interpret)
    lse = m + jnp.log(jnp.where(l == 0, 1.0, l))  # (B, H, Tq) f32
    return out, (q, k, v, bias, out, lse)


def _ring_diff_bwd(axis_name, scale, use_flash, interpret, res, g):
    """Ring the FA-2 backward.

    Every (q-shard, k-block) pair is visited exactly once as the blocks make
    one loop; the GLOBAL lse makes each visit's probabilities the true ones,
    so per-visit dq/dk/dv partials sum to the exact gradients. dq
    accumulates locally (it belongs to the resident q shard); dK/dV
    accumulate in buffers that ROTATE WITH their block and are home after n
    hops. bias is a mask input — zero cotangent (matches
    kernels/flash_attention.py::flash_attention_vjp).
    """
    q, k, v, bias, o, lse = res
    n = lax.psum(1, axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]

    gf = g.astype(jnp.float32)
    delta = jnp.sum(gf * o.astype(jnp.float32), axis=-1)  # (B, H, Tq)

    def partial_bwd(k_blk, v_blk, bias_blk):
        if use_flash:
            from ltx_jax.kernels.flash_attention import (
                flash_backward,
            )

            return flash_backward(q, k_blk, v_blk, bias_blk, o, lse, g,
                                  scale, interpret=interpret)
        qf = q.astype(jnp.float32)
        s = jnp.einsum("bhqd,bhkd->bhqk", qf * jnp.float32(scale),
                       k_blk.astype(jnp.float32),
                       preferred_element_type=jnp.float32)
        if bias_blk is not None:
            s = s + bias_blk[:, None, None, :].astype(jnp.float32)
        p = jnp.exp(s - lse[..., None])                   # true probs
        dv_i = jnp.einsum("bhqk,bhqd->bhkd", p, gf,
                          preferred_element_type=jnp.float32)
        dp = jnp.einsum("bhqd,bhkd->bhqk", gf,
                        v_blk.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
        ds = p * (dp - delta[..., None])
        dq_i = jnp.einsum("bhqk,bhkd->bhqd", ds,
                          k_blk.astype(jnp.float32),
                          preferred_element_type=jnp.float32) * scale
        dk_i = jnp.einsum("bhqk,bhqd->bhkd", ds, qf,
                          preferred_element_type=jnp.float32) * scale
        return dq_i, dk_i, dv_i

    dq = jnp.zeros(q.shape, jnp.float32)
    dk_acc = jnp.zeros(k.shape, jnp.float32)
    dv_acc = jnp.zeros(v.shape, jnp.float32)
    k_blk, v_blk, bias_blk = k, v, bias
    for _ in range(n):
        dq_i, dk_i, dv_i = partial_bwd(k_blk, v_blk, bias_blk)
        dq = dq + dq_i.astype(jnp.float32)
        dk_acc = dk_acc + dk_i.astype(jnp.float32)
        dv_acc = dv_acc + dv_i.astype(jnp.float32)
        k_blk = lax.ppermute(k_blk, axis_name, perm)
        v_blk = lax.ppermute(v_blk, axis_name, perm)
        if bias_blk is not None:
            bias_blk = lax.ppermute(bias_blk, axis_name, perm)
        dk_acc = lax.ppermute(dk_acc, axis_name, perm)
        dv_acc = lax.ppermute(dv_acc, axis_name, perm)
    dbias = None if bias is None else jnp.zeros_like(bias)
    return (dq.astype(q.dtype), dk_acc.astype(k.dtype),
            dv_acc.astype(v.dtype), dbias)


_ring_attention_diff.defvjp(_ring_diff_fwd, _ring_diff_bwd)


def ring_attention(q, k, v, axis_name: str, bias=None,
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None,
                   interpret: bool = False):
    """Full (non-causal) attention with sequence-sharded q/k/v.

    q: (B, H, Tq_local, D); k, v: (B, H, Tk_local, D) — the LOCAL shards.
    bias: optional (B, Tk_local) additive key bias shard (rotates with k/v).
    Returns (B, H, Tq_local, D) in q.dtype. Differentiable (custom VJP
    above — the backward rings the FA-2 kernels; module docstring).

    use_flash (default: True on a GPU) runs the Pallas flash kernel for
    each ring step's partial attention, so per-device attention memory is
    O(Tq_local x block_k), never the O(Tq_local x Tk_local) logits the
    einsum path materializes: at the flagship stage-2 shape (19,840 tokens
    / 4 devices, 32 heads) that is ~4 GB of f32 logits per ring step. The
    flash kernel returns normalized partial outputs + (m, l) stats; the
    (m, l, acc) carry merges them identically in either path.
    interpret=True runs the flash kernel in the Pallas interpreter (CPU
    tests); nothing turns it on by itself.
    """
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    if use_flash is None:
        use_flash = jax.default_backend() == "gpu"
    return _ring_attention_diff(q, k, v, bias, axis_name, float(scale),
                                bool(use_flash), bool(interpret))


def sequence_parallel_sdpa(q, k, v, mesh, bias=None,
                           scale: Optional[float] = None,
                           seq_axis: str = "model",
                           use_flash: Optional[bool] = None,
                           interpret: bool = False):
    """Convenience wrapper: shard (B, H, T, D) q/k/v over `seq_axis` of the
    mesh and run ring attention via shard_map. Intended for the 10k-20k token
    stage-2 / 241-frame configs where one chip's attention working set is the
    bottleneck. bias, if given, is a (B, T) additive KEY bias sharded and
    rotated with k/v. T must divide the ring — sdpa(impl='ring') pads
    non-divisible sequences before calling here. Differentiable end-to-end
    (shard_map transposes through the inner custom VJP).
    """
    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map

    # Pick flash vs einsum from the MESH's devices: the mesh may be virtual
    # CPU devices in a process whose default backend is a GPU.
    plat = mesh.devices.flat[0].platform
    if use_flash is None:
        use_flash = plat == "gpu"
    if use_flash and plat != "gpu" and not interpret:
        raise ValueError(
            "use_flash on a non-GPU mesh needs interpret=True (the Triton "
            f"kernel compiles for GPUs only; the mesh is {plat!r})")

    qkv_spec = P(None, None, seq_axis, None)
    specs_in = (qkv_spec, qkv_spec, qkv_spec)
    args = (q, k, v)
    if bias is not None:
        specs_in = specs_in + (P(None, seq_axis),)
        args = args + (bias,)
        fn = lambda q_, k_, v_, b_: ring_attention(
            q_, k_, v_, axis_name=seq_axis, bias=b_, scale=scale,
            use_flash=use_flash, interpret=interpret)
    else:
        fn = lambda q_, k_, v_: ring_attention(
            q_, k_, v_, axis_name=seq_axis, scale=scale,
            use_flash=use_flash, interpret=interpret)

    # check_vma=False: the Pallas flash kernel's ShapeDtypeStruct outputs
    # carry no varying-mesh-axes annotation, which the default vma check
    # rejects inside shard_map.
    return shard_map(fn, mesh=mesh, in_specs=specs_in, out_specs=qkv_spec,
                     check_vma=False)(*args)
