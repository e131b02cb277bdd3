"""Weight-only group-wise affine quantization (int8 / int4).

JAX equivalent of MLX's `quantize/QuantizedLinear` (Metal) used by the
reference for `--transformer-quant qint8|int4`
(reference: Sources/LTXVideo/Configuration/LTXQuantizationConfig.swift:19-115,
LTXPipeline.swift:323-333). Same scheme: groups of `group_size` along the
INPUT dimension, asymmetric affine (scale + bias per group):

    w ~= w_q * scale[g] + bias[g],   w_q in [0, 2^bits - 1]

Storage is a pytree of arrays only (jit-friendly): int8 uses key "w_q"
(uint8, (in, out)); int4 uses key "w_q4" (uint8, (in/2, out)) with
BLOCK-PLANE packing: within each PACK_BLOCK=256 input rows, byte row r holds
q[r] in the low nibble and q[r + 128] in the high nibble, so the unpack is a
concat of two planes rather than a row interleave. Group size derives from
the scale shape, so everything is static at trace time.

Quantized linears run as plain XLA: dequantize, then a bf16 dot with f32
accumulation. XLA's GPU compiler fuses the int4 unpack and affine into the
GEMM's operand load.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PACK_BLOCK = 256  # divides every DiT (4096/16384) and Gemma (3840/15360) dim


def quantize_weight(w, bits: int = 8, group_size: int = 64):
    """Quantize (in, out) float weight -> {"w_q"|"w_q4", "scale", "bias"}."""
    d_in, d_out = w.shape
    assert d_in % group_size == 0, f"{d_in} % {group_size} != 0"
    levels = (1 << bits) - 1
    wf = w.astype(jnp.float32).reshape(d_in // group_size, group_size, d_out)
    w_min = wf.min(axis=1, keepdims=True)
    w_max = wf.max(axis=1, keepdims=True)
    scale = (w_max - w_min) / levels
    scale = jnp.where(scale == 0, 1.0, scale)
    q = jnp.clip(jnp.round((wf - w_min) / scale), 0, levels)
    out = {
        "scale": scale[:, 0].astype(jnp.float32),
        "bias": w_min[:, 0].astype(jnp.float32),
    }
    q8 = q.reshape(d_in, d_out).astype(jnp.uint8)
    if bits == 8:
        out["w_q"] = q8
    elif bits == 4:
        out["w_q4"] = pack_int4(q8)
    else:
        raise ValueError(f"unsupported bits: {bits}")
    return out


def _effective_pack_block(d_in: int) -> int:
    """PACK_BLOCK when it divides d_in; else the whole dim (single plane).
    Both pack and unpack apply the same rule, so the format is self-
    describing from shapes alone."""
    return PACK_BLOCK if d_in % PACK_BLOCK == 0 else d_in


def pack_int4(q8):
    """(in, out) uint8 values [0,15] -> (in/2, out) block-plane packed."""
    d_in, d_out = q8.shape
    blk = _effective_pack_block(d_in)
    half = blk // 2
    qb = q8.reshape(d_in // blk, blk, d_out)
    return (qb[:, :half] | (qb[:, half:] << 4)).reshape(d_in // 2, d_out)


def unpack_int4(packed, dtype=jnp.float32):
    """Inverse of pack_int4 -> (in, out) values."""
    d2, d_out = packed.shape
    half = _effective_pack_block(d2 * 2) // 2
    pb = packed.reshape(d2 // half, half, d_out)
    lo = (pb & 0x0F).astype(dtype)
    hi = (pb >> 4).astype(dtype)
    return jnp.concatenate([lo, hi], axis=1).reshape(d2 * 2, d_out)


def _unpack(qp):
    """-> (q float32 (in, out), group_size)."""
    if "w_q" in qp:
        q = qp["w_q"].astype(jnp.float32)
    else:
        q = unpack_int4(qp["w_q4"], jnp.float32)
    group = q.shape[0] // qp["scale"].shape[0]
    return q, group


def dequantize_weight(qp, dtype=jnp.bfloat16):
    """Inverse of quantize_weight -> (in, out) dtype weight."""
    q, group = _unpack(qp)
    d_in, d_out = q.shape
    qg = q.reshape(d_in // group, group, d_out)
    w = qg * qp["scale"][:, None] + qp["bias"][:, None]
    return w.reshape(d_in, d_out).astype(dtype)


def dequantize_weight_np(qp):
    """Host (numpy) twin of dequantize_weight -> (in, out) float32."""
    import numpy as np

    if "w_q" in qp:
        q = np.asarray(qp["w_q"], np.float32)
    else:
        packed = np.asarray(qp["w_q4"])
        d2, d_out = packed.shape
        half = _effective_pack_block(d2 * 2) // 2
        pb = packed.reshape(d2 // half, half, d_out)
        q = np.concatenate([pb & 0x0F, pb >> 4], axis=1) \
            .reshape(d2 * 2, d_out).astype(np.float32)
    group = q.shape[0] // qp["scale"].shape[0]
    d_in, d_out = q.shape
    qg = q.reshape(d_in // group, group, d_out)
    w = (qg * np.asarray(qp["scale"], np.float32)[:, None]
         + np.asarray(qp["bias"], np.float32)[:, None])
    return w.reshape(d_in, d_out)


def is_quantized(p) -> bool:
    return isinstance(p, dict) and ("w_q" in p or "w_q4" in p or "w8" in p)


# ---------------------------------------------------------------------------
# W8A8: per-channel int8 weights, dynamic per-row int8 activations.
#
# Built for the Gemma DECODE loop: an int8 weight feeds an s8 x s8 -> s32
# dot directly, with no unpack and one byte per weight. Costs 2x the
# memory of int4 (int8 Gemma ~11.5 GB).
# ---------------------------------------------------------------------------


def requant_int8_channel_np(qp_or_w):
    """int4-group-quantized leaf (or raw (in, out) weight) -> per-output-
    channel int8 {"w8": (in, out) int8, "sw": (out,) f32}, host-side.

    Requantizing the int4-QAT values adds at most one int8 step of noise per
    element (the int4 grid is not a subgrid of the per-channel int8 grid),
    bounded by max|w_channel|/127 — far below the int4 group step itself.

    Routes through the native C++ kernels (ltx_jax.native) when available —
    the numpy path is scalar-loop slow on ml_dtypes bf16. Bit-exact either
    way.
    """
    import numpy as np

    from ltx_jax import native

    if isinstance(qp_or_w, dict) and "w_q4" in qp_or_w:
        out = native.requant_int8_from_int4(qp_or_w)
        if out is not None:
            return out
    elif not isinstance(qp_or_w, dict):
        a = np.asarray(qp_or_w)
        if a.ndim == 2:
            out = native.quant_int8_channel(a)
            if out is not None:
                return out
    return _requant_int8_channel_np_numpy(qp_or_w)


def _requant_int8_channel_np_numpy(qp_or_w):
    """Pure-numpy twin of requant_int8_channel_np (fallback + the exactness
    oracle for tests/test_native.py and the native self-test)."""
    import numpy as np

    if isinstance(qp_or_w, dict) and ("w_q4" in qp_or_w or "w_q" in qp_or_w):
        w = dequantize_weight_np(qp_or_w)
    else:
        w = np.asarray(qp_or_w, np.float32)
    w = np.asarray(w, np.float32)
    sw = np.abs(w).max(axis=0) / 127.0
    sw = np.where(sw == 0, 1.0, sw).astype(np.float32)
    w8 = np.clip(np.rint(w / sw), -127, 127).astype(np.int8)
    return {"w8": w8, "sw": sw}


def quantize_int8_channel(w):
    """Device twin of _requant_int8_channel_np_numpy for raw weights:
    (..., in, out) float -> {"w8" int8, "sw" (..., out) f32}, per output
    channel, symmetric absmax/127. Leading axes (stacked layers) quantize
    independently."""
    wf = w.astype(jnp.float32)
    sw = jnp.max(jnp.abs(wf), axis=-2) / 127.0
    sw = jnp.where(sw == 0, 1.0, sw)
    w8 = jnp.clip(jnp.round(wf / sw[..., None, :]), -127, 127)
    return {"w8": w8.astype(jnp.int8), "sw": sw}


def quantize_act_int8(x):
    """Per-row dynamic activation quant: (..., K) -> (int8 same shape,
    f32 scale (..., 1))."""
    xf = x.astype(jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
    sx = jnp.where(sx == 0, 1.0, sx)
    x8 = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    return x8, sx


def _int8_dot(p, x8, sx, out_dtype):
    acc = jax.lax.dot_general(
        x8, p["w8"], (((x8.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * (sx * p["sw"])).astype(out_dtype)


def _float0_zeros(a):
    """Symbolic-zero cotangent for an integer primal (custom_vjp contract)."""
    import numpy as np

    return np.zeros(a.shape, jax.dtypes.float0)


@jax.custom_vjp
def _int8_mm_ste(w8, sw, x):
    x8, sx = quantize_act_int8(x)
    return _int8_dot({"w8": w8, "sw": sw}, x8, sx, x.dtype)


def _int8_mm_fwd(w8, sw, x):
    return _int8_mm_ste(w8, sw, x), (w8, sw)


def _int8_mm_bwd(res, g):
    # Straight-through: the activation round/clip is treated as identity, so
    # d/dx (x @ W_deq) = g @ W_deq^T, computed without materializing the
    # dequantized weight. The frozen int weights get symbolic-zero
    # cotangents (QLoRA trains only the side-path).
    #
    # Formulated as (w8 @ gw^T)^T — w8 as the LHS contracting its OUTPUT
    # dim. XLA would otherwise hoist a full-leaf relayout copy of a stacked
    # to_v weight when the v activation flows straight from the matmul into
    # the SDPA head-split transpose; the optimization_barrier on v in the
    # models (dit.py) keeps every weight leaf uncopied in either
    # formulation.
    w8, sw = res
    gw = (g.astype(jnp.float32) * sw).astype(jnp.bfloat16)
    gb = gw.reshape((-1, gw.shape[-1]))  # (B*, N)
    gxt = jax.lax.dot_general(
        w8.astype(jnp.bfloat16), gb,
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (K, B*)
    gx = gxt.T.reshape(g.shape[:-1] + (w8.shape[0],))
    # out dtype == x dtype (forward contract), so g.dtype is x's dtype
    return _float0_zeros(w8), jnp.zeros_like(sw), gx.astype(g.dtype)


_int8_mm_ste.defvjp(_int8_mm_fwd, _int8_mm_bwd)


def int8_matmul(p, x):
    """x (..., K) bf16 @ {"w8" (K, N), "sw" (N,)} -> (..., N) in x.dtype.

    Activations quantize dynamically per ROW (absmax/127) so the int8 dot
    needs no unpack and no barrier; the result rescales by sx * sw. Pure
    XLA. Differentiable wrt x via a straight-through estimator (train/:
    QLoRA over a frozen W8A8 base)."""
    return _int8_mm_ste(p["w8"], p["sw"], x)


def linear_many(ps, x):
    """Apply several linears that SHARE the input x (qkv; gate/up).

    When all are W8A8 the activation quantizes ONCE — in the T=1 decode
    chain each extra quantize is a serialized dependency, so sharing it
    trims per-layer latency. Falls back to per-leaf
    linear_any otherwise."""
    if all(isinstance(p, dict) and "w8" in p for p in ps):
        x8, sx = quantize_act_int8(x)
        outs = []
        for p in ps:
            out = _int8_dot(p, x8, sx, x.dtype)
            if "b" in p:
                out = out + p["b"].astype(x.dtype)
            outs.append(out)
        return tuple(outs)
    return tuple(linear_any(p, x) for p in ps)


def _lora_delta(p, x):
    """Trainable LoRA side-path: scale * (x @ A) @ B in float32.

    Present when ltx_jax.train.lora.add_lora inserted {"lora_a" (in, r),
    "lora_b" (r, out), "lora_s" ()} into the leaf. Composes with every base
    path — bf16, int8, W8A8, int4 — without the reference's
    dequantize->merge->requantize round-trip (LoRAAdapter.swift:104-133):
    the low-rank product is added AFTER the (possibly quantized) base
    matmul, so the base weights never change.
    """
    d = jnp.dot(x.astype(jnp.float32), p["lora_a"].astype(jnp.float32))
    d = jnp.dot(d, p["lora_b"].astype(jnp.float32))
    return (d * p["lora_s"].astype(jnp.float32)).astype(x.dtype)


def linear_any(p, x):
    """Apply a linear that may be quantized ({"w_q"|"w_q4", scale, bias, b?})
    or plain ({"w", b?}); f32 accumulation either way. A trainable LoRA
    side-path ({"lora_a", "lora_b", "lora_s"}) adds after the base matmul.

    Stacked-block params carry a leading layer axis; under lax.scan the body
    sees the per-layer slice, so shapes here are always 2D.
    """
    lora = _lora_delta(p, x) if "lora_a" in p else None
    if is_quantized(p):
        if "w8" in p:
            out = int8_matmul(p, x)
            if lora is not None:
                out = out + lora
            if "b" in p:
                out = out + p["b"].astype(x.dtype)
            return out
        # XLA fuses the dequant into the GEMM's operand load for int8 and
        # int4 alike (PERF.md: within 4% of a bf16 dot at 6144 tokens)
        w = dequantize_weight(p, jnp.bfloat16).astype(x.dtype)
    else:
        w = p["w"]
    out = jnp.dot(x, w, preferred_element_type=jnp.float32)
    if lora is not None:
        out = out + lora.astype(jnp.float32)
    if "b" in p:
        out = out + p["b"].astype(jnp.float32)
    return out.astype(x.dtype)


def quantize_linear_params(p, bits: int, group_size: int = 64):
    """{"w": (in,out), "b"?} -> quantized linear params (bias kept as-is)."""
    out = quantize_weight(p["w"], bits, group_size)
    if "b" in p:
        out["b"] = p["b"]
    return out


_MIN_QUANT_SIZE = 1 << 16  # only quantize big matmuls (projections, FFN)

# Linear leaf names that carry the bulk of transformer weights. Covers the
# video DiT (attn1/attn2/ff), the dual AV transformer's 6 attentions + 2
# FFNs per block (models/dit_av.py::_block_init), and Gemma's projections.
QUANTIZABLE_LEAVES = frozenset({
    "to_q", "to_k", "to_v", "to_out", "project_in", "project_out",
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj",
})


def _quantize_weight_np(w, bits: int, group_size: int):
    """Host twin of quantize_weight — loading real 19B bf16 weights must
    not stage the unquantized tree through device HBM. Routes through the
    native C++ kernel (ltx_jax.native) when available: the numpy path is
    scalar-loop slow on ml_dtypes bf16; native runs at memory bandwidth. Bit-exact either way."""
    from ltx_jax import native

    out = native.quant_group(w, bits, group_size, PACK_BLOCK)
    if out is not None:
        return out
    return _quantize_weight_np_numpy(w, bits, group_size)


def _quantize_weight_np_numpy(w, bits: int, group_size: int):
    """Pure-numpy twin (fallback + exactness oracle for test_native.py)."""
    import numpy as np

    d_in, d_out = w.shape
    levels = (1 << bits) - 1
    wf = np.asarray(w, np.float32).reshape(d_in // group_size, group_size,
                                           d_out)
    w_min = wf.min(axis=1)
    w_max = wf.max(axis=1)
    scale = (w_max - w_min) / levels
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.rint((wf - w_min[:, None]) / scale[:, None]), 0, levels)
    out = {"scale": scale, "bias": w_min.astype(np.float32)}
    q8 = q.reshape(d_in, d_out).astype(np.uint8)
    if bits == 8:
        out["w_q"] = q8
    elif bits == 4:
        out["w_q4"] = pack_int4(q8)  # pure reshape/bit-ops: stays numpy
    else:
        raise ValueError(f"unsupported bits: {bits}")
    return out


def quantize_transformer_params(params, bits: int, group_size: int = 64,
                                w8a8: bool = False):
    """Quantize every large linear under `params["blocks"]` (any transformer
    pytree: video DiT, dual AV transformer).

    Stacked blocks have (L, in, out) weights — quantized per layer slice via
    vmap so group stats don't mix across layers. Norm weights, tables and
    small layers stay in bf16 (the reference likewise only quantizes Linear
    modules above a size threshold). Host (numpy) inputs quantize layer-by-
    layer on the host and stay there — see _quantize_weight_np.

    w8a8=True emits per-channel int8 leaves instead ({"w8","sw"}): an s8 x
    s8 dot at 1 byte/weight over dynamically int8-quantized activations.
    """
    import numpy as np

    def quant_stacked(p):
        if w8a8:
            if isinstance(p["w"], np.ndarray):
                per_layer = [requant_int8_channel_np(w) for w in p["w"]]
                out = {k: np.stack([pl[k] for pl in per_layer])
                       for k in per_layer[0]}
            else:
                out = quantize_int8_channel(p["w"])
        elif isinstance(p["w"], np.ndarray):
            per_layer = [_quantize_weight_np(w, bits, group_size)
                         for w in p["w"]]
            out = {k: np.stack([pl[k] for pl in per_layer])
                   for k in per_layer[0]}
        else:
            out = jax.vmap(lambda w: quantize_weight(w, bits, group_size))(
                p["w"])
        if "b" in p:
            out["b"] = p["b"]
        return out

    def maybe_quant(p):
        w = p["w"]
        if (w.ndim == 3 and w.shape[1] * w.shape[2] >= _MIN_QUANT_SIZE
                and w.shape[1] % group_size == 0):
            return quant_stacked(p)
        return p

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if (k in QUANTIZABLE_LEAVES and isinstance(v, dict) and "w" in v):
                out[k] = maybe_quant(v)
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return {**params, "blocks": walk(params["blocks"])}


# Backwards-compatible name (round-1 API; the walker now covers dit_av too).
quantize_dit_params = quantize_transformer_params
