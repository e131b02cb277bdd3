"""On-card checks: each kernel path against its plain f32 reference.

Run at the DiT's real widths (32 heads, head dim 128, bf16 inputs). The
reference is the plain XLA attention or dot in float32 under
`jax.default_matmul_precision("highest")` — a plain f32 product on the GPU
may otherwise run in TF32. Each check returns its max error beside its
tolerance and raises AssertionError when the error is over it. chip_smoke.py
and the `gpu`-marked tests call these; they need a GPU (the kernels compile
through Triton) and about 20 GB of device memory at T=6144.

Tolerances and their reasons:
  * attention output (the Triton kernel and cuDNN alike): p is cast to
    bf16 before the PV product (relative rounding 2^-9 per weight, and the
    weights p/l sum to 1) and the output is rounded to bf16, so
    |err| <= 2^-8 * max|v|.
  * log-sum-exp (the stats ring attention merges): bf16 x bf16 products are
    exact in f32, so only the summation order differs: 1e-3 absolute.
  * attention gradients: p and ds are cast to bf16 before their products,
    and the results are rounded to bf16; the errors have random sign, so
    they stay well under 2^-6 of the largest gradient.
  * int4 linear: the dequantized weight is rounded to bf16 (2^-9 relative
    per weight, random sign over K) and so is the output: 2^-7 * max|ref|.
  * W8A8 linear: against the f32 product of the same quantized operands
    the int32 sums are exact; the bf16 output rounding (half an ulp, up to
    2^-8 of the value) dominates, and the f32 rescale and summation order
    add a few f32 ulps: 2^-7 * max|ref|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _qkv(t: int, heads: int, d: int, seed: int):
    ks = jax.random.split(jax.random.key(seed), 3)
    return [jax.random.normal(k, (1, heads, t, d), jnp.bfloat16) for k in ks]


def _key_bias(t: int):
    # text-padding style mask: the last tenth of the keys is padding
    return jnp.where(jnp.arange(t)[None] < t - t // 10, 0.0, -10000.0
                     ).astype(jnp.float32)


def _reference(q, k, v, bias):
    from ltx_jax.ops.attention import _xla_sdpa

    f32 = [x.astype(jnp.float32) for x in (q, k, v)]
    with jax.default_matmul_precision("highest"):
        return _xla_sdpa(*f32, bias=None if bias is None
                         else bias[:, None, None, :])


def _result(name, err, tol, **extra):
    row = {"check": name, "max_err": float(err), "tol": float(tol), **extra}
    if not err <= tol:
        raise AssertionError(
            f"{name}: max error {err:.3g} over tolerance {tol:.3g}")
    return row


def check_flash_forward(t: int = 6144, heads: int = 32, d: int = 128,
                        with_bias: bool = False, seed: int = 0,
                        tk: int = 0) -> dict:
    """The Triton kernel; tk != t is the cross-attention shape (video
    queries over text keys)."""
    from ltx_jax.kernels.flash_attention import flash_attention

    q, k, v = _qkv(t, heads, d, seed)
    if tk:
        k, v = k[:, :, :tk], v[:, :, :tk]
    bias = _key_bias(k.shape[2]) if with_bias else None
    out = jax.jit(flash_attention)(q, k, v, bias)
    ref = jax.jit(_reference)(q, k, v, bias)
    err = jnp.max(jnp.abs(out.astype(jnp.float32) - ref))
    tol = 2.0 ** -8 * jnp.max(jnp.abs(v.astype(jnp.float32)))
    name = f"flash_fwd_T{t}" + (f"xTk{tk}" if tk else "")
    return _result(name + ("_bias" if with_bias else ""), err, tol,
                   shape=list(q.shape))


def check_cudnn_forward(t: int = 6144, heads: int = 32, d: int = 128,
                        seed: int = 4) -> dict:
    """cuDNN's flash attention as sdpa(impl="cudnn") takes it (no mask:
    the DiT self-attention)."""
    from ltx_jax.ops.attention import sdpa

    q, k, v = _qkv(t, heads, d, seed)
    out = jax.jit(lambda q, k, v: sdpa(q, k, v, impl="cudnn"))(q, k, v)
    ref = jax.jit(_reference)(q, k, v, None)
    err = jnp.max(jnp.abs(out.astype(jnp.float32) - ref))
    tol = 2.0 ** -8 * jnp.max(jnp.abs(v.astype(jnp.float32)))
    return _result(f"cudnn_fwd_T{t}", err, tol, shape=list(q.shape))


def check_flash_stats(t: int = 6144, heads: int = 32, d: int = 128,
                      seed: int = 1) -> dict:
    from ltx_jax.kernels.flash_attention import flash_attention

    q, k, v = _qkv(t, heads, d, seed)
    _, m, l = jax.jit(lambda q, k, v: flash_attention(
        q, k, v, return_stats=True))(q, k, v)

    def ref_lse(q, k):
        with jax.default_matmul_precision("highest"):
            s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                           k.astype(jnp.float32)) * d ** -0.5
        return jax.nn.logsumexp(s, axis=-1)

    err = jnp.max(jnp.abs(m + jnp.log(l) - jax.jit(ref_lse)(q, k)))
    return _result(f"flash_lse_T{t}", err, 1e-3)


def check_flash_backward(t: int = 6144, heads: int = 32, d: int = 128,
                         with_bias: bool = False, seed: int = 2) -> dict:
    from ltx_jax.kernels import flash_attention as fa

    q, k, v = _qkv(t, heads, d, seed)
    g = jax.random.normal(jax.random.key(seed + 100), q.shape, jnp.float32)
    bias = _key_bias(t) if with_bias else None

    def kernel_loss(q, k, v):
        o = fa.flash_attention_vjp(q, k, v, bias, None, fa.BLOCK_Q,
                                   fa.BLOCK_K, False)
        return jnp.sum(o.astype(jnp.float32) * g)

    def ref_loss(q, k, v):
        return jnp.sum(_reference(q, k, v, bias) * g)

    got = jax.jit(jax.grad(kernel_loss, argnums=(0, 1, 2)))(q, k, v)
    f32 = [x.astype(jnp.float32) for x in (q, k, v)]
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(*f32)
    rows = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float(jnp.max(jnp.abs(a.astype(jnp.float32) - b)))
        tol = float(2.0 ** -6 * jnp.max(jnp.abs(b)))
        rows[name] = {"max_err": err, "tol": tol}
    worst = max(rows, key=lambda n: rows[n]["max_err"] / rows[n]["tol"])
    return _result(f"flash_bwd_T{t}{'_bias' if with_bias else ''}",
                   rows[worst]["max_err"], rows[worst]["tol"], grads=rows)


def check_int4_linear(m: int = 6144, k: int = 4096, n: int = 16384,
                      seed: int = 3) -> dict:
    from ltx_jax.kernels.quantization import (
        dequantize_weight, linear_any, quantize_weight,
    )

    kx, kw = jax.random.split(jax.random.key(seed))
    x = jax.random.normal(kx, (m, k), jnp.bfloat16)
    qp = jax.jit(lambda w: quantize_weight(w, 4, 64))(
        jax.random.normal(kw, (k, n), jnp.float32) * 0.02)
    out = jax.jit(linear_any)(qp, x)

    def ref(qp, x):
        with jax.default_matmul_precision("highest"):
            return jnp.dot(x.astype(jnp.float32),
                           dequantize_weight(qp, jnp.float32))

    want = jax.jit(ref)(qp, x)
    err = jnp.max(jnp.abs(out.astype(jnp.float32) - want))
    return _result(f"int4_linear_{m}x{k}@{k}x{n}", err,
                   2.0 ** -7 * jnp.max(jnp.abs(want)))


def check_w8a8_linear(m: int = 1024, k: int = 3840, n: int = 15360,
                      seed: int = 5) -> dict:
    """int8_matmul at Gemma's widths (hidden 3840, MLP 15360)."""
    from ltx_jax.kernels.quantization import (
        int8_matmul, quantize_act_int8, quantize_int8_channel,
    )

    kx, kw = jax.random.split(jax.random.key(seed))
    x = jax.random.normal(kx, (m, k), jnp.bfloat16)
    p = jax.jit(quantize_int8_channel)(
        jax.random.normal(kw, (k, n), jnp.float32) * 0.02)
    out = jax.jit(int8_matmul)(p, x)

    def ref(p, x):
        x8, sx = quantize_act_int8(x)
        with jax.default_matmul_precision("highest"):
            return jnp.dot(x8.astype(jnp.float32) * sx,
                           p["w8"].astype(jnp.float32) * p["sw"])

    want = jax.jit(ref)(p, x)
    err = jnp.max(jnp.abs(out.astype(jnp.float32) - want))
    return _result(f"w8a8_linear_{m}x{k}@{k}x{n}", err,
                   2.0 ** -7 * jnp.max(jnp.abs(want)))


CHECKS = (
    lambda: check_flash_forward(with_bias=False),
    lambda: check_flash_forward(with_bias=True),
    lambda: check_flash_forward(with_bias=True, tk=1024),
    check_flash_stats,
    lambda: check_flash_backward(with_bias=False),
    lambda: check_flash_backward(with_bias=True),
    check_cudnn_forward,
    check_int4_linear,
    check_w8a8_linear,
)


def run_all() -> list:
    """Every check at real widths; raises on the first failure."""
    rows = []
    for check in CHECKS:
        rows.append(check())
        print(f"check: {rows[-1]}", flush=True)
    return rows
