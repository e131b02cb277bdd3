"""Kernel decisions on the card: each hand kernel against its plain version.

Times, at the DiT's real widths (32 heads, head dim 128, bf16):
  * attention forward at T = 1536, 6144, 19840: the Pallas flash kernel,
    cuDNN's fused attention (`jax.nn.dot_product_attention`, no mask) and the
    plain XLA path (`_xla_sdpa`, where its (B, H, T, T) logits fit);
  * attention forward + backward at T = 6144, the same three;
  * int4 weight-only linears: XLA's dequant-and-dot against a bf16 dot, at
    6144x4096 @ 4096x16384 and at M = 19840;
  * int8 weight-only linears with and without the optimization barrier;
  * W8A8 `int8_matmul` at Gemma's shapes against a bf16 dot, and whether the
    compiled program holds an s8 GEMM.
Checks the flash kernel against the f32 reference computed under
`jax.default_matmul_precision("highest")` (the check functions are shared
with chip_smoke.py and the `gpu` tests).

Run on a GPU: python scripts/kernel_bench.py [--out chiprun_out/kernels.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def timed(fn, *args, iters: int = 10):
    """-> (compile+first-call seconds, median steady seconds)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times)


def attention_rows(report):
    from ltx_jax.kernels import flash_attention as fa
    from ltx_jax.ops.attention import _xla_sdpa

    b, h, d = 1, 32, 128

    def qkv(t, seed=0):
        ks = jax.random.split(jax.random.key(seed), 3)
        return [jax.random.normal(kk, (b, h, t, d), jnp.bfloat16)
                for kk in ks]

    def cudnn(q, k, v):
        out = jax.nn.dot_product_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), implementation="cudnn")
        return out.transpose(0, 2, 1, 3)

    impls = {
        "flash": jax.jit(lambda q, k, v: fa.flash_attention(q, k, v)),
        "cudnn": jax.jit(cudnn),
        "xla": jax.jit(lambda q, k, v: _xla_sdpa(q, k, v)),
    }
    fwd = {}
    for t in (1536, 6144, 19840):
        q, k, v = qkv(t)
        row = {}
        for name, fn in impls.items():
            if name == "xla" and t > 6144:
                row[name] = "does not fit: (1, 32, T, T) f32 logits"
                continue
            try:
                c, s = timed(fn, q, k, v)
                row[name] = {"first_s": c, "ms": s * 1e3}
            except Exception as e:  # a refused impl is a result here
                row[name] = f"failed: {type(e).__name__}: {str(e)[:300]}"
        fwd[str(t)] = row
        print(f"attention fwd T={t}: {json.dumps(row)}", flush=True)
        del q, k, v
    report["attention_fwd"] = fwd

    t = 6144
    q, k, v = qkv(t)
    g = jax.random.normal(jax.random.key(9), q.shape, jnp.bfloat16)

    def grad_of(f):
        return jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(f(q, k, v).astype(jnp.float32)
                                    * g.astype(jnp.float32)),
            argnums=(0, 1, 2)))

    bwd_impls = {
        "flash": grad_of(lambda q, k, v: fa.flash_attention_vjp(
            q, k, v, None, None, fa.BLOCK_Q, fa.BLOCK_K, False)),
        "cudnn": grad_of(cudnn),
        "xla": grad_of(_xla_sdpa),
    }
    bwd = {}
    for name, fn in bwd_impls.items():
        try:
            c, s = timed(fn, q, k, v)
            bwd[name] = {"first_s": c, "ms_fwd_bwd": s * 1e3}
        except Exception as e:
            bwd[name] = f"failed: {type(e).__name__}: {str(e)[:300]}"
    print(f"attention fwd+bwd T={t}: {json.dumps(bwd)}", flush=True)
    report["attention_fwd_bwd_6144"] = bwd


def cross_rows(report):
    """Cross-attention to 1024 text tokens with a key-padding bias, and
    self-attention with a key bias (ring padding): the kernel against cuDNN
    (bias broadcast to (B, 1, Tq, Tk)) and XLA."""
    from ltx_jax.kernels import flash_attention as fa
    from ltx_jax.ops.attention import _cudnn_sdpa, _xla_sdpa

    impls = {
        "flash": jax.jit(lambda q, k, v, b: fa.flash_attention(q, k, v, b)),
        "cudnn": jax.jit(lambda q, k, v, b: _cudnn_sdpa(
            q, k, v, b[:, None, None, :])),
        "xla": jax.jit(lambda q, k, v, b: _xla_sdpa(
            q, k, v, b[:, None, None, :])),
    }
    out = {}
    for tq, tk in ((1536, 1024), (6144, 1024), (6144, 6144)):
        ks = jax.random.split(jax.random.key(tq + tk), 3)
        q = jax.random.normal(ks[0], (1, 32, tq, 128), jnp.bfloat16)
        k, v = [jax.random.normal(kk, (1, 32, tk, 128), jnp.bfloat16)
                for kk in ks[1:]]
        bias = jnp.where(jnp.arange(tk)[None] < tk - tk // 4, 0.0,
                         -10000.0).astype(jnp.float32)
        row = {}
        for name, fn in impls.items():
            try:
                _, t = timed(fn, q, k, v, bias)
                row[name] = t * 1e3
            except Exception as e:
                row[name] = f"failed: {type(e).__name__}: {str(e)[:300]}"
        out[f"{tq}x{tk}_keybias_ms"] = row
        print(f"attention key-bias {tq}x{tk}: {json.dumps(row)}", flush=True)
    report["attention_key_bias"] = out


def flash_sweep(report):
    """Tile/warp/stage candidates for the forward at T=6144."""
    from ltx_jax.kernels import flash_attention as fa

    ks = jax.random.split(jax.random.key(1), 3)
    q, k, v = [jax.random.normal(kk, (1, 32, 6144, 128), jnp.bfloat16)
               for kk in ks]
    saved = (fa.NUM_WARPS, fa.NUM_STAGES)
    rows = []
    for bq, bk, w, s in ((128, 64, 4, 2), (128, 64, 8, 3), (128, 128, 8, 2),
                         (64, 64, 4, 3), (128, 32, 4, 3), (64, 128, 4, 2)):
        fa.NUM_WARPS, fa.NUM_STAGES = w, s
        jax.clear_caches()
        fn = jax.jit(lambda q, k, v, bq=bq, bk=bk: fa.flash_attention(
            q, k, v, block_q=bq, block_k=bk))
        try:
            _, t = timed(fn, q, k, v)
            rows.append({"block_q": bq, "block_k": bk, "warps": w,
                         "stages": s, "ms": t * 1e3})
        except Exception as e:
            rows.append({"block_q": bq, "block_k": bk, "warps": w,
                         "stages": s, "failed": str(e)[:200]})
        print(f"flash sweep: {rows[-1]}", flush=True)
    fa.NUM_WARPS, fa.NUM_STAGES = saved
    jax.clear_caches()
    report["flash_sweep_6144"] = rows


def quant_rows(report):
    from ltx_jax.kernels import quantization as qz

    out = {}
    for m in (6144, 19840):
        kx, kw = jax.random.split(jax.random.key(m))
        x = jax.random.normal(kx, (m, 4096), jnp.bfloat16)
        w = jax.random.normal(kw, (4096, 16384), jnp.bfloat16)
        q4 = jax.jit(lambda w: qz.quantize_weight(w, 4, 64))(w)
        q8 = jax.jit(lambda w: qz.quantize_weight(w, 8, 64))(w)

        def dq_dot(p, x, barrier):
            wd = qz.dequantize_weight(p, jnp.bfloat16)
            if barrier:
                wd = jax.lax.optimization_barrier(wd)
            return jnp.dot(x, wd, preferred_element_type=jnp.float32
                           ).astype(jnp.bfloat16)

        row = {}
        for name, fn, p in (
                ("bf16", lambda p, x: jnp.dot(
                    x, p, preferred_element_type=jnp.float32
                ).astype(jnp.bfloat16), w),
                ("int4_xla", lambda p, x: dq_dot(p, x, False), q4),
                ("int4_xla_barrier", lambda p, x: dq_dot(p, x, True), q4),
                ("int8_xla", lambda p, x: dq_dot(p, x, False), q8),
                ("int8_xla_barrier", lambda p, x: dq_dot(p, x, True), q8),
                ("linear_any_int4", qz.linear_any, {**q4}),
                ("linear_any_int8", qz.linear_any, {**q8})):
            try:
                _, t = timed(jax.jit(fn), p, x)
                row[name] = t * 1e3
            except Exception as e:
                row[name] = f"failed: {str(e)[:200]}"
        out[f"{m}x4096@4096x16384_ms"] = row
        print(f"quant m={m}: {json.dumps(row)}", flush=True)
        del x, w, q4, q8
    report["weight_only_linears"] = out


def w8a8_rows(report):
    from ltx_jax.kernels import quantization as qz

    out = {}
    for k_dim, n_dim in ((3840, 15360), (15360, 3840)):
        kw = jax.random.key(k_dim)
        w = jax.random.normal(kw, (k_dim, n_dim), jnp.bfloat16) * 0.02
        w8 = jax.jit(lambda w: {
            "w8": jnp.clip(jnp.round(w / (jnp.abs(w).max(0) / 127)),
                           -127, 127).astype(jnp.int8),
            "sw": (jnp.abs(w).max(0) / 127).astype(jnp.float32)})(w)
        for m in (1, 4, 1024):
            x = jax.random.normal(jax.random.key(m), (m, k_dim), jnp.bfloat16)
            f8 = jax.jit(qz.int8_matmul)
            fb = jax.jit(lambda w, x: jnp.dot(
                x, w, preferred_element_type=jnp.float32).astype(x.dtype))
            hlo = f8.lower(w8, x).compile().as_text()
            gemm_lines = [ln for ln in hlo.splitlines()
                          if "custom_call_target" in ln and "gemm" in ln]
            s8_gemm = any("s8[" in ln for ln in gemm_lines)
            _, t8 = timed(f8, w8, x, iters=50)
            _, tb = timed(fb, w, x, iters=50)
            # per-call times at small M are launch-bound: also time 64
            # dependent matmuls inside one program
            def in_loop(f):
                def run(w, x):
                    def body(i, c):
                        y = f(w, (x * (1 + c)).astype(x.dtype))
                        return c + y[0, 0].astype(jnp.float32) * 1e-9
                    return jax.lax.fori_loop(0, 64, body, jnp.float32(0))
                return jax.jit(run)

            l8, lb = in_loop(qz.int8_matmul), in_loop(fb)
            _, t8l = timed(l8, w8, x, iters=5)
            _, tbl = timed(lb, w, x, iters=5)
            key = f"M{m}_K{k_dim}_N{n_dim}"
            out[key] = {"w8a8_ms": t8 * 1e3, "bf16_ms": tb * 1e3,
                        "w8a8_in_loop_ms": t8l * 1e3 / 64,
                        "bf16_in_loop_ms": tbl * 1e3 / 64,
                        "s8_gemm_in_hlo": s8_gemm,
                        "gemm_calls": [ln.strip()[:240] for ln in gemm_lines]}
            print(f"w8a8 {key}: {json.dumps(out[key])}", flush=True)
    report["w8a8"] = out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/kernels.json")
    ap.add_argument("--only",
                    default="check,attention,cross,sweep,quant,w8a8")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_bench.py measures a GPU; JAX found none")
    from ltx_jax.utils.compile_cache import enable_compile_cache
    from ltx_jax.kernels import checks

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    report = {"card": smi.strip(), "jax": jax.__version__,
              "device_kind": jax.devices()[0].device_kind}
    print(f"card: {smi.strip()}", flush=True)
    parts = args.only.split(",")
    steps = [("check", lambda r: r.update(checks=checks.run_all())),
             ("attention", attention_rows), ("cross", cross_rows),
             ("sweep", flash_sweep),
             ("quant", quant_rows), ("w8a8", w8a8_rows)]
    failed = []
    for name, fn in steps:
        if name not in parts:
            continue
        try:
            fn(report)
        except Exception as e:  # keep the other sections' numbers
            failed.append(name)
            report[f"{name}_error"] = f"{type(e).__name__}: {e}"[:2000]
            print(f"{name} FAILED: {e}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if k in ("card", "checks")}))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
