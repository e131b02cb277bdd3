"""Native (C++) host-side weight preparation.

Fused single-pass kernels for the load-time work that dominates real-
checkpoint startup: (out,in)->(in,out) transposes, asymmetric group
int4/int8 quantization (+ block-plane pack), per-channel int8 (W8A8)
requantization. numpy's ml_dtypes bfloat16 takes scalar ufunc loops on the
host (tens of seconds per large layer, about an hour for the full 19B DiT);
the C++ kernels do the same work at memory bandwidth.

Bit-exactness: every kernel reproduces its numpy twin in
kernels/quantization.py exactly (same f32 expression forms, round-half-to-
even, fp contraction disabled at build); a self-test against the numpy
twins runs once at load and disables the library on any mismatch, so
callers can delegate unconditionally via the maybe_* wrappers.

Build: compiled from weightprep.cpp with g++ at first use (cached next to
the source; rebuilt when the source changes). No pybind11 — plain ctypes
over an extern "C" surface. Set LTX_JAX_NO_NATIVE=1 to force the numpy
paths (tests exercise both).

The reference does this load-time work natively too (MLX's C++ core under
ModelDownloader.swift's sanitize/quantize passes); this module is this
framework's host-runtime equivalent.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("ltx_jax")

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "weightprep.cpp"

_lib = None
_lib_loaded = False

_I64 = ctypes.c_int64
_VP = ctypes.c_void_p


def _build_so() -> Optional[Path]:
    """Compile weightprep.cpp -> a source-hash-stamped .so (cached)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    so = _DIR / f"_weightprep_{tag}.so"
    if so.exists():
        return so
    # -ffp-contract=off is REQUIRED for bit-exactness vs numpy (no fma
    # contraction of the dequant mul+add); no -ffast-math for the same
    # reason. -march=native is a throughput nicety: fall back to plain
    # -O3 if the toolchain rejects it.
    base = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
            "-std=c++17", str(_SRC), "-o", str(so)]
    for flags in (base[:2] + ["-march=native"] + base[2:], base):
        try:
            r = subprocess.run(flags, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:  # no g++ etc.
            log.debug("native weightprep build failed to run: %s", e)
            return None
        if r.returncode == 0:
            return so
        log.debug("native weightprep build failed (%s): %s",
                  " ".join(flags[:3]), r.stderr.decode()[-400:])
    return None


def _bind(lib) -> None:
    lib.lt_transpose1.argtypes = [_VP, _VP, _I64, _I64]
    lib.lt_transpose2.argtypes = [_VP, _VP, _I64, _I64]
    lib.lt_transpose4.argtypes = [_VP, _VP, _I64, _I64]
    lib.lt_bf16_to_f32.argtypes = [_VP, _VP, _I64]
    lib.lt_f32_to_bf16.argtypes = [_VP, _VP, _I64]
    lib.lt_quant_group.argtypes = [
        _VP, ctypes.c_int, _I64, _I64, _I64, ctypes.c_int, _I64, _VP, _VP,
        _VP]
    lib.lt_quant_int8_channel.argtypes = [_VP, ctypes.c_int, _I64, _I64,
                                          _VP, _VP]
    lib.lt_requant_int8_from_int4.argtypes = [
        _VP, _VP, _VP, _I64, _I64, _I64, _I64, _VP, _VP]


def _self_test(mod) -> bool:
    """Tiny cross-check vs the numpy twins; False disables the library.

    Guards against miscompiled/mismatched codegen (e.g. a cached .so built
    with -march=native on a different host silently computing garbage).
    """
    import ml_dtypes

    rng = np.random.default_rng(7)
    w = rng.standard_normal((48, 512), dtype=np.float32) \
        .astype(ml_dtypes.bfloat16)
    wt_ref = np.ascontiguousarray(np.transpose(w))  # (512, 48)
    if not np.array_equal(mod["transpose"](w).view(np.uint16),
                          wt_ref.view(np.uint16)):
        return False
    from ltx_jax.kernels import quantization as Q

    qp_ref = Q._quantize_weight_np_numpy(wt_ref, 4, 64)
    qp = mod["quant_group"](wt_ref, 4, 64, Q.PACK_BLOCK)
    if qp is None or not all(
            np.array_equal(qp[k], qp_ref[k]) for k in qp_ref):
        return False
    c_ref = Q._requant_int8_channel_np_numpy(wt_ref)
    c = mod["quant_int8_channel"](wt_ref)
    if c is None or not (np.array_equal(c["w8"], c_ref["w8"])
                         and np.array_equal(c["sw"], c_ref["sw"])):
        return False
    r_ref = Q._requant_int8_channel_np_numpy(qp_ref)
    r = mod["requant_int8_from_int4"](qp_ref)
    return (r is not None and np.array_equal(r["w8"], r_ref["w8"])
            and np.array_equal(r["sw"], r_ref["sw"]))


def _load():
    global _lib, _lib_loaded
    if _lib_loaded:
        return _lib
    _lib_loaded = True
    if os.environ.get("LTX_JAX_NO_NATIVE"):
        return None
    so = _build_so()
    if so is None:
        log.info("native weightprep unavailable (build failed); "
                 "numpy fallbacks in use")
        return None
    try:
        lib = ctypes.CDLL(str(so))
        _bind(lib)
    except OSError as e:
        log.info("native weightprep failed to load: %s", e)
        return None
    _lib = lib
    if not _self_test({"transpose": transpose, "quant_group": quant_group,
                       "quant_int8_channel": quant_int8_channel,
                       "requant_int8_from_int4": requant_int8_from_int4}):
        log.warning("native weightprep self-test FAILED; numpy fallbacks "
                    "in use (stale .so for this host? delete %s)", so)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _c2d(x) -> np.ndarray:
    a = np.ascontiguousarray(x)
    assert a.ndim == 2, a.shape
    return a


def transpose(x) -> np.ndarray:
    """(rows, cols) -> contiguous (cols, rows) for 2/4-byte dtypes."""
    lib = _load()
    a = _c2d(x)
    if lib is None or a.itemsize not in (1, 2, 4):
        return np.ascontiguousarray(np.transpose(a))
    out = np.empty((a.shape[1], a.shape[0]), dtype=a.dtype)
    fn = {1: lib.lt_transpose1, 2: lib.lt_transpose2,
          4: lib.lt_transpose4}[a.itemsize]
    fn(a.ctypes.data, out.ctypes.data, a.shape[0], a.shape[1])
    return out


def _src_view(a: np.ndarray):
    """-> (contiguous array passable to C, is_bf16 flag) or None."""
    import ml_dtypes

    if a.dtype == ml_dtypes.bfloat16:
        return a, 1
    if a.dtype == np.float32:
        return a, 0
    return None


def quant_group(w, bits: int, group_size: int,
                pack_block: int) -> Optional[dict]:
    """Native quantize_weight twin for (in, out) bf16/f32 numpy weights.
    Returns None when the native path can't take this input (caller falls
    back to numpy)."""
    lib = _load()
    if lib is None or bits not in (4, 8):
        return None
    a = _c2d(w)
    sv = _src_view(a)
    if sv is None:
        return None
    a, is_bf16 = sv
    d_in, d_out = a.shape
    if d_in % group_size or (bits == 4 and d_in % 2):
        return None
    scale = np.empty((d_in // group_size, d_out), np.float32)
    bias = np.empty_like(scale)
    if bits == 8:
        wq = np.empty((d_in, d_out), np.uint8)
    else:
        wq = np.empty((d_in // 2, d_out), np.uint8)
    lib.lt_quant_group(a.ctypes.data, is_bf16, d_in, d_out, group_size,
                       bits, pack_block, wq.ctypes.data, scale.ctypes.data,
                       bias.ctypes.data)
    out = {"scale": scale, "bias": bias}
    out["w_q" if bits == 8 else "w_q4"] = wq
    return out


def quant_int8_channel(w) -> Optional[dict]:
    """Native requant_int8_channel_np twin for raw (in, out) weights."""
    lib = _load()
    if lib is None:
        return None
    a = _c2d(w)
    sv = _src_view(a)
    if sv is None:
        return None
    a, is_bf16 = sv
    d_in, d_out = a.shape
    w8 = np.empty((d_in, d_out), np.int8)
    sw = np.empty((d_out,), np.float32)
    lib.lt_quant_int8_channel(a.ctypes.data, is_bf16, d_in, d_out,
                              w8.ctypes.data, sw.ctypes.data)
    return {"w8": w8, "sw": sw}


def requant_int8_from_int4(qp, pack_block: int = 0) -> Optional[dict]:
    """Native requant_int8_channel_np twin for an int4-group dict
    ({"w_q4", "scale", "bias"}), fused dequant -> per-channel int8."""
    lib = _load()
    if lib is None or "w_q4" not in qp:
        return None
    packed = np.ascontiguousarray(qp["w_q4"])
    scale = np.ascontiguousarray(np.asarray(qp["scale"], np.float32))
    bias = np.ascontiguousarray(np.asarray(qp["bias"], np.float32))
    if packed.dtype != np.uint8 or packed.ndim != 2 or scale.shape != \
            bias.shape or scale.ndim != 2:
        return None
    d_in = packed.shape[0] * 2
    d_out = packed.shape[1]
    if scale.shape[1] != d_out or d_in % scale.shape[0]:
        return None
    group = d_in // scale.shape[0]
    if pack_block <= 0:
        from ltx_jax.kernels.quantization import PACK_BLOCK

        pack_block = PACK_BLOCK
    w8 = np.empty((d_in, d_out), np.int8)
    sw = np.empty((d_out,), np.float32)
    lib.lt_requant_int8_from_int4(
        packed.ctypes.data, scale.ctypes.data, bias.ctypes.data, d_in,
        d_out, group, pack_block, w8.ctypes.data, sw.ctypes.data)
    return {"w8": w8, "sw": sw}


def f32_to_bf16(x) -> Optional[np.ndarray]:
    """Native round-to-nearest-even f32 -> bf16 cast (any shape)."""
    import ml_dtypes

    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(x, np.float32)
    out = np.empty(a.shape, ml_dtypes.bfloat16)
    lib.lt_f32_to_bf16(a.ctypes.data, out.ctypes.data, a.size)
    return out


def bf16_to_f32(x) -> Optional[np.ndarray]:
    """Native bf16 -> f32 cast (any shape)."""
    import ml_dtypes

    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(x)
    if a.dtype != ml_dtypes.bfloat16:
        return None
    out = np.empty(a.shape, np.float32)
    lib.lt_bf16_to_f32(a.ctypes.data, out.ctypes.data, a.size)
    return out
