"""Native (C++) weight-prep kernels vs their numpy twins — exact equality.

The native library self-tests at load and silently falls back to numpy on
any failure, so these tests first assert availability (the build toolchain
is part of the supported environment), then bit-exactness on every kernel
across dtypes, shapes (pack-block divisible and not), and the documented
edge cases (zero-variance groups, zero columns).
"""

import ml_dtypes
import numpy as np
import pytest

from ltx_jax import native
from ltx_jax.kernels import quantization as Q

bf16 = ml_dtypes.bfloat16


def _rand(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, dtype=np.float32).astype(dtype)


def test_native_available():
    assert native.available(), (
        "native weightprep failed to build/self-test — load-time quantize "
        "of real checkpoints regresses ~100x on the numpy fallback")


@pytest.mark.parametrize("dtype", [bf16, np.float32, np.uint8, np.uint32])
@pytest.mark.parametrize("shape", [(33, 127), (64, 64), (5, 257)])
def test_transpose_exact(dtype, shape):
    x = (_rand(shape, np.float32) * 100).astype(dtype)
    got = native.transpose(x)
    ref = np.ascontiguousarray(np.transpose(x))
    assert got.dtype == ref.dtype and got.flags.c_contiguous
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("dtype", [bf16, np.float32])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("d_in,d_out,group", [
    (512, 48, 64),    # pack_block (256) divides d_in: block-plane packing
    (128, 33, 64),    # pack_block does NOT divide: single-plane (blk=d_in)
    (64, 16, 64),     # one group == whole dim
    (384, 24, 96),    # group that doesn't divide pack_block
])
def test_quant_group_exact(dtype, bits, d_in, d_out, group):
    w = _rand((d_in, d_out), dtype, seed=d_in + bits)
    got = Q._quantize_weight_np(w, bits, group)
    ref = Q._quantize_weight_np_numpy(w, bits, group)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_quant_group_zero_variance_group():
    # constant group -> scale==0 -> 1.0 substitution, q = 0 everywhere
    w = np.zeros((128, 8), np.float32)
    w[64:] = _rand((64, 8), np.float32)
    got = Q._quantize_weight_np(w, 4, 64)
    ref = Q._quantize_weight_np_numpy(w, 4, 64)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    assert got["scale"][0].min() == 1.0


@pytest.mark.parametrize("dtype", [bf16, np.float32])
def test_int8_channel_exact(dtype):
    w = _rand((96, 40), dtype, seed=3)
    w[:, 7] = 0  # zero column -> sw 0 -> 1.0 substitution
    got = Q.requant_int8_channel_np(w)
    ref = Q._requant_int8_channel_np_numpy(w)
    assert np.array_equal(got["w8"], ref["w8"])
    assert np.array_equal(got["sw"], ref["sw"])
    assert got["sw"][7] == 1.0


@pytest.mark.parametrize("d_in,d_out,group", [(512, 40, 64), (128, 17, 32)])
def test_requant_int8_from_int4_exact(d_in, d_out, group):
    w = _rand((d_in, d_out), bf16, seed=11)
    qp = Q._quantize_weight_np_numpy(w, 4, group)
    got = Q.requant_int8_channel_np(qp)
    ref = Q._requant_int8_channel_np_numpy(qp)
    assert np.array_equal(got["w8"], ref["w8"])
    assert np.array_equal(got["sw"], ref["sw"])


def test_f32_to_bf16_round_nearest_even():
    # values straddling bf16 rounding boundaries + exact halves
    x = np.array([1.0, 1.0 + 2**-9, 1.0 + 2**-8, -3.14159, 1e-40, 65504.0,
                  np.inf, -np.inf, 0.0, -0.0], np.float32)
    got = native.f32_to_bf16(x)
    assert got is not None
    ref = x.astype(bf16)
    assert np.array_equal(got.view(np.uint16), ref.view(np.uint16))
    r = np.random.default_rng(5).standard_normal(4096, dtype=np.float32)
    assert np.array_equal(native.f32_to_bf16(r).view(np.uint16),
                          r.astype(bf16).view(np.uint16))


def test_bf16_to_f32_exact():
    x = _rand((777,), bf16, seed=9)
    got = native.bf16_to_f32(x)
    assert got is not None
    assert np.array_equal(got, np.asarray(x, np.float32))


def test_keymaps_transpose_routes_native():
    from ltx_jax.weights.keymaps import _t

    w = _rand((48, 96), bf16, seed=2)
    assert np.array_equal(_t(w).view(np.uint16),
                          np.ascontiguousarray(w.T).view(np.uint16))


def test_mlx_repack_still_exact_with_native_transpose():
    # _repack_mlx_4bit now routes its uint8/scale transposes through the
    # native kernel; the repack must stay losslessly identical.
    from ltx_jax.weights import keymaps as KM

    rng = np.random.default_rng(4)
    o, d_in, g = 16, 128, 64
    tensors = {
        "m.weight": rng.integers(0, 2**32, (o, d_in // 8), np.uint64)
        .astype(np.uint32),
        "m.scales": rng.random((o, d_in // g), np.float32).astype(bf16),
        "m.biases": rng.random((o, d_in // g), np.float32).astype(bf16),
    }
    ref_w = KM._maybe_dequant_mlx_4bit(
        {k: v.copy() for k, v in tensors.items()}, "m")
    qp = KM._repack_mlx_4bit(tensors, "m")
    assert set(qp) == {"w_q4", "scale", "bias"}
    got_w = Q.dequantize_weight_np(qp)
    np.testing.assert_array_equal(got_w, np.asarray(ref_w.T, np.float32))
