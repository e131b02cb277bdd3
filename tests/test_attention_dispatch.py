"""sdpa's implementation choice per platform and shape (ops/attention.py).

The GPU paths cannot run here; what is checked is the choice itself, the
errors when an implementation is asked for where it cannot run, and the
cuDNN wrapper's layout and bias handling (with jax.nn's entry point
replaced by a recorder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.ops import attention
from ltx_jax.ops.attention import _xla_sdpa, choose_impl, sdpa

LONG, SHORT = (1, 32, 6144, 128), (1, 32, 512, 128)
TEXT = (1, 32, 1024, 128)
KEY_BIAS = jnp.zeros((1, 1, 1, 1024))
FULL_MASK = jnp.zeros((1, 1, 6144, 6144))


@pytest.mark.parametrize("platform,q,k,bias,dtype,want", [
    ("cpu", LONG, LONG, None, jnp.bfloat16, "xla"),
    ("gpu", LONG, LONG, None, jnp.bfloat16, "cudnn"),
    ("gpu", LONG, TEXT, KEY_BIAS, jnp.bfloat16, "pallas"),
    ("gpu", LONG, LONG, FULL_MASK, jnp.bfloat16, "xla"),
    ("gpu", SHORT, SHORT, None, jnp.bfloat16, "xla"),
    ("gpu", LONG, SHORT, None, jnp.bfloat16, "xla"),
    ("gpu", LONG, LONG, None, jnp.float32, "pallas"),
    ("gpu", (1, 8, 6144, 256), (1, 8, 6144, 256), None, jnp.bfloat16,
     "pallas"),
    ("gpu", (1, 8, 6144, 96), (1, 8, 6144, 96), None, jnp.float32, "xla"),
])
def test_choose_impl(platform, q, k, bias, dtype, want):
    assert choose_impl(q, k, bias, dtype, platform=platform) == want


def _qkv(t=32, d=16, dtype=jnp.float32):
    ks = jax.random.split(jax.random.key(0), 3)
    return [jax.random.normal(kk, (1, 2, t, d), dtype) for kk in ks]


def test_pallas_impl_off_gpu_raises():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="needs a GPU"):
        sdpa(q, k, v, impl="pallas")


def test_pallas_impl_rejects_full_mask(monkeypatch):
    monkeypatch.setattr(attention.jax, "default_backend", lambda: "gpu")
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="key bias"):
        sdpa(q, k, v, bias=jnp.zeros((1, 1, 32, 32)), impl="pallas")


def test_auto_on_cpu_is_the_xla_path():
    q, k, v = _qkv(t=1100)
    np.testing.assert_array_equal(np.asarray(sdpa(q, k, v)),
                                  np.asarray(_xla_sdpa(q, k, v)))


def test_ring_without_mesh_takes_the_single_device_choice():
    attention.set_sequence_parallel(None)
    q, k, v = _qkv()
    np.testing.assert_array_equal(np.asarray(sdpa(q, k, v, impl="ring")),
                                  np.asarray(_xla_sdpa(q, k, v)))


def test_cudnn_wrapper_layout_and_bias(monkeypatch):
    """(B, H, T, D) operands go to jax.nn as (B, T, H, D); a key bias is
    broadcast to the (B, 1, Tq, Tk) bias cuDNN takes, in the operands'
    dtype; the result comes back as (B, H, Tq, D)."""
    seen = {}

    def fake_dpa(q, k, v, bias=None, scale=None, implementation=None):
        seen.update(q=q.shape, k=k.shape, bias=bias, impl=implementation)
        return jnp.zeros(q.shape, q.dtype)

    monkeypatch.setattr(attention.jax.nn, "dot_product_attention", fake_dpa)
    q = jnp.zeros((2, 4, 48, 16), jnp.bfloat16)
    k = jnp.zeros((2, 4, 24, 16), jnp.bfloat16)
    key_bias = jnp.where(jnp.arange(24) < 20, 0.0, -1e4)[None, None, None]
    key_bias = jnp.broadcast_to(key_bias, (2, 1, 1, 24))
    out = sdpa(q, k, k, bias=key_bias, impl="cudnn")
    assert seen["q"] == (2, 48, 4, 16) and seen["k"] == (2, 24, 4, 16)
    assert seen["impl"] == "cudnn"
    assert seen["bias"].shape == (2, 1, 48, 24)
    assert seen["bias"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(seen["bias"][:, 0, 5]),
                                  np.asarray(key_bias[:, 0, 0]
                                             .astype(jnp.bfloat16)))
    assert out.shape == q.shape
