"""Ring attention vs single-device SDPA on the virtual 8-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.ops.attention import _xla_sdpa
from ltx_jax.parallel.ring_attention import sequence_parallel_sdpa
from ltx_jax.parallel.sharding import make_mesh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(data=1, model=8)


def _qkv(key, b=1, h=4, t=256, d=32):
    ks = jax.random.split(key, 3)
    q = jax.random.normal(ks[0], (b, h, t, d), jnp.float32)
    k = jax.random.normal(ks[1], (b, h, t, d), jnp.float32)
    v = jax.random.normal(ks[2], (b, h, t, d), jnp.float32)
    return q, k, v


def test_ring_matches_sdpa(mesh):
    q, k, v = _qkv(jax.random.key(0))
    ref = _xla_sdpa(q, k, v)
    out = sequence_parallel_sdpa(q, k, v, mesh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_ring_with_key_bias(mesh):
    q, k, v = _qkv(jax.random.key(1))
    t = q.shape[2]
    bias = jnp.where(jnp.arange(t)[None] < t - 64, 0.0, -1e9
                     ).astype(jnp.float32)  # mask last 64 keys
    ref = _xla_sdpa(q, k, v, bias=bias[:, None, None, :])
    out = sequence_parallel_sdpa(q, k, v, mesh, bias=bias)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_ring_flash_matches_sdpa(mesh):
    """The flash kernel runs INSIDE the shard_map ring body (interpret
    mode on CPU) and matches plain SDPA — with and without a
    rotating key bias."""
    q, k, v = _qkv(jax.random.key(3), t=256)
    ref = _xla_sdpa(q, k, v)
    out = sequence_parallel_sdpa(q, k, v, mesh, use_flash=True,
                                 interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)

    t = q.shape[2]
    bias = jnp.where(jnp.arange(t)[None] < t - 48, 0.0, -1e9
                     ).astype(jnp.float32)
    ref_b = _xla_sdpa(q, k, v, bias=bias[:, None, None, :])
    out_b = sequence_parallel_sdpa(q, k, v, mesh, bias=bias, use_flash=True,
                                   interpret=True)
    np.testing.assert_allclose(np.asarray(out_b), np.asarray(ref_b),
                               atol=2e-5, rtol=1e-4)


def test_ring_flash_on_cpu_mesh_auto_interprets(mesh):
    """Platform comes from the MESH's devices, not jax.default_backend():
    use_flash=None on a CPU mesh picks the einsum path, and the Triton
    kernel never falls into the interpreter by itself — use_flash=True on
    a CPU mesh without interpret=True is an error."""
    q, k, v = _qkv(jax.random.key(9), t=128)
    ref = _xla_sdpa(q, k, v)
    with pytest.raises(ValueError, match="interpret"):
        sequence_parallel_sdpa(q, k, v, mesh, use_flash=True)
    out_auto = sequence_parallel_sdpa(q, k, v, mesh)
    np.testing.assert_allclose(np.asarray(out_auto), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_ring_dispatch_pads_non_divisible(mesh):
    """sdpa(impl='ring') pads a non-ring-divisible sequence (and its key
    bias) instead of silently falling back to quadratic XLA SDPA."""
    from ltx_jax.ops import attention

    q, k, v = _qkv(jax.random.key(4), t=250)  # 250 % 8 != 0
    bias = jnp.where(jnp.arange(250)[None] < 200, 0.0, -1e9
                     ).astype(jnp.float32)
    ref = _xla_sdpa(q, k, v, bias=bias[:, None, None, :])
    attention.set_sequence_parallel(mesh)
    try:
        out = attention.sdpa(q, k, v, bias=bias[:, None, None, :],
                             impl="ring")
    finally:
        attention.set_sequence_parallel(None)
    assert out.shape == q.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_ring_dispatch_biased_self_attention(mesh):
    """A (B,1,1,T) additive key mask no longer falls back to XLA — the
    flagship stage-2 config with a text mask must actually ring."""
    from ltx_jax.ops import attention

    q, k, v = _qkv(jax.random.key(5), t=256)
    mask = (jnp.arange(256)[None] < 240).astype(jnp.int32)
    bias4 = attention.prepare_additive_mask(mask)
    ref = _xla_sdpa(q, k, v, bias=bias4)
    attention.set_sequence_parallel(mesh)
    try:
        out = attention.sdpa(q, k, v, bias=bias4, impl="ring")
    finally:
        attention.set_sequence_parallel(None)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_ring_flagship_shape_runs(mesh):
    """The 19,840-token flagship stage-2 shape rings on the 8-device mesh
    with a key bias (einsum backend: per-device logits 2480^2 f32 ~ 25 MB;
    the flash backend replaces even that with O(block) tiles on a GPU)."""
    b, h, t, d = 1, 2, 19840, 64
    ks = jax.random.split(jax.random.key(6), 3)
    q = jax.random.normal(ks[0], (b, h, t, d), jnp.bfloat16)
    k = jax.random.normal(ks[1], (b, h, t, d), jnp.bfloat16)
    v = jax.random.normal(ks[2], (b, h, t, d), jnp.bfloat16)
    bias = jnp.where(jnp.arange(t)[None] < t - 1000, 0.0, -1e9
                     ).astype(jnp.float32)
    out = sequence_parallel_sdpa(q, k, v, mesh, bias=bias)
    assert out.shape == (b, h, t, d)
    assert np.isfinite(np.asarray(out, np.float32)).all()


def test_ring_output_stays_sequence_sharded(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    q, k, v = _qkv(jax.random.key(2))
    sharding = NamedSharding(mesh, P(None, None, "model", None))
    q = jax.device_put(q, sharding)
    k = jax.device_put(k, sharding)
    v = jax.device_put(v, sharding)
    out = sequence_parallel_sdpa(q, k, v, mesh)
    assert out.sharding.spec == P(None, None, "model", None)

# ---------------------------------------------------------------------------
# Differentiability (round 4): the ring is a custom VJP whose backward makes
# a second K/V loop with traveling dK/dV accumulators — gradients must match
# the plain XLA SDPA's on every path.
# ---------------------------------------------------------------------------


def _grad_ref(q, k, v, bias4=None):
    def loss(q, k, v):
        o = _xla_sdpa(q, k, v, bias=bias4)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def test_ring_grads_match_sdpa(mesh):
    q, k, v = _qkv(jax.random.key(5))
    dq_r, dk_r, dv_r = _grad_ref(q, k, v)

    def loss(q, k, v):
        o = sequence_parallel_sdpa(q, k, v, mesh)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for got, ref in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=5e-4, rtol=1e-3)


def test_ring_grads_with_key_bias(mesh):
    q, k, v = _qkv(jax.random.key(6))
    t = q.shape[2]
    bias = jnp.where(jnp.arange(t)[None] < t - 64, 0.0, -1e9
                     ).astype(jnp.float32)
    dq_r, dk_r, dv_r = _grad_ref(q, k, v, bias4=bias[:, None, None, :])

    def loss(q, k, v):
        o = sequence_parallel_sdpa(q, k, v, mesh, bias=bias)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for got, ref in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=5e-4, rtol=1e-3)


def test_ring_flash_grads_match_sdpa(mesh):
    """The FLASH ring backward (FA-2 dq + dk/dv kernels inside the
    rotating loop, interpret mode on CPU) matches plain SDPA grads — the
    long-sequence training configuration (TrainConfig.sdpa_impl='ring')."""
    q, k, v = _qkv(jax.random.key(7), t=128)
    dq_r, dk_r, dv_r = _grad_ref(q, k, v)

    def loss(q, k, v):
        o = sequence_parallel_sdpa(q, k, v, mesh, use_flash=True,
                                   interpret=True)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for got, ref in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("bias_kind", [None, "key", "full"])
def test_ring_mode_cross_attention_runs_per_head_shard(mesh, bias_kind):
    """Cross-attention (Tq != Tk) and full-mask self-attention cannot ring;
    under impl='ring' they run the single-device choice per head shard on
    the ring's axis (no global-shape kernel call under GSPMD) and match
    plain SDPA."""
    from ltx_jax.ops import attention

    ks = jax.random.split(jax.random.key(21), 3)
    tk = 48 if bias_kind != "full" else 64
    q = jax.random.normal(ks[0], (2, 8, 64, 16), jnp.float32)
    k = jax.random.normal(ks[1], (2, 8, tk, 16), jnp.float32)
    v = jax.random.normal(ks[2], (2, 8, tk, 16), jnp.float32)
    bias = None
    if bias_kind == "key":
        bias = jnp.where(jnp.arange(tk) < 40, 0.0, -1e9)[None, None, None]
        bias = jnp.broadcast_to(bias, (2, 1, 1, tk))
    elif bias_kind == "full":
        bias = jnp.where(jnp.arange(64)[:, None] >= jnp.arange(64)[None],
                         0.0, -1e9)[None, None]
    ref = _xla_sdpa(q, k, v, bias=bias)
    attention.set_sequence_parallel(mesh)
    try:
        out = attention.sdpa(q, k, v, bias=bias, impl="ring")
    finally:
        attention.set_sequence_parallel(None)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)
