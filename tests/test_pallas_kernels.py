"""Flash-attention kernel parity via the Pallas interpreter (CPU coverage).

The kernels compile through Triton for GPUs only; `interpret=True` runs the
same Pallas programs through the interpreter and diffs them against the XLA
reference paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.kernels.flash_attention import flash_attention
from ltx_jax.ops.attention import _xla_sdpa


def _qkv(key, b, h, tq, tk, d, dtype=jnp.float32):
    ks = jax.random.split(key, 3)
    q = jax.random.normal(ks[0], (b, h, tq, d), dtype)
    k = jax.random.normal(ks[1], (b, h, tk, d), dtype)
    v = jax.random.normal(ks[2], (b, h, tk, d), dtype)
    return q, k, v


def test_flash_attention_no_bias_interpret():
    q, k, v = _qkv(jax.random.key(0), 2, 3, 32, 32, 16)
    out = flash_attention(q, k, v, block_q=16, block_k=16, interpret=True)
    ref = _xla_sdpa(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_key_bias_interpret():
    """Text key-padding bias (B, Tk), the cross-attention case."""
    q, k, v = _qkv(jax.random.key(1), 2, 2, 16, 24, 8)
    mask = np.zeros((2, 24), np.float32)
    mask[0, 20:] = -1e9  # pad out last keys of sample 0
    bias = jnp.asarray(mask)
    out = flash_attention(q, k, v, bias=bias, block_q=8, block_k=8,
                          interpret=True)
    ref = _xla_sdpa(q, k, v, bias=bias[:, None, None, :])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_4d_bias_and_padded_tail_interpret():
    """(B,1,1,Tk) bias squeeze + non-multiple Tq/Tk padding path."""
    q, k, v = _qkv(jax.random.key(2), 1, 2, 10, 12, 8)
    mask = np.zeros((1, 1, 1, 12), np.float32)
    mask[..., 9:] = -1e9
    bias = jnp.asarray(mask)
    out = flash_attention(q, k, v, bias=bias, block_q=8, block_k=8,
                          interpret=True)
    ref = _xla_sdpa(q, k, v, bias=bias)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_padded_tail_no_bias_interpret():
    """Padded keys must not contribute even without a user bias."""
    q, k, v = _qkv(jax.random.key(3), 1, 1, 9, 11, 8)
    out = flash_attention(q, k, v, block_q=8, block_k=8, interpret=True)
    ref = _xla_sdpa(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_scale_interpret():
    q, k, v = _qkv(jax.random.key(4), 1, 2, 16, 16, 8)
    out = flash_attention(q, k, v, scale=0.25, block_q=8, block_k=8,
                          interpret=True)
    ref = _xla_sdpa(q, k, v, scale=0.25)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_gqa_sdpa_matches_repeated_kv():
    """Grouped-query attention (no KV repeat) == repeat-then-SDPA, with
    1-head and full (B,1,Tq,Tk) biases."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ltx_jax.ops.attention import _gqa_sdpa, _xla_sdpa, sdpa

    b, h, hkv, tq, tk, d = 2, 8, 2, 16, 48, 32
    ks = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(ks[0], (b, h, tq, d), jnp.float32)
    k = jax.random.normal(ks[1], (b, hkv, tk, d), jnp.float32)
    v = jax.random.normal(ks[2], (b, hkv, tk, d), jnp.float32)
    bias = jnp.where(jnp.arange(tk)[None, None, None] < 40, 0.0, -1e9)

    kr = jnp.repeat(k, h // hkv, axis=1)
    vr = jnp.repeat(v, h // hkv, axis=1)
    ref = _xla_sdpa(q, kr, vr, bias=bias)
    out = _gqa_sdpa(q, k, v, bias=bias)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)

    # full (B, 1, Tq, Tk) causal-style bias
    causal = jnp.where(
        jnp.arange(tq)[:, None] * 3 >= jnp.arange(tk)[None], 0.0, -1e9
    )[None, None]
    ref2 = _xla_sdpa(q, kr, vr, bias=causal)
    out2 = _gqa_sdpa(q, k, v, bias=causal)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(ref2),
                               atol=2e-5, rtol=1e-4)

    # dispatch: sdpa() routes GQA through the grouped path on xla/auto
    out3 = sdpa(q, k, v, bias=causal, impl="auto")
    np.testing.assert_allclose(np.asarray(out3), np.asarray(ref2),
                               atol=2e-5, rtol=1e-4)


# ----------------------------------------------------------- flash backward


def _flash_grads(q, k, v, bias, block_q, block_k):
    from ltx_jax.kernels.flash_attention import flash_attention_vjp

    def loss(args):
        qq, kk, vv = args
        o = flash_attention_vjp(qq, kk, vv, bias, None, block_q, block_k,
                                True)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    return jax.grad(loss)((q, k, v))


def _xla_grads(q, k, v, bias):
    def loss(args):
        qq, kk, vv = args
        return jnp.sum(_xla_sdpa(qq, kk, vv, bias=bias).astype(
            jnp.float32) ** 2)

    return jax.grad(loss)((q, k, v))


def test_flash_backward_matches_xla_no_bias():
    q, k, v = _qkv(jax.random.key(1), 2, 3, 32, 32, 16)
    got = _flash_grads(q, k, v, None, 16, 16)
    ref = _xla_grads(q, k, v, None)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=5e-5, rtol=5e-5, err_msg=name)


def test_flash_backward_matches_xla_key_bias():
    """Key-padding bias: masked keys must get ZERO dk/dv and not leak dq."""
    q, k, v = _qkv(jax.random.key(2), 2, 4, 24, 40, 16)
    mask = np.ones((2, 40), np.float32)
    mask[0, 33:] = 0.0
    mask[1, 17:] = 0.0
    bias = jnp.asarray((1 - mask) * -1e30)
    got = _flash_grads(q, k, v, bias, 16, 16)
    ref = _xla_grads(q, k, v, bias[:, None, None, :])
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=5e-5, rtol=5e-5, err_msg=name)
    # fully-masked key rows: exactly zero grads
    assert float(jnp.abs(got[1][0, :, 33:]).max()) == 0.0
    assert float(jnp.abs(got[2][0, :, 33:]).max()) == 0.0


def test_flash_backward_padded_tail():
    """Tq/Tk not multiples of the block: pad keys must not contribute."""
    q, k, v = _qkv(jax.random.key(3), 1, 2, 23, 37, 16)
    got = _flash_grads(q, k, v, None, 16, 16)
    ref = _xla_grads(q, k, v, None)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=5e-5, rtol=5e-5, err_msg=name)


def test_flash_backward_4d_bias():
    q, k, v = _qkv(jax.random.key(4), 2, 2, 16, 48, 16)
    mask = np.ones((2, 48), np.float32)
    mask[:, 40:] = 0.0
    bias4 = jnp.asarray((1 - mask) * -1e30)[:, None, None, :]
    got = _flash_grads(q, k, v, bias4, 16, 16)
    ref = _xla_grads(q, k, v, bias4)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=5e-5, rtol=5e-5, err_msg=name)


def test_flash_vjp_primal_matches_forward():
    from ltx_jax.kernels.flash_attention import flash_attention_vjp

    q, k, v = _qkv(jax.random.key(5), 1, 2, 32, 32, 16)
    out = flash_attention_vjp(q, k, v, None, None, 16, 16, True)
    ref = flash_attention(q, k, v, block_q=16, block_k=16, interpret=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


# ------------------------------------------- wrapper: tiles, padding, bias


@pytest.mark.parametrize("block,t,want", [
    (128, 10, 16),      # short sequence: next power of two, at least 16
    (128, 100, 128),
    (128, 6144, 128),
    (32, 40, 32),
    (64, 3, 16),
])
def test_flash_tile_is_power_of_two(block, t, want):
    from ltx_jax.kernels.flash_attention import _block

    assert _block(block, t) == want


@pytest.mark.parametrize("tq,tk", [(17, 33), (48, 16), (16, 47), (1, 20)])
def test_flash_padding_shapes_interpret(tq, tk):
    """Tq/Tk off the tile: padded q rows are sliced off and padded keys get
    a -1e30 bias, so the output equals plain SDPA at the original shape."""
    q, k, v = _qkv(jax.random.key(tq * 100 + tk), 1, 2, tq, tk, 16)
    out = flash_attention(q, k, v, block_q=16, block_k=16, interpret=True)
    assert out.shape == q.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(_xla_sdpa(q, k, v)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("form", ["2d", "4d", "broadcast"])
def test_flash_key_bias_forms_interpret(form):
    """A key bias arrives as (B, Tk), (B, 1, 1, Tk), or (1, Tk) broadcast
    over the batch; each is one per-batch row the kernel loads per k
    block."""
    q, k, v = _qkv(jax.random.key(11), 2, 2, 24, 32, 16)
    row = np.where(np.arange(32) < 27, 0.0, -1e9).astype(np.float32)
    full = np.stack([row, np.roll(row, -3)])
    bias = {"2d": jnp.asarray(full),
            "4d": jnp.asarray(full)[:, None, None, :],
            "broadcast": jnp.asarray(row)[None]}[form]
    ref_bias = jnp.asarray(row[None].repeat(2, 0) if form == "broadcast"
                           else full)[:, None, None, :]
    out = flash_attention(q, k, v, bias=bias, block_q=16, block_k=16,
                          interpret=True)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(_xla_sdpa(q, k, v, bias=ref_bias)),
                               atol=2e-5, rtol=2e-5)


def test_flash_rejects_full_mask():
    """A (B, 1, Tq, Tk) mask is not a key bias: the kernel refuses it."""
    q, k, v = _qkv(jax.random.key(12), 1, 1, 16, 16, 16)
    with pytest.raises(ValueError, match="key bias"):
        flash_attention(q, k, v, bias=jnp.zeros((1, 1, 16, 16)),
                        interpret=True)


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_stats_match_plain_softmax(with_bias):
    """return_stats gives the row max m and normalizer l of the plain
    softmax — the statistics ring attention merges."""
    q, k, v = _qkv(jax.random.key(13), 1, 2, 40, 48, 16)
    bias = (jnp.where(jnp.arange(48)[None] < 40, 0.0, -1e9)
            if with_bias else None)
    out, m, l = flash_attention(q, k, v, bias=bias, block_q=16, block_k=16,
                                interpret=True, return_stats=True)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * 16 ** -0.5
    if with_bias:
        s = s + bias[:, None, None, :]
    m_ref = s.max(-1)
    l_ref = jnp.exp(s - m_ref[..., None]).sum(-1)
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(l), np.asarray(l_ref), rtol=1e-5)
    assert out.shape == q.shape


def test_flash_backward_with_global_lse_sums_to_full_grads():
    """The gradient rule ring attention relies on: with the GLOBAL
    log-sum-exp, backward passes over two halves of the keys give dq
    partials that sum, and dk/dv halves that concatenate, to the full
    gradients."""
    from ltx_jax.kernels.flash_attention import flash_backward

    q, k, v = _qkv(jax.random.key(14), 1, 2, 32, 32, 16)
    g = jax.random.normal(jax.random.key(15), q.shape)
    o, m, l = flash_attention(q, k, v, block_q=16, block_k=16,
                              interpret=True, return_stats=True)
    lse = m + jnp.log(l)
    scale = 16 ** -0.5
    parts = [flash_backward(q, k[:, :, s], v[:, :, s], None, o, lse, g,
                            scale, 16, 16, True)
             for s in (slice(0, 16), slice(16, 32))]
    _, vjp = jax.vjp(_xla_sdpa, q, k, v)
    dq_r, dk_r, dv_r = vjp(g)
    tol = dict(atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(np.asarray(parts[0][0] + parts[1][0]),
                               np.asarray(dq_r), **tol)
    np.testing.assert_allclose(
        np.asarray(jnp.concatenate([parts[0][1], parts[1][1]], 2)),
        np.asarray(dk_r), **tol)
    np.testing.assert_allclose(
        np.asarray(jnp.concatenate([parts[0][2], parts[1][2]], 2)),
        np.asarray(dv_r), **tol)


def test_flash_vjp_bias_cotangent_is_zero():
    """The key bias is a mask input: its cotangent is zeros."""
    from ltx_jax.kernels.flash_attention import flash_attention_vjp

    q, k, v = _qkv(jax.random.key(16), 1, 1, 16, 16, 16)
    bias = jnp.zeros((1, 16))
    gb = jax.grad(lambda b: jnp.sum(flash_attention_vjp(
        q, k, v, b, None, 16, 16, True)))(bias)
    np.testing.assert_array_equal(np.asarray(gb), 0.0)
