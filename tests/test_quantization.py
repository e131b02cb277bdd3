"""Weight-only quantization: round-trip accuracy, int4 packing, DiT path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.kernels import quantization as q
from ltx_jax.models import dit
from ltx_jax.ops import rope as rope_ops


def test_int8_roundtrip_error():
    w = jax.random.normal(jax.random.key(0), (128, 64))
    qp = q.quantize_weight(w, bits=8, group_size=64)
    back = q.dequantize_weight(qp, jnp.float32)
    err = np.abs(np.asarray(back) - np.asarray(w)).max()
    # 8-bit over a ~[-3,3] group range -> step ~0.025, max err ~ step/2
    assert err < 0.03
    assert qp["w_q"].dtype == jnp.uint8
    assert qp["scale"].shape == (2, 64)


def test_int4_roundtrip_and_packing():
    w = jax.random.normal(jax.random.key(1), (128, 32))
    qp = q.quantize_weight(w, bits=4, group_size=64)
    assert qp["w_q4"].shape == (64, 32)  # packed 2 per byte
    back = q.dequantize_weight(qp, jnp.float32)
    err = np.abs(np.asarray(back) - np.asarray(w)).max()
    assert err < 0.5  # 15 levels over group range
    # int4 better than nothing: correlation strongly positive
    c = np.corrcoef(np.asarray(back).ravel(), np.asarray(w).ravel())[0, 1]
    assert c > 0.98


def test_exact_representable():
    """A two-level weight sits exactly on the quantization grid."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.integers(0, 2, (128, 8)) * 2.55, jnp.float32)
    # ensure both levels present per group so min/max are 0 and 2.55
    w = w.at[0].set(0.0).at[63].set(2.55).at[64].set(0.0).at[127].set(2.55)
    qp = q.quantize_weight(w, bits=8, group_size=64)
    back = q.dequantize_weight(qp, jnp.float32)
    np.testing.assert_allclose(np.asarray(back), np.asarray(w), atol=1e-5)


def test_linear_any_matches_plain():
    w = jax.random.normal(jax.random.key(2), (128, 64)) * 0.05
    b = jax.random.normal(jax.random.key(3), (64,)) * 0.1
    x = jax.random.normal(jax.random.key(4), (2, 128), jnp.float32)
    plain = q.linear_any({"w": w, "b": b}, x)
    qp = q.quantize_linear_params({"w": w, "b": b}, bits=8)
    quant = q.linear_any(qp, x)
    np.testing.assert_allclose(
        np.asarray(plain), np.asarray(quant), atol=0.05
    )


def test_quantized_dit_forward():
    """Quantized DiT must run under jit and stay close to bf16 output."""
    cfg = TransformerConfig().tiny()
    params = dit.init_params(jax.random.key(0), cfg, dtype=jnp.float32)
    f, h, w = 2, 2, 2
    t = f * h * w
    latent = jax.random.normal(jax.random.key(1), (1, t, cfg.in_channels))
    ctx = jax.random.normal(jax.random.key(2), (1, 8, cfg.caption_channels))
    ts = jnp.full((1,), 0.5)
    cos, sin = rope_ops.video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
    pe = (jnp.asarray(cos), jnp.asarray(sin))

    base = dit.dit_forward(params, latent, ctx, ts, pe, cfg)
    qparams = q.quantize_dit_params(params, bits=8)
    # tiny config weights are small; FFN (128 x 512 = 65536) hits threshold
    assert q.is_quantized(qparams["blocks"]["ff"]["project_in"])
    out = jax.jit(
        lambda p, l, c, t_: dit.dit_forward(p, l, c, t_, pe, cfg)
    )(qparams, latent, ctx, ts)
    diff = np.abs(np.asarray(out) - np.asarray(base)).mean()
    assert np.isfinite(np.asarray(out)).all()
    assert diff < 0.1, f"quantized output diverged: {diff}"

def test_transformer_w8a8_walker_and_forward():
    """w8a8=True emits per-channel int8 leaves for the big block linears and
    the quantized DiT forward tracks bf16."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ltx_jax.core.config import TransformerConfig
    from ltx_jax.kernels.quantization import quantize_transformer_params
    from ltx_jax.models import dit
    from ltx_jax.ops import rope as rope_ops

    # dims large enough to pass the _MIN_QUANT_SIZE threshold (inner 256)
    cfg = dataclasses.replace(TransformerConfig().tiny(), in_channels=32,
                              out_channels=32, num_heads=4, head_dim=64,
                              cross_attention_dim=256)
    params = dit.init_params(jax.random.key(0), cfg, jnp.float32)
    q = quantize_transformer_params(params, bits=8, w8a8=True)
    blk = q["blocks"]
    assert blk["attn1"]["to_q"]["w8"].dtype == jnp.int8
    assert blk["attn1"]["to_q"]["w8"].shape == (
        cfg.num_layers, cfg.inner_dim, cfg.inner_dim)
    assert blk["ff"]["project_in"]["sw"].shape == (
        cfg.num_layers, cfg.ffn_dim)
    # small leaves stay bf16 ("w")
    assert "w" in q["patchify_proj"]

    cos, sin = rope_ops.video_rope(2, 2, 2, cfg.inner_dim, cfg.num_heads)
    pe = (jnp.asarray(cos), jnp.asarray(sin))
    x = jax.random.normal(jax.random.key(1), (1, 8, cfg.in_channels),
                          jnp.float32) * 0.5
    ctx = jax.random.normal(jax.random.key(2),
                            (1, 4, cfg.caption_channels), jnp.float32) * 0.5
    ts = jnp.full((1,), 0.5)
    base = dit.dit_forward(params, x.astype(jnp.bfloat16),
                           ctx.astype(jnp.bfloat16), ts, pe, cfg)
    out = dit.dit_forward(q, x.astype(jnp.bfloat16),
                          ctx.astype(jnp.bfloat16), ts, pe, cfg)
    corr = np.corrcoef(np.asarray(base, np.float32).ravel(),
                       np.asarray(out, np.float32).ravel())[0, 1]
    assert np.isfinite(np.asarray(out, np.float32)).all()
    assert corr > 0.99, f"w8a8 DiT diverged: corr={corr}"


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)])
def test_device_int8_channel_matches_numpy_twin(shape):
    """quantize_int8_channel (device, any leading layer axes) == the numpy
    twin the loaders use, layer by layer."""
    import numpy as np

    from ltx_jax.kernels.quantization import (
        _requant_int8_channel_np_numpy, quantize_int8_channel,
    )

    w = np.asarray(jax.random.normal(jax.random.key(3), shape)) * 0.05
    w[..., 5] = 0.0  # an all-zero channel keeps scale 1
    got = quantize_int8_channel(jnp.asarray(w))
    layers = w.reshape((-1,) + shape[-2:])
    want = [_requant_int8_channel_np_numpy(x) for x in layers]
    np.testing.assert_array_equal(
        np.asarray(got["w8"]).reshape(layers.shape),
        np.stack([x["w8"] for x in want]))
    np.testing.assert_allclose(
        np.asarray(got["sw"]).reshape(len(layers), -1),
        np.stack([x["sw"] for x in want]), rtol=1e-6)


def test_w8a8_walker_quantizes_device_trees_on_device():
    """A device (non-numpy) tree quantizes to W8A8 with device arrays out —
    no host round trip of the weights."""
    from ltx_jax.kernels.quantization import quantize_transformer_params

    params = {"blocks": {"ff": {"project_in": {
        "w": jax.random.normal(jax.random.key(4), (2, 256, 512),
                               jnp.bfloat16),
        "b": jnp.zeros((2, 512), jnp.bfloat16)}}}}
    q = quantize_transformer_params(params, bits=8, w8a8=True)
    leaf = q["blocks"]["ff"]["project_in"]
    assert isinstance(leaf["w8"], jax.Array) and leaf["w8"].dtype == jnp.int8
    assert leaf["w8"].shape == (2, 256, 512) and leaf["sw"].shape == (2, 512)
