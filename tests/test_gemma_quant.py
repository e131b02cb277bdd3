"""Quantized Gemma: MLX 4-bit repack exactness + quantized forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.kernels.quantization import dequantize_weight
from ltx_jax.models import gemma3
from ltx_jax.weights import keymaps


def _mlx_pack(q_vals, scales, biases):
    """Pack (out, in) 4-bit values into MLX uint32 format."""
    o, i = q_vals.shape
    packed = np.zeros((o, i // 8), np.uint32)
    for n in range(8):
        packed |= q_vals[:, n::8].astype(np.uint32) << (4 * n)
    return {"weight": packed, "scales": scales, "biases": biases}


def test_repack_is_exact():
    rng = np.random.default_rng(0)
    o, i, g = 16, 128, 64
    q_vals = rng.integers(0, 16, (o, i)).astype(np.uint8)
    scales = rng.uniform(0.01, 0.1, (o, i // g)).astype(np.float32)
    biases = rng.uniform(-1, 0, (o, i // g)).astype(np.float32)
    mlx = _mlx_pack(q_vals, scales, biases)
    tensors = {f"x.{k}": v for k, v in mlx.items()}

    # MLX semantics: w[o, i] = q * scales[o, i//g] + biases[o, i//g]
    w_mlx = (q_vals.astype(np.float32)
             * np.repeat(scales, g, axis=1)
             + np.repeat(biases, g, axis=1))

    ours = keymaps._repack_mlx_4bit(tensors, "x")
    w_ours = np.asarray(dequantize_weight(ours, jnp.float32))
    np.testing.assert_allclose(w_ours, w_mlx.T, atol=1e-6)


def test_gemma_forward_with_quantized_layers():
    """Quantized projections must run and approximate the bf16 forward."""
    cfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(0), cfg, jnp.float32)

    from ltx_jax.kernels.quantization import quantize_linear_params

    qlayers = dict(params["layers"])
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        stacked = params["layers"][name]["w"]  # (L, in, out)
        per = [quantize_linear_params({"w": stacked[i]}, bits=8)
               for i in range(cfg.hidden_layers)]
        qlayers[name] = jax.tree.map(lambda *xs: jnp.stack(xs), *per)
    qparams = {**params, "layers": qlayers}

    ids = jnp.asarray([[3, 5, 7, 9]])
    mask = jnp.ones((1, 4), jnp.int32)
    base = gemma3.forward_hidden_states(params, ids, mask, cfg)
    quant = gemma3.forward_hidden_states(qparams, ids, mask, cfg)
    assert np.isfinite(np.asarray(quant)).all()
    # final states should be close (int8 error accumulates over 7 layers)
    corr = np.corrcoef(np.asarray(base[-1]).ravel(),
                       np.asarray(quant[-1]).ravel())[0, 1]
    assert corr > 0.99, f"quantized gemma diverged: corr={corr}"

def test_int8_matmul_matches_dequant_reference():
    """W8A8 per-channel: s8 x s8 dot + rescale vs explicit f32 product."""
    from ltx_jax.kernels.quantization import (
        int8_matmul, requant_int8_channel_np,
    )

    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    p = requant_int8_channel_np(w)
    assert p["w8"].dtype == np.int8 and p["sw"].shape == (128,)
    # requantized weights round-trip within one int8 step per channel
    np.testing.assert_allclose(p["w8"].astype(np.float32) * p["sw"], w,
                               atol=float(p["sw"].max()) * 0.51)

    x = (rng.standard_normal((4, 256)) * 0.7).astype(np.float32)
    y = np.asarray(int8_matmul(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    yref = x @ (p["w8"].astype(np.float32) * p["sw"])
    # activation quant: per-row absmax/127 -> ~1e-2 relative
    rel = np.abs(y - yref).max() / np.abs(yref).max()
    assert rel < 2e-2, rel


def test_int8_requant_from_int4_leaf():
    """requant accepts an int4-group-quantized leaf directly."""
    from ltx_jax.kernels.quantization import (
        dequantize_weight_np, quantize_linear_params,
        requant_int8_channel_np,
    )

    rng = np.random.default_rng(4)
    w = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    q4 = quantize_linear_params({"w": jnp.asarray(w)}, bits=4, group_size=32)
    q4 = {k: np.asarray(v) for k, v in q4.items()}
    p8 = requant_int8_channel_np(q4)
    w4 = dequantize_weight_np(q4)
    np.testing.assert_allclose(p8["w8"].astype(np.float32) * p8["sw"], w4,
                               atol=float(p8["sw"].max()) * 0.51)


def test_gemma_forward_w8a8():
    """mode="w8a8" loads int8 leaves and the forward tracks bf16 closely."""
    cfg = gemma3.Gemma3Config().tiny()
    rng = np.random.default_rng(5)
    d, hd = cfg.hidden_size, cfg.head_dim
    t = {"model.embed_tokens.weight":
         rng.standard_normal((cfg.vocab_size, d)).astype(np.float32) * 0.02,
         "model.norm.weight": np.zeros((d,), np.float32)}
    for i in range(cfg.hidden_layers):
        p = f"model.layers.{i}"
        for nm, o, ii in (("self_attn.q_proj", cfg.attention_heads * hd, d),
                          ("self_attn.k_proj", cfg.kv_heads * hd, d),
                          ("self_attn.v_proj", cfg.kv_heads * hd, d),
                          ("self_attn.o_proj", d, cfg.attention_heads * hd),
                          ("mlp.gate_proj", cfg.intermediate_size, d),
                          ("mlp.up_proj", cfg.intermediate_size, d),
                          ("mlp.down_proj", d, cfg.intermediate_size)):
            t[f"{p}.{nm}.weight"] = rng.standard_normal(
                (o, ii)).astype(np.float32) * 0.05
        t[f"{p}.self_attn.q_norm.weight"] = np.zeros((hd,), np.float32)
        t[f"{p}.self_attn.k_norm.weight"] = np.zeros((hd,), np.float32)
        for nrm in ("input_layernorm", "post_attention_layernorm",
                    "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            t[f"{p}.{nrm}.weight"] = np.zeros((d,), np.float32)

    p8 = keymaps.load_gemma_params(dict(t), cfg.hidden_layers, mode="w8a8")
    pb = keymaps.load_gemma_params(dict(t), cfg.hidden_layers, mode="bf16")
    assert p8["layers"]["q_proj"]["w8"].dtype == np.int8
    assert "w" in p8["embed_tokens"]  # embeddings stay dense
    assert "lm_head8" not in p8  # measured neutral; not worth 1 GB HBM

    ids = jnp.asarray([[3, 5, 7, 9]])
    mask = jnp.ones((1, 4), jnp.int32)
    h8 = gemma3.forward_hidden_states(p8, ids, mask, cfg)
    hb = gemma3.forward_hidden_states(pb, ids, mask, cfg)
    assert np.isfinite(np.asarray(h8)).all()
    corr = np.corrcoef(np.asarray(h8[-1], np.float32).ravel(),
                       np.asarray(hb[-1], np.float32).ravel())[0, 1]
    assert corr > 0.99, f"w8a8 gemma diverged: corr={corr}"


def test_gemma_generate_w8a8():
    """Device-side generation runs with int8 leaves (scan-stability path)."""
    cfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(1), cfg, jnp.float32)
    from ltx_jax.kernels.quantization import requant_int8_channel_np

    qlayers = dict(params["layers"])
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        stacked = np.asarray(params["layers"][name]["w"], np.float32)
        per = [requant_int8_channel_np(stacked[i])
               for i in range(cfg.hidden_layers)]
        qlayers[name] = jax.tree.map(lambda *xs: jnp.stack(
            [jnp.asarray(x) for x in xs]), *per)
    qparams = {**params, "layers": qlayers}
    toks = gemma3.generate_tokens(qparams, np.array([3, 5, 7]), cfg,
                                  jax.random.key(2), max_new_tokens=8,
                                  bucket=8)
    assert 0 < len(toks) <= 8
