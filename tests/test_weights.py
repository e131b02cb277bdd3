"""Weight key-mapping round trips: reference-format tensors -> pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.models import dit, gemma3, text_encoder, vae
from ltx_jax.weights import keymaps


def test_transformer_key_mapping_table():
    cases = {
        "proj_in.weight": "patchify_proj.weight",
        "time_embed.emb.timestep_embedder.linear_1.weight":
            "adaln_single.emb.linear_1.weight",
        "time_embed.linear.bias": "adaln_single.linear.bias",
        "transformer_blocks.0.attn1.norm_q.weight":
            "transformer_blocks.0.attn1.q_norm.weight",
        "transformer_blocks.3.attn2.to_out.0.bias":
            "transformer_blocks.3.attn2.to_out.bias",
        "transformer_blocks.1.ff.net.0.proj.weight":
            "transformer_blocks.1.ff.project_in.proj.weight",
        "transformer_blocks.1.ff.net.2.weight":
            "transformer_blocks.1.ff.project_out.weight",
        "scale_shift_table": "scale_shift_table",
        "caption_projection.linear_1.weight": "caption_projection.linear_1.weight",
    }
    for src, expected in cases.items():
        assert keymaps.map_transformer_key(src) == expected
    # audio keys dropped when include_audio=False
    assert keymaps.map_transformer_key("audio_proj_in.weight") is None
    assert keymaps.map_transformer_key(
        "transformer_blocks.0.a2v_ca_video.weight") is None
    # but kept when include_audio=True
    assert keymaps.map_transformer_key(
        "audio_proj_in.weight", include_audio=True) == "audio_proj_in.weight"


def _fake_transformer_tensors(cfg: TransformerConfig, rng):
    """Reference-format (torch layout) tensors for the video DiT."""
    d = cfg.inner_dim
    t = {}

    def lin(key, i, o):
        t[f"{key}.weight"] = rng.standard_normal((o, i)).astype(np.float32)
        t[f"{key}.bias"] = rng.standard_normal((o,)).astype(np.float32)

    lin("proj_in", cfg.in_channels, d)
    lin("time_embed.emb.timestep_embedder.linear_1", 256, d)
    lin("time_embed.emb.timestep_embedder.linear_2", d, d)
    lin("time_embed.linear", d, 6 * d)
    lin("caption_projection.linear_1", cfg.caption_channels, d)
    lin("caption_projection.linear_2", d, d)
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        for attn, ctx in (("attn1", d), ("attn2", cfg.cross_attention_dim)):
            lin(f"{p}.{attn}.to_q", d, d)
            lin(f"{p}.{attn}.to_k", ctx, d)
            lin(f"{p}.{attn}.to_v", ctx, d)
            lin(f"{p}.{attn}.to_out.0", d, d)
            t[f"{p}.{attn}.norm_q.weight"] = np.ones((d,), np.float32)
            t[f"{p}.{attn}.norm_k.weight"] = np.ones((d,), np.float32)
        lin(f"{p}.ff.net.0.proj", d, cfg.ffn_dim)
        lin(f"{p}.ff.net.2", cfg.ffn_dim, d)
        t[f"{p}.scale_shift_table"] = rng.standard_normal(
            (6, d)).astype(np.float32) * 0.01
    lin("proj_out", d, cfg.out_channels)
    t["scale_shift_table"] = rng.standard_normal((2, d)).astype(np.float32) * 0.01
    return t


def test_transformer_load_and_forward():
    cfg = TransformerConfig().tiny()
    rng = np.random.default_rng(0)
    tensors = {
        "model.diffusion_model." + k: v
        for k, v in _fake_transformer_tensors(cfg, rng).items()
    }
    params = keymaps.load_transformer_params(tensors, cfg.num_layers)

    # shapes: stacked blocks, (in, out) layout, bf16
    assert params["blocks"]["attn1"]["to_q"]["w"].shape == (
        cfg.num_layers, cfg.inner_dim, cfg.inner_dim)
    assert params["blocks"]["ff"]["project_in"]["w"].shape == (
        cfg.num_layers, cfg.inner_dim, cfg.ffn_dim)
    assert params["patchify_proj"]["w"].dtype == jnp.bfloat16
    assert params["blocks"]["scale_shift_table"].dtype == jnp.float32

    # weight VALUES routed correctly: check one transposed matrix
    src = tensors["model.diffusion_model.transformer_blocks.1.ff.net.2.weight"]
    np.testing.assert_allclose(
        np.asarray(params["blocks"]["ff"]["project_out"]["w"][1], np.float32),
        src.T, rtol=0.01, atol=0.01,  # bf16 rounding
    )

    # full forward runs
    from ltx_jax.ops import rope as rope_ops

    cos, sin = rope_ops.video_rope(2, 2, 2, cfg.inner_dim, cfg.num_heads)
    out = dit.dit_forward(
        params,
        jnp.ones((1, 8, cfg.in_channels), jnp.bfloat16),
        jnp.ones((1, 4, cfg.caption_channels), jnp.bfloat16),
        jnp.full((1,), 0.5),
        (jnp.asarray(cos), jnp.asarray(sin)),
        cfg,
    )
    assert np.isfinite(np.asarray(out, np.float32)).all()


def test_vae_decoder_key_mapping():
    cases = {
        "decoder.mid_block.resnets.0.conv1.conv.weight":
            "up_blocks_0.res_blocks.0.conv1.conv.weight",
        "decoder.up_blocks.0.upsamplers.0.conv.conv.weight":
            "up_blocks_1.conv.conv.weight",
        "decoder.up_blocks.0.resnets.2.conv2.conv.bias":
            "up_blocks_2.res_blocks.2.conv2.conv.bias",
        "decoder.up_blocks.2.upsamplers.0.conv.conv.weight":
            "up_blocks_5.conv.conv.weight",
        "decoder.up_blocks.2.resnets.4.scale_shift_table":
            "up_blocks_6.res_blocks.4.scale_shift_table",
        "decoder.conv_in.conv.weight": "conv_in.conv.weight",
        "per_channel_statistics.mean-of-means": "mean_of_means",
        "per_channel_statistics.std-of-means": "std_of_means",
        "latents_mean": "mean_of_means",
    }
    for src, expected in cases.items():
        assert keymaps.map_vae_decoder_key(src) == expected, src
    assert keymaps.map_vae_decoder_key("encoder.conv_in.conv.weight") is None


def _fake_vae_tensors(cfg: vae.VAEConfig, rng):
    t = {}
    bc, lc, g = cfg.base_channels, cfg.latent_channels, cfg.blocks_per_group

    def conv(key, ci, co, k=3):
        t[f"{key}.conv.weight"] = rng.standard_normal(
            (co, ci, k, k, k)).astype(np.float32) * (ci * 27) ** -0.5
        t[f"{key}.conv.bias"] = np.zeros((co,), np.float32)

    def group(diff_prefix, c):
        # NOTE: no group time_embedder keys — in the Diffusers 3-up-block
        # layout "up_blocks.0.time_embedder" would legacy-map onto
        # up_blocks_0 (the mid group), colliding; the reference map has the
        # same fall-through (ModelDownloader.swift:863-871). Conditioned
        # VAEs ship in the flat layout where this is unambiguous.
        for j in range(g):
            conv(f"{diff_prefix}.resnets.{j}.conv1", c, c)
            conv(f"{diff_prefix}.resnets.{j}.conv2", c, c)
            t[f"{diff_prefix}.resnets.{j}.scale_shift_table"] = \
                rng.standard_normal((4, c)).astype(np.float32) * 0.01

    conv("decoder.conv_in", lc, bc)
    group("decoder.mid_block", bc)
    for i, c in enumerate((bc, bc // 2, bc // 4)):
        conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, (c // 2) * 8)
        group(f"decoder.up_blocks.{i}", c // 2)
    conv("decoder.conv_out", bc // 8, 3 * cfg.patch_size ** 2)
    t["decoder.last_scale_shift_table"] = np.zeros((2, bc // 8), np.float32)
    t["per_channel_statistics.mean-of-means"] = np.zeros((lc,), np.float32)
    t["per_channel_statistics.std-of-means"] = np.ones((lc,), np.float32)
    return t


def test_vae_decoder_load_and_forward():
    cfg = vae.VAEConfig().tiny()
    rng = np.random.default_rng(1)
    # group() above writes resnets under decoder.up_blocks.{i}.resnets.{j}
    tensors = _fake_vae_tensors(cfg, rng)
    params = keymaps.load_vae_decoder_params(tensors)
    assert len(params["up_blocks_0"]["res_blocks"]) == cfg.blocks_per_group
    assert params["conv_in"]["w"].shape[-2:] == (cfg.latent_channels,
                                                 cfg.base_channels)
    latent = jax.random.normal(jax.random.key(0),
                               (1, cfg.latent_channels, 2, 2, 2))
    out = vae.decoder_forward(params, latent, cfg, timestep=None)
    assert out.shape == (1, 3, 9, 64, 64)
    assert np.isfinite(np.asarray(out)).all()


def test_text_encoder_key_mapping():
    cases = {
        "text_proj_in.weight": "feature_extractor.aggregate_embed.weight",
        "video_connector.transformer_blocks.0.attn1.norm_q.weight":
            "embeddings_connector.transformer_1d_blocks.0.attn1.q_norm.weight",
        "video_connector.learnable_registers":
            "embeddings_connector.learnable_registers",
        "text_embedding_projection.aggregate_embed.weight":
            "feature_extractor.aggregate_embed.weight",
        "video_embeddings_connector.transformer_blocks.1.ff.net.2.weight":
            "embeddings_connector.transformer_1d_blocks.1.ff.project_out.weight",
        "audio_connector.learnable_registers":
            "audio_embeddings_connector.learnable_registers",
    }
    for src, expected in cases.items():
        assert keymaps.map_text_encoder_key(src) == expected, src
    assert keymaps.map_text_encoder_key("random.key") is None


def test_text_encoder_load_and_forward():
    cfg = text_encoder.TextEncoderConfig().tiny()
    d = cfg.inner_dim
    rng = np.random.default_rng(2)
    t = {"text_proj_in.weight": rng.standard_normal(
        (cfg.hidden_dim, cfg.hidden_dim * cfg.num_gemma_layers)
    ).astype(np.float32) * 0.01}
    for i in range(cfg.connector_layers):
        p = f"video_connector.transformer_blocks.{i}"
        for proj, ci in (("to_q", d), ("to_k", d), ("to_v", d), ("to_out.0", d)):
            t[f"{p}.attn1.{proj}.weight"] = rng.standard_normal(
                (d, ci)).astype(np.float32) * 0.05
            t[f"{p}.attn1.{proj}.bias"] = np.zeros((d,), np.float32)
        t[f"{p}.attn1.norm_q.weight"] = np.ones((d,), np.float32)
        t[f"{p}.attn1.norm_k.weight"] = np.ones((d,), np.float32)
        t[f"{p}.ff.net.0.proj.weight"] = rng.standard_normal(
            (4 * d, d)).astype(np.float32) * 0.05
        t[f"{p}.ff.net.0.proj.bias"] = np.zeros((4 * d,), np.float32)
        t[f"{p}.ff.net.2.weight"] = rng.standard_normal(
            (d, 4 * d)).astype(np.float32) * 0.05
        t[f"{p}.ff.net.2.bias"] = np.zeros((d,), np.float32)
    t["video_connector.learnable_registers"] = rng.uniform(
        -1, 1, (cfg.num_registers, d)).astype(np.float32)

    params = keymaps.load_text_encoder_params(t)
    assert "audio_embeddings_connector" not in params
    l, b, tt = cfg.num_gemma_layers, 1, cfg.max_length
    hs = jax.random.normal(jax.random.key(0), (l, b, tt, cfg.hidden_dim),
                           jnp.bfloat16)
    mask = jnp.ones((b, tt), jnp.int32)
    out = text_encoder.encode_from_hidden_states(params, hs, mask, cfg)
    assert out["video"].shape == (b, tt, d)


def test_gemma_load_bf16_and_mlx4bit():
    cfg = gemma3.Gemma3Config().tiny()
    rng = np.random.default_rng(3)
    d, hd = cfg.hidden_size, cfg.head_dim
    t = {"model.embed_tokens.weight":
         rng.standard_normal((cfg.vocab_size, d)).astype(np.float32) * 0.02,
         "model.norm.weight": np.zeros((d,), np.float32),
         "lm_head.weight": np.zeros((cfg.vocab_size, d), np.float32)}
    for i in range(cfg.hidden_layers):
        p = f"model.layers.{i}"
        t[f"{p}.self_attn.q_proj.weight"] = rng.standard_normal(
            (cfg.attention_heads * hd, d)).astype(np.float32) * 0.05
        t[f"{p}.self_attn.k_proj.weight"] = rng.standard_normal(
            (cfg.kv_heads * hd, d)).astype(np.float32) * 0.05
        t[f"{p}.self_attn.v_proj.weight"] = rng.standard_normal(
            (cfg.kv_heads * hd, d)).astype(np.float32) * 0.05
        t[f"{p}.self_attn.o_proj.weight"] = rng.standard_normal(
            (d, cfg.attention_heads * hd)).astype(np.float32) * 0.05
        t[f"{p}.self_attn.q_norm.weight"] = np.zeros((hd,), np.float32)
        t[f"{p}.self_attn.k_norm.weight"] = np.zeros((hd,), np.float32)
        t[f"{p}.mlp.gate_proj.weight"] = rng.standard_normal(
            (cfg.intermediate_size, d)).astype(np.float32) * 0.05
        t[f"{p}.mlp.up_proj.weight"] = rng.standard_normal(
            (cfg.intermediate_size, d)).astype(np.float32) * 0.05
        t[f"{p}.mlp.down_proj.weight"] = rng.standard_normal(
            (d, cfg.intermediate_size)).astype(np.float32) * 0.05
        for nrm in ("input_layernorm", "post_attention_layernorm",
                    "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            t[f"{p}.{nrm}.weight"] = np.zeros((d,), np.float32)

    params = keymaps.load_gemma_params(t, cfg.hidden_layers)
    assert params["layers"]["q_proj"]["w"].shape == (
        cfg.hidden_layers, d, cfg.attention_heads * hd)
    ids = jnp.asarray([[3, 7, 11, 5]])
    hs = gemma3.forward_hidden_states(params, ids, jnp.ones((1, 4), jnp.int32),
                                      cfg)
    assert hs.shape == (cfg.hidden_layers + 1, 1, 4, d)

    # VLM prefix variant routes identically
    t_vlm = {"language_model." + k: v for k, v in t.items()}
    t_vlm["vision_tower.blah.weight"] = np.zeros((2, 2), np.float32)
    params_vlm = keymaps.load_gemma_params(t_vlm, cfg.hidden_layers)
    np.testing.assert_array_equal(
        np.asarray(params_vlm["layers"]["q_proj"]["w"], np.float32),
        np.asarray(params["layers"]["q_proj"]["w"], np.float32),
    )


def test_mlx_4bit_dequant():
    """Pack a known 4-bit pattern and verify dequantization."""
    # w_q row: values 0..7 packed little-endian into one uint32
    q_vals = np.arange(8, dtype=np.uint32)
    packed = np.zeros((1, 1), np.uint32)
    for n, v in enumerate(q_vals):
        packed[0, 0] |= v << (4 * n)
    tensors = {
        "x.weight": packed,
        "x.scales": np.full((1, 1), 2.0, np.float32),
        "x.biases": np.full((1, 1), -1.0, np.float32),
    }
    w = keymaps._maybe_dequant_mlx_4bit(tensors, "x", group_size=8)
    np.testing.assert_allclose(w[0], np.arange(8) * 2.0 - 1.0)


def test_split_unified():
    tensors = {
        "model.diffusion_model.proj_in.weight": np.zeros((4, 4), np.float32),
        "model.diffusion_model.video_embeddings_connector.learnable_registers":
            np.zeros((2, 4), np.float32),
        "model.diffusion_model.text_embedding_projection.aggregate_embed.weight":
            np.zeros((4, 8), np.float32),
        "vae.decoder.conv_in.conv.weight": np.zeros((4, 4, 3, 3, 3), np.float32),
        "per_channel_statistics.mean-of-means": np.zeros((4,), np.float32),
        "model.diffusion_model.foo.weight_scale": np.zeros((1,), np.float32),
        "vocoder.something.weight": np.zeros((1,), np.float32),
        "model.diffusion_model.audio_proj_in.weight": np.zeros((4,), np.float32),
    }
    tr, va, conn = keymaps.split_unified(tensors, include_audio=False)
    assert set(tr) == {"proj_in.weight"}
    assert set(va) == {"decoder.conv_in.conv.weight",
                       "per_channel_statistics.mean-of-means"}
    assert set(conn) == {
        "video_embeddings_connector.learnable_registers",
        "text_embedding_projection.aggregate_embed.weight",
    }
    tr2, _, _ = keymaps.split_unified(tensors, include_audio=True)
    assert "audio_proj_in.weight" in tr2