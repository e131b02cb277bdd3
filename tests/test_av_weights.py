"""AV transformer weight assembly + prompt-enhancement plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.models import dit_av, gemma3
from ltx_jax.weights import keymaps

CFG = TransformerConfig().tiny()


def _fake_av_tensors(cfg, rng):
    dv, da = cfg.inner_dim, cfg.audio_inner_dim
    t = {}

    def lin(key, i, o):
        t[f"{key}.weight"] = rng.standard_normal((o, i)).astype(np.float32) * 0.05
        t[f"{key}.bias"] = np.zeros((o,), np.float32)

    def norm(key, d):
        t[f"{key}.weight"] = np.ones((d,), np.float32)

    def attn(prefix, q, ctx, inner):
        lin(f"{prefix}.to_q", q, inner)
        lin(f"{prefix}.to_k", ctx, inner)
        lin(f"{prefix}.to_v", ctx, inner)
        lin(f"{prefix}.to_out.0", inner, q)
        norm(f"{prefix}.norm_q", inner)
        norm(f"{prefix}.norm_k", inner)

    def adaln(prefix, d, n):
        lin(f"{prefix}.emb.timestep_embedder.linear_1", 256, d)
        lin(f"{prefix}.emb.timestep_embedder.linear_2", d, d)
        lin(f"{prefix}.linear", d, n * d)

    lin("proj_in", cfg.in_channels, dv)
    adaln("time_embed", dv, 6)
    lin("caption_projection.linear_1", cfg.caption_channels, dv)
    lin("caption_projection.linear_2", dv, dv)
    lin("proj_out", dv, cfg.out_channels)
    t["scale_shift_table"] = np.zeros((2, dv), np.float32)

    lin("audio_proj_in", cfg.audio_in_channels, da)
    adaln("audio_time_embed", da, 6)
    lin("audio_caption_projection.linear_1", cfg.caption_channels, da)
    lin("audio_caption_projection.linear_2", da, da)
    lin("audio_proj_out", da, cfg.audio_out_channels)
    t["audio_scale_shift_table"] = np.zeros((2, da), np.float32)

    adaln("av_ca_video_scale_shift_adaln_single", dv, 4)
    adaln("av_ca_a2v_gate_adaln_single", dv, 1)
    adaln("av_ca_audio_scale_shift_adaln_single", da, 4)
    adaln("av_ca_v2a_gate_adaln_single", da, 1)

    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        norm(f"{p}.norm1", dv)
        attn(f"{p}.attn1", dv, dv, dv)
        norm(f"{p}.norm2", dv)
        attn(f"{p}.attn2", dv, cfg.cross_attention_dim, dv)
        norm(f"{p}.norm3", dv)
        lin(f"{p}.ff.net.0.proj", dv, cfg.ffn_dim)
        lin(f"{p}.ff.net.2", cfg.ffn_dim, dv)
        t[f"{p}.scale_shift_table"] = np.zeros((6, dv), np.float32)
        norm(f"{p}.audio_norm1", da)
        attn(f"{p}.audio_attn1", da, da, da)
        norm(f"{p}.audio_norm2", da)
        attn(f"{p}.audio_attn2", da, cfg.audio_cross_attention_dim, da)
        norm(f"{p}.audio_norm3", da)
        lin(f"{p}.audio_ff.net.0.proj", da, 4 * da)
        lin(f"{p}.audio_ff.net.2", 4 * da, da)
        t[f"{p}.audio_scale_shift_table"] = np.zeros((6, da), np.float32)
        norm(f"{p}.audio_to_video_norm", dv)
        attn(f"{p}.audio_to_video_attn", dv, da, da)
        norm(f"{p}.video_to_audio_norm", da)
        attn(f"{p}.video_to_audio_attn", da, dv, da)
        t[f"{p}.scale_shift_table_a2v_ca_video"] = np.zeros((5, dv), np.float32)
        t[f"{p}.scale_shift_table_a2v_ca_audio"] = np.zeros((5, da), np.float32)
    return t


def test_av_transformer_load_and_forward():
    rng = np.random.default_rng(0)
    tensors = {"model.diffusion_model." + k: v
               for k, v in _fake_av_tensors(CFG, rng).items()}
    params = keymaps.load_av_transformer_params(tensors, CFG.num_layers)

    assert params["blocks"]["audio_attn1"]["to_q"]["w"].shape == (
        CFG.num_layers, CFG.audio_inner_dim, CFG.audio_inner_dim)
    assert params["blocks"]["audio_to_video_attn"]["to_q"]["w"].shape == (
        CFG.num_layers, CFG.inner_dim, CFG.audio_inner_dim)
    assert params["audio_patchify_proj"]["w"].shape == (
        CFG.audio_in_channels, CFG.audio_inner_dim)

    f, h, w, ta = 2, 2, 2, 4
    ropes = dit_av.prepare_av_ropes(CFG, f, h, w, ta)
    v_out, a_out = dit_av.dit_av_forward(
        params,
        jnp.ones((1, f * h * w, CFG.in_channels), jnp.bfloat16),
        jnp.ones((1, ta, CFG.audio_in_channels), jnp.bfloat16),
        jnp.ones((1, 4, CFG.caption_channels), jnp.bfloat16),
        jnp.ones((1, 4, CFG.caption_channels), jnp.bfloat16),
        jnp.full((1,), 0.5), jnp.full((1,), 0.5), ropes, CFG,
    )
    assert v_out.shape == (1, 8, CFG.out_channels)
    assert a_out.shape == (1, ta, CFG.audio_out_channels)
    assert np.isfinite(np.asarray(v_out, np.float32)).all()


def test_enhance_prompt_fallback_and_template():
    from ltx_jax.pipeline import enhance

    chat = enhance.build_chat_prompt("SYS", "a cat")
    assert chat.startswith("<start_of_turn>user\nSYS")
    assert chat.endswith("<start_of_turn>model\n")
    assert "user prompt: a cat" in chat

    cleaned = enhance.clean_enhanced_prompt(
        "Output: Style: realistic.<end_of_turn><eos>")
    assert cleaned == "Style: realistic."

    # failure path: broken tokenizer -> returns raw prompt
    gcfg = gemma3.Gemma3Config().tiny()
    gp = gemma3.init_params(jax.random.key(0), gcfg, jnp.float32)
    out = enhance.enhance_prompt(gp, gcfg, tokenizer=None, prompt="a dog")
    assert out == "a dog"


def test_enhance_prompt_with_stub_tokenizer():
    from ltx_jax.pipeline import enhance

    gcfg = gemma3.Gemma3Config().tiny()
    gp = gemma3.init_params(jax.random.key(0), gcfg, jnp.float32)

    class StubTok:
        class Enc:
            def __init__(self, ids):
                self.ids = ids

        def encode(self, text):
            return self.Enc([(ord(c) % 200) + 2 for c in text[:32]])

        def decode(self, ids):
            return "enhanced scene description"

    out = enhance.enhance_prompt(gp, gcfg, StubTok(), "a dog", max_tokens=3)
    assert out == "enhanced scene description"