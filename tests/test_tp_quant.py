"""TP sharding of quantized + AV + Gemma transformers (VERDICT r1 weak #3:
TP existed only for the unquantized video DiT and was never user-reachable).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.kernels.quantization import (
    is_quantized,
    quantize_transformer_params,
)
from ltx_jax.ops.latents import VideoLatentShape
from ltx_jax.parallel.sharding import (
    make_mesh,
    shard_transformer_params,
    transformer_param_specs,
)
from ltx_jax.pipeline.denoise import GuidanceSpec, make_denoise_step

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def tcfg():
    # head/ffn dims divisible by the 4-way model axis AND by group_size 16
    return dataclasses.replace(
        TransformerConfig().tiny(), num_heads=4, head_dim=64,
        in_channels=32, out_channels=32, cross_attention_dim=256,
    )


@pytest.fixture(scope="module")
def qparams(tcfg):
    from ltx_jax.models import dit

    params = dit.init_params(jax.random.key(0), tcfg, jnp.bfloat16)
    return quantize_transformer_params(params, bits=4, group_size=16)


def test_quantize_walker_covers_av_blocks(tcfg):
    """All 6 attentions + 2 FFNs of the dual block quantize."""
    from ltx_jax.models import dit_av

    big = dataclasses.replace(
        tcfg, num_layers=1, num_heads=4, head_dim=64,
        audio_num_heads=4, audio_head_dim=64,
    )
    params = dit_av.init_params(jax.random.key(1), big, jnp.bfloat16)
    q = quantize_transformer_params(params, bits=4, group_size=16)
    b = q["blocks"]
    for name in ("attn1", "attn2", "audio_attn1", "audio_attn2",
                 "audio_to_video_attn", "video_to_audio_attn"):
        assert is_quantized(b[name]["to_q"]), name
        assert is_quantized(b[name]["to_out"]), name
    for ff in ("ff", "audio_ff"):
        assert is_quantized(b[ff]["project_in"]), ff
        assert is_quantized(b[ff]["project_out"]), ff
    # norms and tables untouched
    assert "w" in b["norm1"] and not is_quantized(b["norm1"])
    assert b["scale_shift_table"].dtype == jnp.float32


def test_quantized_specs_shard_all_quant_arrays(qparams):
    """Every w_q4/scale/bias in blocks gets a 'model'-sharded spec."""
    specs = transformer_param_specs(qparams)
    attn = specs["blocks"]["attn1"]
    # column parallel: last axis sharded on every array
    for arr_key in ("w_q4", "scale", "bias", "b"):
        assert attn["to_q"][arr_key][-1] == "model", arr_key
    # row parallel: input axis sharded, "b" replicated
    assert attn["to_out"]["w_q4"][-2] == "model"
    assert attn["to_out"]["scale"][-2] == "model"
    assert len([a for a in attn["to_out"]["b"] if a]) == 0
    # flat-dim q_norm shards; top-level stays replicated
    assert attn["q_norm"]["w"][-1] == "model"
    assert len([a for a in specs["patchify_proj"]["w"] if a]) == 0


@needs_mesh
def test_int4_tp_matches_single_device(tcfg, qparams):
    mesh = make_mesh(data=1, model=4)
    shape = VideoLatentShape(1, tcfg.in_channels, 2, 2, 2)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, tcfg.caption_channels), jnp.bfloat16)
    latent = jax.random.normal(jax.random.key(0), shape.shape)
    vel = jnp.zeros_like(latent)

    step = make_denoise_step(qparams, tcfg, g, shape, ctx, None)
    base, _ = step(jnp.array(latent), 0.9, 0.5, vel, jnp.asarray(False),
                   jax.random.key(1))

    sharded = shard_transformer_params(qparams, mesh)
    step_s = make_denoise_step(sharded, tcfg, g, shape, ctx, None)
    out, _ = step_s(jnp.array(latent), 0.9, 0.5, vel, jnp.asarray(False),
                    jax.random.key(1))
    np.testing.assert_allclose(
        np.asarray(base, np.float32), np.asarray(out, np.float32),
        atol=2e-2, rtol=2e-2)


@needs_mesh
def test_av_tp_matches_single_device():
    from ltx_jax.models import dit_av
    from ltx_jax.pipeline.denoise import make_av_denoise_step

    tcfg = dataclasses.replace(
        TransformerConfig().tiny(), audio_num_heads=4, audio_head_dim=32)
    params = dit_av.init_params(jax.random.key(2), tcfg, jnp.bfloat16)
    mesh = make_mesh(data=1, model=4)

    shape = VideoLatentShape(1, tcfg.in_channels, 2, 2, 2)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    v_ctx = jnp.ones((1, 8, tcfg.caption_channels), jnp.bfloat16)
    a_ctx = jnp.ones((1, 8, tcfg.caption_channels), jnp.bfloat16)
    video = jax.random.normal(jax.random.key(3), shape.shape)
    audio = jax.random.normal(jax.random.key(4),
                              (1, 5, tcfg.audio_in_channels))

    step = make_av_denoise_step(params, tcfg, g, shape, 5, v_ctx, a_ctx, None)
    bv, ba = step(jnp.array(video), jnp.array(audio), 0.9, 0.5,
                  jax.random.key(5))

    sharded = shard_transformer_params(params, mesh)
    step_s = make_av_denoise_step(sharded, tcfg, g, shape, 5, v_ctx, a_ctx,
                                  None)
    sv, sa = step_s(jnp.array(video), jnp.array(audio), 0.9, 0.5,
                    jax.random.key(5))
    np.testing.assert_allclose(np.asarray(bv, np.float32),
                               np.asarray(sv, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(ba, np.float32),
                               np.asarray(sa, np.float32),
                               atol=2e-2, rtol=2e-2)


@needs_mesh
def test_gemma_tp_matches_single_device():
    from ltx_jax.models import gemma3

    gcfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(6), gcfg, jnp.bfloat16)
    mesh = make_mesh(data=1, model=2)  # 2 kv heads -> model<=2

    ids = jnp.asarray(np.arange(1, 9)[None], jnp.int32)
    mask = jnp.ones((1, 8), jnp.int32)
    base = gemma3.forward_hidden_states(params, ids, mask, gcfg)

    specs = transformer_param_specs(params)
    # Gemma per-head-dim q_norm must stay replicated
    assert len([a for a in specs["layers"]["q_norm"]["w"] if a]) == 0
    sharded = shard_transformer_params(params, mesh)
    out = gemma3.forward_hidden_states(sharded, ids, mask, gcfg)
    np.testing.assert_allclose(np.asarray(base, np.float32),
                               np.asarray(out, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_gemma_w8a8_tp_matches_single_device():
    """W8A8 leaves ({"w8","sw"}) shard over the model axis like any other
    quantized linear: w8 column/row by leaf name, sw with the output dim."""
    from ltx_jax.kernels.quantization import requant_int8_channel_np
    from ltx_jax.models import gemma3

    gcfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(7), gcfg, jnp.float32)
    ql = dict(params["layers"])
    for nm in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj"):
        w = np.asarray(params["layers"][nm]["w"], np.float32)
        per = [requant_int8_channel_np(w[i])
               for i in range(gcfg.hidden_layers)]
        ql[nm] = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *per)
    p8 = {**params, "layers": ql}

    specs = transformer_param_specs(p8)
    # column-parallel: w8 and sw shard on the output (last) axis
    assert specs["layers"]["q_proj"]["w8"][-1] == "model"
    assert specs["layers"]["q_proj"]["sw"][-1] == "model"
    # row-parallel: w8 shards the input axis, sw replicates
    assert specs["layers"]["o_proj"]["w8"][-2] == "model"
    assert len([a for a in specs["layers"]["o_proj"]["sw"] if a]) == 0

    ids = jnp.asarray(np.arange(1, 9)[None], jnp.int32)
    mask = jnp.ones((1, 8), jnp.int32)
    base = gemma3.forward_hidden_states(p8, ids, mask, gcfg)
    mesh = make_mesh(data=1, model=2)
    sharded = shard_transformer_params(p8, mesh)
    out = gemma3.forward_hidden_states(sharded, ids, mask, gcfg)
    np.testing.assert_allclose(np.asarray(base, np.float32),
                               np.asarray(out, np.float32),
                               atol=2e-2, rtol=2e-2)


@needs_mesh
def test_pipeline_shard_end_to_end():
    """pipe.shard(mesh) then a full tiny generation."""
    from ltx_jax.core.config import GenerationConfig
    from ltx_jax.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.memory = dataclasses.replace(pipe.memory,
                                      offload_text_encoder=False)
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=1)
    base = pipe.generate_video("a cat", cfg)

    pipe.shard(make_mesh(data=2, model=4))
    out = pipe.generate_video("a cat", cfg)
    np.testing.assert_allclose(
        np.asarray(base.frames, np.float32),
        np.asarray(out.frames, np.float32), atol=3e-2, rtol=3e-2)
