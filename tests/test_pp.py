"""Pipeline parallelism (parallel/pipeline.py): GPipe over the stacked
block axis must be numerically identical to the sequential scan, forward
AND backward, for every microbatch split."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.models import dit
from ltx_jax.ops.attention import prepare_additive_mask
from ltx_jax.parallel.pipeline import (
    dit_forward_pp, make_pp_mesh, pp_param_specs, shard_pp_params,
)

CFG = dataclasses.replace(TransformerConfig().tiny(), num_layers=4)
B, T, S_CTX = 4, 6, 8


def _inputs(batch=B, dtype=jnp.float32):
    k = jax.random.split(jax.random.key(0), 5)
    params = dit.init_params(k[0], CFG, dtype)
    latent = jax.random.normal(k[1], (batch, T, CFG.in_channels), dtype)
    context = jax.random.normal(
        k[2], (batch, S_CTX, CFG.caption_channels), dtype)
    timesteps = jax.random.uniform(k[3], (batch,), jnp.float32)
    cos, sin = np.ones((CFG.num_heads, T, CFG.head_dim // 2), np.float32), \
        np.zeros((CFG.num_heads, T, CFG.head_dim // 2), np.float32)
    rng = np.random.default_rng(7)
    cos = jnp.asarray(np.cos(rng.normal(size=cos.shape)).astype(np.float32))
    sin = jnp.asarray(np.sin(rng.normal(size=sin.shape)).astype(np.float32))
    mask = jnp.asarray(
        rng.integers(0, 2, size=(batch, S_CTX)).astype(np.int32) | 1)
    bias = prepare_additive_mask(mask)
    return params, latent, context, timesteps, (cos, sin), bias


def _stg(batch=B):
    sa, ff = dit.stg_skip_masks(CFG, batch, (1, 2), (batch - 1,),
                                skip_ff_too=True)
    cas = jnp.asarray(np.linspace(0.8, 1.2, CFG.num_layers), jnp.float32)
    return sa, ff, cas


@pytest.mark.parametrize("data,pipe,n_mb", [(2, 4, 2), (1, 4, 4), (1, 2, 1)])
def test_pp_matches_sequential(data, pipe, n_mb):
    params, latent, context, ts, pe, bias = _inputs()
    sa, ff, cas = _stg()
    mesh = make_pp_mesh(data=data, pipe=pipe)
    ref = dit.dit_forward(params, latent, context, ts, pe, CFG,
                          context_bias=bias, skip_self_attn=sa, skip_ff=ff,
                          cross_attn_scale=cas, sdpa_impl="xla")
    pp_params = shard_pp_params(params, mesh)
    out = dit_forward_pp(pp_params, latent, context, ts, pe, CFG, mesh,
                         context_bias=bias, skip_self_attn=sa, skip_ff=ff,
                         cross_attn_scale=cas, n_microbatches=n_mb,
                         sdpa_impl="xla")
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_pp_defaults_and_broadcast_bias():
    """No STG masks, bias batch-dim 1, default microbatching."""
    params, latent, context, ts, pe, _ = _inputs()
    bias1 = prepare_additive_mask(jnp.ones((1, S_CTX), jnp.int32))
    mesh = make_pp_mesh(data=2, pipe=4)
    ref = dit.dit_forward(params, latent, context, ts, pe, CFG,
                          context_bias=bias1, sdpa_impl="xla")
    out = dit_forward_pp(shard_pp_params(params, mesh), latent, context, ts,
                         pe, CFG, mesh, context_bias=bias1, sdpa_impl="xla")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_pp_backward_matches_sequential():
    """Grads through the pipeline (ppermute/scan/dynamic-update transposes)
    equal the sequential scan's grads — PP is usable for training."""
    params, latent, context, ts, pe, bias = _inputs()
    mesh = make_pp_mesh(data=1, pipe=4)

    def loss_seq(p, lat):
        out = dit.dit_forward(p, lat, context, ts, pe, CFG,
                              context_bias=bias, sdpa_impl="xla")
        return jnp.mean(out.astype(jnp.float32) ** 2)

    def loss_pp(p, lat):
        out = dit_forward_pp(p, lat, context, ts, pe, CFG, mesh,
                             context_bias=bias, n_microbatches=2,
                             sdpa_impl="xla", remat=True)
        return jnp.mean(out.astype(jnp.float32) ** 2)

    g_ref = jax.grad(loss_seq, argnums=(0, 1))(params, latent)
    g_pp = jax.grad(loss_pp, argnums=(0, 1))(
        shard_pp_params(params, mesh), latent)
    flat_ref, _ = jax.tree_util.tree_flatten(g_ref)
    flat_pp, _ = jax.tree_util.tree_flatten(g_pp)
    assert len(flat_ref) == len(flat_pp)
    for a, b in zip(flat_ref, flat_pp):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=3e-5, rtol=3e-5)


def test_pp_specs_and_validation():
    params, *_ = _inputs()
    specs = pp_param_specs(params)
    from jax.sharding import PartitionSpec as P
    assert specs["blocks"]["attn1"]["to_q"]["w"] == P("pipe")
    assert specs["patchify_proj"]["w"] == P()
    mesh = make_pp_mesh(data=1, pipe=8)
    # num_layers=4 not divisible by 8 stages
    _, latent, context, ts, pe, bias = _inputs()
    with pytest.raises(InvalidConfigurationError):
        dit_forward_pp(params, latent, context, ts, pe, CFG, mesh)


def test_pp_train_step_matches_sequential():
    """TrainConfig.pp_mesh routes the flow-matching loss through the GPipe
    forward; with the same PRNG key the updated params must equal the
    sequential step's."""
    from ltx_jax.train import TrainConfig
    from ltx_jax.train.step import init_train_state, make_train_step

    params, latent, context, _ts, pe, bias = _inputs()
    mesh = make_pp_mesh(data=1, pipe=4)
    tc_seq = TrainConfig(learning_rate=1e-3, lora_only=False, remat=True,
                         compute_dtype=jnp.float32, sdpa_impl="xla")
    tc_pp = dataclasses.replace(tc_seq, pp_mesh=mesh, pp_microbatches=2)
    key = jax.random.key(5)

    tr1, fr1, os1 = init_train_state(params, tc_seq)
    step1 = make_train_step(CFG, tc_seq, donate=False)
    tr1, os1, aux1 = step1(tr1, fr1, os1, latent, context, pe, key, bias)

    tr2, fr2, os2 = init_train_state(shard_pp_params(params, mesh), tc_pp)
    step2 = make_train_step(CFG, tc_pp, donate=False)
    tr2, os2, aux2 = step2(tr2, fr2, os2, latent, context, pe, key, bias)

    assert float(aux2["loss"]) == pytest.approx(float(aux1["loss"]),
                                                rel=1e-5)
    flat1 = jax.tree_util.tree_flatten(tr1)[0]
    flat2 = jax.tree_util.tree_flatten(tr2)[0]
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=3e-5, rtol=3e-5)


def test_pp_denoise_step_matches_sequential():
    """make_denoise_step(pp_mesh=...) — the full guidance step (CFG + STG
    rows as microbatches, I2V-free path) equals the standard step."""
    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.pipeline.denoise import (
        GuidanceSpec, build_guidance_context, make_denoise_step,
    )

    params, *_ = _inputs()
    guidance = GuidanceSpec(
        use_cfg=True, cfg_scale=4.0, guidance_rescale=0.7, stg_scale=0.5,
        stg_blocks=(1,), ge_gamma=0.0, cross_attention_scale=1.1)
    shape = VideoLatentShape(1, CFG.in_channels, 2, 4, 4)
    pos = jax.random.normal(jax.random.key(11),
                            (1, 16, CFG.caption_channels), jnp.float32)
    neg = jax.random.normal(jax.random.key(12),
                            (1, 16, CFG.caption_channels), jnp.float32)
    mask = jnp.ones((1, 16), jnp.int32)
    context, bias = build_guidance_context(guidance, pos, mask, neg, mask)
    latent_np = np.asarray(
        jax.random.normal(jax.random.key(13), shape.shape))

    step = make_denoise_step(params, CFG, guidance, shape, context, bias,
                             sdpa_impl="xla")
    # the step donates its latent buffer — give each call its own copy
    lat1 = jnp.asarray(latent_np)
    ref, ref_vel = step(lat1, 0.9, 0.5, jnp.zeros_like(lat1),
                        jnp.asarray(False), jax.random.key(14))

    mesh = make_pp_mesh(data=1, pipe=4)
    pp_step = make_denoise_step(
        shard_pp_params(params, mesh), CFG, guidance, shape, context, bias,
        sdpa_impl="xla", pp_mesh=mesh)
    lat2 = jnp.asarray(latent_np)
    out, vel = pp_step(lat2, 0.9, 0.5, jnp.zeros_like(lat2),
                       jnp.asarray(False), jax.random.key(14))
    # the production step casts tokens to bf16; microbatched (B=1) and
    # batched (B=3) bf16 matmuls round differently, so tolerance is
    # bf16-ulp scale here — exactness is pinned by the f32 tests above
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(vel), np.asarray(ref_vel),
                               atol=2e-2, rtol=2e-2)


def test_pp_av_matches_sequential():
    """Dual AV transformer under the pipeline: the (video, audio) activation
    pair hops stages together and must equal the sequential dual scan."""
    from ltx_jax.models import dit_av
    from ltx_jax.parallel.pipeline import dit_av_forward_pp

    k = jax.random.split(jax.random.key(3), 6)
    params = dit_av.init_params(k[0], CFG, jnp.float32)
    b, tv, ta, s = 4, 8, 5, 8
    vlat = jax.random.normal(k[1], (b, tv, CFG.in_channels), jnp.float32)
    alat = jax.random.normal(k[2], (b, ta, CFG.audio_in_channels),
                             jnp.float32)
    vctx = jax.random.normal(k[3], (b, s, CFG.caption_channels), jnp.float32)
    actx = jax.random.normal(k[4], (b, s, CFG.caption_channels), jnp.float32)
    ts_v = jax.random.uniform(k[5], (b,), jnp.float32)
    ts_a = ts_v * 0.9
    ropes = dit_av.prepare_av_ropes(CFG, 2, 2, 2, ta)
    vbias = prepare_additive_mask(jnp.ones((b, s), jnp.int32))

    ref_v, ref_a = dit_av.dit_av_forward(
        params, vlat, alat, vctx, actx, ts_v, ts_a, ropes, CFG,
        video_bias=vbias, sdpa_impl="xla")

    mesh = make_pp_mesh(data=2, pipe=4)
    out_v, out_a = dit_av_forward_pp(
        shard_pp_params(params, mesh), vlat, alat, vctx, actx, ts_v, ts_a,
        ropes, CFG, mesh, video_bias=vbias, n_microbatches=2,
        sdpa_impl="xla")
    np.testing.assert_allclose(np.asarray(out_v), np.asarray(ref_v),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(ref_a),
                               atol=2e-5, rtol=2e-5)


def test_pp_av_train_step_matches_sequential():
    """AV joint train step under TrainConfig.pp_mesh == sequential."""
    from ltx_jax.models import dit_av
    from ltx_jax.train import TrainConfig
    from ltx_jax.train.step import init_train_state, make_av_train_step

    k = jax.random.split(jax.random.key(6), 5)
    params = dit_av.init_params(k[0], CFG, jnp.float32)
    b, tv, ta, s = 2, 8, 5, 8
    vtok = jax.random.normal(k[1], (b, tv, CFG.in_channels), jnp.float32)
    atok = jax.random.normal(k[2], (b, ta, CFG.audio_in_channels),
                             jnp.float32)
    vctx = jax.random.normal(k[3], (b, s, CFG.caption_channels), jnp.float32)
    actx = jax.random.normal(k[4], (b, s, CFG.caption_channels), jnp.float32)
    ropes = dit_av.prepare_av_ropes(CFG, 2, 2, 2, ta)
    key = jax.random.key(7)

    tc_seq = TrainConfig(learning_rate=1e-3, compute_dtype=jnp.float32,
                         sdpa_impl="xla")
    tr1, fr1, os1 = init_train_state(params, tc_seq)
    step1 = make_av_train_step(CFG, tc_seq, donate=False)
    tr1, os1, aux1 = step1(tr1, fr1, os1, vtok, atok, vctx, actx, ropes, key)

    mesh = make_pp_mesh(data=1, pipe=4)
    tc_pp = dataclasses.replace(tc_seq, pp_mesh=mesh, pp_microbatches=2)
    tr2, fr2, os2 = init_train_state(shard_pp_params(params, mesh), tc_pp)
    step2 = make_av_train_step(CFG, tc_pp, donate=False)
    tr2, os2, aux2 = step2(tr2, fr2, os2, vtok, atok, vctx, actx, ropes, key)

    assert float(aux2["loss"]) == pytest.approx(float(aux1["loss"]),
                                                rel=1e-5)
    for a, b_ in zip(jax.tree_util.tree_flatten(tr1)[0],
                     jax.tree_util.tree_flatten(tr2)[0]):
        np.testing.assert_allclose(np.asarray(b_), np.asarray(a),
                                   atol=3e-5, rtol=3e-5)


def test_pp_pipeline_e2e_generate():
    """LTXPipeline.shard_pp: full tiny T2V e2e through the public API on a
    (1, 2) pipe mesh matches the unsharded pipeline (same seed) at bf16
    tolerance."""
    from ltx_jax.core.config import GenerationConfig
    from ltx_jax.pipeline.generate import LTXPipeline

    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=21)
    ref = LTXPipeline.random_tiny(seed=0).generate_video("pp e2e", cfg)

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.shard_pp(make_pp_mesh(data=1, pipe=2))
    out = pipe.generate_video("pp e2e", cfg)
    a, b = np.asarray(out.frames), np.asarray(ref.frames)
    assert a.shape == b.shape == (9, 64, 64, 3)
    assert np.isfinite(a).all()
    # frames are [0,1] uint8-ish f32; bf16 activation rounding differs
    # between microbatched and batched matmuls (see denoise-step test)
    assert np.max(np.abs(a - b)) < 0.05, np.max(np.abs(a - b))


def test_pp_shard_excludes_tp():
    """shard()/shard_pp() mutual exclusion holds in BOTH orders."""
    from ltx_jax.core.errors import InvalidConfigurationError
    from ltx_jax.parallel.sharding import make_mesh
    from ltx_jax.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.shard(make_mesh(data=1, model=2))
    with pytest.raises(InvalidConfigurationError):
        pipe.shard_pp(make_pp_mesh(data=1, pipe=2))

    pipe2 = LTXPipeline.random_tiny(seed=0)
    pipe2.shard_pp(make_pp_mesh(data=1, pipe=2))
    with pytest.raises(InvalidConfigurationError):
        pipe2.shard(make_mesh(data=1, model=2))


def test_pp_av_denoise_step_matches_sequential():
    """make_av_denoise_step(pp_mesh=...) — dual AV guidance step (CFG rows
    as microbatches) equals the standard step."""
    from ltx_jax.models import dit_av
    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.pipeline.denoise import GuidanceSpec, make_av_denoise_step

    params = dit_av.init_params(jax.random.key(31), CFG, jnp.float32)
    guidance = GuidanceSpec(
        use_cfg=True, cfg_scale=4.0, guidance_rescale=0.3, stg_scale=0.0,
        stg_blocks=(), ge_gamma=0.0, cross_attention_scale=1.0)
    shape = VideoLatentShape(1, CFG.in_channels, 2, 4, 4)
    ta = 5
    v_ctx = jnp.tile(jax.random.normal(
        jax.random.key(32), (1, 8, CFG.caption_channels), jnp.float32),
        (2, 1, 1))
    a_ctx = v_ctx * 0.9
    video_np = np.asarray(
        jax.random.normal(jax.random.key(33), shape.shape))
    audio_np = np.asarray(
        jax.random.normal(jax.random.key(34), (1, ta, CFG.audio_in_channels)))

    step = make_av_denoise_step(params, CFG, guidance, shape, ta,
                                v_ctx, a_ctx, None, sdpa_impl="xla")
    ref_v, ref_a = step(jnp.asarray(video_np), jnp.asarray(audio_np),
                        0.9, 0.5, jax.random.key(35))

    mesh = make_pp_mesh(data=1, pipe=4)
    pp_step = make_av_denoise_step(
        shard_pp_params(params, mesh), CFG, guidance, shape, ta,
        v_ctx, a_ctx, None, sdpa_impl="xla", pp_mesh=mesh)
    out_v, out_a = pp_step(jnp.asarray(video_np), jnp.asarray(audio_np),
                           0.9, 0.5, jax.random.key(35))
    # bf16 token cast in the step: microbatched (B=1) vs batched (B=2)
    # matmuls round differently — bf16-ulp tolerance (see the video test)
    np.testing.assert_allclose(np.asarray(out_v), np.asarray(ref_v),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(ref_a),
                               atol=2e-2, rtol=2e-2)


def test_pp_pipeline_e2e_generate_audio():
    """LTXPipeline.shard_pp with the dual AV path: tiny audio+video e2e on
    a (1, 2) pipe mesh matches the unsharded pipeline at bf16 tolerance."""
    from ltx_jax.core.config import GenerationConfig
    from ltx_jax.pipeline.generate import LTXPipeline

    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=23)
    ref = LTXPipeline.random_tiny(
        seed=0, include_audio=True).generate_video_with_audio("pp av", cfg)

    pipe = LTXPipeline.random_tiny(seed=0, include_audio=True)
    pipe.shard_pp(make_pp_mesh(data=1, pipe=2))
    out = pipe.generate_video_with_audio("pp av", cfg)
    a, b = np.asarray(out.frames), np.asarray(ref.frames)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.max(np.abs(a - b)) < 0.05, np.max(np.abs(a - b))
    aa, ab = np.asarray(out.audio), np.asarray(ref.audio)
    assert aa.shape == ab.shape and np.isfinite(aa).all()
    assert np.max(np.abs(aa - ab)) < 0.05, np.max(np.abs(aa - ab))


def test_pp_cli_accepts_audio():
    """--mesh-pp + --audio is a supported combination (dry-run passes)."""
    import ltx_jax.io.cli as cli

    rc = cli.main(["generate", "x", "--audio", "--mesh-pp", "1,2",
                   "--dry-run"])
    assert rc == 0
