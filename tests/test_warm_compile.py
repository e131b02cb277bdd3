"""Warm-compile coverage for EVERY generation entry point (round 5).

Round 4 warmed only generate_video's T2V step + VAE decoder; VERDICT r4 #1:
two-stage / AV / flagship / chain / extension / keyframe runs paid their
compiles serially after enhancement (~150 s hideable at the flagship
shape). These tests pin that each path's abstract warm lowering is
IDENTICAL to the program its real phase traces (a mismatched warm compiles
a program that is never hit), and that each entry point requests the right
program set.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.ops.latents import VideoLatentShape
from ltx_jax.pipeline.denoise import (
    GuidanceSpec,
    build_guidance_context,
    make_av_denoise_step,
    make_denoise_step,
)
from ltx_jax.pipeline.generate import GenerationTimings, LTXPipeline, \
    _WarmCompiles


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


@pytest.fixture(scope="module")
def pipe_av():
    p = LTXPipeline.random_tiny(seed=1, include_audio=True)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


def _real_step_text(pipe, cfg, guidance, width=None, height=None,
                    cond_frames=None, cond_frame_idx=None):
    """Lower the step exactly as the real denoise phase does."""
    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, height or cfg.height, width or cfg.width,
        channels=pipe.tcfg.in_channels)
    pos = pipe.encode_prompt("a cat")
    neg = pipe.encode_prompt("bad") if guidance.use_cfg else None
    context, bias = build_guidance_context(
        guidance, pos["video"], pos["mask"],
        neg["video"] if neg else None, neg["mask"] if neg else None)
    cm = cond = None
    k = 1
    if cond_frame_idx is not None:
        cm = pipe._conditioning_mask(shape, frame_idx=cond_frame_idx)
        k = len(cond_frame_idx)
    elif cond_frames is not None:
        cm = pipe._conditioning_mask(shape, frames=cond_frames)
        k = cond_frames
    ics = cfg.image_cond_noise_scale if cm is not None else 0.0
    if cm is not None and ics > 0:
        cond = jnp.zeros((1, pipe.tcfg.in_channels, k, shape.height,
                          shape.width), jnp.float32)
    step = make_denoise_step(
        pipe.transformer_params, pipe.tcfg, guidance, shape, context, bias,
        conditioning_mask=cm, conditioned_latent=cond,
        image_cond_noise_scale=(ics if cm is not None
                                else cfg.image_cond_noise_scale),
        cond_frames=(cond_frames or 1), cond_frame_idx=cond_frame_idx,
        fps=cfg.fps, sdpa_impl=pipe.sdpa_impl)
    latent = jnp.zeros(shape.shape, jnp.float32)
    args = [pipe.transformer_params, context, bias, step._pe,
            latent, 0.9, 0.5, jnp.zeros_like(latent), jnp.asarray(False),
            jax.random.key(0)]
    if cond is not None:
        args.append(cond)
    return step._jit.lower(*args).as_text()


def test_warm_halfres_lowering_matches_stage1(pipe):
    """Two-stage stage 1 runs at half resolution — the width/height
    overrides must lower the same program the s1 denoise traces."""
    cfg = _cfg(width=128, height=128)
    guidance = GuidanceSpec.from_config(cfg)
    warm = pipe._warm_lowering(cfg, guidance, width=cfg.width // 2,
                               height=cfg.height // 2).as_text()
    real = _real_step_text(pipe, cfg, guidance, width=cfg.width // 2,
                           height=cfg.height // 2)
    assert warm == real


def test_warm_cond_lowering_matches_extension_step(pipe):
    """Extension/chain segments trace the CONDITIONED step variant
    (mask + frozen-frame split + clean-source injection arg)."""
    cfg = _cfg(image_cond_noise_scale=0.15)
    guidance = GuidanceSpec.from_config(cfg)
    warm = pipe._warm_lowering(cfg, guidance, cond_frames=2).as_text()
    real = _real_step_text(pipe, cfg, guidance, cond_frames=2)
    assert warm == real


def test_warm_cond_lowering_injection_off(pipe):
    """With image_cond_noise_scale == 0 the step drops the cond-latent
    argument entirely — the warm lowering must drop it too."""
    cfg = _cfg(image_cond_noise_scale=0.0)
    guidance = GuidanceSpec.from_config(cfg)
    warm = pipe._warm_lowering(cfg, guidance, cond_frames=1).as_text()
    real = _real_step_text(pipe, cfg, guidance, cond_frames=1)
    assert warm == real


def test_warm_keyframe_lowering_matches_real(pipe):
    cfg = _cfg(num_frames=17, image_cond_noise_scale=0.15)
    guidance = GuidanceSpec.from_config(cfg)
    idx = np.asarray([0, 2], np.int64)
    warm = pipe._warm_lowering(cfg, guidance, cond_frame_idx=idx).as_text()
    real = _real_step_text(pipe, cfg, guidance, cond_frame_idx=idx)
    assert warm == real


def test_warm_upscaler_lowering_matches_real(pipe):
    from ltx_jax.models.upscaler import UpscalerConfig, upsample_latents_jit

    cfg = _cfg(width=128, height=128)
    warm = pipe._warm_upscaler_lowering(cfg).as_text()

    s1 = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height // 2, cfg.width // 2,
        channels=pipe.tcfg.in_channels)
    mean = pipe.vae_decoder_params["mean_of_means"]
    std = pipe.vae_decoder_params["std_of_means"]
    ucfg = pipe.upscaler_config or UpscalerConfig(
        in_channels=pipe.tcfg.in_channels)
    real = upsample_latents_jit.lower(
        pipe.upscaler_params, jnp.zeros(s1.shape, jnp.float32),
        mean, std, ucfg).as_text()
    assert warm == real


def _real_av_step_text(pipe, cfg, guidance, width=None, height=None,
                       cond_frames=None, video_euler="scheduler"):
    from ltx_jax.models import dit_av

    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, height or cfg.height, width or cfg.width,
        channels=pipe.tcfg.in_channels)
    audio_frames = dit_av.audio_frame_count(cfg.num_frames / cfg.fps)
    pos = pipe.encode_prompt("a cat")
    v_ctx, bias = build_guidance_context(guidance, pos["video"],
                                         pos["mask"])
    a_ctx, _ = build_guidance_context(guidance, pos["audio"], pos["mask"])
    cm = cond = None
    if cond_frames is not None:
        cm = pipe._conditioning_mask(shape, frames=cond_frames)
        if cfg.image_cond_noise_scale > 0:
            cond = jnp.zeros((1, pipe.tcfg.in_channels, cond_frames,
                              shape.height, shape.width), jnp.float32)
    step = make_av_denoise_step(
        pipe.av_transformer_params, pipe.tcfg, guidance, shape,
        audio_frames, v_ctx, a_ctx, bias,
        conditioning_mask=cm, conditioned_latent=cond,
        image_cond_noise_scale=cfg.image_cond_noise_scale,
        cond_frames=(cond_frames or 1), fps=cfg.fps,
        sdpa_impl=pipe.sdpa_impl, video_euler=video_euler)
    video = jnp.zeros(shape.shape, jnp.float32)
    audio = jnp.zeros((1, audio_frames, pipe.tcfg.audio_in_channels),
                      jnp.float32)
    args = [pipe.av_transformer_params, v_ctx, a_ctx, bias, step._ropes,
            video, audio, 0.9, 0.5, jax.random.key(0)]
    if cond is not None:
        args.append(cond)
    return step._jit.lower(*args).as_text()


def test_warm_av_lowering_matches_real(pipe_av):
    cfg = _cfg()
    guidance = dataclasses.replace(
        GuidanceSpec.from_config(cfg), stg_scale=0.0)
    warm = pipe_av._warm_av_lowering(cfg, guidance).as_text()
    real = _real_av_step_text(pipe_av, cfg, guidance)
    assert warm == real


def test_warm_av_lowering_stage2_plain_euler(pipe_av):
    """The AV two-stage's stage 2 steps video with PLAIN Euler — a
    different program from stage 1's scheduler step."""
    cfg = _cfg(width=128, height=128)
    guidance = dataclasses.replace(
        GuidanceSpec.from_config(cfg, use_cfg=False), stg_scale=0.0)
    warm_s1 = pipe_av._warm_av_lowering(
        cfg, guidance, width=cfg.width // 2,
        height=cfg.height // 2).as_text()
    warm_s2 = pipe_av._warm_av_lowering(
        cfg, guidance, video_euler="plain").as_text()
    assert warm_s1 != warm_s2
    real_s1 = _real_av_step_text(pipe_av, cfg, guidance,
                                 width=cfg.width // 2,
                                 height=cfg.height // 2)
    real_s2 = _real_av_step_text(pipe_av, cfg, guidance,
                                 video_euler="plain")
    assert warm_s1 == real_s1
    assert warm_s2 == real_s2


def test_warm_av_cond_lowering_matches_real(pipe_av):
    cfg = _cfg(num_frames=17, image_cond_noise_scale=0.15)
    guidance = dataclasses.replace(
        GuidanceSpec.from_config(cfg), stg_scale=0.0)
    warm = pipe_av._warm_av_lowering(cfg, guidance,
                                     cond_frames=2).as_text()
    real = _real_av_step_text(pipe_av, cfg, guidance, cond_frames=2)
    assert warm == real


# ---------------------------------------------------------------------------
# Entry-point wiring: each path must request ITS program set
# ---------------------------------------------------------------------------

def _capture_plans(pipe, monkeypatch):
    plans = []

    def spy(config, guidance, timings=None, plan=None):
        if plan is None:
            plan = [("denoise", None), ("vae", None)]
        plans.append([n for n, _ in plan])
        return _WarmCompiles(timings)

    monkeypatch.setattr(pipe, "_start_warm_compile", spy)
    monkeypatch.setattr(pipe, "_should_warm", lambda cfg: True)
    return plans


def test_two_stage_warm_plan(pipe, monkeypatch):
    plans = _capture_plans(pipe, monkeypatch)
    pipe.generate_video_two_stage("a cat", _cfg(width=128, height=128))
    assert plans == [["denoise_s1", "upscaler", "denoise_s2", "vae"]]


def test_chain_warm_plan(pipe, monkeypatch):
    plans = _capture_plans(pipe, monkeypatch)
    pipe.generate_video_chain("a cat", _cfg(num_frames=17), segments=2,
                              cond_frames=9)
    assert plans == [["denoise", "denoise_ext", "vae"]]


def test_extension_warm_plan(pipe, monkeypatch):
    plans = _capture_plans(pipe, monkeypatch)
    frames = np.zeros((1, 3, 9, 64, 64), np.float32)
    pipe.generate_video_extension("a cat", _cfg(num_frames=17),
                                  video_frames=frames, cond_frames=9)
    assert plans == [["denoise", "vae"]]


def test_av_two_stage_warm_plan(pipe_av, monkeypatch):
    plans = _capture_plans(pipe_av, monkeypatch)
    pipe_av.generate_video_with_audio_two_stage(
        "a cat", _cfg(width=128, height=128))
    assert plans == [["denoise_s1", "upscaler", "denoise_s2", "vae"]]


def test_warm_threads_compile_and_join(pipe):
    """The background-thread machinery end-to-end on CPU: both programs
    compile off-thread, joins block, timings record the overlap window,
    and a failing thunk only logs."""
    cfg = _cfg()
    guidance = GuidanceSpec.from_config(cfg)
    timings = GenerationTimings()
    warm = pipe._start_warm_compile(cfg, guidance, timings)
    warm.join("denoise")
    warm.join()          # remaining (vae) + repeat joins no-op
    warm.join("denoise")
    assert timings.warm_compile > 0

    # failure path: never raises out of join
    bad = _WarmCompiles()
    bad.add("boom", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    bad.join()

    # empty handle: all joins no-op (un-warmed entry points share the
    # call sites)
    _WarmCompiles().join("anything")
