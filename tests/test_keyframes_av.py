"""Round 5: AV keyframe anchoring + per-segment chain anchors.

VERDICT r4 #4: cond_frame_idx existed only in make_denoise_step — AV
generation could not anchor arbitrary frames, and chains could not take
mid-chain anchors to fight autoregressive drift. Now:
  * make_av_denoise_step grows the cond_frame_idx scatter + frame-mask
    Euler (pipeline/denoise.py), mirroring the video path;
  * generate_video_keyframes(audio=True) runs the dual AV transformer
    (AV I2V bit-for-bit at keyframes=[(0, lat)]);
  * generate_video_chain(anchors={seg: [(pix_idx, src), ...]}) pins
    segments to reference images (segment 0: == generate_video_keyframes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.ops.latents import VideoLatentShape
from ltx_jax.pipeline import generate as gen_mod
from ltx_jax.pipeline.denoise import (
    GuidanceSpec,
    build_guidance_context,
    make_av_denoise_step,
)
from ltx_jax.pipeline.generate import LTXPipeline


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=25, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


@pytest.fixture(scope="module")
def pipe_av():
    p = LTXPipeline.random_tiny(seed=0, include_audio=True)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def _img(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(1, 3, 1, 64, 64)).astype(np.float32)


def test_av_keyframe_zero_is_av_i2v(pipe_av):
    """keyframes=[(0, latent)] with audio=True IS AV I2V: bit-for-bit
    equal frames AND waveform (same key derivation; scatter/where vs
    slice/concat are elementwise-identical)."""
    lat = pipe_av.encode_image(jnp.asarray(_img(1)))
    cfg = _cfg()
    i2v = pipe_av.generate_video_with_audio("a fox at dawn", cfg,
                                            image_latent=lat)
    kf = pipe_av.generate_video_keyframes("a fox at dawn", cfg,
                                          [(0, np.asarray(lat))],
                                          audio=True)
    np.testing.assert_array_equal(np.asarray(kf.frames),
                                  np.asarray(i2v.frames))
    np.testing.assert_array_equal(np.asarray(kf.audio),
                                  np.asarray(i2v.audio))


def test_av_keyframe_interpolation(pipe_av):
    """First+last anchors through the AV path: finite frames, a waveform
    of the right duration, and the conditioned latent frames pinned."""
    cfg = _cfg(image_cond_noise_scale=0.15)
    r = pipe_av.generate_video_keyframes(
        "between two moments", cfg, [(24, _img(3)), (0, _img(2))],
        audio=True)
    f = np.asarray(r.frames)
    assert f.shape == (25, 64, 64, 3) and np.isfinite(f).all()
    assert r.audio is not None
    wav = np.asarray(r.audio)
    assert wav.ndim == 2 and wav.shape[0] == 2 and np.isfinite(wav).all()


def test_av_step_injects_and_carries_at_arbitrary_positions(pipe_av):
    """The AV denoise-step pin (the dual twin of the video-path test):
    conditioned VIDEO frames at {0, 2} equal clean + scale * normal *
    sigma^2 after every step; unconditioned frames and AUDIO still step."""
    cfg = _cfg(num_frames=33)  # 5 latent frames
    from ltx_jax.models import dit_av

    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height, cfg.width,
        channels=pipe_av.tcfg.in_channels)
    audio_frames = dit_av.audio_frame_count(cfg.num_frames / cfg.fps)
    mel = pipe_av.tcfg.audio_in_channels // 8
    idx = np.array([0, 2])
    cond = jax.random.normal(
        jax.random.key(7),
        (1, shape.channels, 2, shape.height, shape.width), jnp.float32)
    cm = pipe_av._conditioning_mask(shape, frame_idx=idx)

    emb = pipe_av.encode_prompt("a fox")
    guidance = dataclasses.replace(GuidanceSpec.from_config(cfg),
                                   stg_scale=0.0)
    v_ctx, bias = build_guidance_context(guidance, emb["video"],
                                         emb["mask"])
    a_ctx, _ = build_guidance_context(guidance, emb["audio"], emb["mask"])
    scale = 0.4
    step = make_av_denoise_step(
        pipe_av.av_transformer_params, pipe_av.tcfg, guidance, shape,
        audio_frames, v_ctx, a_ctx, bias,
        conditioning_mask=cm, conditioned_latent=cond,
        image_cond_noise_scale=scale, cond_frame_idx=idx)

    video = jax.random.normal(jax.random.key(3), shape.shape, jnp.float32)
    video = video.at[:, :, idx].set(cond)
    audio = dit_av.pack_audio_latents(jax.random.normal(
        jax.random.key(5), (1, 8, audio_frames, mel), jnp.float32))
    frame1_before = np.asarray(video[:, :, 1])
    audio_before = np.asarray(audio)
    k1, k2 = jax.random.key(11), jax.random.key(12)

    v1, a1 = step(video, audio, 0.9, 0.7, k1)
    want1 = cond + scale * jax.random.normal(k1, cond.shape,
                                             cond.dtype) * 0.9 ** 2
    np.testing.assert_allclose(np.asarray(v1[:, :, idx]),
                               np.asarray(want1), atol=1e-6)
    assert not np.allclose(np.asarray(v1[:, :, 1]), frame1_before)
    assert not np.allclose(np.asarray(a1), audio_before)  # audio steps

    v2, a2 = step(v1, a1, 0.7, 0.4, k2)
    want2 = cond + scale * jax.random.normal(k2, cond.shape,
                                             cond.dtype) * 0.7 ** 2
    # only step 2's injection — no accumulation
    np.testing.assert_allclose(np.asarray(v2[:, :, idx]),
                               np.asarray(want2), atol=1e-6)


def test_av_step_cond_frame_idx_validation(pipe_av):
    from ltx_jax.models import dit_av

    cfg = _cfg()
    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height, cfg.width,
        channels=pipe_av.tcfg.in_channels)
    audio_frames = dit_av.audio_frame_count(cfg.num_frames / cfg.fps)
    emb = pipe_av.encode_prompt("x")
    guidance = dataclasses.replace(GuidanceSpec.from_config(cfg),
                                   stg_scale=0.0)
    v_ctx, bias = build_guidance_context(guidance, emb["video"],
                                         emb["mask"])
    a_ctx, _ = build_guidance_context(guidance, emb["audio"], emb["mask"])
    cm = pipe_av._conditioning_mask(shape, frame_idx=[0])

    def build(**kw):
        return make_av_denoise_step(
            pipe_av.av_transformer_params, pipe_av.tcfg, guidance, shape,
            audio_frames, v_ctx, a_ctx, bias, **kw)

    with pytest.raises(InvalidConfigurationError):  # idx without mask
        build(cond_frame_idx=[0])
    with pytest.raises(InvalidConfigurationError):  # not increasing
        build(conditioning_mask=cm, cond_frame_idx=[2, 1])
    with pytest.raises(InvalidConfigurationError):  # out of range
        build(conditioning_mask=cm, cond_frame_idx=[99])


# ---------------------------------------------------------------------------
# Chain anchors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def test_chain_anchor_segment0_is_keyframes(pipe):
    """anchors={0: kfs} with segments=1 reproduces
    generate_video_keyframes bit-for-bit (same key derivation and ops
    order)."""
    cfg = _cfg(num_frames=17, image_cond_noise_scale=0.15)
    kfs = [(0, _img(4)), (16, _img(5))]
    ref = pipe.generate_video_keyframes("a bridge", cfg, kfs)
    chain = pipe.generate_video_chain("a bridge", cfg, segments=1,
                                      anchors={0: kfs})
    np.testing.assert_array_equal(np.asarray(chain.frames),
                                  np.asarray(ref.frames))


def test_chain_mid_anchor(pipe):
    """A mid-chain anchor conditions segment 1 on the carried tail PLUS
    the anchor frame: the _denoise call must see cond_frame_idx
    [0..k_lat-1] + anchor, and the conditioned latent must be the tail
    concatenated with the anchor's encoded latent."""
    cfg = _cfg(num_frames=17, image_cond_noise_scale=0.15)
    anchor = _img(6)
    seen = []
    orig = pipe._denoise

    def spy(latent, sigmas, shape, guidance, context, bias, cm, scale, fps,
            key, timings, on_progress, conditioned_latent=None,
            cond_frames=1, cond_frame_idx=None):
        seen.append(dict(idx=cond_frame_idx,
                         cond=(None if conditioned_latent is None
                               else np.asarray(conditioned_latent))))
        return orig(latent, sigmas, shape, guidance, context, bias, cm,
                    scale, fps, key, timings, on_progress,
                    conditioned_latent=conditioned_latent,
                    cond_frames=cond_frames, cond_frame_idx=cond_frame_idx)

    pipe._denoise = spy
    try:
        r = pipe.generate_video_chain(
            "a road trip", cfg, segments=2, cond_frames=9,
            anchors={1: [(16, anchor)]})  # latent idx 2 >= k_lat 2
    finally:
        pipe._denoise = orig

    f = np.asarray(r.frames)
    assert f.shape == (17 + (17 - 9), 64, 64, 3)
    assert np.isfinite(f.astype(np.float32)).all()
    # segment 0 plain, segment 1 anchored (tail idx 0,1 + anchor idx 2)
    assert len(seen) == 2
    assert seen[0]["idx"] is None
    np.testing.assert_array_equal(seen[1]["idx"], [0, 1, 2])
    a_lat = np.asarray(pipe.encode_image(jnp.asarray(anchor))
                       .astype(jnp.float32))
    assert seen[1]["cond"].shape[2] == 3
    np.testing.assert_allclose(seen[1]["cond"][:, :, 2], a_lat[:, :, 0],
                               atol=1e-6)


def test_serve_anchor_and_av_keyframe_validation():
    """Submit-time validation for the new request surface: chain 'anchors'
    (segment range, tail overlap, audio exclusion, keyframe rules) and
    keyframes+audio."""
    from ltx_jax.serve.app import request_to_config

    base = {"kind": "chain", "prompt": "x", "segments": 2,
            "cond_frames": 9, "width": 64, "height": 64, "num_frames": 17,
            "num_steps": 2}
    a = [{"frame": 16, "image_path": "a.png"}]
    request_to_config({**base, "anchors": {"1": a}})       # valid
    request_to_config({**base, "anchors": {"0": [{"frame": 0,
                                                  "image_path": "a.png"}]}})
    request_to_config({**base, "anchors": {"1": a},
                       "audio": True})                     # AV chain anchors
    kf_base = {"kind": "keyframes", "prompt": "x", "width": 64,
               "height": 64, "num_frames": 17, "num_steps": 2,
               "keyframes": [{"frame": 0, "image_path": "a.png"}]}
    request_to_config(kf_base)
    request_to_config({**kf_base, "audio": True})          # AV keyframes

    for bad in (
        {**base, "anchors": {"5": a}},                     # seg range
        {**base, "anchors": {"x": a}},                     # non-int seg
        {**base, "anchors": {"1": [{"frame": 0,            # tail overlap
                                    "image_path": "a.png"}]}},
        {**base, "anchors": {"1": []}},                    # empty list
        {**base, "anchors": {"1": [{"frame": 3,            # unaligned
                                    "image_path": "a.png"}]}},
        {**base, "anchors": []},                           # not a dict
        {**base, "audio_cond": True},                      # needs audio
    ):
        with pytest.raises(ValueError):
            request_to_config(bad)


def test_cli_chain_anchor_and_av_keyframes(tmp_path, monkeypatch):
    """--chain-anchor SEG:IDX:PATH and --keyframe ... --audio dispatch
    through cmd_generate; malformed specs exit 2."""
    from PIL import Image

    from ltx_jax.io import cli
    from ltx_jax.pipeline import loader

    rng = np.random.default_rng(9)
    img = tmp_path / "a.png"
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8),
                    "RGB").save(img)

    monkeypatch.setattr(
        loader, "load_pipeline",
        lambda **kw: LTXPipeline.random_tiny(seed=0, include_audio=True))
    out = tmp_path / "out.mp4"
    rc = cli.main([
        "generate", "a drive", "--chain", "2", "--chain-anchor",
        f"1:16:{img}", "-w", "64", "-H", "64", "-f", "17", "--steps", "2",
        "--seed", "3", "-o", str(out)])
    assert rc == 0 and out.exists() and out.stat().st_size > 0

    rc = cli.main([
        "generate", "x", "--chain", "2", "--chain-anchor", "badspec",
        "-w", "64", "-H", "64", "-f", "17", "-o", str(tmp_path / "y.mp4")])
    assert rc == 2

    out_avc = tmp_path / "avchain.mp4"
    rc = cli.main([  # anchors compose with the AV chain (round 5)
        "generate", "anchored song", "--chain", "2", "--audio",
        "--chain-anchor", f"1:16:{img}", "-w", "64", "-H", "64",
        "-f", "17", "--steps", "2", "--seed", "3", "-o", str(out_avc)])
    assert rc == 0 and out_avc.exists() and out_avc.stat().st_size > 0

    out_av = tmp_path / "av.mp4"
    rc = cli.main([
        "generate", "anchored with sound", "--keyframe", f"0:{img}",
        "--audio", "-w", "64", "-H", "64", "-f", "17", "--steps", "2",
        "--seed", "3", "-o", str(out_av)])
    assert rc == 0 and out_av.exists() and out_av.stat().st_size > 0


def test_av_chain_anchor(pipe_av):
    """AV chain per-segment anchors (round 5 symmetry): the anchored
    segment builds its own AV step with cond_frame_idx = tail + anchor
    indices; output finite with the stitched length; waveform present."""
    import ltx_jax.pipeline.denoise as dn

    cfg = _cfg(num_frames=17, image_cond_noise_scale=0.15)
    calls = []
    orig = dn.make_av_denoise_step

    def spy(*a, **kw):
        calls.append(kw.get("cond_frame_idx"))
        return orig(*a, **kw)

    dn.make_av_denoise_step = spy
    try:
        r = pipe_av.generate_video_chain_with_audio(
            "an anchored song", cfg, segments=2, cond_frames=9,
            anchors={1: [(16, _img(7))]}, audio_cond=True)
    finally:
        dn.make_av_denoise_step = orig
    f = np.asarray(r.frames)
    assert f.shape == (17 + (17 - 9), 64, 64, 3)
    assert np.isfinite(f.astype(np.float32)).all()
    assert np.isfinite(np.asarray(r.audio)).all()
    # base step (no idx) + anchored extension (tail 0,1 + anchor 2)
    assert len(calls) == 2 and calls[0] is None
    np.testing.assert_array_equal(np.asarray(calls[1]), [0, 1, 2])


def test_cli_chain_flag_guards(tmp_path, monkeypatch):
    """Chain-only flags must fail loudly without --chain (self-review r5):
    silently producing an unanchored/unrenormed T2V was the same defect
    class as the --chain 0 fallthrough."""
    from ltx_jax.io import cli
    from ltx_jax.pipeline import loader

    monkeypatch.setattr(loader, "load_pipeline",
                        lambda **kw: LTXPipeline.random_tiny(seed=0))
    base = ["-w", "64", "-H", "64", "-f", "17",
            "-o", str(tmp_path / "x.mp4")]
    for extra in (
        ["--chain-anchor", "1:16:a.png"],
        ["--chain-tail-renorm", "0.5"],
        ["--chain", "2", "--chain-audio-cond"],          # needs --audio
        ["--chain-audio-cond", "--audio"],               # needs --chain
    ):
        assert cli.main(["generate", "p", *extra, *base]) == 2, extra


def test_chain_anchor_validation(pipe):
    cfg = _cfg(num_frames=17)
    img = _img()
    with pytest.raises(InvalidConfigurationError):  # segment out of range
        pipe.generate_video_chain("x", cfg, segments=2,
                                  anchors={5: [(0, img)]})
    with pytest.raises(InvalidConfigurationError):  # overlaps carried tail
        pipe.generate_video_chain("x", cfg, segments=2, cond_frames=9,
                                  anchors={1: [(0, img)]})
    with pytest.raises(InvalidConfigurationError):  # unaligned index
        pipe.generate_video_chain("x", cfg, segments=2,
                                  anchors={0: [(3, img)]})
