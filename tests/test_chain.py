"""CHAINED long-video generation (autoregressive latent-carry).

generate_video_chain extends past the single-clip budget by conditioning
each segment on the previous segment's tail — in LATENT space (no VAE
decode->re-encode round trip, so no reconstruction drift accumulates), with
all denoises before all decodes (one DiT staging for the whole chain) and
ONE compiled extension-step program shared by every segment >= 1 (context
and the conditioned tail are call-time jit arguments). No reference analog
(the Swift pipeline generates one clip per call, LTXPipeline.swift:586).
"""

import dataclasses

import jax
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.pipeline import generate as gen_mod
from ltx_jax.pipeline.generate import GenerationTimings, LTXPipeline


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=17, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def test_chain_segment_zero_is_generate_video(pipe):
    """segments=1 IS generate_video (same seed derivation), and with
    segments=2 the first num_frames frames still reproduce it bit-for-bit
    (segment 0's denoise AND decode keys are unchanged by the chain)."""
    cfg = _cfg()
    t2v = pipe.generate_video("a tide pool at dusk", cfg)
    one = pipe.generate_video_chain("a tide pool at dusk", cfg, segments=1)
    np.testing.assert_array_equal(np.asarray(one.frames),
                                  np.asarray(t2v.frames))

    two = pipe.generate_video_chain("a tide pool at dusk", cfg,
                                    segments=2, cond_frames=9)
    f = np.asarray(two.frames)
    assert f.shape == (17 + (17 - 9), 64, 64, 3)
    assert np.isfinite(f.astype(np.float32)).all()
    np.testing.assert_array_equal(f[:17], np.asarray(t2v.frames))


def test_chain_shares_one_extension_program(pipe):
    """Segments >= 1 must reuse ONE make_denoise_step build (context/tail
    rebind on the same jitted program) — a 10-segment chain on real
    hardware would otherwise pay ~10 remote compiles."""
    calls = []
    orig = gen_mod.make_denoise_step

    def spy(*a, **kw):
        calls.append(kw.get("conditioned_latent"))
        return orig(*a, **kw)

    gen_mod.make_denoise_step = spy
    try:
        r = pipe.generate_video_chain("a fox", _cfg(), segments=3,
                                      cond_frames=9)
    finally:
        gen_mod.make_denoise_step = orig
    # one build from segment 0's _denoise, one for ALL extension segments
    assert len(calls) == 2
    f = np.asarray(r.frames)
    assert f.shape == (17 + 2 * (17 - 9), 64, 64, 3)


def test_chain_rebind_matches_canonical_denoise(pipe):
    """THE REBIND PIN: segment 2 runs through ext_step._jit with rebound
    (context, tail) arguments; recomputing it through the canonical
    _denoise path (a fresh make_denoise_step) from the captured segment-1
    tail must give the same latent."""
    cfg = _cfg(image_cond_noise_scale=0.15)
    seen = []
    orig_loop = gen_mod.run_denoise_loop

    def spy(step, latent, sigmas, **kw):
        out = orig_loop(step, latent, sigmas, **kw)
        seen.append((np.asarray(latent), np.asarray(out)))
        return out

    gen_mod.run_denoise_loop = spy
    try:
        pipe.generate_video_chain("a red kite", cfg, segments=3,
                                  cond_frames=9)
    finally:
        gen_mod.run_denoise_loop = orig_loop
    assert len(seen) == 3
    k_lat = 2  # (9 - 1) // 8 + 1

    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.pipeline.denoise import build_guidance_context
    from ltx_jax.pipeline.generate import GuidanceSpec

    shape = VideoLatentShape.from_pixels(1, 17, 64, 64,
                                         channels=pipe.tcfg.in_channels)
    guidance = GuidanceSpec.from_config(cfg)
    emb = pipe.encode_prompt("a red kite")
    context, bias = build_guidance_context(guidance, emb["video"],
                                           emb["mask"])
    tail = seen[1][1][:, :, -k_lat:].astype(np.float32)
    cm = pipe._conditioning_mask(shape, frames=k_lat)
    key = jax.random.key(cfg.seed + 2)
    key, nkey = jax.random.split(key)
    key, dkey = jax.random.split(key)

    init = seen[2][0]  # chain's segment-2 initial latent (noise + tail)
    np.testing.assert_allclose(init[:, :, :k_lat], tail, atol=1e-6)
    want = pipe._denoise(
        jax.numpy.asarray(init), pipe._sigmas(cfg, shape), shape,
        guidance, context, bias, cm, cfg.image_cond_noise_scale, cfg.fps,
        dkey, GenerationTimings(), None,
        conditioned_latent=jax.numpy.asarray(tail), cond_frames=k_lat)
    np.testing.assert_allclose(seen[2][1], np.asarray(want), atol=1e-5)


def test_chain_per_segment_prompts(pipe):
    r = pipe.generate_video_chain(
        "dawn", _cfg(), segments=3, cond_frames=9,
        prompts=["dawn", "noon", "dusk"])
    f = np.asarray(r.frames)
    assert f.shape == (17 + 2 * (17 - 9), 64, 64, 3)
    assert np.isfinite(f.astype(np.float32)).all()


def test_chain_precomputed_embeddings(pipe):
    """The parity-injection hook: injecting encode_prompt's own output
    reproduces the encoded path bit-for-bit; varied per-segment prompts
    are rejected with one embedding set."""
    cfg = _cfg()
    emb = pipe.encode_prompt("a river")
    ref = pipe.generate_video_chain("a river", cfg, segments=2,
                                    cond_frames=9)
    inj = pipe.generate_video_chain(
        "ignored", cfg, segments=2, cond_frames=9,
        precomputed_embeddings={"video": emb["video"],
                                "mask": emb["mask"]})
    np.testing.assert_array_equal(np.asarray(ref.frames),
                                  np.asarray(inj.frames))
    with pytest.raises(InvalidConfigurationError):
        pipe.generate_video_chain(
            "x", cfg, segments=2, prompts=["a", "b"],
            precomputed_embeddings={"video": emb["video"],
                                    "mask": emb["mask"]})


def test_chain_tail_renorm_mechanism(pipe):
    """The drift-mitigation knob (round 5): with tail_renorm=1.0 the tail
    conditioning segment 1 must carry segment 0's tail per-channel
    mean/std EXACTLY (AdaIN re-anchors the statistics; content structure
    untouched — same tail up to an affine per-channel map)."""
    cfg = _cfg()
    seen = []
    orig_loop = gen_mod.run_denoise_loop

    def spy(step, latent, sigmas, **kw):
        out = orig_loop(step, latent, sigmas, **kw)
        seen.append((np.asarray(latent), np.asarray(out)))
        return out

    gen_mod.run_denoise_loop = spy
    try:
        pipe.generate_video_chain("a dune sea", cfg, segments=2,
                                  cond_frames=9, tail_renorm=1.0)
    finally:
        gen_mod.run_denoise_loop = orig_loop
    assert len(seen) == 2
    k_lat = 2  # (9 - 1) // 8 + 1
    tail0 = seen[0][1][:, :, -k_lat:]
    carried = seen[1][0][:, :, :k_lat]
    ax = (2, 3, 4)
    np.testing.assert_allclose(carried.mean(axis=ax), tail0.mean(axis=ax),
                               atol=1e-4)
    np.testing.assert_allclose(carried.std(axis=ax), tail0.std(axis=ax),
                               atol=1e-4)
    # affine per-channel only: correlation with the raw tail stays 1
    raw = seen[0][1][:, :, -k_lat:]
    for c in range(raw.shape[1]):
        a, b = raw[0, c].ravel(), carried[0, c].ravel()
        r = np.corrcoef(a, b)[0, 1]
        assert r > 0.9999, f"channel {c} correlation {r}"


def test_chain_validation(pipe):
    with pytest.raises(InvalidConfigurationError):
        pipe.generate_video_chain("x", _cfg(), segments=0)
    with pytest.raises(InvalidConfigurationError):  # not 8k+1
        pipe.generate_video_chain("x", _cfg(), segments=2, cond_frames=8)
    with pytest.raises(InvalidConfigurationError):  # >= num_frames
        pipe.generate_video_chain("x", _cfg(), segments=2, cond_frames=17)
    with pytest.raises(InvalidConfigurationError):  # prompts len mismatch
        pipe.generate_video_chain("x", _cfg(), segments=2,
                                  prompts=["a", "b", "c"])


@pytest.fixture(scope="module")
def pipe_av():
    p = LTXPipeline.random_tiny(seed=0, include_audio=True)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def test_av_chain_segment_zero_is_av_generate(pipe_av):
    """AV chain with segments=1 reproduces generate_video_with_audio
    bit-for-bit (frames AND waveform — same per-segment derivation)."""
    cfg = _cfg()
    base = pipe_av.generate_video_with_audio("a brass band", cfg)
    one = pipe_av.generate_video_chain_with_audio("a brass band", cfg,
                                                  segments=1)
    np.testing.assert_array_equal(np.asarray(one.frames),
                                  np.asarray(base.frames))
    np.testing.assert_array_equal(np.asarray(one.audio),
                                  np.asarray(base.audio))


def test_av_chain_stitch_and_program_reuse(pipe_av):
    """3 AV segments: video trims the overlap, audio crossfades over the
    same window, and ALL extension segments share one step build (base +
    ext = exactly 2 make_av_denoise_step calls)."""
    import ltx_jax.pipeline.denoise as dn

    calls = []
    orig = dn.make_av_denoise_step

    def spy(*a, **kw):
        calls.append(kw.get("cond_frames"))
        return orig(*a, **kw)

    dn.make_av_denoise_step = spy
    try:
        r = pipe_av.generate_video_chain_with_audio(
            "a storm rolls in", _cfg(), segments=3, cond_frames=9)
    finally:
        dn.make_av_denoise_step = orig
    assert len(calls) == 2  # base T2V+audio step, ONE extension step
    f = np.asarray(r.frames)
    assert f.shape == (17 + 2 * (17 - 9), 64, 64, 3)
    assert np.isfinite(f.astype(np.float32)).all()

    a = np.asarray(r.audio)
    base = pipe_av.generate_video_with_audio("a storm rolls in", _cfg())
    s = np.asarray(base.audio).shape[-1]
    k = int(round(s * 9 / 17))
    assert a.shape[-1] == 3 * s - 2 * k
    assert np.isfinite(a).all()


def test_av_chain_audio_cond(pipe_av):
    """audio_cond=True (round 5): the extension step is built with
    audio_cond_frames = the overlap window's audio latent frames, and the
    result is finite with the standard stitched length."""
    import ltx_jax.pipeline.denoise as dn

    cfg = _cfg(image_cond_noise_scale=0.15)
    calls = []
    orig = dn.make_av_denoise_step

    def spy(*a, **kw):
        calls.append((kw.get("cond_frames"), kw.get("audio_cond_frames")))
        return orig(*a, **kw)

    dn.make_av_denoise_step = spy
    try:
        r = pipe_av.generate_video_chain_with_audio(
            "a river", cfg, segments=2, cond_frames=9, audio_cond=True)
    finally:
        dn.make_av_denoise_step = orig
    # base step (no audio cond) + ONE extension step with k_a > 0
    assert len(calls) == 2
    assert (calls[1][0], bool(calls[1][1])) == (2, True)
    f = np.asarray(r.frames)
    assert f.shape == (17 + (17 - 9), 64, 64, 3)
    assert np.isfinite(f.astype(np.float32)).all()
    assert np.isfinite(np.asarray(r.audio)).all()


def test_av_step_audio_conditioning_mechanism(pipe_av):
    """The audio cond_frames path in make_av_denoise_step: conditioned
    AUDIO frames equal clean + scale * normal(fold_in(key, 1)) * sigma^2
    after every step (fresh clean-source injection, keyed separately from
    the video draw), carry through Euler, and unconditioned audio frames
    still step."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from ltx_jax.models import dit_av
    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.pipeline.denoise import (
        GuidanceSpec, build_guidance_context, make_av_denoise_step,
    )

    cfg = _cfg()
    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height, cfg.width,
        channels=pipe_av.tcfg.in_channels)
    audio_frames = dit_av.audio_frame_count(cfg.num_frames / cfg.fps)
    mel = pipe_av.tcfg.audio_in_channels // 8
    k_lat, k_a, scale = 2, 4, 0.4

    emb = pipe_av.encode_prompt("a river")
    guidance = dc.replace(GuidanceSpec.from_config(cfg), stg_scale=0.0)
    v_ctx, bias = build_guidance_context(guidance, emb["video"],
                                         emb["mask"])
    a_ctx, _ = build_guidance_context(guidance, emb["audio"], emb["mask"])
    cm = pipe_av._conditioning_mask(shape, frames=k_lat)
    v_cond = jax.random.normal(
        jax.random.key(7),
        (1, shape.channels, k_lat, shape.height, shape.width), jnp.float32)
    a_cond = jax.random.normal(
        jax.random.key(8), (1, k_a, pipe_av.tcfg.audio_in_channels),
        jnp.float32)

    step = make_av_denoise_step(
        pipe_av.av_transformer_params, pipe_av.tcfg, guidance, shape,
        audio_frames, v_ctx, a_ctx, bias,
        conditioning_mask=cm, conditioned_latent=v_cond,
        image_cond_noise_scale=scale, cond_frames=k_lat,
        audio_cond_frames=k_a, audio_conditioned_latent=a_cond)

    video = jax.random.normal(jax.random.key(3), shape.shape, jnp.float32)
    audio = dit_av.pack_audio_latents(jax.random.normal(
        jax.random.key(5), (1, 8, audio_frames, mel), jnp.float32))
    tail_before = np.asarray(audio[:, k_a:])
    k1 = jax.random.key(11)

    v1, a1 = step(video, audio, 0.9, 0.7, k1)
    want = a_cond + scale * jax.random.normal(
        jax.random.fold_in(k1, 1), a_cond.shape, a_cond.dtype) * 0.9 ** 2
    np.testing.assert_allclose(np.asarray(a1[:, :k_a]), np.asarray(want),
                               atol=1e-6)
    assert not np.allclose(np.asarray(a1[:, k_a:]), tail_before)

    k2 = jax.random.key(12)
    v2, a2 = step(v1, a1, 0.7, 0.4, k2)
    want2 = a_cond + scale * jax.random.normal(
        jax.random.fold_in(k2, 1), a_cond.shape, a_cond.dtype) * 0.7 ** 2
    # only step 2's injection — no accumulation
    np.testing.assert_allclose(np.asarray(a2[:, :k_a]), np.asarray(want2),
                               atol=1e-6)


def test_cmd_generate_chain_audio_dispatch(tmp_path, monkeypatch):
    """`generate --chain 2 --audio` routes through the AV chain and
    writes MP4 + side WAV."""
    from ltx_jax.io import cli
    from ltx_jax.pipeline import loader

    monkeypatch.setattr(
        loader, "load_pipeline",
        lambda **kw: LTXPipeline.random_tiny(seed=0, include_audio=True))
    out = tmp_path / "out.mp4"
    rc = cli.main([
        "generate", "a road movie", "--chain", "2", "--audio",
        "--cond-frames", "9", "-w", "64", "-H", "64", "-f", "17",
        "--seed", "3", "-o", str(out),
    ])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0
    assert (tmp_path / "out.mp4.wav").exists()


def test_serve_chain_job_http(pipe, tmp_path):
    """kind=chain over real HTTP: segment/overlap/prompt validation at
    submit (400, never a failed job); job produces a longer MP4."""
    import json
    import os
    import urllib.error
    import urllib.request

    from ltx_jax.serve.app import build_app
    from ltx_jax.serve.server import serve_forever_threaded

    app = build_app(pipe, output_dir=str(tmp_path / "out"), port=0)
    serve_forever_threaded(app.server)
    host, port = app.server.server_address[:2]
    base = f"http://{host}:{port}"

    def post(body):
        req = urllib.request.Request(
            base + "/v1/generate", json.dumps(body).encode(),
            {"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req).read())

    try:
        body = {"kind": "chain", "prompt": "a long take", "segments": 2,
                "cond_frames": 9, "width": 64, "height": 64,
                "num_frames": 17, "num_steps": 2, "seed": 4}
        job_id = post(body)["job_id"]
        rec = app.jobs.wait(job_id, timeout=600)
        assert rec["state"] == "done", rec
        assert os.path.getsize(rec["result"]["output"]) > 0
        assert rec["result"]["frames"] == 17 + (17 - 9)

        for bad in (
            {**body, "segments": 1},                 # chain means > 1
            {**body, "segments": 99},                # device-time cap
            {**body, "cond_frames": 8},              # not 8k+1
            {**body, "cond_frames": 17},             # >= num_frames
            {**body, "prompts": ["only-one"]},       # len != segments
        ):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(bad)
            assert ei.value.code == 400
    finally:
        app.close()


def test_cmd_generate_chain_dispatch(tmp_path, monkeypatch):
    """`generate --chain 2` end-to-end through cmd_generate."""
    from ltx_jax.io import cli
    from ltx_jax.pipeline import loader

    monkeypatch.setattr(loader, "load_pipeline",
                        lambda **kw: LTXPipeline.random_tiny(seed=0))
    out = tmp_path / "out.mp4"
    rc = cli.main([
        "generate", "an ever-longer story", "--chain", "2",
        "--chain-prompt", "the story continues",
        "--cond-frames", "9", "-w", "64", "-H", "64", "-f", "17",
        "--seed", "3", "-o", str(out),
    ])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0

    # composition guard + chain-prompt count check exit loudly
    assert cli.main([
        "generate", "x", "--chain", "2", "--two-stage",
        "-w", "64", "-H", "64", "-f", "17", "-o", str(out),
    ]) == 2
    assert cli.main([
        "generate", "x", "--chain", "3", "--chain-prompt", "y",
        "-w", "64", "-H", "64", "-f", "17", "-o", str(out),
    ]) == 2
    assert cli.main([  # --chain-prompt without --chain is loud, not silent
        "generate", "x", "--chain-prompt", "y",
        "-w", "64", "-H", "64", "-f", "17", "-o", str(out),
    ]) == 2
