"""Video extension (multi-frame conditioning) + the clean-source injection
fix.

generate_video_extension conditions on the last cond_frames pixel frames of
an input clip (encoded to k latent frames) and generates the continuation —
the multi-frame generalization of I2V (no reference analog; the Swift
pipeline conditions on a single image only). The same change fixed an I2V
parity bug: conditioned frames must be re-noised each step FROM THE CLEAN
conditioned latent (reference: LTXPipeline.swift:2224-2229 uses condLatent),
not from the carried latent — the old code accumulated injection noise
across steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.ops.latents import VideoLatentShape, generate_noise
from ltx_jax.pipeline.denoise import build_guidance_context, make_denoise_step
from ltx_jax.pipeline.generate import GuidanceSpec, LTXPipeline


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=17, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def _clip(frames):
    # smooth synthetic clip in [-1, 1], (1, 3, frames, 64, 64)
    t = np.linspace(-1, 1, frames, dtype=np.float32)
    y = np.linspace(-1, 1, 64, dtype=np.float32)
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    g = (t[:, None, None] * 0.3 + y[None, :, None] * 0.5
         + x[None, None, :] * 0.2)
    return np.stack([g, -g, 0.5 * g], axis=0)[None].astype(np.float32)


def test_injection_source_is_clean_latent(pipe):
    """THE PARITY PIN: each step's conditioned frames must equal
    clean + scale * normal(step_key) * sigma^2 — fresh injection from the
    clean latent (reference: LTXPipeline.swift:2224-2229), NOT cumulative
    noise on the carried frames (the pre-fix behavior)."""
    cfg = _cfg()
    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height, cfg.width,
        channels=pipe.tcfg.in_channels)
    k_lat = 2
    cm = pipe._conditioning_mask(shape, frames=k_lat)
    cond = jax.random.normal(
        jax.random.key(7),
        (1, shape.channels, k_lat, shape.height, shape.width), jnp.float32)

    emb = pipe.encode_prompt("a fox")
    guidance = GuidanceSpec.from_config(cfg)
    context, bias = build_guidance_context(guidance, emb["video"],
                                           emb["mask"])
    scale = 0.5
    step = make_denoise_step(
        pipe.transformer_params, pipe.tcfg, guidance, shape, context, bias,
        conditioning_mask=cm, conditioned_latent=cond,
        image_cond_noise_scale=scale, cond_frames=k_lat)

    latent = generate_noise(jax.random.key(3), shape)
    latent = latent.at[:, :, :k_lat].set(cond)
    vel = jnp.zeros_like(latent)
    k1, k2 = jax.random.key(11), jax.random.key(12)

    l1, vel = step(latent, 0.9, 0.7, vel, jnp.asarray(False), k1)
    r1 = np.asarray(l1[:, :, :k_lat])
    want1 = cond + scale * jax.random.normal(k1, cond.shape,
                                             cond.dtype) * 0.9 ** 2
    np.testing.assert_allclose(r1, np.asarray(want1), atol=1e-6)

    l2, vel = step(l1, 0.7, 0.4, vel, jnp.asarray(True), k2)
    r2 = np.asarray(l2[:, :, :k_lat])
    # contains ONLY step 2's injection — no trace of step 1's noise
    want2 = cond + scale * jax.random.normal(k2, cond.shape,
                                             cond.dtype) * 0.7 ** 2
    np.testing.assert_allclose(r2, np.asarray(want2), atol=1e-6)


def test_extension_cond_frames_one_is_i2v(pipe):
    """cond_frames=1 with a one-frame clip IS I2V: bit-for-bit equal to
    generate_video conditioned on the same latent (same key derivation,
    same injection — both run the default image_cond_noise_scale 0.15)."""
    frame = _clip(1)
    cfg = _cfg()
    lat = pipe.encode_image(jnp.asarray(frame))
    i2v = pipe.generate_video("a watercolor fox", cfg, image_latent=lat)
    ext = pipe.generate_video_extension("a watercolor fox", cfg,
                                        video_frames=frame, cond_frames=1)
    np.testing.assert_array_equal(np.asarray(ext.frames),
                                  np.asarray(i2v.frames))


def test_extension_mechanism(pipe):
    """What reaches the denoiser: the initial latent's first k latent
    frames are the ENCODED clip tail; the mask marks exactly those tokens;
    cond_frames and the clean conditioned latent flow through."""
    clip9 = _clip(9)  # -> 2 latent frames
    cfg = _cfg()
    seen = {}
    orig = pipe._denoise

    def spy(latent, sigmas, shape, guidance, context, bias, cm, scale, fps,
            key, timings, on_progress, conditioned_latent=None,
            cond_frames=1):
        seen.update(latent=np.asarray(latent), cm=cm,
                    cond=np.asarray(conditioned_latent), k=cond_frames)
        return orig(latent, sigmas, shape, guidance, context, bias, cm,
                    scale, fps, key, timings, on_progress,
                    conditioned_latent=conditioned_latent,
                    cond_frames=cond_frames)

    pipe._denoise = spy
    try:
        r = pipe.generate_video_extension("a fox", cfg, video_frames=clip9,
                                          cond_frames=9)
    finally:
        pipe._denoise = orig

    f = np.asarray(r.frames)
    assert f.shape == (17, 64, 64, 3) and np.isfinite(f).all()

    assert seen["k"] == 2
    src = np.asarray(pipe.encode_video(jnp.asarray(clip9))
                     .astype(jnp.float32))
    np.testing.assert_allclose(seen["latent"][:, :, :2], src, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(seen["cond"]), src)

    shape = VideoLatentShape.from_pixels(1, 17, 64, 64,
                                         channels=pipe.tcfg.in_channels)
    tpf = shape.height * shape.width
    assert seen["cm"].shape == (1, shape.token_count)
    assert (seen["cm"][:, : 2 * tpf] == 1.0).all()
    assert (seen["cm"][:, 2 * tpf:] == 0.0).all()


def test_extension_takes_the_clip_tail(pipe, tmp_path):
    """The file path uses the input's LAST cond_frames frames (an
    extension continues the end of a clip, not a resample of it)."""
    from ltx_jax.io.video import export_video, load_video

    rng = np.random.default_rng(5)
    clip = rng.uniform(size=(24, 64, 64, 3)).astype(np.float32)
    path = str(tmp_path / "in.mp4")
    export_video(clip, path)

    tail = load_video(path, 64, 64, 9, sample="tail")
    full = load_video(path, 64, 64, 24, sample="even")  # decode reference
    np.testing.assert_array_equal(tail[0], full[0][:, -9:])

    with pytest.raises(IOError):
        load_video(path, 64, 64, 99, sample="tail")  # clip too short

    seen = {}
    orig = pipe.encode_video

    def spy(pixels):
        seen["pixels"] = np.asarray(pixels)
        return orig(pixels)

    pipe.encode_video = spy
    try:
        r = pipe.generate_video_extension("a fox", _cfg(), video_path=path,
                                          cond_frames=9)
    finally:
        del pipe.encode_video  # restore the bound method
    np.testing.assert_array_equal(seen["pixels"], tail)
    assert np.isfinite(np.asarray(r.frames)).all()


def test_extension_argument_validation(pipe):
    clip9 = _clip(9)
    with pytest.raises(InvalidConfigurationError):  # not 8k+1
        pipe.generate_video_extension("x", _cfg(), video_frames=clip9,
                                      cond_frames=8)
    with pytest.raises(InvalidConfigurationError):  # >= num_frames
        pipe.generate_video_extension("x", _cfg(num_frames=9),
                                      video_frames=clip9, cond_frames=9)
    with pytest.raises(InvalidConfigurationError):  # neither source
        pipe.generate_video_extension("x", _cfg())
    with pytest.raises(InvalidConfigurationError):  # frame-count mismatch
        pipe.generate_video_extension("x", _cfg(), video_frames=clip9,
                                      cond_frames=17)


@pytest.fixture(scope="module")
def pipe_av():
    p = LTXPipeline.random_tiny(seed=0, include_audio=True)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def test_av_extension_cond_frames_one_is_av_i2v(pipe_av):
    """EXTEND with a soundtrack (the AV twin): cond_frames=1 with a
    one-frame clip reproduces image-conditioned generate_video_with_audio
    bit-for-bit (same key derivation; the clip tail encodes to the same
    latent encode_image produces)."""
    frame = _clip(1)
    cfg = _cfg()
    lat = pipe_av.encode_image(jnp.asarray(frame))
    i2v = pipe_av.generate_video_with_audio("a singing fox", cfg,
                                            image_latent=lat)
    ext = pipe_av.generate_video_with_audio("a singing fox", cfg,
                                            video_frames=frame,
                                            cond_frames=1)
    np.testing.assert_array_equal(np.asarray(ext.frames),
                                  np.asarray(i2v.frames))
    np.testing.assert_array_equal(np.asarray(ext.audio),
                                  np.asarray(i2v.audio))


def test_av_extension_multi_frame_tail(pipe_av):
    """Multi-frame tail conditioning through the dual transformer: output
    well-formed, audio attached, and the head latent frames carry the
    encoded tail (mask plumbing checked via the step builder spy)."""
    clip9 = _clip(9)
    cfg = _cfg()
    seen = {}
    import ltx_jax.pipeline.denoise as dn
    orig = dn.make_av_denoise_step

    def spy(*a, **kw):
        seen.update(cm=kw.get("conditioning_mask"),
                    cond=kw.get("conditioned_latent"),
                    k=kw.get("cond_frames"))
        return orig(*a, **kw)

    # generate_video_with_audio imports make_av_denoise_step locally from
    # ltx_jax.pipeline.denoise — patch the source module
    dn.make_av_denoise_step = spy
    try:
        r = pipe_av.generate_video_with_audio("a fox", cfg,
                                              video_frames=clip9,
                                              cond_frames=9)
    finally:
        dn.make_av_denoise_step = orig
    f = np.asarray(r.frames)
    assert f.shape == (17, 64, 64, 3) and np.isfinite(f).all()
    assert r.audio is not None and np.isfinite(np.asarray(r.audio)).all()
    assert seen["k"] == 2
    src = np.asarray(pipe_av.encode_video(jnp.asarray(clip9))
                     .astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(seen["cond"]), src)
    shape = VideoLatentShape.from_pixels(
        1, 17, 64, 64, channels=pipe_av.tcfg.in_channels)
    tpf = shape.height * shape.width
    assert (seen["cm"][:, : 2 * tpf] == 1.0).all()
    assert (seen["cm"][:, 2 * tpf:] == 0.0).all()


def test_av_extension_validation(pipe_av):
    clip9 = _clip(9)
    with pytest.raises(InvalidConfigurationError):  # image + clip tail
        pipe_av.generate_video_with_audio(
            "x", _cfg(image_path="nope.png"), video_frames=clip9)
    with pytest.raises(InvalidConfigurationError):  # not 8k+1
        pipe_av.generate_video_with_audio("x", _cfg(),
                                          video_frames=clip9,
                                          cond_frames=8)
    with pytest.raises(InvalidConfigurationError):  # >= num_frames
        pipe_av.generate_video_with_audio("x", _cfg(num_frames=9),
                                          video_frames=clip9,
                                          cond_frames=9)


def test_cmd_generate_extend_audio_dispatch(tmp_path, monkeypatch):
    """`generate --extend-video in.mp4 --audio` routes through the AV
    twin and writes MP4 + side WAV."""
    from ltx_jax.io import cli
    from ltx_jax.io.video import export_video
    from ltx_jax.pipeline import loader

    clip = np.random.default_rng(1).uniform(size=(24, 64, 64, 3)) \
        .astype(np.float32)
    in_path = tmp_path / "in.mp4"
    export_video(clip, str(in_path))

    monkeypatch.setattr(
        loader, "load_pipeline",
        lambda **kw: LTXPipeline.random_tiny(seed=0, include_audio=True))
    out = tmp_path / "out.mp4"
    rc = cli.main([
        "generate", "the story continues, with music", "--extend-video",
        str(in_path), "--audio", "--cond-frames", "9",
        "-w", "64", "-H", "64", "-f", "17", "--seed", "3",
        "-o", str(out),
    ])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0
    assert (tmp_path / "out.mp4.wav").exists()


def test_serve_extend_audio_job_http(pipe_av, tmp_path):
    """kind=extend with "audio": true over real HTTP routes through the
    AV twin (audio muxed into the job's MP4)."""
    import json
    import os
    import urllib.request

    from ltx_jax.io.video import export_video
    from ltx_jax.serve.app import build_app
    from ltx_jax.serve.server import serve_forever_threaded

    root = tmp_path / "media"
    root.mkdir()
    clip = np.random.default_rng(2).uniform(size=(24, 64, 64, 3)) \
        .astype(np.float32)
    export_video(clip, str(root / "in.mp4"))

    app = build_app(pipe_av, output_dir=str(tmp_path / "out"), port=0,
                    image_root=str(root))
    serve_forever_threaded(app.server)
    host, port = app.server.server_address[:2]

    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/generate",
            json.dumps({"kind": "extend", "prompt": "with a soundtrack",
                        "video_path": "in.mp4", "cond_frames": 9,
                        "audio": True, "width": 64, "height": 64,
                        "num_frames": 17, "num_steps": 2,
                        "seed": 5}).encode(),
            {"Content-Type": "application/json"})
        job_id = json.loads(urllib.request.urlopen(req).read())["job_id"]
        rec = app.jobs.wait(job_id, timeout=600)
        assert rec["state"] == "done", rec
        assert os.path.getsize(rec["result"]["output"]) > 0
    finally:
        app.close()


def test_cmd_generate_extend_dispatch(tmp_path, monkeypatch):
    """`generate --extend-video in.mp4 --cond-frames 9` end-to-end through
    cmd_generate with a tiny pipeline."""
    from ltx_jax.io import cli
    from ltx_jax.io.video import export_video
    from ltx_jax.pipeline import loader

    clip = np.random.default_rng(1).uniform(size=(24, 64, 64, 3)) \
        .astype(np.float32)
    in_path = tmp_path / "in.mp4"
    export_video(clip, str(in_path))

    monkeypatch.setattr(loader, "load_pipeline",
                        lambda **kw: LTXPipeline.random_tiny(seed=0))
    out = tmp_path / "out.mp4"
    rc = cli.main([
        "generate", "the story continues", "--extend-video", str(in_path),
        "--cond-frames", "9", "-w", "64", "-H", "64", "-f", "17",
        "--seed", "3", "-o", str(out),
    ])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0
