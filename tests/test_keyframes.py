"""Keyframe conditioning at ARBITRARY latent-frame positions.

generate_video_keyframes anchors images at any 8-aligned pixel frame
(first+last interpolation, mid-clip anchors) — the multi-position
generalization of I2V (no reference analog: the Swift pipeline conditions
on frame 0 only, LTXPipeline.swift:1902-1932; the upstream LTX-Video
Python pipeline's conditioning items are the behavioral model). The
denoise-step mechanism is pipeline/denoise.py's cond_frame_idx path:
scatter-injection from the clean conditioned latent + frame-mask carry
through Euler.
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
    d = dict(width=64, height=64, num_frames=25, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def _img(seed=0):
    # (1, 3, 1, 64, 64) pixels in [-1, 1]
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(1, 3, 1, 64, 64)).astype(np.float32)


def test_keyframe_zero_is_i2v(pipe):
    """keyframes=[(0, latent)] IS I2V: bit-for-bit equal to
    generate_video(image_latent=...) — same key derivation, same noise
    draw shapes; scatter/where vs slice/concat are elementwise-identical."""
    lat = pipe.encode_image(jnp.asarray(_img(1)))
    cfg = _cfg()
    i2v = pipe.generate_video("a fox at dawn", cfg, image_latent=lat)
    kf = pipe.generate_video_keyframes("a fox at dawn", cfg,
                                       [(0, np.asarray(lat))])
    np.testing.assert_array_equal(np.asarray(kf.frames),
                                  np.asarray(i2v.frames))


def test_step_injects_and_carries_at_arbitrary_positions(pipe):
    """The denoise-step pin: conditioned frames at indices {0, 2} equal
    clean + scale * normal(step_key) * sigma^2 after EVERY step (fresh
    clean-source injection), while unconditioned frames move by Euler."""
    cfg = _cfg(num_frames=33)  # 5 latent frames
    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height, cfg.width,
        channels=pipe.tcfg.in_channels)
    idx = np.array([0, 2])
    cond = jax.random.normal(
        jax.random.key(7),
        (1, shape.channels, 2, shape.height, shape.width), jnp.float32)
    cm = pipe._conditioning_mask(shape, frame_idx=idx)

    emb = pipe.encode_prompt("a fox")
    guidance = GuidanceSpec.from_config(cfg)
    context, bias = build_guidance_context(guidance, emb["video"],
                                           emb["mask"])
    scale = 0.4
    step = make_denoise_step(
        pipe.transformer_params, pipe.tcfg, guidance, shape, context, bias,
        conditioning_mask=cm, conditioned_latent=cond,
        image_cond_noise_scale=scale, cond_frame_idx=idx)

    latent = generate_noise(jax.random.key(3), shape)
    latent = latent.at[:, :, idx].set(cond)
    frame1_before = np.asarray(latent[:, :, 1])  # step donates `latent`
    vel = jnp.zeros_like(latent)
    k1, k2 = jax.random.key(11), jax.random.key(12)

    l1, vel = step(latent, 0.9, 0.7, vel, jnp.asarray(False), k1)
    want1 = cond + scale * jax.random.normal(k1, cond.shape,
                                             cond.dtype) * 0.9 ** 2
    np.testing.assert_allclose(np.asarray(l1[:, :, idx]),
                               np.asarray(want1), atol=1e-6)
    # unconditioned frames moved (Euler with a nonzero sigma gap)
    assert not np.allclose(np.asarray(l1[:, :, 1]), frame1_before)

    l2, vel = step(l1, 0.7, 0.4, vel, jnp.asarray(True), k2)
    want2 = cond + scale * jax.random.normal(k2, cond.shape,
                                             cond.dtype) * 0.7 ** 2
    # only step 2's injection — no accumulation
    np.testing.assert_allclose(np.asarray(l2[:, :, idx]),
                               np.asarray(want2), atol=1e-6)


def test_interpolation_mechanism(pipe):
    """First+last anchors through the full pipeline: what reaches the
    denoiser — scattered clean latents, token mask on exactly those
    frames' blocks, indices flow through; output finite."""
    cfg = _cfg(num_frames=25)  # latent frames 0..3; pixel 24 -> latent 3
    first, last = _img(2), _img(3)
    seen = {}
    orig = pipe._denoise

    def spy(latent, sigmas, shape, guidance, context, bias, cm, scale, fps,
            key, timings, on_progress, conditioned_latent=None,
            cond_frames=1, cond_frame_idx=None):
        seen.update(latent=np.asarray(latent), cm=cm,
                    cond=np.asarray(conditioned_latent), idx=cond_frame_idx)
        return orig(latent, sigmas, shape, guidance, context, bias, cm,
                    scale, fps, key, timings, on_progress,
                    conditioned_latent=conditioned_latent,
                    cond_frames=cond_frames, cond_frame_idx=cond_frame_idx)

    pipe._denoise = spy
    try:
        r = pipe.generate_video_keyframes(
            "a fox walks to the river", cfg,
            [(24, last), (0, first)])  # unsorted on purpose
    finally:
        pipe._denoise = orig

    f = np.asarray(r.frames)
    assert f.shape == (25, 64, 64, 3) and np.isfinite(f).all()

    np.testing.assert_array_equal(seen["idx"], [0, 3])  # sorted
    lat_first = np.asarray(pipe.encode_image(jnp.asarray(first))
                           .astype(jnp.float32))
    lat_last = np.asarray(pipe.encode_image(jnp.asarray(last))
                          .astype(jnp.float32))
    np.testing.assert_allclose(seen["cond"][:, :, 0], lat_first[:, :, 0],
                               atol=1e-6)
    np.testing.assert_allclose(seen["cond"][:, :, 1], lat_last[:, :, 0],
                               atol=1e-6)
    np.testing.assert_allclose(seen["latent"][:, :, 0], lat_first[:, :, 0],
                               atol=1e-6)
    np.testing.assert_allclose(seen["latent"][:, :, 3], lat_last[:, :, 0],
                               atol=1e-6)

    shape = VideoLatentShape.from_pixels(1, 25, 64, 64,
                                         channels=pipe.tcfg.in_channels)
    tpf = shape.height * shape.width
    cm = seen["cm"].reshape(shape.frames, tpf)
    assert (cm[0] == 1).all() and (cm[3] == 1).all()
    assert (cm[1] == 0).all() and (cm[2] == 0).all()


def test_keyframe_argument_validation(pipe):
    img = _img()
    with pytest.raises(InvalidConfigurationError):  # empty
        pipe.generate_video_keyframes("x", _cfg(), [])
    with pytest.raises(InvalidConfigurationError):  # not 8-aligned
        pipe.generate_video_keyframes("x", _cfg(), [(3, img)])
    with pytest.raises(InvalidConfigurationError):  # out of range
        pipe.generate_video_keyframes("x", _cfg(num_frames=17),
                                      [(24, img)])
    with pytest.raises(InvalidConfigurationError):  # duplicate latent idx
        pipe.generate_video_keyframes("x", _cfg(), [(0, img), (0, img)])
    with pytest.raises(InvalidConfigurationError):  # bad source shape
        pipe.generate_video_keyframes("x", _cfg(), [(0, img[:, :, 0])])
    with pytest.raises(InvalidConfigurationError):  # bad channel count
        pipe.generate_video_keyframes(
            "x", _cfg(), [(0, np.zeros((1, 7, 1, 64, 64), np.float32))])


def test_cmd_generate_keyframes_dispatch(tmp_path, monkeypatch):
    """`generate --keyframe 0:a.png --keyframe 16:b.png` end-to-end
    through cmd_generate with a tiny pipeline; malformed spec exits 2."""
    from PIL import Image

    from ltx_jax.io import cli
    from ltx_jax.pipeline import loader

    rng = np.random.default_rng(9)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8),
                        "RGB").save(tmp_path / name)

    monkeypatch.setattr(loader, "load_pipeline",
                        lambda **kw: LTXPipeline.random_tiny(seed=0))
    out = tmp_path / "out.mp4"
    rc = cli.main([
        "generate", "between two moments",
        "--keyframe", f"0:{tmp_path / 'a.png'}",
        "--keyframe", f"16:{tmp_path / 'b.png'}",
        "-w", "64", "-H", "64", "-f", "17", "--seed", "3", "-o", str(out),
    ])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0

    rc = cli.main([
        "generate", "x", "--keyframe", "zero:a.png",
        "-w", "64", "-H", "64", "-f", "17", "-o", str(tmp_path / "y.mp4"),
    ])
    assert rc == 2


def test_serve_keyframes_job_http(pipe, tmp_path):
    """kind=keyframes over real HTTP: anchors fenced + validated at
    submit; job produces an MP4."""
    import json
    import os
    import urllib.error
    import urllib.request

    from PIL import Image

    from ltx_jax.serve.app import build_app
    from ltx_jax.serve.server import serve_forever_threaded

    root = tmp_path / "media"
    root.mkdir()
    rng = np.random.default_rng(4)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8),
                        "RGB").save(root / name)

    app = build_app(pipe, output_dir=str(tmp_path / "out"), port=0,
                    image_root=str(root))
    serve_forever_threaded(app.server)
    host, port = app.server.server_address[:2]
    base = f"http://{host}:{port}"

    def post(body):
        req = urllib.request.Request(
            base + "/v1/generate", json.dumps(body).encode(),
            {"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req).read())

    try:
        body = {"kind": "keyframes", "prompt": "between",
                "keyframes": [{"frame": 0, "image_path": "a.png"},
                              {"frame": 16, "image_path": "b.png"}],
                "width": 64, "height": 64, "num_frames": 17,
                "num_steps": 2, "seed": 4}
        job_id = post(body)["job_id"]
        rec = app.jobs.wait(job_id, timeout=600)
        assert rec["state"] == "done", rec
        assert os.path.getsize(rec["result"]["output"]) > 0

        for bad in (
            {**body, "keyframes": []},                       # empty
            {**body, "keyframes": [{"frame": 3,              # unaligned
                                    "image_path": "a.png"}]},
            {**body, "keyframes": [{"frame": 24,             # >= num_frames
                                    "image_path": "a.png"}]},
            {**body, "keyframes": [{"frame": 0,              # dup latent idx
                                    "image_path": "a.png"},
                                   {"frame": 0,
                                    "image_path": "b.png"}]},
            {**body, "keyframes": [{"frame": 0,              # fence escape
                                    "image_path": "../../etc/passwd"}]},
        ):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(bad)
            assert ei.value.code == 400
    finally:
        app.close()
