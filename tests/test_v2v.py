"""Video-to-video (round 4, beyond parity — the reference conditions on a
single image only). SDEdit-style partial noising on the scheduler's exact
flow-matching forward: encode clip -> x_k = (1-sigma_k) x0 + sigma_k noise
-> denoise the schedule tail -> decode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.pipeline.generate import LTXPipeline


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


@pytest.fixture(scope="module")
def clip():
    # smooth synthetic clip in [-1, 1], (1, 3, 9, 64, 64)
    t = np.linspace(-1, 1, 9, dtype=np.float32)
    y = np.linspace(-1, 1, 64, dtype=np.float32)
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    g = (t[:, None, None] * 0.3 + y[None, :, None] * 0.5
         + x[None, None, :] * 0.2)
    return np.stack([g, -g, 0.5 * g], axis=0)[None].astype(np.float32)


def test_v2v_strength_one_equals_t2v(pipe, clip):
    """strength=1.0: sigma_0 is 1.0, so the noised latent IS the T2V noise
    — the output must reproduce generate_video bit-for-bit (same seed,
    same key derivation)."""
    t2v = pipe.generate_video("a watercolor fox", _cfg())
    v2v = pipe.generate_video_from_video(
        "a watercolor fox", _cfg(), video_frames=clip, strength=1.0)
    np.testing.assert_array_equal(np.asarray(v2v.frames),
                                  np.asarray(t2v.frames))


def test_v2v_partial_noising_semantics(pipe, clip):
    """The exact SDEdit mechanism, pinned by capturing what reaches the
    denoiser (a random tiny model's decoded pixels can't witness
    'closeness to input', so the test checks the math, not perception):
    at strength s over an N-step schedule, the tail starts at index
    k = round((1-s)N), and the initial latent is
    add_noise(encode(clip), T2V-noise, sigma_k)."""
    from ltx_jax.ops import schedule
    from ltx_jax.ops.latents import VideoLatentShape, generate_noise

    cfg = _cfg(num_steps=8)
    seen = {}
    orig = pipe._denoise

    def spy(latent, sigmas, *a, **kw):
        seen["latent"], seen["sigmas"] = np.asarray(latent), sigmas
        return orig(latent, sigmas, *a, **kw)

    pipe._denoise = spy
    try:
        low = pipe.generate_video_from_video(
            "a watercolor fox", cfg, video_frames=clip, strength=0.25)
    finally:
        pipe._denoise = orig

    shape = VideoLatentShape.from_pixels(1, cfg.num_frames, cfg.height,
                                         cfg.width,
                                         channels=pipe.tcfg.in_channels)
    sig_full = pipe._sigmas(cfg, shape)
    n = len(sig_full) - 1
    k = int(round(0.75 * n))
    np.testing.assert_allclose(seen["sigmas"], sig_full[k:])
    assert len(low.timings.denoise_steps) == n - k  # fewer steps ran

    key = jax.random.key(cfg.seed)
    _, nkey = jax.random.split(key)
    noise = generate_noise(nkey, shape)
    src = pipe.encode_video(jnp.asarray(clip)).astype(jnp.float32)
    want = schedule.add_noise(src, noise, float(sig_full[k]))
    np.testing.assert_allclose(seen["latent"], np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_v2v_loads_from_file(pipe, clip, tmp_path):
    """Round-trips through the exporter + load_video reader (the CLI's
    --video path)."""
    from ltx_jax.io.video import export_video

    ref = np.clip((np.asarray(clip)[0].transpose(1, 2, 3, 0) + 1) / 2, 0, 1)
    path = str(tmp_path / "in.mp4")
    export_video(ref, path)
    r = pipe.generate_video_from_video("a fox", _cfg(), video_path=path,
                                       strength=0.5)
    f = np.asarray(r.frames)
    assert f.shape == (9, 64, 64, 3) and np.isfinite(f).all()


def test_v2v_argument_validation(pipe, clip):
    with pytest.raises(InvalidConfigurationError):
        pipe.generate_video_from_video("x", _cfg(), video_frames=clip,
                                       strength=0.0)
    with pytest.raises(InvalidConfigurationError):
        pipe.generate_video_from_video("x", _cfg())  # neither source
    with pytest.raises(InvalidConfigurationError):
        pipe.generate_video_from_video(
            "x", _cfg(), video_frames=clip[:, :, :5])  # frame mismatch
