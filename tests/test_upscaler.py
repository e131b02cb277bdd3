"""Spatial upscaler + two-stage pipeline tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.models import upscaler

CFG = upscaler.UpscalerConfig().tiny()


@pytest.fixture(scope="module")
def params():
    return upscaler.init_params(jax.random.key(0), CFG)


def test_upscaler_shape(params):
    latent = jax.random.normal(jax.random.key(1), (1, CFG.in_channels, 2, 4, 6))
    out = upscaler.upscaler_forward(params, latent, CFG)
    assert out.shape == (1, CFG.in_channels, 2, 8, 12)
    assert np.isfinite(np.asarray(out)).all()


def test_pixel_shuffle_golden():
    # 1x1 spatial, 4 channels, r=2 -> 2x2 spatial 1 channel
    x = jnp.asarray([[[[1.0, 2.0, 3.0, 4.0]]]])  # (1, 1, 1, 4)
    out = np.asarray(upscaler.pixel_shuffle_2d(x, 2))
    assert out.shape == (1, 2, 2, 1)
    # channel order (c, rh, rw): [[1, 2], [3, 4]]
    np.testing.assert_array_equal(out[0, :, :, 0], [[1, 2], [3, 4]])


def test_upsample_latents_denorm_roundtrip(params):
    """With identity stats, upsample == raw upscale."""
    latent = jax.random.normal(jax.random.key(2), (1, CFG.in_channels, 1, 4, 4))
    mean = jnp.zeros((CFG.in_channels,))
    std = jnp.ones((CFG.in_channels,))
    a = np.asarray(upscaler.upsample_latents(params, latent, mean, std, CFG))
    b = np.asarray(upscaler.upscaler_forward(params, latent, CFG))
    np.testing.assert_allclose(a, b, atol=1e-5)
    # non-identity stats change the result
    mean2 = jnp.full((CFG.in_channels,), 0.5)
    std2 = jnp.full((CFG.in_channels,), 2.0)
    c = np.asarray(upscaler.upsample_latents(params, latent, mean2, std2, CFG))
    assert not np.allclose(a, c)


def test_upscaler_weight_loading():
    rng = np.random.default_rng(0)
    mid, cin = CFG.mid_channels, CFG.in_channels
    t = {}

    def c3(prefix, ci, co):
        t[f"{prefix}.weight"] = rng.standard_normal(
            (co, ci, 3, 3, 3)).astype(np.float32) * 0.02
        t[f"{prefix}.bias"] = np.zeros((co,), np.float32)

    def norm(prefix):
        t[f"{prefix}.weight"] = np.ones((mid,), np.float32)
        t[f"{prefix}.bias"] = np.zeros((mid,), np.float32)

    c3("initial_conv", cin, mid)
    norm("initial_norm")
    for blocks in ("res_blocks", "post_upsample_res_blocks"):
        c3(f"{blocks}.0.conv1", mid, mid)
        norm(f"{blocks}.0.norm1")
        c3(f"{blocks}.0.conv2", mid, mid)
        norm(f"{blocks}.0.norm2")
    t["upsampler.conv.weight"] = rng.standard_normal(
        (4 * mid, mid, 3, 3)).astype(np.float32) * 0.02
    t["upsampler.conv.bias"] = np.zeros((4 * mid,), np.float32)
    c3("final_conv", mid, cin)
    t["blur_down.weight"] = np.zeros((1,), np.float32)  # must be skipped

    params = upscaler.load_params(t)
    assert params["initial_conv"]["w"].shape == (3, 3, 3, cin, mid)
    assert params["upsampler"]["conv"]["w"].shape == (3, 3, mid, 4 * mid)
    latent = jax.random.normal(jax.random.key(3), (1, cin, 1, 4, 4))
    out = upscaler.upscaler_forward(params, latent, CFG)
    assert out.shape == (1, cin, 1, 8, 8)


def test_two_stage_pipeline():
    from ltx_jax.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.memory = dataclasses.replace(pipe.memory, offload_text_encoder=False)
    cfg = GenerationConfig(width=128, height=128, num_frames=9, num_steps=2,
                           seed=5, two_stage=True)
    result = pipe.generate_video_two_stage("a river", cfg)
    assert result.frames.shape == (9, 128, 128, 3)
    f = np.asarray(result.frames)
    assert np.isfinite(f).all() and f.min() >= 0.0 and f.max() <= 1.0
    # stage 1 distilled table (8 steps) + stage 2 (3 steps)
    assert len(result.timings.denoise_steps) == 11


def test_two_stage_i2v():
    from ltx_jax.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.memory = dataclasses.replace(pipe.memory, offload_text_encoder=False)
    cfg = GenerationConfig(width=128, height=128, num_frames=9, num_steps=2,
                           seed=5, two_stage=True)
    img_half = jax.random.uniform(jax.random.key(7), (1, 3, 1, 64, 64),
                                  minval=-1, maxval=1)
    img_full = jax.random.uniform(jax.random.key(7), (1, 3, 1, 128, 128),
                                  minval=-1, maxval=1)
    result = pipe.generate_video_two_stage(
        "a river", cfg,
        image_latent=pipe.encode_image(img_half),
        full_res_image_latent=pipe.encode_image(img_full),
    )
    assert result.frames.shape == (9, 128, 128, 3)