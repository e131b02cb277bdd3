"""Joint video+audio generation pipeline."""

import dataclasses

import jax
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.pipeline.generate import LTXPipeline


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0, include_audio=True)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def test_av_generation(pipe):
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=3)
    result = pipe.generate_video_with_audio("waves crash on a beach", cfg)
    assert result.frames.shape == (9, 64, 64, 3)
    assert result.audio is not None
    # duration 9/24 s -> round(0.375*25) = 9 audio latent frames
    # mel frames 4*9-3 = 33; tiny vocoder upsamples 4x -> 132 samples
    assert result.audio.shape == (2, 132)
    a = np.asarray(result.audio)
    assert np.isfinite(a).all() and a.min() >= -1.0 and a.max() <= 1.0
    assert len(result.timings.denoise_steps) == 8  # distilled table


def test_av_generation_with_cfg(pipe):
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=3, cfg_scale=3.0, guidance_rescale=0.7,
                           negative_prompt="noise")
    result = pipe.generate_video_with_audio("a storm", cfg)
    assert result.frames.shape == (9, 64, 64, 3)
    assert result.audio is not None


def test_av_i2v(pipe):
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=4, image_cond_noise_scale=0.15)
    img = jax.random.uniform(jax.random.key(9), (1, 3, 1, 64, 64),
                             minval=-1, maxval=1)
    result = pipe.generate_video_with_audio(
        "a dog", cfg, image_latent=pipe.encode_image(img))
    assert result.frames.shape == (9, 64, 64, 3)
    assert result.audio is not None


def test_av_deterministic(pipe):
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=11)
    r1 = pipe.generate_video_with_audio("rain", cfg)
    r2 = pipe.generate_video_with_audio("rain", cfg)
    np.testing.assert_array_equal(np.asarray(r1.frames), np.asarray(r2.frames))
    np.testing.assert_array_equal(np.asarray(r1.audio), np.asarray(r2.audio))