"""Parity-injection hooks: precomputed embeddings + injected noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.ops.latents import VideoLatentShape
from ltx_jax.pipeline.generate import LTXPipeline


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def test_precomputed_embeddings_bypass_text_encoder(pipe):
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=1)
    emb = {
        "video": jax.random.normal(
            jax.random.key(0), (1, 16, pipe.tcfg.caption_channels),
            jnp.bfloat16),
        "mask": jnp.ones((1, 16), jnp.int32),
    }
    r = pipe.generate_video("ignored prompt text", cfg,
                            precomputed_embeddings=emb)
    assert r.frames.shape == (9, 64, 64, 3)
    # different embeddings -> different output (proves injection is live)
    emb2 = {"video": emb["video"] + 1.0, "mask": emb["mask"]}
    r2 = pipe.generate_video("ignored prompt text", cfg,
                             precomputed_embeddings=emb2)
    assert not np.allclose(np.asarray(r.frames), np.asarray(r2.frames))


def test_injected_noise_is_live(pipe):
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=1)
    shape = VideoLatentShape.from_pixels(1, 9, 64, 64,
                                         channels=pipe.tcfg.in_channels)
    noise = np.random.default_rng(0).standard_normal(shape.shape).astype(
        np.float32)
    r1 = pipe.generate_video("a cat", cfg, initial_noise=noise)
    r2 = pipe.generate_video("a cat", cfg, initial_noise=noise)
    np.testing.assert_array_equal(np.asarray(r1.frames), np.asarray(r2.frames))
    r3 = pipe.generate_video("a cat", cfg, initial_noise=-noise)
    assert not np.allclose(np.asarray(r1.frames), np.asarray(r3.frames))