"""Sequence-parallel denoise step: ring attention inside the DiT forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.ops.attention import set_sequence_parallel
from ltx_jax.parallel.sharding import make_mesh
from ltx_jax.pipeline.denoise import GuidanceSpec, make_denoise_step
from ltx_jax.pipeline.generate import LTXPipeline
from ltx_jax.ops.latents import VideoLatentShape


@pytest.fixture()
def sp_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(data=1, model=8)
    set_sequence_parallel(mesh)
    yield mesh
    set_sequence_parallel(None)


def test_sp_denoise_matches_unsharded(sp_mesh):
    pipe = LTXPipeline.random_tiny(seed=0)
    # token count divisible by 8: (F, H, W) = (2, 4, 4) -> 32 tokens
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 4, 4)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    latent = jax.random.normal(jax.random.key(0), shape.shape)
    vel = jnp.zeros_like(latent)

    step_ring = make_denoise_step(pipe.transformer_params, pipe.tcfg, g,
                                  shape, ctx, None, sdpa_impl="ring")
    out_ring, _ = step_ring(jnp.array(latent), 0.9, 0.5, vel,
                            jnp.asarray(False), jax.random.key(1))

    set_sequence_parallel(None)
    step_base = make_denoise_step(pipe.transformer_params, pipe.tcfg, g,
                                  shape, ctx, None, sdpa_impl="xla")
    out_base, _ = step_base(jnp.array(latent), 0.9, 0.5, vel,
                            jnp.asarray(False), jax.random.key(1))

    np.testing.assert_allclose(
        np.asarray(out_ring, np.float32), np.asarray(out_base, np.float32),
        atol=2e-2, rtol=2e-2,
    )


def test_ring_impl_without_mesh_falls_back():
    set_sequence_parallel(None)
    pipe = LTXPipeline.random_tiny(seed=0)
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 2, 2)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    step = make_denoise_step(pipe.transformer_params, pipe.tcfg, g, shape,
                             ctx, None, sdpa_impl="ring")
    latent = jax.random.normal(jax.random.key(0), shape.shape)
    out, _ = step(latent, 0.9, 0.5, jnp.zeros_like(latent),
                  jnp.asarray(False), jax.random.key(1))
    assert np.isfinite(np.asarray(out)).all()

def test_sp_av_denoise_matches_unsharded(sp_mesh):
    """AV dual step with sdpa_impl="ring": VIDEO self-attention rings over
    the mesh (token count divides 8); the SHORT audio self-attention (5
    frames, not divisible) and all cross attentions fall back to XLA
    instead of failing the shard_map partition."""
    from ltx_jax.pipeline.denoise import (
        build_guidance_context, make_av_denoise_step,
    )

    pipe = LTXPipeline.random_tiny(seed=0, include_audio=True)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    # 2*4*4 = 32 video tokens -> divisible by the 8-ring; 5 audio frames not
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 4, 4)
    ctx = jax.random.normal(jax.random.key(1),
                            (1, 16, pipe.tcfg.caption_channels), jnp.bfloat16)
    mask = jnp.ones((1, 16), jnp.int32)
    v_ctx, _ = build_guidance_context(g, ctx, mask)
    a_ctx, _ = build_guidance_context(g, ctx, mask)

    vlat = jax.random.normal(jax.random.key(2), shape.shape)
    alat = jax.random.normal(jax.random.key(3),
                             (1, 5, pipe.tcfg.audio_in_channels))

    step_ring = make_av_denoise_step(
        pipe.av_transformer_params, pipe.tcfg, g, shape, 5, v_ctx, a_ctx,
        None, sdpa_impl="ring")
    vr, ar = step_ring(jnp.array(vlat), jnp.array(alat), 0.9, 0.5,
                       jax.random.key(4))

    step_base = make_av_denoise_step(
        pipe.av_transformer_params, pipe.tcfg, g, shape, 5, v_ctx, a_ctx,
        None, sdpa_impl="xla")
    vb, ab = step_base(jnp.array(vlat), jnp.array(alat), 0.9, 0.5,
                       jax.random.key(4))

    np.testing.assert_allclose(np.asarray(vr, np.float32),
                               np.asarray(vb, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(ar, np.float32),
                               np.asarray(ab, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_sp_av_denoise_matches_unsharded(sp_mesh):
    """The dual AV transformer rides the same global SP toggle: its video
    self-attention rings over the mesh; audio self-attention and the
    cross-modal attentions (Tq != Tk) fall back correctly."""
    from ltx_jax.pipeline.denoise import make_av_denoise_step

    pipe = LTXPipeline.random_tiny(seed=0, include_audio=True)
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 4, 4)  # 32 tok
    audio_frames = 8
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    vlat = jax.random.normal(jax.random.key(0), shape.shape)
    alat = jax.random.normal(jax.random.key(1),
                             (1, audio_frames, pipe.tcfg.audio_in_channels))

    step_ring = make_av_denoise_step(
        pipe.av_transformer_params, pipe.tcfg, g, shape, audio_frames,
        ctx, ctx, None, sdpa_impl="ring")
    vr, ar = step_ring(jnp.array(vlat), jnp.array(alat), 0.9, 0.5,
                       jax.random.key(2))

    set_sequence_parallel(None)
    step_base = make_av_denoise_step(
        pipe.av_transformer_params, pipe.tcfg, g, shape, audio_frames,
        ctx, ctx, None, sdpa_impl="xla")
    vb, ab = step_base(jnp.array(vlat), jnp.array(alat), 0.9, 0.5,
                       jax.random.key(2))

    np.testing.assert_allclose(np.asarray(vr, np.float32),
                               np.asarray(vb, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(ar, np.float32),
                               np.asarray(ab, np.float32),
                               atol=2e-2, rtol=2e-2)
