"""Latent utilities: patchify round-trip, CFG/rescale/AdaIN formulas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.ops import latents
from ltx_jax.ops.attention import prepare_additive_mask
from ltx_jax.ops.embeddings import get_timestep_embedding
from ltx_jax.ops.normalization import adaln, layer_norm_no_affine, rms_norm


def test_latent_shape_from_pixels():
    s = latents.VideoLatentShape.from_pixels(1, 25, 512, 768)
    assert s.shape == (1, 128, 4, 16, 24)
    assert s.token_count == 4 * 16 * 24
    assert s.pixel_frames == 25
    s.validate()


def test_patchify_roundtrip_and_order():
    b, c, f, h, w = 2, 3, 2, 2, 3
    x = jnp.arange(b * c * f * h * w, dtype=jnp.float32).reshape(b, c, f, h, w)
    p = latents.patchify(x)
    assert p.shape == (b, f * h * w, c)
    # token order is row-major (F, H, W): token 1 should be (f=0,h=0,w=1)
    np.testing.assert_array_equal(
        np.asarray(p[0, 1]), np.asarray(x[0, :, 0, 0, 1])
    )
    shape = latents.VideoLatentShape(b, c, f, h, w)
    back = latents.unpatchify(p, shape)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_cfg_exact_form():
    uncond = jnp.asarray([1.0, 2.0])
    cond = jnp.asarray([2.0, 1.0])
    out = latents.apply_cfg(uncond, cond, 4.0)
    # cond + 3*(cond - uncond)
    np.testing.assert_allclose(np.asarray(out), [5.0, -2.0])


def test_cfg_scale_one_is_identity():
    uncond = jnp.asarray([1.0, 2.0])
    cond = jnp.asarray([3.0, 5.0])
    np.testing.assert_allclose(
        np.asarray(latents.apply_cfg(uncond, cond, 1.0)), [3.0, 5.0]
    )


def test_guidance_rescale():
    rng = np.random.default_rng(1)
    cfg = jnp.asarray(rng.standard_normal((2, 4, 3, 3, 3)) * 5, jnp.float32)
    cond = jnp.asarray(rng.standard_normal((2, 4, 3, 3, 3)), jnp.float32)
    out = latents.apply_guidance_rescale(cfg, cond, phi=1.0)
    # with phi=1 the output std should match cond std per-sample
    out_std = np.asarray(out).std(axis=(1, 2, 3, 4))
    cond_std = np.asarray(cond).std(axis=(1, 2, 3, 4))
    np.testing.assert_allclose(out_std, cond_std, rtol=1e-3)
    # phi=0 is identity
    np.testing.assert_array_equal(
        np.asarray(latents.apply_guidance_rescale(cfg, cond, 0.0)), np.asarray(cfg)
    )


def test_adain():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((1, 4, 2, 3, 3)) * 3 + 1, jnp.float32)
    ref = jnp.asarray(rng.standard_normal((1, 4, 5, 2, 2)) * 0.5 - 2, jnp.float32)
    out = np.asarray(latents.adain_filter_latent(x, ref, 1.0))
    np.testing.assert_allclose(
        out.mean(axis=(2, 3, 4)), np.asarray(ref).mean(axis=(2, 3, 4)), atol=1e-4
    )
    np.testing.assert_allclose(
        out.std(axis=(2, 3, 4)), np.asarray(ref).std(axis=(2, 3, 4)), rtol=1e-3
    )


def test_rms_norm_weightless():
    x = jnp.asarray([[3.0, 4.0]], jnp.float32)
    out = np.asarray(rms_norm(x))
    rms = np.sqrt((9 + 16) / 2 + 1e-6)
    np.testing.assert_allclose(out, [[3 / rms, 4 / rms]], rtol=1e-6)


def test_layer_norm_no_affine():
    x = jnp.asarray([[1.0, 2.0, 3.0]], jnp.float32)
    out = np.asarray(layer_norm_no_affine(x))
    np.testing.assert_allclose(out.mean(), 0.0, atol=1e-6)
    np.testing.assert_allclose(out.std(), 1.0, rtol=1e-3)


def test_adaln_formula():
    x = jnp.asarray([[2.0, 2.0]], jnp.float32)  # rms = 2 -> normed = 1
    out = np.asarray(adaln(x, scale=jnp.asarray(0.5), shift=jnp.asarray(0.1)))
    np.testing.assert_allclose(out, 1.0 * 1.5 + 0.1, rtol=1e-5)


def test_timestep_embedding_arange_not_linspace():
    emb = np.asarray(get_timestep_embedding(jnp.asarray([1000.0]), 8))
    half = 4
    freqs = np.exp(
        np.float32(-np.log(10000.0)) * np.arange(half, dtype=np.float32) / np.float32(half)
    ).astype(np.float32)
    args = np.float32(1000.0) * freqs
    expected = np.concatenate([np.cos(args), np.sin(args)]).astype(np.float32)
    # atol covers f32 trig argument-reduction ULP differences (XLA vs numpy)
    np.testing.assert_allclose(emb[0], expected, atol=2e-4)


def test_timestep_embedding_2d_input():
    emb = get_timestep_embedding(jnp.ones((2, 5)), 16)
    assert emb.shape == (2, 5, 16)


def test_additive_mask():
    m = jnp.asarray([[1, 1, 0]], jnp.int32)
    bias = np.asarray(prepare_additive_mask(m))
    assert bias.shape == (1, 1, 1, 3)
    np.testing.assert_array_equal(bias[0, 0, 0], [0.0, 0.0, -10000.0])


def test_generate_noise_shape_dtype():
    s = latents.VideoLatentShape(1, 8, 2, 4, 4)
    n = latents.generate_noise(jax.random.key(0), s)
    assert n.shape == s.shape and n.dtype == jnp.float32


def test_memory_estimate_and_preset():
    """Memory estimator (reference: LatentUtils.swift:294-319) against an
    explicit budget of 60 GB (an 80 GB card at JAX's default 0.75 share):
    small int4 configs fit light; the bf16 19B AV flagship with 3 guidance
    rows does not fit untiled."""
    from ltx_jax.ops.latents import (
        estimate_memory_gb, recommended_memory_preset,
    )

    budget = 80 * 0.75
    small = latents.VideoLatentShape.from_pixels(1, 25, 512, 768)
    assert estimate_memory_gb(small, 1, 4) < budget
    assert recommended_memory_preset(small, 1, 4, budget_gb=budget) == "light"
    flagship = latents.VideoLatentShape.from_pixels(1, 241, 640, 1024)
    assert estimate_memory_gb(flagship, 3, None, audio=True) > budget
    assert recommended_memory_preset(flagship, 3, None, audio=True,
                                     budget_gb=budget) != "light"
    big = latents.VideoLatentShape.from_pixels(1, 241, 640, 1024)
    assert estimate_memory_gb(big, 1, 4) > estimate_memory_gb(small, 1, 4)
