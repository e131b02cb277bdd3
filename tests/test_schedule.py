"""Sigma schedules and Euler stepping vs hand-computed golden values
(formulas cited from reference LTXScheduler.swift in ops/schedule.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.ops import schedule


def test_distilled_raw_sigmas():
    s = schedule.get_sigmas(8, distilled=True, token_count=None)
    expected = np.array(
        [1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875, 0.0],
        dtype=np.float32,
    )
    np.testing.assert_array_equal(s, expected)


def test_mu_anchor_values():
    # mu linear through (1024, 0.95) and (4096, 2.05), clamped at 4096 tokens.
    assert schedule.compute_mu(1024) == pytest.approx(0.95)
    assert schedule.compute_mu(4096) == pytest.approx(2.05)
    assert schedule.compute_mu(100000) == pytest.approx(2.05)
    assert schedule.compute_mu(2560) == pytest.approx(1.5)


def test_distilled_shifted_golden():
    """Hand-compute the shift+stretch for token_count=2560 (mu=1.5)."""
    mu = 1.5
    em = math.exp(mu)
    raw = [1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875]
    shifted = [s if s in (0.0, 1.0) else em / (em + (1.0 / s - 1.0)) for s in raw]
    # stretch: scale = (1 - last) / (1 - terminal); x' = 1 - (1-x)/scale
    scale = (1.0 - shifted[-1]) / (1.0 - 0.1)
    expected = [1.0 - (1.0 - s) / scale for s in shifted] + [0.0]

    got = schedule.get_sigmas(8, distilled=True, token_count=2560)
    np.testing.assert_allclose(got, expected, rtol=2e-6)
    # last non-zero sigma stretched exactly to terminal 0.1
    assert got[-2] == pytest.approx(0.1, abs=1e-6)
    assert got[0] == pytest.approx(1.0)
    assert got[-1] == 0.0


def test_dev_schedule_monotone_and_terminal():
    s = schedule.get_sigmas(40, distilled=False, token_count=9216)
    assert len(s) == 41
    assert s[0] == pytest.approx(1.0)
    assert s[-1] == 0.0
    assert s[-2] == pytest.approx(0.1, abs=1e-6)
    assert np.all(np.diff(s) < 0)


def test_dev_schedule_clamps_tokens():
    a = schedule.get_sigmas(10, distilled=False, token_count=4096)
    b = schedule.get_sigmas(10, distilled=False, token_count=999999)
    np.testing.assert_array_equal(a, b)


def test_stage2_sigmas_suffix_of_distilled():
    np.testing.assert_allclose(
        schedule.STAGE_2_SIGMAS, schedule.DISTILLED_SIGMAS[-4:]
    )


def test_with_terminal():
    np.testing.assert_allclose(
        schedule.with_terminal([0.9, 0.5]), [0.9, 0.5, 0.0]
    )
    np.testing.assert_allclose(
        schedule.with_terminal([0.9, 0.0]), [0.9, 0.0]
    )


def test_euler_step_f32_golden():
    latent = jnp.array([1.0, -2.0, 0.5], dtype=jnp.float32)
    vel = jnp.array([0.3, 0.1, -0.2], dtype=jnp.float32)
    sigma, sigma_next = 0.8, 0.5
    denoised = latent - sigma * vel
    expected = denoised + sigma_next * (latent - denoised) / sigma
    got = schedule.euler_step(latent, vel, sigma, sigma_next)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), rtol=1e-6)


def test_euler_terminal_step_returns_denoised():
    latent = jnp.array([1.0, -2.0], dtype=jnp.float32)
    vel = jnp.array([0.5, 0.5], dtype=jnp.float32)
    got = schedule.euler_step(latent, vel, 0.4, 0.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(latent - 0.4 * vel))


def test_euler_step_bf16_roundtrip():
    """bf16 latents: denoised rounds through bf16 before the f32 update."""
    latent = jnp.array([1.0, -2.0, 0.3333333], dtype=jnp.bfloat16)
    vel = jnp.array([0.3, 0.1, 0.7], dtype=jnp.bfloat16)
    sigma, sigma_next = 0.9, 0.6
    lf = np.asarray(latent, np.float32)
    vf = np.asarray(vel, np.float32)
    denoised_bf16 = jnp.asarray(lf - sigma * vf).astype(jnp.bfloat16)
    df = np.asarray(denoised_bf16, np.float32)
    expected = jnp.asarray(df + sigma_next * (lf - df) / sigma).astype(jnp.bfloat16)
    got = schedule.euler_step(latent, vel, sigma, sigma_next)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got, np.float32), np.asarray(expected, np.float32)
    )


def test_add_noise():
    x = jnp.ones((2, 3))
    n = jnp.zeros((2, 3))
    out = schedule.add_noise(x, n, 0.25)
    np.testing.assert_allclose(np.asarray(out), 0.75)
