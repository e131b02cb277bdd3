"""RoPE precompute + application golden tests (formulas cited from
reference LTXRoPE.swift in ops/rope.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.ops import rope


def test_position_grid_causal_fix_and_fps():
    grid = rope.create_position_grid(frames=3, height=2, width=2, fps=24.0)
    assert grid.shape == (3, 12)
    # frame 0: start=max(0+1-8,0)=0, end=max(8+1-8,0)=1 -> mid 0.5 / 24
    # frame 1: start=max(8-7,0)=1, end=max(16-7,0)=9 -> mid 5 / 24
    # frame 2: start=17-8=... start=max(16-7,0)=9, end=max(24-7,0)=17 -> mid 13/24
    t = grid[0].reshape(3, 2, 2)
    np.testing.assert_allclose(t[0], 0.5 / 24.0, rtol=1e-6)
    np.testing.assert_allclose(t[1], 5.0 / 24.0, rtol=1e-6)
    np.testing.assert_allclose(t[2], 13.0 / 24.0, rtol=1e-6)
    # spatial middles: i*32 + 16
    h = grid[1].reshape(3, 2, 2)
    np.testing.assert_allclose(h[:, 0, :], 16.0)
    np.testing.assert_allclose(h[:, 1, :], 48.0)
    w = grid[2].reshape(3, 2, 2)
    np.testing.assert_allclose(w[:, :, 0], 16.0)
    np.testing.assert_allclose(w[:, :, 1], 48.0)


def test_audio_position_grid():
    g = rope.create_audio_position_grid(3)
    # frame 0: start=max(0+1-4,0)=0, end=max(4+1-4,0)=1 -> 0.5*160/16000
    # frame 1: start=max(4-3,0)=1, end=max(8-3,0)=5 -> 3*0.01
    np.testing.assert_allclose(g[0, 0], 0.5 * 160 / 16000, rtol=1e-6)
    np.testing.assert_allclose(g[0, 1], 3.0 * 160 / 16000, rtol=1e-6)


def test_freq_indices_log_spacing():
    idx = rope._freq_indices_f64(dim=4096, n_pos_dims=3, theta=10000.0)
    # numIndices = 4096 // 6 = 682; first = theta^0 * pi/2; last = theta^1 * pi/2
    assert idx.shape == (682,)
    assert idx[0] == pytest.approx(np.pi / 2)
    assert idx[-1] == pytest.approx(10000.0 * np.pi / 2)
    # log-spaced: ratios constant
    ratios = idx[1:] / idx[:-1]
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-12)


def test_precompute_split_shapes_and_padding():
    dim, heads = 4096, 32
    grid = rope.create_position_grid(2, 2, 2)
    cos, sin = rope.precompute_freqs_cis(grid, dim, num_heads=heads)
    # freq_dim = 682*3 = 2046, padded to dim/2 = 2048 -> per-head 64
    assert cos.shape == (heads, 8, 64)
    assert sin.shape == (heads, 8, 64)
    # pad goes at the FRONT of the flat (T, 2048) table -> head 0, first 2 slots
    assert cos[0, 0, 0] == 1.0 and cos[0, 0, 1] == 1.0
    assert sin[0, 0, 0] == 0.0 and sin[0, 0, 1] == 0.0
    np.testing.assert_allclose(cos**2 + sin**2, 1.0, atol=1e-6)


def test_precompute_matches_manual_f64():
    """Elementwise golden check against a direct f64 recomputation."""
    dim, heads, n_dims = 24, 2, 3
    grid = rope.create_position_grid(2, 1, 2)  # T = 4
    cos, sin = rope.precompute_freqs_cis(
        grid, dim, theta=100.0, max_pos=[20, 2048, 2048], num_heads=heads
    )
    # manual: numIndices = 24 // 6 = 4
    t_lin = np.arange(4) / 3.0
    indices = 100.0**t_lin * np.pi / 2
    maxp = np.array([20.0, 2048.0, 2048.0])
    scaled = (grid.astype(np.float64) / maxp[:, None]) * 2 - 1  # (3, 4)
    freqs = np.zeros((4, 12))
    for t in range(4):
        for fi in range(4):
            for d in range(3):
                freqs[t, fi * 3 + d] = indices[fi] * scaled[d, t]
    c = np.cos(freqs)  # (T=4, 12) == dim/2, no padding
    c = c.reshape(4, heads, 6).transpose(1, 0, 2)
    s = np.sin(freqs).reshape(4, heads, 6).transpose(1, 0, 2)
    np.testing.assert_allclose(cos, c.astype(np.float32), atol=1e-7)
    np.testing.assert_allclose(sin, s.astype(np.float32), atol=1e-7)


def test_apply_split_rope_flat_vs_headed():
    """The flat (B,T,H*D) path must equal reshaping to heads first."""
    rng = np.random.default_rng(0)
    b, h, t, d = 2, 4, 6, 8
    x = jnp.asarray(rng.standard_normal((b, t, h * d)), jnp.float32)
    cos = jnp.asarray(rng.uniform(-1, 1, (h, t, d // 2)), jnp.float32)
    sin = jnp.asarray(rng.uniform(-1, 1, (h, t, d // 2)), jnp.float32)

    flat_out = rope.apply_rope_split(x, cos, sin)

    x4 = x.reshape(b, t, h, d).transpose(0, 2, 1, 3)
    headed_out = rope.apply_rope_split(x4, cos, sin)
    headed_back = headed_out.transpose(0, 2, 1, 3).reshape(b, t, h * d)
    np.testing.assert_allclose(
        np.asarray(flat_out), np.asarray(headed_back), atol=1e-6
    )


def test_apply_split_rope_rotation_golden():
    """Pure rotation: |x| preserved pairwise, exact formula check."""
    x = jnp.asarray([[[1.0, 2.0, 3.0, 4.0]]], jnp.float32)  # (1, 1, 4): 1 head d=4
    cos = jnp.full((1, 1, 2), np.cos(0.3), jnp.float32)
    sin = jnp.full((1, 1, 2), np.sin(0.3), jnp.float32)
    out = np.asarray(rope.apply_rope_split(x, cos, sin))[0, 0]
    c, s = np.cos(0.3), np.sin(0.3)
    expected = [1 * c - 3 * s, 2 * c - 4 * s, 3 * c + 1 * s, 4 * c + 2 * s]
    np.testing.assert_allclose(out, expected, rtol=1e-6)


def test_apply_interleaved_golden():
    x = jnp.asarray([[1.0, 2.0, 3.0, 4.0]], jnp.float32)
    theta = 0.5
    c, s = np.cos(theta), np.sin(theta)
    cos = jnp.full((1, 4), c, jnp.float32)
    sin = jnp.full((1, 4), s, jnp.float32)
    out = np.asarray(rope.apply_rope_interleaved(x, cos, sin))[0]
    expected = [1 * c - 2 * s, 2 * c + 1 * s, 3 * c - 4 * s, 4 * c + 3 * s]
    np.testing.assert_allclose(out, expected, rtol=1e-6)


def test_apply_rope_preserves_dtype():
    x = jnp.ones((1, 2, 8), jnp.bfloat16)
    cos = jnp.ones((2, 2, 2), jnp.float32)
    sin = jnp.zeros((2, 2, 2), jnp.float32)
    out = rope.apply_rope_split(x, cos, sin)
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(out, np.float32), 1.0)
