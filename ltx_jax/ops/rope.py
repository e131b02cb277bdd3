"""3D fractional-position rotary embeddings for the LTX-2 DiT.

Two parts with very different execution homes:

* Precompute (`precompute_freqs_cis`, `create_position_grid`): runs ONCE per
  latent geometry on the host in numpy float64, then ships float32 cos/sin
  tables to the device. The reference documents that float32 frequency math
  visibly degrades quality over 48 blocks x 40 steps
  (reference: Sources/LTXVideo/Models/Transformer/LTXRoPE.swift:309-316), and
  accelerators run f64 slowly or not at all, so host-numpy is both the
  parity-exact and the fast answer — unlike the reference's scalar Swift
  loops this is
  vectorized numpy, so it is microseconds, not the multi-second host
  bottleneck called out in SURVEY.md §3.6.

* Apply (`apply_rope`): pure jnp, float32 rotation math with cast back to the
  input dtype, traced into the jitted DiT step
  (reference: LTXRoPE.swift:84-149).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Position grids (host-side, tiny)
# ---------------------------------------------------------------------------


def create_position_grid(
    frames: int,
    height: int,
    width: int,
    temporal_scale: int = 8,
    spatial_scale: int = 32,
    fps: float = 24.0,
    causal_fix: bool = True,
) -> np.ndarray:
    """Pixel-space middle coordinates per latent token, shape (3, T) float32.

    For latent frame i the pixel bounds are [i*ts, (i+1)*ts]; the causal fix
    shifts both by (1 - ts) clamped at 0 (frame 0 covers only pixel frame 0),
    and temporal coords are divided by fps. Spatial coords are patch middles
    i*ss + ss/2. Reference: LTXRoPE.swift:552-610.
    """
    i = np.arange(frames, dtype=np.float32)
    ts = np.float32(temporal_scale)
    start = i * ts
    end = (i + 1) * ts
    if causal_fix:
        start = np.maximum(start + (1 - ts), 0)
        end = np.maximum(end + (1 - ts), 0)
    t_coords = ((start + end) / 2.0) / np.float32(fps)

    ss = np.float32(spatial_scale)
    h_coords = np.arange(height, dtype=np.float32) * ss + ss / 2
    w_coords = np.arange(width, dtype=np.float32) * ss + ss / 2

    t_grid = np.broadcast_to(t_coords[:, None, None], (frames, height, width))
    h_grid = np.broadcast_to(h_coords[None, :, None], (frames, height, width))
    w_grid = np.broadcast_to(w_coords[None, None, :], (frames, height, width))

    return np.stack(
        [t_grid.reshape(-1), h_grid.reshape(-1), w_grid.reshape(-1)], axis=0
    ).astype(np.float32)


def create_audio_position_grid(
    audio_frames: int,
    hop_length: int = 160,
    sample_rate: int = 16000,
    temporal_scale: int = 4,
    causal_offset: int = 1,
) -> np.ndarray:
    """1D temporal positions for audio tokens, shape (1, T) float32.

    mid_seconds of each latent frame's mel-span; reference:
    LTXRoPE.swift:627-655.
    """
    i = np.arange(audio_frames, dtype=np.float32)
    scale = np.float32(temporal_scale)
    off = np.float32(causal_offset)
    start_mel = np.maximum(i * scale + off - scale, 0)
    end_mel = np.maximum((i + 1) * scale + off - scale, 0)
    mid_s = (start_mel + end_mel) / 2.0 * np.float32(hop_length) / np.float32(sample_rate)
    return mid_s[None, :].astype(np.float32)


# ---------------------------------------------------------------------------
# Frequency precompute (host-side numpy, float64)
# ---------------------------------------------------------------------------


def _freq_indices_f64(dim: int, n_pos_dims: int, theta: float) -> np.ndarray:
    """Log-spaced frequency indices in float64.

    indices[k] = theta^t_k * pi/2 with t_k linearly spaced over [0, 1] in
    log_theta space, numIndices = dim // (2 * n_pos_dims).
    Reference: LTXRoPE.swift:393-404.
    """
    num_indices = max(1, dim // (2 * n_pos_dims))
    if num_indices > 1:
        t = np.arange(num_indices, dtype=np.float64) / np.float64(num_indices - 1)
    else:
        t = np.zeros((1,), dtype=np.float64)
    return np.power(np.float64(theta), t) * (np.pi / 2.0)


def precompute_freqs_cis(
    grid: np.ndarray,
    dim: int,
    theta: float = 10000.0,
    max_pos: Sequence[int] = (20, 2048, 2048),
    num_heads: int = 32,
    rope_type: str = "split",
) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 cos/sin tables, returned as float32 numpy arrays.

    grid: (n_pos_dims, T) float32 position grid (batch-independent).
    Returns, for split RoPE: (cos, sin) each (num_heads, T, dim//2//num_heads);
    for interleaved: (cos, sin) each (T, dim_padded).

    Math (reference: LTXRoPE.swift:375-527):
      frac[t, d]   = grid[d, t] / max_pos[d]
      scaled[t, d] = 2*frac - 1                       (in [-1, 1])
      freqs[t, k, d] = indices[k] * scaled[t, d]      flattened k-major
      split: pad the FRONT with (cos=1, sin=0) up to dim/2, reshape to heads.
    """
    grid64 = grid.astype(np.float64)
    n_pos_dims, seq_len = grid64.shape
    indices = _freq_indices_f64(dim, n_pos_dims, theta)
    num_indices = indices.shape[0]

    max_pos_arr = np.asarray(max_pos, dtype=np.float64)[:, None]  # (n_dims, 1)
    scaled = (grid64 / max_pos_arr) * 2.0 - 1.0  # (n_dims, T)

    # (T, num_indices, n_dims) -> flatten to (T, num_indices * n_dims), k-major
    freqs = indices[None, :, None] * scaled.T[:, None, :]
    freq_dim = num_indices * n_pos_dims
    freqs = freqs.reshape(seq_len, freq_dim)

    cos = np.cos(freqs)
    sin = np.sin(freqs)

    if rope_type == "split":
        expected = dim // 2
        pad = max(0, expected - freq_dim)
        if pad:
            cos = np.concatenate([np.ones((seq_len, pad)), cos], axis=-1)
            sin = np.concatenate([np.zeros((seq_len, pad)), sin], axis=-1)
        per_head = (pad + freq_dim) // num_heads
        cos = cos.reshape(seq_len, num_heads, per_head).transpose(1, 0, 2)
        sin = sin.reshape(seq_len, num_heads, per_head).transpose(1, 0, 2)
        return cos.astype(np.float32), sin.astype(np.float32)

    if rope_type == "interleaved":
        n_elem = 2 * n_pos_dims
        pad = dim % n_elem
        cos = np.repeat(cos, 2, axis=-1)
        sin = np.repeat(sin, 2, axis=-1)
        if pad:
            cos = np.concatenate([np.ones((seq_len, pad)), cos], axis=-1)
            sin = np.concatenate([np.zeros((seq_len, pad)), sin], axis=-1)
        return cos.astype(np.float32), sin.astype(np.float32)

    raise ValueError(f"unknown rope_type: {rope_type}")


def video_rope(
    frames: int,
    height: int,
    width: int,
    dim: int,
    num_heads: int,
    theta: float = 10000.0,
    max_pos: Sequence[int] = (20, 2048, 2048),
    fps: float = 24.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (H, T, head_dim/2) for the video DiT's 3D split RoPE."""
    grid = create_position_grid(frames, height, width, fps=fps)
    return precompute_freqs_cis(
        grid, dim, theta=theta, max_pos=max_pos, num_heads=num_heads
    )


# ---------------------------------------------------------------------------
# Apply (device-side jnp)
# ---------------------------------------------------------------------------


def apply_rope_split(x, cos, sin):
    """Split RoPE: contiguous halves rotate against each other in float32.

    x: (B, T, H*D) flat (DiT pre-head-split semantics,
       reference: LTXAttention.swift:177-189) or (B, H, T, D) (connector
       post-head-split semantics, reference: LTXTextEncoder.swift:248-257).
    cos/sin: (H, T, D/2) or (B, H, T, D/2).

    first'  = first * cos - second * sin
    second' = second * cos + first * sin
    Reference: LTXRoPE.swift:84-149.
    """
    dtype = x.dtype
    if cos.ndim == 3:
        cos = cos[None]
        sin = sin[None]
    h = cos.shape[1]
    t = cos.shape[2]

    flat = x.ndim == 3
    xf = x.astype(jnp.float32)
    if flat:
        b = x.shape[0]
        xf = xf.reshape(b, t, h, -1).transpose(0, 2, 1, 3)  # (B, H, T, D)

    d = xf.shape[-1]
    first, second = xf[..., : d // 2], xf[..., d // 2 :]
    cosf = cos.astype(jnp.float32)
    sinf = sin.astype(jnp.float32)
    out = jnp.concatenate(
        [first * cosf - second * sinf, second * cosf + first * sinf], axis=-1
    )

    if flat:
        out = out.transpose(0, 2, 1, 3).reshape(x.shape)
    return out.astype(dtype)


def apply_rope_interleaved(x, cos, sin):
    """Interleaved RoPE: adjacent pairs (d0,d1),(d2,d3)... rotate.

    x: (..., T, D); cos/sin broadcastable to x. Reference:
    LTXRoPE.swift:45-79.
    """
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    shape = xf.shape
    xf2 = xf.reshape(*shape[:-1], shape[-1] // 2, 2)
    t1, t2 = xf2[..., 0], xf2[..., 1]
    rot = jnp.stack([-t2, t1], axis=-1).reshape(shape)
    out = xf * cos.astype(jnp.float32) + rot * sin.astype(jnp.float32)
    return out.astype(dtype)
