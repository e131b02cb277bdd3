"""Video VAE: causal-3D-conv decoder + encoder.

Reference behavior: Sources/LTXVideo/Models/VAE/VideoDecoder.swift,
VideoEncoder.swift, VideoConvolution.swift. The reference decomposes every
3D conv into kt sequential 2D convs because MLX lacked conv3d
(VideoConvolution.swift:305-339); here XLA's native `conv_general_dilated`
does the full 3D conv in one op, channels-last (NDHWC) throughout (cuDNN's
preferred layout). The public interface stays (B, C, F, H, W) to match
the pipeline; transposes happen once at entry/exit.

Decoder architecture (reference: VideoDecoder.swift:278-450):
  conv_in 128->1024, then alternating [5x ResBlock group, depth-to-space x2
  upsample] x3 (1024->512->256->128), PixelNorm + AdaLN out, conv_out 128->48,
  spatial unpatchify 4x4. Output frames = 8*(latent_frames-1)+1.

Encoder (reference: VideoEncoder.swift:198-313): patchify 3->48, conv_in
48->128, 4 down blocks (128->256->512->1024->2048) with space-to-depth +
group-averaged residual, mid block, norm+SiLU, conv_out 2048->129, keep the
first 128 channels (mean). Encoder pads spatially with ZEROS, decoder with
REFLECT (reference: VideoEncoder.swift:227, VideoConvolution.swift:220).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ltx_jax.models.common import silu
from ltx_jax.ops.embeddings import get_timestep_embedding

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 128
    base_channels: int = 1024  # decoder conv_in output
    patch_size: int = 4
    blocks_per_group: int = 5
    causal: bool = False  # pipeline constructs the decoder non-causal
    timestep_conditioning: bool = False  # from vae/config.json
    decode_noise_scale: float = 0.025
    timestep_scale_multiplier: float = 1000.0
    # encoder
    encoder_causal: bool = True
    encoder_channels: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    encoder_resnets: Tuple[int, ...] = (4, 6, 6, 2)
    encoder_factors: Tuple[Tuple[int, int, int], ...] = (
        (1, 2, 2), (2, 1, 1), (2, 2, 2), (2, 2, 2)
    )

    def tiny(self) -> "VAEConfig":
        return dataclasses.replace(
            self,
            latent_channels=8,
            base_channels=64,
            blocks_per_group=1,
            encoder_channels=(8, 16, 32, 64, 128),
            encoder_resnets=(1, 1, 1, 1),
        )


# ---------------------------------------------------------------------------
# Core conv
# ---------------------------------------------------------------------------


def causal_conv3d(params, x, causal: bool, spatial_mode: str = "reflect",
                  stride=(1, 1, 1)):
    """3D conv on NDHWC input with the reference's padding semantics.

    params: {"w": (kt, kh, kw, C_in, C_out), "b": (C_out,) optional}.
    Temporal: causal -> replicate first frame (kt-1) at the front; else
    symmetric replicate. Spatial: reflect | zeros | replicate, symmetric.
    Reference: VideoConvolution.swift:238-347.
    """
    w = params["w"]
    kt, kh, kw = w.shape[0], w.shape[1], w.shape[2]

    pads = [(0, 0)]
    pads.append(((kt - 1, 0) if causal else ((kt - 1) // 2, kt - 1 - (kt - 1) // 2)))
    pads.append((kh // 2, kh // 2))
    pads.append((kw // 2, kw // 2))
    pads.append((0, 0))

    # temporal always replicates ("edge"); spatial uses the requested mode
    if kt > 1:
        x = jnp.pad(x, [pads[0], pads[1], (0, 0), (0, 0), pads[4]], mode="edge")
    mode = {"reflect": "reflect", "zeros": "constant", "replicate": "edge"}[
        spatial_mode
    ]
    if kh > 1 or kw > 1:
        x = jnp.pad(x, [(0, 0), (0, 0), pads[2], pads[3], (0, 0)], mode=mode)

    out = lax.conv_general_dilated(
        x, w.astype(x.dtype),
        window_strides=stride,
        padding="VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
    if "b" in params:
        out = out + params["b"].astype(x.dtype)
    return out


def conv3d_init(key, c_in: int, c_out: int, k: int = 3, dtype=jnp.float32):
    scale = (c_in * k * k * k) ** -0.5
    return {
        "w": (jax.random.normal(key, (k, k, k, c_in, c_out), jnp.float32) * scale
              ).astype(dtype),
        "b": jnp.zeros((c_out,), dtype),
    }


# ---------------------------------------------------------------------------
# Building blocks (all NDHWC)
# ---------------------------------------------------------------------------


def vae_pixel_norm(x, eps: float = 1e-8):
    """Channel RMS norm, channels-last (reference: VideoDecoder.swift:29-32)."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    ms = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf / jnp.sqrt(ms + eps)).astype(dtype)


def timestep_embedder(params, t_emb):
    """256 -> hidden -> out MLP with SiLU (reference: VideoDecoder.swift:37-52).
    Keys nested as timestep_embedder.{linear_1,linear_2} to match safetensors."""
    p = params["timestep_embedder"]
    h = t_emb @ p["linear_1"]["w"] + p["linear_1"]["b"]
    h = silu(h)
    return h @ p["linear_2"]["w"] + p["linear_2"]["b"]


def res_block(params, x, causal: bool, spatial_mode: str, time_emb=None):
    """PixelNorm -> scale/shift -> SiLU -> conv, twice, + residual.
    scale_shift_table (4, C): rows shift1, scale1, shift2, scale2; time_emb
    (B, 4C) adds to the table (reference: VideoDecoder.swift:75-131)."""
    table = params["scale_shift_table"].astype(jnp.float32)  # (4, C)
    c = table.shape[1]
    if time_emb is not None:
        b = time_emb.shape[0]
        ss = table[None] + time_emb.reshape(b, 4, c).astype(jnp.float32)
        ss = ss[:, :, None, None, None, :]  # (B, 4, 1, 1, 1, C)
    else:
        ss = table[None, :, None, None, None, :]  # (1, 4, 1, 1, 1, C)
    dt = x.dtype
    shift1, scale1 = ss[:, 0].astype(dt), (ss[:, 1] + 1).astype(dt)
    shift2, scale2 = ss[:, 2].astype(dt), (ss[:, 3] + 1).astype(dt)

    h = vae_pixel_norm(x) * scale1 + shift1
    h = causal_conv3d(params["conv1"], silu(h), causal, spatial_mode)
    h = vae_pixel_norm(h) * scale2 + shift2
    h = causal_conv3d(params["conv2"], silu(h), causal, spatial_mode)
    return h + x


def res_block_group(params, x, causal: bool, spatial_mode: str,
                    scaled_timestep=None):
    """5 res blocks sharing one timestep embedding
    (reference: VideoDecoder.swift:136-168)."""
    time_emb = None
    if scaled_timestep is not None:
        t_emb = get_timestep_embedding(scaled_timestep, 256)
        time_emb = timestep_embedder(params["time_embedder"],
                                     t_emb.astype(jnp.float32))
    h = x
    for block in params["res_blocks"]:
        h = res_block(block, h, causal, spatial_mode, time_emb)
    return h


def depth_to_space(x, factor, c_out: int):
    """NDHWC depth-to-space with channel order (c_out, ft, fh, fw)
    (reference: VideoDecoder.swift:201-212)."""
    ft, fh, fw = factor
    b, t, h, w, _ = x.shape
    out = x.reshape(b, t, h, w, c_out, ft, fh, fw)
    out = out.transpose(0, 1, 5, 2, 6, 3, 7, 4)  # (b, t, ft, h, fh, w, fw, c)
    return out.reshape(b, t * ft, h * fh, w * fw, c_out)


def space_to_depth(x, factor):
    """Inverse of depth_to_space; pads temporal front with replicated first
    frame if t % ft != 0 (reference: VideoEncoder.swift:38-65)."""
    ft, fh, fw = factor
    b, t, h, w, c = x.shape
    if t % ft != 0:
        pad_t = ft - (t % ft)
        x = jnp.pad(x, [(0, 0), (pad_t, 0), (0, 0), (0, 0), (0, 0)], mode="edge")
        t = x.shape[1]
    out = x.reshape(b, t // ft, ft, h // fh, fh, w // fw, fw, c)
    out = out.transpose(0, 1, 3, 5, 7, 2, 4, 6)  # (b, t', h', w', c, ft, fh, fw)
    return out.reshape(b, t // ft, h // fh, w // fw, c * ft * fh * fw)


def d2s_upsample(params, x, causal: bool, spatial_mode: str,
                 factor=(2, 2, 2)):
    """Conv -> depth-to-space + channel-tiled residual; first output frame is
    trimmed when the temporal factor > 1, giving 8*(F-1)+1 total
    (reference: VideoDecoder.swift:177-252)."""
    ft, fh, fw = factor
    prod = ft * fh * fw
    c_in = x.shape[-1]
    c_out = c_in // 2
    repeats = prod // 2

    # residual: d2s on raw input, trim, tile channels
    res = depth_to_space(x, factor, c_in // prod)
    if ft > 1:
        res = res[:, 1:]
    res = jnp.concatenate([res] * repeats, axis=-1)

    h = causal_conv3d(params["conv"], x, causal, spatial_mode)
    h = depth_to_space(h, factor, c_out)
    if ft > 1:
        h = h[:, 1:]
    return h + res


def decoder_unpatchify(x, p: int = 4):
    """(B, T, H, W, 48) -> (B, T, 4H, 4W, 3); channel order (c, i1, i2) with
    i1 -> width offset, i2 -> height offset
    (reference: VideoDecoder.swift:257-275)."""
    b, t, h, w, cp = x.shape
    c = cp // (p * p)
    out = x.reshape(b, t, h, w, c, p, p)  # (..., c, i1, i2)
    out = out.transpose(0, 1, 2, 6, 3, 5, 4)  # (b, t, h, i2, w, i1, c)
    return out.reshape(b, t, h * p, w * p, c)


def encoder_patchify(x, p: int = 4):
    """(B, T, H, W, 3) -> (B, T, H/4, W/4, 48); channel order (c, pw, ph)
    (reference: VideoEncoder.swift:13-32 — pW before pH in channels)."""
    b, t, h, w, c = x.shape
    out = x.reshape(b, t, h // p, p, w // p, p, c)  # (b,t,h',ph,w',pw,c)
    out = out.transpose(0, 1, 2, 4, 6, 5, 3)  # (b, t, h', w', c, pw, ph)
    return out.reshape(b, t, h // p, w // p, c * p * p)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def init_decoder_params(key, cfg: VAEConfig, dtype=jnp.float32):
    lc, bc, g = cfg.latent_channels, cfg.base_channels, cfg.blocks_per_group
    ks = iter(jax.random.split(key, 64))

    def group(c):
        return {
            "res_blocks": [
                {
                    "conv1": conv3d_init(next(ks), c, c, dtype=dtype),
                    "conv2": conv3d_init(next(ks), c, c, dtype=dtype),
                    "scale_shift_table": jnp.zeros((4, c), jnp.float32),
                }
                for _ in range(g)
            ],
            "time_embedder": {
                "timestep_embedder": {
                    "linear_1": {
                        "w": jax.random.normal(next(ks), (256, 256), jnp.float32)
                        * 256**-0.5,
                        "b": jnp.zeros((256,), jnp.float32),
                    },
                    "linear_2": {
                        "w": jax.random.normal(next(ks), (256, 4 * c), jnp.float32)
                        * 256**-0.5,
                        "b": jnp.zeros((4 * c,), jnp.float32),
                    },
                }
            },
        }

    def up(c_in):
        return {"conv": conv3d_init(next(ks), c_in, (c_in // 2) * 8, dtype=dtype)}

    return {
        "conv_in": conv3d_init(next(ks), lc, bc, dtype=dtype),
        "up_blocks_0": group(bc),
        "up_blocks_1": up(bc),
        "up_blocks_2": group(bc // 2),
        "up_blocks_3": up(bc // 2),
        "up_blocks_4": group(bc // 4),
        "up_blocks_5": up(bc // 4),
        "up_blocks_6": group(bc // 8),
        "conv_out": conv3d_init(next(ks), bc // 8, 3 * cfg.patch_size**2, dtype=dtype),
        "last_time_embedder": {
            "timestep_embedder": {
                "linear_1": {
                    "w": jax.random.normal(next(ks), (256, 256), jnp.float32)
                    * 256**-0.5,
                    "b": jnp.zeros((256,), jnp.float32),
                },
                "linear_2": {
                    "w": jax.random.normal(next(ks), (256, 2 * (bc // 8)), jnp.float32)
                    * 256**-0.5,
                    "b": jnp.zeros((2 * (bc // 8),), jnp.float32),
                },
            }
        },
        "last_scale_shift_table": jnp.zeros((2, bc // 8), jnp.float32),
        "mean_of_means": jnp.zeros((lc,), jnp.float32),
        "std_of_means": jnp.ones((lc,), jnp.float32),
    }


def decoder_forward(params, sample, cfg: VAEConfig,
                    timestep: Optional[float] = 0.05,
                    noise_key: Optional[jax.Array] = None):
    """Latent (B, C, F', H', W') -> pixels (B, 3, 8(F'-1)+1, 32H', 32W') in
    [-1, 1] (reference: VideoDecoder.swift:358-449).

    Decode-noise injection happens in NORMALIZED latent space before the
    per-channel denorm; both are tied to `timestep is not None`.
    """
    causal, mode = cfg.causal, "reflect"
    x = sample.transpose(0, 2, 3, 4, 1)  # -> NDHWC
    b = x.shape[0]

    scaled_ts = None
    if timestep is not None:
        if noise_key is not None:
            noise = jax.random.normal(noise_key, x.shape, x.dtype)
            x = noise * cfg.decode_noise_scale + (1.0 - cfg.decode_noise_scale) * x
        scaled_ts = jnp.full((b,), timestep, jnp.float32) * cfg.timestep_scale_multiplier

    # denormalize AFTER noise (reference: VideoDecoder.swift:377-382)
    mean = params["mean_of_means"].astype(jnp.float32)
    std = params["std_of_means"].astype(jnp.float32)
    x = (x.astype(jnp.float32) * std + mean).astype(x.dtype)

    x = causal_conv3d(params["conv_in"], x, causal, mode)
    x = res_block_group(params["up_blocks_0"], x, causal, mode, scaled_ts)
    x = d2s_upsample(params["up_blocks_1"], x, causal, mode)
    x = res_block_group(params["up_blocks_2"], x, causal, mode, scaled_ts)
    x = d2s_upsample(params["up_blocks_3"], x, causal, mode)
    x = res_block_group(params["up_blocks_4"], x, causal, mode, scaled_ts)
    x = d2s_upsample(params["up_blocks_5"], x, causal, mode)
    x = res_block_group(params["up_blocks_6"], x, causal, mode, scaled_ts)

    x = vae_pixel_norm(x)
    table = params["last_scale_shift_table"].astype(jnp.float32)  # (2, C)
    if scaled_ts is not None:
        t_emb = get_timestep_embedding(scaled_ts, 256)
        te = timestep_embedder(params["last_time_embedder"],
                               t_emb.astype(jnp.float32))
        ss = table[None] + te.reshape(b, 2, -1)
        shift = ss[:, 0, None, None, None, :]
        scale = ss[:, 1, None, None, None, :] + 1
    else:
        shift = table[None, 0, None, None, None, :]
        scale = table[None, 1, None, None, None, :] + 1
    x = x * scale.astype(x.dtype) + shift.astype(x.dtype)
    x = silu(x)

    x = causal_conv3d(params["conv_out"], x, causal, mode)
    x = decoder_unpatchify(x, cfg.patch_size)
    return x.transpose(0, 4, 1, 2, 3)  # -> (B, 3, T, H, W)


def _rgb_to_yuv420_u8(px):
    """(B, 3, F, H, W) f32 in [-1, 1] -> ONE packed uint8 (B, F, 3H/2, W):
    the planar I420 frame layout — full-res BT.601 Y on top, then the
    2x2-averaged U and V planes each reshaped to (H/4, W) rows.

    1.5 bytes/pixel instead of uint8 RGB's 3: the device->host pull pays
    per byte, and the MP4 encoder quantizes to yuv420p anyway —
    subsampling on DEVICE moves a lossy step the codec would take
    regardless to before the wire. ONE contiguous array keeps it one
    transfer per tile."""
    rgb = jnp.clip((px.astype(jnp.float32) + 1.0) / 2.0, 0.0, 1.0)
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5
    bb, ff, hh, ww = u.shape
    u = u.reshape(bb, ff, hh // 2, 2, ww // 2, 2).mean(axis=(3, 5))
    v = v.reshape(bb, ff, hh // 2, 2, ww // 2, 2).mean(axis=(3, 5))

    def q(x):
        return jnp.round(jnp.clip(x, 0.0, 1.0) * 255.0).astype(jnp.uint8)

    return jnp.concatenate(
        [q(y),
         q(u).reshape(bb, ff, hh // 4, ww),
         q(v).reshape(bb, ff, hh // 4, ww)], axis=2)


def _yuv420_to_rgb_np(packed):
    """Host inverse of _rgb_to_yuv420_u8: packed (B, F, 3H/2, W) uint8 ->
    (B, 3, F, H, W) f32 in [0, 1] (nearest-neighbor chroma upsample).
    H recovers from the packed shape (rows = 3H/2)."""
    import numpy as np

    bb, ff, rows, ww = packed.shape
    hh = rows * 2 // 3
    y = packed[:, :, :hh].astype(np.float32) / 255.0
    u = packed[:, :, hh: hh + hh // 4].reshape(bb, ff, hh // 2, ww // 2)
    v = packed[:, :, hh + hh // 4:].reshape(bb, ff, hh // 2, ww // 2)
    u = u.astype(np.float32) / 255.0 - 0.5
    v = v.astype(np.float32) / 255.0 - 0.5
    u = u.repeat(2, axis=-2).repeat(2, axis=-1)
    v = v.repeat(2, axis=-2).repeat(2, axis=-1)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=1), 0.0, 1.0)


@functools.lru_cache(maxsize=16)
def _decoder_exec(cfg: VAEConfig, timestep, to_uint8):
    """Compile-cached decoder program for decode_video.

    to_uint8: False = raw f32 pixels; True = on-device uint8 RGB (4x fewer
    transfer bytes); "yuv420" = on-device uint8 YUV 4:2:0 planes (8x fewer
    than f32 — see _rgb_to_yuv420_u8).

    The decoder must run as ONE compiled program, not eagerly: eager
    op-by-op execution loses cross-op fusion (every intermediate
    round-trips device memory) and compiles a program per distinct op
    shape on its first call."""

    def fn(params, tile, noise_key):
        px = decoder_forward(params, tile, cfg, timestep, noise_key)
        if to_uint8 == "yuv420":
            return _rgb_to_yuv420_u8(px)
        if to_uint8:
            px = jnp.round(
                jnp.clip((px.astype(jnp.float32) + 1.0) / 2.0, 0.0, 1.0)
                * 255.0).astype(jnp.uint8)
        return px

    return jax.jit(fn)


def decode_video(params, latent, cfg: VAEConfig,
                 timestep: Optional[float] = 0.05,
                 noise_key: Optional[jax.Array] = None,
                 tile_size: int = 0, tile_overlap: int = 1,
                 transfer_uint8: bool = False):
    """Decode with optional temporal tiling; returns (F, H, W, 3) in [0, 1].

    Tiles of `tile_size` latent frames with `tile_overlap` latent frames of
    overlap, blended linearly. The reference
    (VideoDecoder.swift:517-602) blends a fixed 8*overlap pixel window
    WITHOUT aligning chunk time bases, which drops 7 pixel frames per seam
    (each chunk re-anchors its first latent to a single pixel frame). Here
    stitching is frame-aligned — chunk pixel p>=1 of a chunk starting at
    latent s is global pixel 8s+p — so the tiled decode returns exactly
    8*(F-1)+1 frames and blends 8*(overlap-1) genuinely-coincident frames.
    Every full tile has the same shape -> one decoder compilation (plus one
    for a ragged tail).

    The stitched video assembles in a PREALLOCATED HOST buffer: at most TWO
    decoded tiles are device-resident at peak — the double-buffering below
    dispatches tile i+1 before pulling tile i so transfer overlaps compute
    (the untiled 241f@1024x640 output alone is ~1.9 GB f32 on top of
    decoder activations; estimate_memory_gb accounts 2x tile residency).
    The frames are headed to host-side MP4 export anyway.

    transfer_uint8: quantize each tile to uint8 ON DEVICE before the
    device->host pull (4x fewer bytes than f32; the MP4 encoder consumes
    uint8 anyway). Seam blending then happens in uint8 with f32 weights —
    max error 1/255, far below codec quantization. The pipeline enables
    this for tiled decodes; the default stays exact f32 for parity tests.
    """
    import numpy as np

    if latent.ndim == 4:
        latent = latent[None]
    f = latent.shape[2]

    def finish(x):
        frames = jnp.clip((x + 1.0) / 2.0, 0.0, 1.0)
        return frames[0].transpose(1, 2, 3, 0)

    if tile_size <= 0 or f <= tile_size:
        return finish(_decoder_exec(cfg, timestep, False)(
            params, latent, noise_key))

    tile_overlap = max(tile_overlap, 1)
    if tile_overlap >= tile_size:
        from ltx_jax.core.errors import InvalidConfigurationError

        raise InvalidConfigurationError(
            f"vae_tile_overlap ({tile_overlap}) must be < vae_tile_size "
            f"({tile_size}); stride would be <= 0")
    stride = tile_size - tile_overlap
    pixel_blend = 8 * (tile_overlap - 1)

    starts = []
    s = 0
    while s < f:
        starts.append(s)
        if s + tile_size >= f:
            break
        s += stride

    def launch(i):
        st = starts[i]
        key_i = None
        if noise_key is not None:
            key_i = jax.random.fold_in(noise_key, i)
        return _decoder_exec(cfg, timestep, transfer_uint8)(
            params, latent[:, :, st: st + tile_size], key_i)

    if transfer_uint8 == "yuv420":
        return _stitch_tiled_yuv(launch, starts, f, pixel_blend)

    out = None  # host (B, 3, 8(f-1)+1, H, W) float32, allocated on chunk 0
    filled = 0
    pending = launch(0)
    for idx in range(len(starts)):
        # double-buffer: dispatch the NEXT tile's decode (async) before the
        # device->host pull of this one, so transfer overlaps compute; pull
        # in the decoder's native dtype (bf16 halves the PCIe bytes)
        # and widen on the host.
        cur = pending
        if idx + 1 < len(starts):
            pending = launch(idx + 1)
        chunk = np.asarray(cur)
        if not transfer_uint8:
            chunk = chunk.astype(np.float32)
        del cur
        if idx == 0:
            b, _, _, hh, ww = chunk.shape
            out = np.empty((b, 3, 8 * (f - 1) + 1, hh, ww), chunk.dtype)
            out[:, :, : chunk.shape[2]] = chunk
            filled = chunk.shape[2]
        else:
            nxt = chunk[:, :, 1:]  # drop re-anchored first pixel frame
            if 0 < pixel_blend < filled and pixel_blend < nxt.shape[2]:
                wts = (np.arange(1, pixel_blend + 1, dtype=np.float32)
                       / (pixel_blend + 1)).reshape(1, 1, -1, 1, 1)
                blended = (out[:, :, filled - pixel_blend: filled] * (1 - wts)
                           + nxt[:, :, :pixel_blend] * wts)
                if transfer_uint8:
                    blended = np.round(blended)
                out[:, :, filled - pixel_blend: filled] = blended
                rest = nxt[:, :, pixel_blend:]
            else:
                rest = nxt
            out[:, :, filled: filled + rest.shape[2]] = rest
            filled += rest.shape[2]
    assert filled == out.shape[2], (filled, out.shape)
    if transfer_uint8:
        frames = out.astype(np.float32) / 255.0
    else:
        frames = np.clip((out + 1.0) / 2.0, 0.0, 1.0)
    # stays on host: the frames are headed to host-side export
    return frames[0].transpose(1, 2, 3, 0)


def _stitch_tiled_yuv(launch, starts, f: int, pixel_blend: int):
    """Tiled-decode host stitch for the yuv420 transfer mode: the same
    frame-aligned double-buffered loop as the uint8 path on the PACKED
    I420 frame (B, F_tile, 3H/2, W) — one device->host transfer per tile.
    Seam blending applies the same per-time-frame weights to every packed
    row (Y and the reshaped chroma alike), which is exactly the per-plane
    blend: blending commutes with the packing."""
    import numpy as np

    total = 8 * (f - 1) + 1
    out = None
    filled = 0
    pending = launch(0)
    for idx in range(len(starts)):
        cur = pending
        if idx + 1 < len(starts):
            pending = launch(idx + 1)
        chunk = np.asarray(cur)  # (B, F_tile, 3H/2, W) uint8
        del cur
        if idx == 0:
            b, _, rows, ww = chunk.shape
            out = np.empty((b, total, rows, ww), np.uint8)
            out[:, : chunk.shape[1]] = chunk
            filled = chunk.shape[1]
        else:
            nxt = chunk[:, 1:]  # drop the re-anchored first pixel frame
            n_new = nxt.shape[1]
            blend = pixel_blend if (0 < pixel_blend < filled
                                    and pixel_blend < n_new) else 0
            if blend:
                wts = (np.arange(1, blend + 1, dtype=np.float32)
                       / (blend + 1)).reshape(1, -1, 1, 1)
                out[:, filled - blend: filled] = np.round(
                    out[:, filled - blend: filled] * (1 - wts)
                    + nxt[:, :blend] * wts)
                out[:, filled: filled + n_new - blend] = nxt[:, blend:]
            else:
                out[:, filled: filled + n_new] = nxt
            filled += n_new - blend
    assert filled == total, (filled, total)
    rgb = _yuv420_to_rgb_np(out)  # (B, 3, F, H, W) f32 [0, 1]
    return rgb[0].transpose(1, 2, 3, 0)


def decode_video_sharded(params, latent, cfg: VAEConfig, mesh,
                         timestep: Optional[float] = 0.05,
                         noise_key: Optional[jax.Array] = None,
                         tile_overlap: int = 1, axis: str = "model",
                         transfer_uint8: bool = False):
    """Frame-axis SHARDED temporal-tiled decode (SURVEY.md §2.9 item 5).

    The sequential `decode_video` loop maps directly onto a shard_map over
    the latent frame axis: each device owns `stride` latent frames, fetches
    a RIGHT halo of `tile_overlap` frames from its neighbor via ppermute
    (the tile structure exploits the causal conv's front-only replicate
    padding: extra future frames never change earlier outputs), decodes its
    tile independently, then a second ppermute carries the LEFT neighbor's
    decoded seam pixels over for the same linear blend the host loop does.
    All n tiles decode CONCURRENTLY — wall-clock ~1/n of the host loop.

    Numerics match `decode_video(tile_size=stride+overlap, overlap)` exactly
    for timestep=None (with decode noise, the edge-padded last tile draws a
    differently-shaped noise block; everything before it is identical).

    Returns (F, H, W, 3) in [0, 1], gathered to the host.
    """
    import numpy as np
    try:
        from jax import shard_map
        _check_kw = {"check_vma": False}
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
        _check_kw = {"check_rep": False}
    from jax.sharding import PartitionSpec as P

    if latent.ndim == 4:
        latent = latent[None]
    b, c, f, lh, lw = latent.shape
    n = mesh.shape[axis]
    ov = max(tile_overlap, 1)
    stride = -(-f // n)  # ceil
    pad = n * stride - f
    if pad:
        latent = jnp.concatenate(
            [latent, jnp.repeat(latent[:, :, -1:], pad, axis=2)], axis=2)
    # right halo also needs edge frames past the final chunk
    latent_ext = jnp.concatenate(
        [latent, jnp.repeat(latent[:, :, -1:], ov, axis=2)], axis=2)
    tail = latent_ext[:, :, n * stride:]  # (B, C, ov, ...) replicated

    pb = 8 * (ov - 1)  # blended pixel frames per seam
    own = 8 * stride + 1  # pixels each device emits

    def body(lat, tail_pad):
        # lat: (B, C, stride, lh, lw) local shard; tail_pad replicated
        idx = jax.lax.axis_index(axis)
        perm_left = [(i, (i - 1) % n) for i in range(n)]  # to LEFT neighbor
        halo = jax.lax.ppermute(lat[:, :, :ov], axis, perm_left)
        # last device: neighbor's wrap-around halo is garbage; use edge pad
        halo = jnp.where(idx == n - 1, tail_pad, halo)
        tile = jnp.concatenate([lat, halo], axis=2)  # (B, C, stride+ov, ...)

        # per-tile decode noise, same fold_in indexing as the host loop
        k = None
        if noise_key is not None and timestep is not None:
            k = jax.random.fold_in(noise_key, idx)
        pixels = decoder_forward(params, tile, cfg, timestep, k)
        # (B, 3, 8*(stride+ov-1)+1, H, W); local q>=1 = global 8*s_i + q

        out = pixels[:, :, :own]
        if pb > 0:
            # seam blend: receive the LEFT neighbor's decode of our first
            # pb pixels (its local q' = 8*stride + q) and ramp toward ours
            # (reference blend: VideoDecoder.swift:560-585, frame-aligned)
            seam = pixels[:, :, 8 * stride + 1: 8 * stride + 1 + pb]
            perm_right = [(i, (i + 1) % n) for i in range(n)]
            prev_tail = jax.lax.ppermute(seam, axis, perm_right)
            w = (jnp.arange(1, pb + 1, dtype=jnp.float32)
                 / (pb + 1)).reshape(1, 1, -1, 1, 1)
            blended = prev_tail * (1 - w) + out[:, :, 1: 1 + pb] * w
            # device 0 has no left neighbor: keep its own pixels
            blended = jnp.where(idx == 0, out[:, :, 1: 1 + pb], blended)
            out = jnp.concatenate(
                [out[:, :, :1], blended, out[:, :, 1 + pb:]], axis=2)
        if transfer_uint8 == "yuv420":
            # packed I420 frame AFTER the seam blend: 8x fewer gather
            # bytes than f32, ONE array (the host converts post-gather)
            return _rgb_to_yuv420_u8(out)[None]
        if transfer_uint8:
            # quantize ON DEVICE (after the seam blend — cleaner than the
            # host loop, which must blend post-quantization): 4x fewer
            # device->host bytes for the gather below
            out = jnp.round(
                jnp.clip((out.astype(jnp.float32) + 1.0) / 2.0, 0.0, 1.0)
                * 255.0).astype(jnp.uint8)
        return out[None]  # (1, B, 3, own, H, W) -> stacked over devices

    spec_in = P(None, None, axis, None, None)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(spec_in, P()),
        out_specs=P(axis),
        **_check_kw,
    )
    chunks = fn(latent, tail)
    # host-side stitch: device 0 keeps its anchor pixel; others drop q=0
    # (owned by the left neighbor)
    # the stitched frames STAY on host (numpy, like decode_video): they are
    # headed to host-side MP4 export, and a jnp.asarray here would push the
    # full f32 video back through the wire the reduced-byte gather just
    # avoided (and the caller would pull it right back out)
    if transfer_uint8 == "yuv420":
        total = 8 * (f - 1) + 1
        a = np.asarray(chunks)  # (n, B, own, 3H/2, W) packed I420
        parts = [a[0]] + [a[i][:, 1:] for i in range(1, n)]
        packed = np.concatenate(parts, axis=1)[:, :total]
        rgb = _yuv420_to_rgb_np(packed)
        return rgb[0].transpose(1, 2, 3, 0)
    chunks = np.asarray(chunks)  # (n, B, 3, own, H, W)
    parts = [chunks[0]] + [chunks[i][:, :, 1:] for i in range(1, n)]
    full = np.concatenate(parts, axis=2)[:, :, : 8 * (f - 1) + 1]
    if transfer_uint8:
        frames = full.astype(np.float32) / 255.0
    else:
        frames = np.clip((full + 1.0) / 2.0, 0.0, 1.0)
    return frames[0].transpose(1, 2, 3, 0)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def init_encoder_params(key, cfg: VAEConfig, dtype=jnp.float32):
    chans = cfg.encoder_channels
    ks = iter(jax.random.split(key, 64))

    def enc_block(c, n):
        return {
            "resnets": [
                {
                    "conv1": conv3d_init(next(ks), c, c, dtype=dtype),
                    "conv2": conv3d_init(next(ks), c, c, dtype=dtype),
                }
                for _ in range(n)
            ]
        }

    down = []
    for i, n in enumerate(cfg.encoder_resnets):
        c_in, c_out = chans[i], chans[i + 1]
        prod = 1
        for fk in cfg.encoder_factors[i]:
            prod *= fk
        down.append({
            "resnets": enc_block(c_in, n)["resnets"],
            "downsamplers": {"conv": conv3d_init(next(ks), c_in, c_out // prod,
                                                 dtype=dtype)},
        })
    return {
        "conv_in": conv3d_init(next(ks), 48, chans[0], dtype=dtype),
        "down_blocks": down,
        "mid_block": enc_block(chans[-1], 2),
        "conv_out": conv3d_init(next(ks), chans[-1], cfg.latent_channels + 1,
                                dtype=dtype),
    }


def _encoder_res_block(params, x, causal, mode):
    """Norm -> SiLU -> conv x2 + residual, no conditioning
    (reference: VideoEncoder.swift:71-98)."""
    h = causal_conv3d(params["conv1"], silu(vae_pixel_norm(x)), causal, mode)
    h = causal_conv3d(params["conv2"], silu(vae_pixel_norm(h)), causal, mode)
    return h + x


def _s2d_downsample(params, x, factor, target_channels, causal, mode):
    """Conv -> s2d main path + group-averaged s2d residual
    (reference: VideoEncoder.swift:125-166)."""
    main = space_to_depth(causal_conv3d(params["conv"], x, causal, mode), factor)
    res = space_to_depth(x, factor)
    b, t, h, w, c = res.shape
    group = c // target_channels
    res = res.reshape(b, t, h, w, target_channels, group).mean(axis=-1)
    return main + res


def encoder_forward(params, pixels, cfg: VAEConfig):
    """(B, 3, T, H, W) in [-1, 1] -> latent mean (B, 128, T', H/32, W/32)
    (reference: VideoEncoder.swift:264-312)."""
    causal, mode = cfg.encoder_causal, "zeros"
    x = pixels.transpose(0, 2, 3, 4, 1)
    x = encoder_patchify(x, cfg.patch_size)
    x = causal_conv3d(params["conv_in"], x, causal, mode)
    for i, blk in enumerate(params["down_blocks"]):
        for rb in blk["resnets"]:
            x = _encoder_res_block(rb, x, causal, mode)
        x = _s2d_downsample(blk["downsamplers"], x, cfg.encoder_factors[i],
                            cfg.encoder_channels[i + 1], causal, mode)
    for rb in params["mid_block"]["resnets"]:
        x = _encoder_res_block(rb, x, causal, mode)
    x = silu(vae_pixel_norm(x))
    x = causal_conv3d(params["conv_out"], x, causal, mode)
    x = x[..., : cfg.latent_channels]  # mean only, drop logvar channel
    return x.transpose(0, 4, 1, 2, 3)


# Compiled entry point for the pipeline's I2V image encode (see
# gemma3.forward_hidden_states_jit for why eager is the wrong default here)
encoder_forward_jit = jax.jit(encoder_forward, static_argnums=2)
