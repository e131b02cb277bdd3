"""Dual audio/video diffusion transformer.

Reference behavior: Sources/LTXVideo/Models/Transformer/LTX2Transformer.swift
and LTX2TransformerBlock.swift. Each of the 48 blocks runs 8 phases:
video self-attn, audio self-attn, video text cross-attn, audio text
cross-attn, A2V cross-modal attn (gated), V2A cross-modal attn, video FFN,
audio FFN. Unlike the video-only block (weightless adaln), the dual block has
LEARNABLE RMSNorms norm1/2/3 and audio_norm1/2/3
(reference: LTX2TransformerBlock.swift:71-86).

Cross-modal attention aligns the streams on TIME: both sides use
temporal-only 1D RoPE at the audio inner dim
(reference: LTX2Transformer.swift:196-236).

Functional pytree + lax.scan over stacked blocks, same conventions as
models/dit.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ltx_jax.core.config import TransformerConfig
from ltx_jax.kernels.quantization import linear_any
from ltx_jax.models.common import gelu_tanh, linear_init, silu
from ltx_jax.models.dit import (
    adaln_single,
    caption_projection,
    feed_forward,
)
from ltx_jax.ops.attention import sdpa
from ltx_jax.ops.normalization import layer_norm_no_affine, rms_norm
from ltx_jax.ops import rope as rope_ops
from ltx_jax.ops.rope import apply_rope_split


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _attn_init(key, query_dim, context_dim, inner_dim, dtype):
    ks = jax.random.split(key, 4)
    return {
        "to_q": linear_init(ks[0], query_dim, inner_dim, dtype),
        "to_k": linear_init(ks[1], context_dim, inner_dim, dtype),
        "to_v": linear_init(ks[2], context_dim, inner_dim, dtype),
        "to_out": linear_init(ks[3], inner_dim, query_dim, dtype),
        "q_norm": {"w": jnp.ones((inner_dim,), dtype)},
        "k_norm": {"w": jnp.ones((inner_dim,), dtype)},
    }


def _block_init(key, cfg: TransformerConfig, dtype):
    dv, da = cfg.inner_dim, cfg.audio_inner_dim
    ks = jax.random.split(key, 8)
    return {
        # video
        "norm1": {"w": jnp.ones((dv,), dtype)},
        "attn1": _attn_init(ks[0], dv, dv, dv, dtype),
        "norm2": {"w": jnp.ones((dv,), dtype)},
        "attn2": _attn_init(ks[1], dv, cfg.cross_attention_dim, dv, dtype),
        "norm3": {"w": jnp.ones((dv,), dtype)},
        "ff": {
            "project_in": linear_init(ks[2], dv, cfg.ffn_dim, dtype),
            "project_out": linear_init(ks[3], cfg.ffn_dim, dv, dtype),
        },
        "scale_shift_table": jnp.zeros((6, dv), jnp.float32),
        # audio
        "audio_norm1": {"w": jnp.ones((da,), dtype)},
        "audio_attn1": _attn_init(ks[4], da, da, da, dtype),
        "audio_norm2": {"w": jnp.ones((da,), dtype)},
        "audio_attn2": _attn_init(ks[5], da, cfg.audio_cross_attention_dim,
                                  da, dtype),
        "audio_norm3": {"w": jnp.ones((da,), dtype)},
        "audio_ff": {
            "project_in": linear_init(ks[6], da, 4 * da, dtype),
            "project_out": linear_init(ks[7], 4 * da, da, dtype),
        },
        "audio_scale_shift_table": jnp.zeros((6, da), jnp.float32),
        # cross-modal (both at audio inner dim)
        "audio_to_video_norm": {"w": jnp.ones((dv,), dtype)},
        "audio_to_video_attn": _attn_init(
            jax.random.fold_in(key, 100), dv, da, da, dtype),
        "video_to_audio_norm": {"w": jnp.ones((da,), dtype)},
        "video_to_audio_attn": _attn_init(
            jax.random.fold_in(key, 101), da, dv, da, dtype),
        "scale_shift_table_a2v_ca_video": jnp.zeros((5, dv), jnp.float32),
        "scale_shift_table_a2v_ca_audio": jnp.zeros((5, da), jnp.float32),
    }


def init_params(key, cfg: TransformerConfig, dtype=jnp.bfloat16):
    dv, da = cfg.inner_dim, cfg.audio_inner_dim
    ks = jax.random.split(key, 16)
    blocks = [
        _block_init(k, cfg, dtype) for k in jax.random.split(ks[0], cfg.num_layers)
    ]

    def adaln_init(k, d, n):
        k1, k2, k3 = jax.random.split(k, 3)
        return {
            "emb": {
                "linear_1": linear_init(k1, 256, d, dtype),
                "linear_2": linear_init(k2, d, d, dtype),
            },
            "linear": linear_init(k3, d, n * d, dtype),
        }

    return {
        "patchify_proj": linear_init(ks[1], cfg.in_channels, dv, dtype),
        "adaln_single": adaln_init(ks[2], dv, 6),
        "caption_projection": {
            "linear_1": linear_init(ks[3], cfg.caption_channels, dv, dtype),
            "linear_2": linear_init(ks[4], dv, dv, dtype),
        },
        "proj_out": linear_init(ks[5], dv, cfg.out_channels, dtype),
        "scale_shift_table": jnp.zeros((2, dv), jnp.float32),
        "audio_patchify_proj": linear_init(ks[6], cfg.audio_in_channels, da,
                                           dtype),
        "audio_adaln_single": adaln_init(ks[7], da, 6),
        "audio_caption_projection": {
            "linear_1": linear_init(ks[8], cfg.caption_channels, da, dtype),
            "linear_2": linear_init(ks[9], da, da, dtype),
        },
        "audio_proj_out": linear_init(ks[10], da, cfg.audio_out_channels,
                                      dtype),
        "audio_scale_shift_table": jnp.zeros((2, da), jnp.float32),
        "av_ca_video_scale_shift_adaln_single": adaln_init(ks[11], dv, 4),
        "av_ca_a2v_gate_adaln_single": adaln_init(ks[12], dv, 1),
        "av_ca_audio_scale_shift_adaln_single": adaln_init(ks[13], da, 4),
        "av_ca_v2a_gate_adaln_single": adaln_init(ks[14], da, 1),
        "blocks": jax.tree.map(lambda *xs: jnp.stack(xs), *blocks),
    }


# ---------------------------------------------------------------------------
# RoPE preparation (host-side)
# ---------------------------------------------------------------------------


def prepare_av_ropes(cfg: TransformerConfig, frames, height, width,
                     audio_frames, fps: float = 24.0):
    """(video 3D, audio 1D, cross-video 1D, cross-audio 1D) cos/sin tables.

    Cross-modal tables use TEMPORAL-ONLY coordinates at the audio inner dim
    with audio max_pos (reference: LTX2Transformer.swift:196-236).
    """
    video = rope_ops.video_rope(
        frames, height, width, cfg.inner_dim, cfg.num_heads,
        theta=cfg.rope_theta, max_pos=cfg.max_pos, fps=fps,
    )
    audio_grid = rope_ops.create_audio_position_grid(audio_frames)
    audio = rope_ops.precompute_freqs_cis(
        audio_grid, cfg.audio_inner_dim, theta=cfg.rope_theta,
        max_pos=cfg.audio_max_pos, num_heads=cfg.audio_num_heads,
    )
    video_grid = rope_ops.create_position_grid(frames, height, width, fps=fps)
    cross_video = rope_ops.precompute_freqs_cis(
        video_grid[0:1], cfg.audio_cross_attention_dim, theta=cfg.rope_theta,
        max_pos=cfg.audio_max_pos, num_heads=cfg.audio_num_heads,
    )
    cross_audio = rope_ops.precompute_freqs_cis(
        audio_grid, cfg.audio_cross_attention_dim, theta=cfg.rope_theta,
        max_pos=cfg.audio_max_pos, num_heads=cfg.audio_num_heads,
    )
    as_j = lambda pair: (jnp.asarray(pair[0]), jnp.asarray(pair[1]))
    return as_j(video), as_j(audio), as_j(cross_video), as_j(cross_audio)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention(p, x, context, heads, head_dim, bias=None, q_rope=None,
               k_rope=None, eps=1e-6, sdpa_impl="auto"):
    """LTXAttention with separate Q/K RoPE tables (cross-modal needs kPe;
    reference: LTXAttention.swift:160-218)."""
    b, tq, _ = x.shape
    tk = context.shape[1]
    q = linear_any(p["to_q"], x)
    k = linear_any(p["to_k"], context)
    v = linear_any(p["to_v"], context)
    # see models/dit.py::attention — pins the SDPA layout relayout to the
    # per-layer v activation instead of a hoisted copy of the stacked
    # to_v weight (768 MB per attention at DiT scale)
    v = jax.lax.optimization_barrier(v)
    q = rms_norm(q, p["q_norm"]["w"], eps=eps)
    k = rms_norm(k, p["k_norm"]["w"], eps=eps)
    if q_rope is not None:
        q = apply_rope_split(q, *q_rope)
        k = apply_rope_split(k, *(k_rope if k_rope is not None else q_rope))
    q = q.reshape(b, tq, heads, head_dim).transpose(0, 2, 1, 3)
    k = k.reshape(b, tk, heads, head_dim).transpose(0, 2, 1, 3)
    v = v.reshape(b, tk, heads, head_dim).transpose(0, 2, 1, 3)
    out = sdpa(q, k, v, bias=bias, impl=sdpa_impl)
    out = out.transpose(0, 2, 1, 3).reshape(b, tq, heads * head_dim)
    return linear_any(p["to_out"], out)


def _mod(norm_w, x, scale, shift, eps):
    """Learnable RMSNorm then (1+scale)+shift modulation."""
    return rms_norm(x, norm_w, eps=eps) * (1 + scale) + shift


def _ada6(table, ts_emb):
    """(6, D) table + (B, T', 6, D) timestep -> six (B, T', D) tensors."""
    vals = table[None, None].astype(jnp.float32) + ts_emb.astype(jnp.float32)
    return [vals[:, :, i] for i in range(6)]


def av_block_forward(p, video_x, audio_x, ctx_v, ctx_a, ts_v, ts_a,
                     cross_v_ss, cross_a_ss, ropes, bias_v, bias_a,
                     cfg: TransformerConfig, sdpa_impl="auto"):
    """One dual block, 8 phases (reference: LTX2TransformerBlock.swift:174-297)."""
    eps = cfg.norm_eps
    video_rope, audio_rope, cross_v_rope, cross_a_rope = ropes
    dt = video_x.dtype

    v_sh, v_sc, v_g, v_sh2, v_sc2, v_g2 = [
        t.astype(dt) for t in _ada6(p["scale_shift_table"], ts_v)]
    a_sh, a_sc, a_g, a_sh2, a_sc2, a_g2 = [
        t.astype(dt) for t in _ada6(p["audio_scale_shift_table"], ts_a)]

    # 1-2: self attention
    normed = _mod(p["norm1"]["w"], video_x, v_sc, v_sh, eps)
    video_x = video_x + v_g * _attention(
        p["attn1"], normed, normed, cfg.num_heads, cfg.head_dim,
        q_rope=video_rope, eps=eps, sdpa_impl=sdpa_impl)
    normed = _mod(p["audio_norm1"]["w"], audio_x, a_sc, a_sh, eps)
    audio_x = audio_x + a_g * _attention(
        p["audio_attn1"], normed, normed, cfg.audio_num_heads,
        cfg.audio_head_dim, q_rope=audio_rope, eps=eps, sdpa_impl=sdpa_impl)

    # 3-4: text cross attention (norm without modulation)
    normed = rms_norm(video_x, p["norm2"]["w"], eps=eps)
    video_x = video_x + _attention(
        p["attn2"], normed, ctx_v, cfg.num_heads, cfg.head_dim,
        bias=bias_v, eps=eps, sdpa_impl=sdpa_impl)
    normed = rms_norm(audio_x, p["audio_norm2"]["w"], eps=eps)
    audio_x = audio_x + _attention(
        p["audio_attn2"], normed, ctx_a, cfg.audio_num_heads,
        cfg.audio_head_dim, bias=bias_a, eps=eps, sdpa_impl=sdpa_impl)

    # 5-6: cross-modal (5-value SSTs + global cross-modal embeddings)
    v_ca = (p["scale_shift_table_a2v_ca_video"][None, None].astype(jnp.float32)
            + cross_v_ss.astype(jnp.float32))
    a_ca = (p["scale_shift_table_a2v_ca_audio"][None, None].astype(jnp.float32)
            + cross_a_ss.astype(jnp.float32))
    vA2Vsc, vA2Vsh, vV2Asc, vV2Ash, vA2Vg = [
        v_ca[:, :, i].astype(dt) for i in range(5)]
    aA2Vsc, aA2Vsh, aV2Asc, aV2Ash, aV2Ag = [
        a_ca[:, :, i].astype(dt) for i in range(5)]

    norm_v_ca = rms_norm(video_x, p["audio_to_video_norm"]["w"], eps=eps)
    norm_a_ca = rms_norm(audio_x, p["video_to_audio_norm"]["w"], eps=eps)

    mod_v_a2v = norm_v_ca * (1 + vA2Vsc) + vA2Vsh
    mod_a_a2v = norm_a_ca * (1 + aA2Vsc) + aA2Vsh
    a2v = _attention(
        p["audio_to_video_attn"], mod_v_a2v, mod_a_a2v, cfg.audio_num_heads,
        cfg.audio_head_dim, q_rope=cross_v_rope, k_rope=cross_a_rope,
        eps=eps, sdpa_impl=sdpa_impl)
    video_x = video_x + a2v * vA2Vg

    mod_a_v2a = norm_a_ca * (1 + aV2Asc) + aV2Ash
    mod_v_v2a = norm_v_ca * (1 + vV2Asc) + vV2Ash
    v2a = _attention(
        p["video_to_audio_attn"], mod_a_v2a, mod_v_v2a, cfg.audio_num_heads,
        cfg.audio_head_dim, q_rope=cross_a_rope, k_rope=cross_v_rope,
        eps=eps, sdpa_impl=sdpa_impl)
    audio_x = audio_x + v2a * aV2Ag

    # 7-8: FFN
    normed = _mod(p["norm3"]["w"], video_x, v_sc2, v_sh2, eps)
    video_x = video_x + v_g2 * feed_forward(p["ff"], normed)
    normed = _mod(p["audio_norm3"]["w"], audio_x, a_sc2, a_sh2, eps)
    audio_x = audio_x + a_g2 * feed_forward(p["audio_ff"], normed)

    return video_x, audio_x


def _prepare_stream(proj_p, adaln_p, cap_p, latent, context, timesteps,
                    cfg_d, scale_mult, batch, dtype):
    x = linear_any(proj_p, latent)
    scaled = timesteps.astype(jnp.float32) * scale_mult
    ada, embedded = adaln_single(adaln_p, scaled.reshape(-1))
    ada = ada.reshape(batch, -1, 6, cfg_d).astype(dtype)
    embedded = embedded.reshape(batch, -1, cfg_d).astype(dtype)
    ctx = caption_projection(cap_p, context.astype(dtype)).reshape(
        batch, -1, cfg_d)
    return x, ada, embedded, ctx, scaled


def dit_av_forward(
    params,
    video_latent,    # (B, Tv, C)
    audio_latent,    # (B, Ta, C_audio) packed
    video_context,   # (B, S, caption_channels)
    audio_context,   # (B, S, caption_channels)
    video_timesteps,  # (B,) or (B, Tv)
    audio_timesteps,  # (B,) or (B, Ta)
    ropes,           # from prepare_av_ropes
    cfg: TransformerConfig,
    video_bias=None,
    audio_bias=None,
    sdpa_impl: str = "auto",
    remat: bool = False,
    remat_segments: int = 0,
):
    """(video velocity (B, Tv, C), audio velocity (B, Ta, C_audio))
    (reference: LTX2Transformer.swift:254-392)."""
    b = video_latent.shape[0]
    dt = video_latent.dtype
    dv, da = cfg.inner_dim, cfg.audio_inner_dim

    video_x, ts_v, emb_v, ctx_v, scaled_v = _prepare_stream(
        params["patchify_proj"], params["adaln_single"],
        params["caption_projection"], video_latent, video_context,
        video_timesteps, dv, cfg.timestep_scale_multiplier, b, dt)
    audio_x, ts_a, emb_a, ctx_a, scaled_a = _prepare_stream(
        params["audio_patchify_proj"], params["audio_adaln_single"],
        params["audio_caption_projection"], audio_latent, audio_context,
        audio_timesteps, da, cfg.timestep_scale_multiplier, b, dt)

    cross_v_ss, cross_a_ss = cross_modal_modulation(
        params, scaled_v, scaled_a, b, dv, da, dt)

    def body(carry, block_params):
        vx, ax = carry
        vx, ax = av_block_forward(
            block_params, vx, ax, ctx_v, ctx_a, ts_v, ts_a,
            cross_v_ss, cross_a_ss, ropes, video_bias, audio_bias, cfg,
            sdpa_impl=sdpa_impl,
        )
        return (vx, ax), None

    if remat_segments and remat_segments > 1:
        # segmented ("sqrt") remat — see models/dit.py::dit_forward
        seg = remat_segments
        if cfg.num_layers % seg:
            raise ValueError(f"remat_segments {seg} must divide "
                             f"num_layers {cfg.num_layers}")
        per = cfg.num_layers // seg
        blocks_seg = jax.tree.map(
            lambda a: a.reshape(seg, per, *a.shape[1:]), params["blocks"])

        inner = jax.checkpoint(body)  # see models/dit.py

        def seg_body(carry, seg_blocks):
            out, _ = lax.scan(inner, carry, seg_blocks)
            return out, None

        (video_x, audio_x), _ = lax.scan(
            jax.checkpoint(seg_body), (video_x, audio_x), blocks_seg)
    else:
        if remat:
            body = jax.checkpoint(body)
        (video_x, audio_x), _ = lax.scan(body, (video_x, audio_x),
                                         params["blocks"])

    video_out = av_output_head(video_x, params["scale_shift_table"], emb_v,
                               params["proj_out"], cfg)
    audio_out = av_output_head(audio_x, params["audio_scale_shift_table"],
                               emb_a, params["audio_proj_out"], cfg)
    return video_out, audio_out


def cross_modal_modulation(params, scaled_v, scaled_a, batch, dv, da, dtype):
    """Per-token cross-modal modulation: 4 scale/shift + 1 gate per stream
    (reference: LTX2Transformer.swift:284-312). Shared by dit_av_forward
    and the pipeline-parallel forward (parallel/pipeline.py)."""
    ss_v, _ = adaln_single(params["av_ca_video_scale_shift_adaln_single"],
                           scaled_v.reshape(-1))
    gate_v, _ = adaln_single(params["av_ca_a2v_gate_adaln_single"],
                             scaled_v.reshape(-1))
    cross_v_ss = jnp.concatenate([
        ss_v.reshape(batch, -1, 4, dv), gate_v.reshape(batch, -1, 1, dv)
    ], axis=2).astype(dtype)
    ss_a, _ = adaln_single(params["av_ca_audio_scale_shift_adaln_single"],
                           scaled_a.reshape(-1))
    gate_a, _ = adaln_single(params["av_ca_v2a_gate_adaln_single"],
                             scaled_a.reshape(-1))
    cross_a_ss = jnp.concatenate([
        ss_a.reshape(batch, -1, 4, da), gate_a.reshape(batch, -1, 1, da)
    ], axis=2).astype(dtype)
    return cross_v_ss, cross_a_ss


def av_output_head(x, table, embedded, proj_p, cfg: TransformerConfig):
    """Final AdaLN layer-norm + projection for one AV stream (reference:
    LTX2Transformer.swift:360-392). Shared with parallel/pipeline.py."""
    dt = x.dtype
    vals = (table[None, None].astype(jnp.float32)
            + embedded[:, :, None].astype(jnp.float32))
    shift, scale = vals[:, :, 0].astype(dt), vals[:, :, 1].astype(dt)
    out = layer_norm_no_affine(x, eps=cfg.norm_eps) * (1 + scale) + shift
    return linear_any(proj_p, out)


# ---------------------------------------------------------------------------
# Audio latent packing
# ---------------------------------------------------------------------------


def pack_audio_latents(audio):
    """(B, 8, T, 16) -> (B, T, 128) (reference: LTXPipeline.swift:540-544)."""
    b, c, t, m = audio.shape
    return audio.transpose(0, 2, 1, 3).reshape(b, t, c * m)


def unpack_audio_latents(packed, channels: int = 8, mel: int = 16):
    """(B, T, 128) -> (B, 8, T, 16) (reference: LTXPipeline.swift:546-557)."""
    b, t, _ = packed.shape
    return packed.reshape(b, t, channels, mel).transpose(0, 2, 1, 3)


def audio_frame_count(duration_s: float, sample_rate: int = 16000,
                      hop: int = 160, scale: int = 4) -> int:
    """round(dur * 16000 / 160 / 4) (reference: LTXPipeline.swift:530-534)."""
    return int(round(duration_s * sample_rate / hop / scale))
