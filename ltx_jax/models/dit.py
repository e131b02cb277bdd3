"""Video diffusion transformer (DiT) — the denoising hot path.

A functional JAX re-design of the reference LTX-2 transformer
(reference: Sources/LTXVideo/Models/Transformer/LTXTransformer.swift:235-486,
LTXTransformerBlock.swift:187-232, LTXAttention.swift:117-219):

* params are a pytree with all 48 blocks STACKED along a leading axis and the
  block loop expressed as `lax.scan` — one compiled block body instead of 48
  unrolled copies (fast compiles, constant program size, remat-friendly);
* STG "skip self-attention / skip feed-forward" is a per-(block, sample)
  boolean input selected with jnp.where, not module mutation, so the
  cond/uncond/perturbed guidance branches run as ONE batched forward
  (the reference runs them serially: LTXPipeline.swift:829-921);
* RoPE cos/sin tables are precomputed host-side (ops/rope.py) and passed in;
* everything is shape-static and jit-safe; TP sharding is applied externally
  by constraining the stacked params (parallel/sharding.py).

Semantics preserved exactly: RMSNorm on flat Q/K across all heads BEFORE the
head split, RoPE applied on the flat tensor (LTXAttention.swift:177-189),
AdaLN-single with per-block (6, D) scale_shift_table, weightless RMSNorm in
adaln, affine-free LayerNorm + (2, D) table at the output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ltx_jax.core.config import TransformerConfig
from ltx_jax.kernels.quantization import linear_any
from ltx_jax.models.common import gelu_tanh, linear, linear_init, silu
from ltx_jax.ops.attention import sdpa
from ltx_jax.ops.embeddings import get_timestep_embedding
from ltx_jax.ops.normalization import adaln, layer_norm_no_affine, rms_norm
from ltx_jax.ops.rope import apply_rope_split


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _attention_init(key, query_dim, context_dim, inner_dim, dtype):
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
    d = cfg.inner_dim
    ks = jax.random.split(key, 4)
    return {
        "attn1": _attention_init(ks[0], d, d, d, dtype),
        "attn2": _attention_init(ks[1], d, cfg.cross_attention_dim, d, dtype),
        "ff": {
            "project_in": linear_init(ks[2], d, cfg.ffn_dim, dtype),
            "project_out": linear_init(ks[3], cfg.ffn_dim, d, dtype),
        },
        # float32 for numerical stability (reference keeps SSTs f32)
        "scale_shift_table": jnp.zeros((6, d), jnp.float32),
    }


def init_params(key, cfg: TransformerConfig, dtype=jnp.bfloat16):
    """Random-init DiT params (tests / shape-checking; real weights come from
    safetensors via ltx_jax.weights)."""
    d = cfg.inner_dim
    ks = jax.random.split(key, 8)
    # vmap builds the stacked (num_layers, ...) leaves directly: the same
    # values as a per-block loop, without a second copy for the stack
    stacked = jax.vmap(lambda k: _block_init(k, cfg, dtype))(
        jax.random.split(ks[0], cfg.num_layers))
    return {
        "patchify_proj": linear_init(ks[1], cfg.in_channels, d, dtype),
        "adaln_single": {
            "emb": {
                "linear_1": linear_init(ks[2], 256, d, dtype),
                "linear_2": linear_init(ks[3], d, d, dtype),
            },
            "linear": linear_init(ks[4], d, 6 * d, dtype),
        },
        "caption_projection": {
            "linear_1": linear_init(ks[5], cfg.caption_channels, d, dtype),
            "linear_2": linear_init(ks[6], d, d, dtype),
        },
        "blocks": stacked,
        "proj_out": linear_init(ks[7], d, cfg.out_channels, dtype),
        "scale_shift_table": jnp.zeros((2, d), jnp.float32),
    }


# ---------------------------------------------------------------------------
# Sub-modules (pure functions)
# ---------------------------------------------------------------------------


def attention(params, x, context, num_heads: int, head_dim: int,
              bias=None, rope=None, norm_eps: float = 1e-6,
              sdpa_impl: str = "auto"):
    """LTX attention: QK RMSNorm across all heads on the FLAT (B, T, H*D)
    tensor, then RoPE on the flat tensor, then head split + SDPA
    (reference: LTXAttention.swift:160-218)."""
    b, tq, _ = x.shape
    tk = context.shape[1]

    q = linear_any(params["to_q"], x)
    k = linear_any(params["to_k"], context)
    v = linear_any(params["to_v"], context)
    # q/k pass through rms_norm below, which decouples the SDPA's layout
    # preferences from their matmuls; v flows straight into the head-split
    # transpose, and XLA then relayouts the STACKED to_v weight outside the
    # block scan (a hoisted 768 MB copy per attention at DiT scale — OOMs
    # the one-chip QLoRA train step). The barrier pins the relayout to the
    # ~12 MB per-layer activation instead (measured-neutral at inference:
    # the copy rides HBM bandwidth, ~15 us/layer).
    v = jax.lax.optimization_barrier(v)

    q = rms_norm(q, params["q_norm"]["w"], eps=norm_eps)
    k = rms_norm(k, params["k_norm"]["w"], eps=norm_eps)

    if rope is not None:
        cos, sin = rope
        q = apply_rope_split(q, cos, sin)
        k = apply_rope_split(k, cos, sin)

    q = q.reshape(b, tq, num_heads, head_dim).transpose(0, 2, 1, 3)
    k = k.reshape(b, tk, num_heads, head_dim).transpose(0, 2, 1, 3)
    v = v.reshape(b, tk, num_heads, head_dim).transpose(0, 2, 1, 3)

    out = sdpa(q, k, v, bias=bias, impl=sdpa_impl)
    out = out.transpose(0, 2, 1, 3).reshape(b, tq, num_heads * head_dim)
    return linear_any(params["to_out"], out)


def feed_forward(params, x):
    """Linear -> GELU(tanh) -> Linear (reference: LTXFeedForward.swift:35-52)."""
    return linear_any(params["project_out"],
                      gelu_tanh(linear_any(params["project_in"], x)))


def timestep_mlp(params, t):
    """sinusoid(256) -> Linear -> SiLU -> Linear
    (reference: LTXTimestepEmbedding.swift:96-124). Output float32 until the
    caller casts, matching the f32 sinusoid."""
    emb = get_timestep_embedding(t, 256)
    emb = linear(params["linear_1"], emb.astype(params["linear_1"]["w"].dtype))
    return linear(params["linear_2"], silu(emb))


def adaln_single(params, t):
    """Timestep -> (6*D modulation, D embedded timestep)
    (reference: LTXTimestepEmbedding.swift:62-89)."""
    embedded = timestep_mlp(params["emb"], t)
    ada = linear(params["linear"], silu(embedded))
    return ada, embedded


def caption_projection(params, context):
    """Gemma 3840 -> 4096 with GELU between two linears
    (reference: LTXTimestepEmbedding.swift:131-152)."""
    return linear(params["linear_2"], gelu_tanh(linear(params["linear_1"], context)))


def _ada_values(table_slice, ts_emb, start: int):
    """(shift, scale, gate) from per-block table + timestep embedding
    (reference: LTXTransformerBlock.swift:166-185). table_slice: (6, D) f32;
    ts_emb: (B, T', 6, D)."""
    vals = table_slice[None, None, start : start + 3] + ts_emb[
        :, :, start : start + 3
    ].astype(jnp.float32)
    return vals[:, :, 0], vals[:, :, 1], vals[:, :, 2]


def block_forward(block_params, x, context, ts_emb, rope, bias,
                  cfg: TransformerConfig,
                  skip_self_attn=None, skip_ff=None,
                  cross_attn_scale=None, sdpa_impl: str = "auto"):
    """One DiT block (reference: LTXTransformerBlock.swift:187-232).

    skip_self_attn / skip_ff: optional (B,) bool — per-SAMPLE STG skips so
    perturbed guidance branches batch with the others.
    cross_attn_scale: optional scalar (traced ok).
    """
    eps = cfg.norm_eps
    table = block_params["scale_shift_table"].astype(jnp.float32)
    dtype = x.dtype

    # Self-attention with AdaLN
    shift_msa, scale_msa, gate_msa = _ada_values(table, ts_emb, 0)
    normed = adaln(x, scale_msa.astype(dtype), shift_msa.astype(dtype), eps=eps)
    attn_out = attention(
        block_params["attn1"], normed, normed, cfg.num_heads, cfg.head_dim,
        rope=rope, norm_eps=eps, sdpa_impl=sdpa_impl,
    )
    x_attn = x + attn_out * gate_msa.astype(dtype)
    if skip_self_attn is not None:
        x_attn = jnp.where(skip_self_attn[:, None, None], x, x_attn)
    x = x_attn

    # Cross-attention (no pre-norm; q_norm inside handles Q)
    cross = attention(
        block_params["attn2"], x, context, cfg.num_heads, cfg.head_dim,
        bias=bias, norm_eps=eps, sdpa_impl=sdpa_impl,
    )
    if cross_attn_scale is not None:
        cross = cross * jnp.asarray(cross_attn_scale, dtype)
    x = x + cross

    # Feed-forward with AdaLN
    shift_mlp, scale_mlp, gate_mlp = _ada_values(table, ts_emb, 3)
    normed = adaln(x, scale_mlp.astype(dtype), shift_mlp.astype(dtype), eps=eps)
    ff_out = feed_forward(block_params["ff"], normed)
    x_ff = x + ff_out * gate_mlp.astype(dtype)
    if skip_ff is not None:
        x_ff = jnp.where(skip_ff[:, None, None], x, x_ff)
    return x_ff


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def prepare_timestep(params, timesteps, batch: int, cfg: TransformerConfig,
                     dtype=jnp.bfloat16):
    """(B,) or (B, T) sigmas -> ((B, T', 6, D) modulation, (B, T', D) embedded)
    with T' in {1, T} (reference: LTXTransformer.swift:104-124)."""
    scaled = timesteps.astype(jnp.float32) * cfg.timestep_scale_multiplier
    ada, embedded = adaln_single(params["adaln_single"], scaled.reshape(-1))
    ada = ada.reshape(batch, -1, 6, cfg.inner_dim).astype(dtype)
    embedded = embedded.reshape(batch, -1, cfg.inner_dim).astype(dtype)
    return ada, embedded


def dit_forward(
    params,
    latent,          # (B, T, C) patchified tokens
    context,         # (B, S, caption_channels)
    timesteps,       # (B,) or (B, T) sigma values in [0, 1]
    rope,            # (cos, sin) each (H, T, head_dim/2) — from ops.rope
    cfg: TransformerConfig,
    context_bias=None,       # (B, 1, 1, S) additive mask or None
    skip_self_attn=None,     # (L, B) bool — STG per-(block, sample)
    skip_ff=None,            # (L, B) bool
    cross_attn_scale=None,   # scalar or (L,) per-block
    sdpa_impl: str = "auto",
    remat: bool = False,
    remat_segments: int = 0,
):
    """Velocity prediction (B, T, C) -> (B, T, C).

    Reference: LTXTransformer.swift:235-486. The 48-block loop is a lax.scan
    over stacked block params.
    """
    b = latent.shape[0]
    dtype = latent.dtype

    x = linear(params["patchify_proj"], latent)
    ts_emb, embedded_ts = prepare_timestep(params, timesteps, b, cfg, dtype)
    ctx = caption_projection(params["caption_projection"], context.astype(dtype))
    ctx = ctx.reshape(b, -1, cfg.inner_dim)

    num_layers = cfg.num_layers
    if skip_self_attn is None:
        skip_self_attn = jnp.zeros((num_layers, b), bool)
    if skip_ff is None:
        skip_ff = jnp.zeros((num_layers, b), bool)
    if cross_attn_scale is None:
        cas = jnp.ones((num_layers,), jnp.float32)
    else:
        cas = jnp.broadcast_to(
            jnp.asarray(cross_attn_scale, jnp.float32), (num_layers,)
        )

    def body(carry, scanned):
        block_params, skip_sa, skip_f, scale_ca = scanned
        out = block_forward(
            block_params, carry, ctx, ts_emb, rope, context_bias, cfg,
            skip_self_attn=skip_sa, skip_ff=skip_f,
            cross_attn_scale=scale_ca, sdpa_impl=sdpa_impl,
        )
        return out, None

    xs = (params["blocks"], skip_self_attn, skip_ff, cas)
    if remat_segments and remat_segments > 1:
        # Segmented ("sqrt") remat: per-block remat still makes the scan
        # save every block's INPUT as a residual — L x (B, T, D) bf16 =
        # 2.25 GB at T=6144 (the one-device training blocker once the
        # flash backward removed the (T, T) logits term).
        # Checkpointing SEGMENTS of L/S blocks instead stores S boundary
        # activations, and each segment's backward re-forward stores L/S —
        # peak S + L/S residuals (minimized near sqrt(L)) at the cost of
        # one extra forward (already paid by per-block remat).
        s = remat_segments
        if num_layers % s:
            raise ValueError(
                f"remat_segments {s} must divide num_layers {num_layers}")
        per = num_layers // s
        xs_seg = jax.tree.map(
            lambda a: a.reshape(s, per, *a.shape[1:]), xs)

        # the inner body must ALSO be checkpointed: the segment's
        # backward re-forward otherwise saves every block's full
        # intermediates (16384-wide FFN activations — measured 24.4 GB at
        # T=6144, WORSE than flat remat). Two nested checkpoints = two
        # extra forwards, the price of the S + L/S residual footprint.
        inner = jax.checkpoint(body)

        def seg_body(carry, seg_xs):
            out, _ = lax.scan(inner, carry, seg_xs)
            return out, None

        x, _ = lax.scan(jax.checkpoint(seg_body), x, xs_seg)
        return output_head(params, x, embedded_ts, cfg)

    if remat:
        body = jax.checkpoint(body)

    x, _ = lax.scan(body, x, xs)

    return output_head(params, x, embedded_ts, cfg)


def output_head(params, x, embedded_ts, cfg: TransformerConfig):
    """Final AdaLN layer-norm + projection (reference:
    LTXTransformer.swift:208-224). Shared by dit_forward and the
    pipeline-parallel forward (parallel/pipeline.py)."""
    dtype = x.dtype
    table = params["scale_shift_table"].astype(jnp.float32)  # (2, D)
    vals = table[None, None] + embedded_ts[:, :, None].astype(jnp.float32)
    shift, scale = vals[:, :, 0].astype(dtype), vals[:, :, 1].astype(dtype)
    out = layer_norm_no_affine(x, eps=cfg.norm_eps)
    out = out * (1 + scale) + shift
    return linear(params["proj_out"], out)


def stg_skip_masks(
    cfg: TransformerConfig,
    batch: int,
    stg_blocks,
    perturbed_rows,
    skip_ff_too: bool = False,
):
    """Build (L, B) skip masks: rows in `perturbed_rows` skip self-attention
    (and optionally FF) in `stg_blocks`. Used to batch the STG perturbed
    branch with cond/uncond (replaces reference's setSTGSkipFlags mutation,
    LTXTransformer.swift:512-526)."""
    import numpy as np

    sa = np.zeros((cfg.num_layers, batch), bool)
    for blk in stg_blocks:
        for row in perturbed_rows:
            sa[blk, row] = True
    ff = sa if skip_ff_too else np.zeros_like(sa)
    return jnp.asarray(sa), jnp.asarray(ff)
