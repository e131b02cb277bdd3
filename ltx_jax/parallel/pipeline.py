"""GPipe-style pipeline parallelism over the stacked DiT block axis.

The reference runs its 48 transformer blocks strictly sequentially in one
process (LTXTransformer.swift:446-465) and has no parallelism of any kind
(SURVEY.md §2.9); like TP/SP this module is new capability, not a
port. The design exploits the repo's params invariant directly: all blocks
are STACKED along a leading (L, ...) axis, so pipeline parallelism is just a
sharding of that axis —

* a ("data", "pipe") mesh: batch rows ride "data" (guidance branches at
  inference, sample rows in training), contiguous groups of L/S blocks live
  on each of the S "pipe" stages;
* inside `shard_map`, each stage runs its local sub-stack as the SAME
  `lax.scan` block body as the single-device forward (models/dit.py), so
  numerics are identical by construction;
* activations hop stage-to-stage with `lax.ppermute`. M microbatches
  keep stages busy; the classic GPipe fill/drain bubble is (S-1)/(M+S-1) of
  the steady-state time;
* the schedule is a `lax.scan` over M+S-1 ticks. Ticks where a stage has no
  real microbatch compute on garbage and are masked at collection — the
  standard compiler-friendly formulation (static shapes, no host control
  flow);
* everything is differentiable (ppermute/dynamic-slice/scan all have
  transposes), so the same forward drops into the flow-matching training
  step for pipeline-parallel training.

When to use which axis on real hardware: TP (parallel/sharding.py) is the
default for the 19B DiT on one host's cards — it shards *within* every matmul
and needs no bubble. PP becomes useful when the model axis is exhausted
(num_heads=32 caps TP) or across slower links: per-hop traffic here is one
(mb, T, C) activation per tick versus TP's two all-reduces per block.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
    _CHECK_KW = {"check_vma": False}
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
    _CHECK_KW = {"check_rep": False}

from ltx_jax.core.config import TransformerConfig
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.models import dit
from ltx_jax.models.common import linear


def make_pp_mesh(data: int = 1, pipe: Optional[int] = None,
                 devices=None) -> Mesh:
    """A ("data", "pipe") mesh. Default: all devices on the pipe axis."""
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if pipe is None:
        pipe = n // data
    if data * pipe > n:
        raise InvalidConfigurationError(
            f"mesh {data}x{pipe} needs {data * pipe} devices, have {n}")
    arr = np.asarray(devices[: data * pipe]).reshape(data, pipe)
    return Mesh(arr, ("data", "pipe"))


def pp_param_specs(params) -> dict:
    """PartitionSpecs: the stacked block axis shards over "pipe"; the small
    non-block params (patchify/adaln/caption/head) replicate."""
    specs = jax.tree.map(lambda _: P(), params)
    specs["blocks"] = jax.tree.map(lambda _: P("pipe"), params["blocks"])
    return specs


def shard_pp_params(params, mesh: Mesh):
    """Place a DiT pytree on a ("data", "pipe") mesh, block-stack sharded."""
    return jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
        params, pp_param_specs(params))


def gpipe_schedule(stage_fn, xs, aux_mb, n_mb: int, n_stage: int,
                   axis_name: str = "pipe"):
    """The GPipe tick loop, generic over pytree-valued activations.

    Runs INSIDE a shard_map body with `axis_name` in scope.

    stage_fn(x, aux, m_idx) -> y: one stage's compute for one microbatch
        (x and y share structure/shape; aux is aux_mb indexed at m_idx).
    xs: pytree of (M, mb, ...) microbatch-stacked input activations.
    aux_mb: pytree of (M, ...) per-microbatch auxiliary inputs.

    Schedule: M + S - 1 ticks as one lax.scan; stage s processes microbatch
    t - s at tick t (fill/drain ticks compute on garbage and are masked at
    collection); activations hop s -> s+1 via ppermute; the last stage's
    collected outputs broadcast to all stages with a psum (single non-zero
    contributor -> exact). Differentiable throughout.
    """
    stage = lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n_stage) for i in range(n_stage)]

    def pick(tree, idx):
        return jax.tree.map(
            lambda a: lax.dynamic_index_in_dim(a, idx, 0, keepdims=False),
            tree)

    def tick(carry, t):
        buf, outs = carry
        m_here = t - stage                       # microbatch at this stage
        m_idx = jnp.clip(m_here, 0, n_mb - 1)
        x_in = jax.tree.map(
            lambda s, b: jnp.where(stage == 0,
                                   lax.dynamic_index_in_dim(
                                       s, m_idx, 0, keepdims=False), b),
            xs, buf)
        y = stage_fn(x_in, pick(aux_mb, m_idx), m_idx)
        valid = (stage == n_stage - 1) & (m_here >= 0) & (m_here < n_mb)
        outs = jax.tree.map(
            lambda o, yy: lax.dynamic_update_index_in_dim(
                o, jnp.where(valid, yy,
                             lax.dynamic_index_in_dim(o, m_idx, 0,
                                                      keepdims=False)),
                m_idx, 0),
            outs, y)
        buf = jax.tree.map(lambda yy: lax.ppermute(yy, axis_name, perm), y)
        return (buf, outs), None

    buf0 = jax.tree.map(lambda s: jnp.zeros_like(s[0]), xs)
    outs0 = jax.tree.map(jnp.zeros_like, xs)
    (_, outs), _ = lax.scan(tick, (buf0, outs0),
                            jnp.arange(n_mb + n_stage - 1))
    return jax.tree.map(lambda o: lax.psum(o, axis_name), outs)


def dit_forward_pp(
    params,
    latent,          # (B, T, C) patchified tokens
    context,         # (B, S_ctx, caption_channels)
    timesteps,       # (B,) or (B, T) sigma values
    rope,            # (cos, sin) — replicated
    cfg: TransformerConfig,
    mesh: Mesh,
    context_bias=None,       # (B or 1, 1, 1, S_ctx) additive mask or None
    skip_self_attn=None,     # (L, B) bool — STG per-(block, sample)
    skip_ff=None,            # (L, B) bool
    cross_attn_scale=None,   # scalar or (L,)
    n_microbatches: Optional[int] = None,
    sdpa_impl: str = "auto",
    remat: bool = False,
):
    """Pipeline-parallel velocity prediction, numerically identical to
    `dit.dit_forward` (same block body, same order). `mesh` must carry
    ("data", "pipe") axes; the batch must divide data*n_microbatches."""
    n_data = mesh.shape["data"]
    n_stage = mesh.shape["pipe"]
    n_layers = cfg.num_layers
    batch = latent.shape[0]
    if n_layers % n_stage:
        raise InvalidConfigurationError(
            f"num_layers={n_layers} not divisible by pipe={n_stage}")
    if batch % n_data:
        raise InvalidConfigurationError(
            f"batch={batch} not divisible by data={n_data}")
    b_local = batch // n_data
    n_mb = n_microbatches or b_local
    if b_local % n_mb:
        raise InvalidConfigurationError(
            f"local batch={b_local} not divisible by microbatches={n_mb}")
    mb = b_local // n_mb

    # Normalize optional inputs to dense arrays so the shard_map signature
    # is static (same trick as dit_forward's defaults).
    if skip_self_attn is None:
        skip_self_attn = jnp.zeros((n_layers, batch), bool)
    if skip_ff is None:
        skip_ff = jnp.zeros((n_layers, batch), bool)
    if cross_attn_scale is None:
        cas = jnp.ones((n_layers,), jnp.float32)
    else:
        cas = jnp.broadcast_to(
            jnp.asarray(cross_attn_scale, jnp.float32), (n_layers,))
    if context_bias is None:
        bias = jnp.zeros((batch, 1, 1, context.shape[1]), jnp.float32)
    else:
        bias = jnp.broadcast_to(
            context_bias,
            (batch,) + tuple(context_bias.shape[1:])).astype(jnp.float32)
    if timesteps.ndim == 1:
        timesteps = timesteps[:, None]  # (B, 1) — slices like (B, T)

    bspec = P("data")
    in_specs = (
        pp_param_specs(params),
        bspec,                      # latent
        bspec,                      # context
        bspec,                      # timesteps
        P(),                        # rope
        bspec,                      # bias
        P("pipe", "data"),          # skip_self_attn
        P("pipe", "data"),          # skip_ff
        P("pipe"),                  # cas
    )

    def body(p, lat, ctx_raw, ts, pe, bias_b, skip_sa, skip_f, cas_l):
        dtype = lat.dtype
        # Replicated (cheap) pre/post compute — identical on every stage.
        x = linear(p["patchify_proj"], lat)
        ts_emb, embedded_ts = dit.prepare_timestep(
            p, ts.reshape(b_local, -1)[:, 0] if ts.shape[1] == 1 else ts,
            b_local, cfg, dtype)
        ctx = dit.caption_projection(
            p["caption_projection"], ctx_raw.astype(dtype))
        ctx = ctx.reshape(b_local, -1, cfg.inner_dim)

        # Microbatch-major stacking: (M, mb, ...)
        def split(a):
            return a.reshape((n_mb, mb) + a.shape[1:])

        xs = split(x)
        ts_mb = split(ts_emb)
        ctx_mb = split(ctx)
        bias_mb = split(bias_b)

        def stage_fn(x_in, aux_m, m_idx):
            ctx_m, ts_m, bias_m = aux_m
            col = m_idx * mb
            sa_m = lax.dynamic_slice_in_dim(skip_sa, col, mb, axis=1)
            ff_m = lax.dynamic_slice_in_dim(skip_f, col, mb, axis=1)

            def blk(carry, scanned):
                bp, s_sa, s_ff, s_cas = scanned
                out = dit.block_forward(
                    bp, carry, ctx_m, ts_m, pe, bias_m, cfg,
                    skip_self_attn=s_sa, skip_ff=s_ff,
                    cross_attn_scale=s_cas, sdpa_impl=sdpa_impl)
                return out, None

            if remat:
                blk = jax.checkpoint(blk)
            y, _ = lax.scan(blk, x_in, (p["blocks"], sa_m, ff_m, cas_l))
            return y

        outs = gpipe_schedule(stage_fn, xs, (ctx_mb, ts_mb, bias_mb),
                              n_mb, n_stage)
        x_full = outs.reshape(b_local, *outs.shape[2:])
        return dit.output_head(p, x_full, embedded_ts, cfg)

    fn = shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=bspec, **_CHECK_KW)
    return fn(params, latent, context, timesteps, rope, bias,
              skip_self_attn, skip_ff, cas)


def dit_av_forward_pp(
    params,
    video_latent,    # (B, Tv, C)
    audio_latent,    # (B, Ta, C_audio) packed
    video_context,   # (B, S, caption_channels)
    audio_context,   # (B, S, caption_channels)
    video_timesteps,  # (B,) or (B, Tv)
    audio_timesteps,  # (B,) or (B, Ta)
    ropes,           # from models.dit_av.prepare_av_ropes — replicated
    cfg: TransformerConfig,
    mesh: Mesh,
    video_bias=None,
    audio_bias=None,
    n_microbatches: Optional[int] = None,
    sdpa_impl: str = "auto",
    remat: bool = False,
):
    """GPipe pipeline for the dual audio/video transformer — the carried
    activation is the (video_x, audio_x) PAIR, hopped between stages
    together; numerics match `dit_av.dit_av_forward` exactly (same
    av_block_forward scan body)."""
    from ltx_jax.models import dit_av

    n_data = mesh.shape["data"]
    n_stage = mesh.shape["pipe"]
    n_layers = cfg.num_layers
    batch = video_latent.shape[0]
    if n_layers % n_stage:
        raise InvalidConfigurationError(
            f"num_layers={n_layers} not divisible by pipe={n_stage}")
    if batch % n_data:
        raise InvalidConfigurationError(
            f"batch={batch} not divisible by data={n_data}")
    b_local = batch // n_data
    n_mb = n_microbatches or b_local
    if b_local % n_mb:
        raise InvalidConfigurationError(
            f"local batch={b_local} not divisible by microbatches={n_mb}")
    mb = b_local // n_mb

    def norm_bias(bias, ctx):
        if bias is None:
            return jnp.zeros((batch, 1, 1, ctx.shape[1]), jnp.float32)
        return jnp.broadcast_to(
            bias, (batch,) + tuple(bias.shape[1:])).astype(jnp.float32)

    vbias = norm_bias(video_bias, video_context)
    abias = norm_bias(audio_bias, audio_context)
    if video_timesteps.ndim == 1:
        video_timesteps = video_timesteps[:, None]
    if audio_timesteps.ndim == 1:
        audio_timesteps = audio_timesteps[:, None]

    bspec = P("data")
    in_specs = (pp_param_specs(params),) + (bspec,) * 6 + (P(),) + (bspec,) * 2

    def body(p, v_lat, a_lat, v_ctx_raw, a_ctx_raw, ts_v_raw, ts_a_raw,
             pe, vbias_b, abias_b):
        dt = v_lat.dtype
        dv, da = cfg.inner_dim, cfg.audio_inner_dim

        video_x, ts_v, emb_v, ctx_v, scaled_v = dit_av._prepare_stream(
            p["patchify_proj"], p["adaln_single"], p["caption_projection"],
            v_lat, v_ctx_raw, ts_v_raw, dv, cfg.timestep_scale_multiplier,
            b_local, dt)
        audio_x, ts_a, emb_a, ctx_a, scaled_a = dit_av._prepare_stream(
            p["audio_patchify_proj"], p["audio_adaln_single"],
            p["audio_caption_projection"], a_lat, a_ctx_raw, ts_a_raw, da,
            cfg.timestep_scale_multiplier, b_local, dt)

        cross_v_ss, cross_a_ss = dit_av.cross_modal_modulation(
            p, scaled_v, scaled_a, b_local, dv, da, dt)

        def split(a):
            return a.reshape((n_mb, mb) + a.shape[1:])

        xs = (split(video_x), split(audio_x))
        aux = jax.tree.map(split, (ctx_v, ctx_a, ts_v, ts_a,
                                   cross_v_ss, cross_a_ss, vbias_b, abias_b))

        def stage_fn(x_in, aux_m, m_idx):
            vx0, ax0 = x_in
            c_v, c_a, t_v, t_a, x_v_ss, x_a_ss, b_v, b_a = aux_m

            def blk(carry, block_params):
                vx, ax = carry
                vx, ax = dit_av.av_block_forward(
                    block_params, vx, ax, c_v, c_a, t_v, t_a,
                    x_v_ss, x_a_ss, pe, b_v, b_a, cfg,
                    sdpa_impl=sdpa_impl)
                return (vx, ax), None

            if remat:
                blk = jax.checkpoint(blk)
            (vy, ay), _ = lax.scan(blk, (vx0, ax0), p["blocks"])
            return (vy, ay)

        v_outs, a_outs = gpipe_schedule(stage_fn, xs, aux, n_mb, n_stage)
        video_full = v_outs.reshape(b_local, *v_outs.shape[2:])
        audio_full = a_outs.reshape(b_local, *a_outs.shape[2:])
        return (dit_av.av_output_head(video_full, p["scale_shift_table"],
                                      emb_v, p["proj_out"], cfg),
                dit_av.av_output_head(audio_full,
                                      p["audio_scale_shift_table"], emb_a,
                                      p["audio_proj_out"], cfg))

    fn = shard_map(body, mesh=mesh, in_specs=in_specs,
                   out_specs=(bspec, bspec), **_CHECK_KW)
    return fn(params, video_latent, audio_latent, video_context,
              audio_context, video_timesteps, audio_timesteps, ropes,
              vbias, abias)
