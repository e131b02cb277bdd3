"""The denoising loop — one jit-compiled step, guidance branches batched.

The reference runs cond / uncond / STG-perturbed as up to 3 SERIAL
transformer passes per step with module mutation for STG
(reference: Sources/LTXVideo/Pipeline/LTXPipeline.swift:2191-2401). Here a
single compiled step function:

  patchify -> tile G guidance rows -> DiT (scan over blocks, STG skips as
  per-row masks) -> unpatchify -> CFG/rescale/STG/GE combine in f32 ->
  Euler step (I2V: slice frames 1+, re-attach clean frame 0)

runs once per sigma with sigma/sigma_next as TRACED scalars, so the whole
denoise loop reuses ONE compilation. Guidance rows sit on the batch axis and
ride the mesh `data` axis when sharded.

Row layout (matching the reference's CFG order uncond-first):
  G=1: [cond]
  G=2 (CFG): [uncond, cond]
  G=2 (STG, no CFG): [cond, perturbed]
  G=3 (CFG+STG): [uncond, cond, perturbed]
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ltx_jax.core.config import GenerationConfig, TransformerConfig
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.models import dit
from ltx_jax.ops import rope as rope_ops
from ltx_jax.ops.attention import prepare_additive_mask
from ltx_jax.ops.latents import (
    VideoLatentShape,
    apply_cfg,
    apply_guidance_rescale,
    patchify,
    unpatchify,
)
from ltx_jax.ops.schedule import euler_step
from ltx_jax.utils.diagnostics import device_sync


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """Static guidance configuration baked into the compiled step."""

    use_cfg: bool
    cfg_scale: float
    guidance_rescale: float
    stg_scale: float
    stg_blocks: Tuple[int, ...]
    ge_gamma: float
    cross_attention_scale: float

    @classmethod
    def from_config(cls, cfg: GenerationConfig, use_cfg: Optional[bool] = None):
        if use_cfg is None:
            use_cfg = cfg.cfg_scale > 1.0
        return cls(
            use_cfg=use_cfg,
            cfg_scale=cfg.cfg_scale,
            guidance_rescale=cfg.guidance_rescale,
            stg_scale=cfg.stg_scale,
            stg_blocks=tuple(cfg.stg_blocks),
            ge_gamma=cfg.ge_gamma,
            cross_attention_scale=cfg.cross_attention_scale,
        )

    @property
    def use_stg(self) -> bool:
        return self.stg_scale > 0

    @property
    def num_rows(self) -> int:
        return (2 if self.use_cfg else 1) + (1 if self.use_stg else 0)


def build_guidance_context(guidance: GuidanceSpec, pos_embeddings, pos_mask,
                           neg_embeddings=None, neg_mask=None):
    """Stack per-row text context/mask: [neg?, pos, pos(perturbed)?].

    pos/neg embeddings: (1, S, D); masks: (1, S) binary.
    Returns (context (G, S, D), bias (G, 1, 1, S) or None).
    """
    rows = []
    mask_rows = []
    if guidance.use_cfg:
        if neg_embeddings is None:
            raise InvalidConfigurationError(
                "CFG requires negative-prompt embeddings")
        rows.append(neg_embeddings)
        mask_rows.append(neg_mask)
    rows.append(pos_embeddings)
    mask_rows.append(pos_mask)
    if guidance.use_stg:
        rows.append(pos_embeddings)
        mask_rows.append(pos_mask)
    context = jnp.concatenate(rows, axis=0)
    if mask_rows[0] is None:
        return context, None
    mask = jnp.concatenate(mask_rows, axis=0)
    return context, prepare_additive_mask(mask)


def build_guidance_context_batched(guidance: GuidanceSpec, pos_embeddings,
                                   pos_mask, neg_embeddings=None,
                                   neg_mask=None):
    """B-prompt guidance rows, B-MAJOR: sample i's rows at i*G..i*G+G-1.

    pos/neg embeddings: (B, S, D); masks: (B, S). Returns
    (context (B*G, S, D), bias (B*G, 1, 1, S) or None) — the layout
    make_denoise_step's batched path (shape.batch=B) expects. Serving jobs
    batch with per-job prompts but SHARED guidance config (the step is
    compiled per GuidanceSpec)."""
    per = []
    if guidance.use_cfg:
        if neg_embeddings is None:
            raise InvalidConfigurationError(
                "CFG requires negative-prompt embeddings")
        per.append((neg_embeddings, neg_mask))
    per.append((pos_embeddings, pos_mask))
    if guidance.use_stg:
        per.append((pos_embeddings, pos_mask))
    b, s, d = pos_embeddings.shape
    g = len(per)
    context = jnp.stack([e for e, _ in per], axis=1).reshape(b * g, s, d)
    if per[0][1] is None:
        return context, None
    mask = jnp.stack([m for _, m in per], axis=1).reshape(b * g, s)
    return context, prepare_additive_mask(mask)


def make_denoise_step(
    dit_params,
    tcfg: TransformerConfig,
    guidance: GuidanceSpec,
    shape: VideoLatentShape,
    context,            # (G, S, caption_channels)
    context_bias,       # (G, 1, 1, S) or None
    conditioning_mask=None,   # (1, T) 1 on conditioned-frame tokens or None
    conditioned_latent=None,  # (1, C, K, h, w) CLEAN cond latent (the K
                              # conditioned frames only, in index order)
    image_cond_noise_scale: float = 0.0,
    cond_frames: int = 1,     # leading latent frames held clean (I2V: 1;
                              # video extension: >1)
    cond_frame_idx=None,      # (K,) int latent-frame indices held clean at
                              # ARBITRARY positions (keyframe conditioning);
                              # supersedes cond_frames when given
    fps: float = 24.0,
    sdpa_impl: str = "auto",
    remat: bool = False,
    pp_mesh=None,
    pp_microbatches=None,
):
    """Build the jitted per-step function.

    Returns step(latent, sigma, sigma_next, prev_velocity, has_prev, key)
      -> (new_latent, velocity); latent/velocity are f32 (B, C, F, H, W).

    Conditioning (I2V / video extension): conditioning_mask marks the
    first cond_frames latent frames' tokens; their timesteps are 0, Euler
    skips them, and when image_cond_noise_scale > 0 they are re-noised
    each step FROM THE CLEAN conditioned_latent
    (noised = cond + scale * noise * sigma^2 — the injection source is the
    clean latent every step, NOT the carried one, so injection noise never
    accumulates; reference: LTXPipeline.swift:2224-2229 uses condLatent).
    conditioned_latent is a jit ARGUMENT (not a closure constant): a new
    input image/clip must not recompile the step program.

    cond_frame_idx generalizes conditioning to ARBITRARY latent-frame
    positions (keyframe interpolation — first+last, mid-clip anchors; no
    reference analog, matching the upstream LTX-Video Python pipeline's
    conditioning items): the K indexed frames are scattered from
    conditioned_latent (same per-frame noise draw shape as the leading
    path, so leading indices reproduce it bit-for-bit) and carried
    through Euler via a frame mask. Indices are STATIC (baked into the
    program); different keyframe positions recompile, different images
    do not.

    shape.batch > 1 batches B PROMPTS through one compiled step (serving:
    queued jobs with identical shape/params stack like enhance rows do) —
    context must then be (B*G, S, D) B-major from
    build_guidance_context_batched; per-sample numerics match the B=1 step
    (tests/test_serve_batch.py). The B=1 program is unchanged.

    pp_mesh: a ("data", "pipe") mesh (parallel/pipeline.py) runs the DiT
    forward as a GPipe pipeline — guidance rows become the microbatches;
    place dit_params with shard_pp_params first. Numerics identical to the
    sequential scan (tests/test_pp.py). Mutually exclusive with the TP
    ("data", "model") sharding path.
    """
    g = guidance.num_rows
    b = shape.batch  # B>1: serving batch — B prompts' rows stack B-major
    cos, sin = rope_ops.video_rope(
        shape.frames, shape.height, shape.width, tcfg.inner_dim,
        tcfg.num_heads, theta=tcfg.rope_theta, max_pos=tcfg.max_pos, fps=fps,
    )
    pe = (jnp.asarray(cos), jnp.asarray(sin))

    skip_sa = skip_ff = None
    if guidance.use_stg:
        skip_sa, skip_ff = dit.stg_skip_masks(
            tcfg, b * g, guidance.stg_blocks,
            perturbed_rows=[i * g + g - 1 for i in range(b)]
        )

    cond_mask = None
    if conditioning_mask is not None:
        cond_mask = jnp.asarray(conditioning_mask, jnp.float32)  # (1, T)
    cond_lat = None
    if cond_mask is not None and image_cond_noise_scale > 0:
        if conditioned_latent is None:
            raise InvalidConfigurationError(
                "image_cond_noise_scale > 0 requires conditioned_latent "
                "(the clean injection source)")
        cond_lat = jnp.asarray(conditioned_latent, jnp.float32)

    fidx = fmask = None
    if cond_frame_idx is not None:
        if cond_mask is None:
            raise InvalidConfigurationError(
                "cond_frame_idx requires conditioning_mask")
        fidx = np.asarray(cond_frame_idx, np.int64).reshape(-1)
        if fidx.size == 0 or (np.diff(fidx) <= 0).any():
            raise InvalidConfigurationError(
                "cond_frame_idx must be non-empty, strictly increasing")
        if fidx[0] < 0 or fidx[-1] >= shape.frames:
            raise InvalidConfigurationError(
                f"cond_frame_idx {fidx.tolist()} out of range "
                f"[0, {shape.frames})")
        m = np.zeros((1, 1, shape.frames, 1, 1), bool)
        m[:, :, fidx] = True
        fmask = jnp.asarray(m)
        if cond_lat is not None and cond_lat.shape[2] != fidx.size:
            raise InvalidConfigurationError(
                f"conditioned_latent has {cond_lat.shape[2]} frames, "
                f"cond_frame_idx names {fidx.size}")

    cas = (guidance.cross_attention_scale
           if guidance.cross_attention_scale != 1.0 else None)

    # Params, context and RoPE tables are jit ARGUMENTS, not closures:
    # closed-over arrays lower as program constants, embedding the full
    # multi-GB weight pytree into the executable.
    @partial(jax.jit, donate_argnums=(4,))
    def _step(dit_params, context, context_bias, pe,
              latent, sigma, sigma_next, prev_velocity, has_prev, key,
              cond_latent=None):
        sigma = jnp.asarray(sigma, jnp.float32)
        sigma_next = jnp.asarray(sigma_next, jnp.float32)

        # I2V/extension: re-noise the conditioned frames BEFORE the
        # transformer, FROM THE CLEAN conditioned latent (fresh noise per
        # step, quadratic decay — no accumulation across steps;
        # reference: LTXPipeline.swift:2224-2229)
        if cond_lat is not None:
            noise = jax.random.normal(key, cond_latent.shape,
                                      cond_latent.dtype)
            noised = cond_latent + image_cond_noise_scale * noise * sigma**2
            if fidx is not None:
                latent = latent.at[:, :, fidx].set(
                    noised.astype(latent.dtype))
            else:
                latent = latent.at[:, :, :cond_frames].set(
                    noised.astype(latent.dtype))

        tokens = patchify(latent).astype(jnp.bfloat16)  # (B, T, C)
        if b == 1:
            tokens_g = jnp.tile(tokens, (g, 1, 1))
        else:
            # B-major rows: sample i's guidance rows at i*g .. i*g+g-1
            # (matches build_guidance_context_batched's context layout)
            tokens_g = jnp.repeat(tokens, g, axis=0)

        if cond_mask is not None:
            # per-token timestep: frame-0 tokens sigma=0 (clean)
            timesteps = jnp.tile(sigma * (1 - cond_mask), (b * g, 1))
        else:
            timesteps = jnp.full((b * g,), sigma, jnp.float32)

        if pp_mesh is not None:
            from ltx_jax.parallel.pipeline import dit_forward_pp

            vel_tokens = dit_forward_pp(
                dit_params, tokens_g, context, timesteps, pe, tcfg,
                pp_mesh, context_bias=context_bias,
                skip_self_attn=skip_sa, skip_ff=skip_ff,
                cross_attn_scale=cas, n_microbatches=pp_microbatches,
                sdpa_impl=sdpa_impl, remat=remat,
            )  # (G, T, C)
        else:
            vel_tokens = dit.dit_forward(
                dit_params, tokens_g, context, timesteps, pe, tcfg,
                context_bias=context_bias,
                skip_self_attn=skip_sa, skip_ff=skip_ff,
                cross_attn_scale=cas, sdpa_impl=sdpa_impl, remat=remat,
            )  # (G, T, C)

        rows = unpatchify(
            vel_tokens,
            dataclasses.replace(shape, batch=b * g),
        ).astype(jnp.float32)  # (B*G, C, F, H, W)

        if b == 1:
            def row(j):  # keeps the B=1 lowering byte-identical
                return rows[j: j + 1]
        else:
            rr = rows.reshape(b, g, *rows.shape[1:])

            def row(j):  # (B, C, F, H, W): row j of every sample
                return rr[:, j]

        if guidance.use_cfg:
            uncond, cond = row(0), row(1)
            velocity = apply_cfg(uncond, cond, guidance.cfg_scale)
            if guidance.guidance_rescale > 0:
                velocity = apply_guidance_rescale(
                    velocity, cond, guidance.guidance_rescale
                )
        else:
            velocity = row(0)

        if guidance.use_stg:
            perturbed = row(g - 1)
            velocity = velocity + guidance.stg_scale * (velocity - perturbed)

        if guidance.ge_gamma > 0:
            ge = guidance.ge_gamma * (velocity - prev_velocity) + prev_velocity
            velocity = jnp.where(has_prev, ge, velocity)

        if fidx is not None:
            # keyframes at arbitrary positions: Euler everywhere, carry
            # the conditioned frames through a mask (values identical to
            # the slice-and-concat leading path — euler_step is
            # elementwise)
            stepped = euler_step(latent, velocity, sigma, sigma_next)
            new_latent = jnp.where(fmask, latent, stepped)
        elif cond_mask is not None:
            # Euler only the generated frames; conditioned frames carry
            # (reference: LTXPipeline.swift:2349-2365)
            stepped = euler_step(
                latent[:, :, cond_frames:], velocity[:, :, cond_frames:],
                sigma, sigma_next
            )
            new_latent = jnp.concatenate(
                [latent[:, :, :cond_frames], stepped], axis=2)
        else:
            new_latent = euler_step(latent, velocity, sigma, sigma_next)

        return new_latent, velocity

    def step(latent, sigma, sigma_next, prev_velocity, has_prev, key):
        return _step(dit_params, context, context_bias, pe,
                     latent, sigma, sigma_next, prev_velocity, has_prev, key,
                     cond_lat)

    step._jit = _step  # expose for cache introspection in tests
    step._pe = pe      # expose for AOT warm-compile (generate._start_warm_compile)
    return step


def make_av_denoise_step(
    params,
    tcfg: TransformerConfig,
    guidance: GuidanceSpec,
    shape: VideoLatentShape,
    audio_frames: int,
    video_context,        # (G, S, caption)
    audio_context,        # (G, S, caption)
    context_bias,         # (G, 1, 1, S) or None
    conditioning_mask=None,
    conditioned_latent=None,  # (1, C, cond_frames, h, w) CLEAN cond latent
    image_cond_noise_scale: float = 0.0,
    cond_frames: int = 1,
    cond_frame_idx=None,      # (K,) int latent-frame indices held clean at
                              # ARBITRARY positions (AV keyframe anchoring;
                              # supersedes cond_frames when given — the AV
                              # twin of make_denoise_step's path)
    audio_cond_frames: int = 0,       # leading AUDIO latent frames held
                                      # clean (AV chain audio continuity
                                      # experiment — round 5)
    audio_conditioned_latent=None,    # (1, K_a, C_a) clean packed source
    fps: float = 24.0,
    sdpa_impl: str = "auto",
    remat: bool = False,
    video_euler: str = "scheduler",
    pp_mesh=None,
    pp_microbatches=None,
):
    """Dual video+audio denoise step, guidance rows batched.

    Reference runs cond/uncond as serial dual-transformer passes
    (LTXPipeline.swift:1313-1381); here they batch. Video steps via the
    f32 Euler with bf16 round-trip; audio uses the reference's inline form
    x += (sigma_next - sigma) * v (LTXPipeline.swift:1402). Guidance rescale
    applies to VIDEO only, matching the reference. STG is not defined for
    the AV path (reference has no STG in generateVideoWithAudio).

    video_euler: "scheduler" = the f32/bf16-round-trip scheduler step
    (stage 1 of every AV path); "plain" = x += dt * v, which is what the
    reference uses for VIDEO in stage 2 of the audio two-stage path
    (LTXPipeline.swift:1800-1816) instead of scheduler.step.

    audio_cond_frames > 0 conditions the first K_a AUDIO latent frames
    exactly like the video path conditions video frames: per-token audio
    timestep 0 on those frames, per-step clean-source injection from
    audio_conditioned_latent (noise keyed by fold_in(key, 1) so the VIDEO
    injection draw is unchanged), and carry through the audio Euler. The
    AV chain's audio-continuity experiment (the model was not explicitly
    trained for audio conditioning; crossfade stays the default).

    pp_mesh: a ("data", "pipe") mesh runs the dual transformer's stacked
    block axis as a GPipe pipeline (parallel/pipeline.py::dit_av_forward_pp
    — the (video, audio) activation pair hops stages together); guidance
    rows microbatch. Numerics match the sequential forward exactly.
    """
    from ltx_jax.models import dit_av

    if guidance.use_stg:
        raise InvalidConfigurationError(
            "STG is not supported on the audio+video path")
    g = guidance.num_rows
    # RoPE tables are jit ARGUMENTS, not closures: closed-over arrays lower
    # as program constants — at 19840 stage-2 tokens the tables are ~650 MB
    # and the remote compile payload exceeds the backend's request limit
    # (HTTP 413; same invariant as make_denoise_step's pe argument).
    ropes = jax.tree.map(
        jnp.asarray,
        dit_av.prepare_av_ropes(
            tcfg, shape.frames, shape.height, shape.width, audio_frames,
            fps=fps,
        ),
    )

    cond_mask = None
    if conditioning_mask is not None:
        cond_mask = jnp.asarray(conditioning_mask, jnp.float32)
    cond_lat = None
    if cond_mask is not None and image_cond_noise_scale > 0:
        if conditioned_latent is None:
            raise InvalidConfigurationError(
                "image_cond_noise_scale > 0 requires conditioned_latent "
                "(the clean injection source)")
        cond_lat = jnp.asarray(conditioned_latent, jnp.float32)

    fidx = fmask = None
    if cond_frame_idx is not None:
        if cond_mask is None:
            raise InvalidConfigurationError(
                "cond_frame_idx requires conditioning_mask")
        fidx = np.asarray(cond_frame_idx, np.int64).reshape(-1)
        if fidx.size == 0 or (np.diff(fidx) <= 0).any():
            raise InvalidConfigurationError(
                "cond_frame_idx must be non-empty, strictly increasing")
        if fidx[0] < 0 or fidx[-1] >= shape.frames:
            raise InvalidConfigurationError(
                f"cond_frame_idx {fidx.tolist()} out of range "
                f"[0, {shape.frames})")
        m = np.zeros((1, 1, shape.frames, 1, 1), bool)
        m[:, :, fidx] = True
        fmask = jnp.asarray(m)
        if cond_lat is not None and cond_lat.shape[2] != fidx.size:
            raise InvalidConfigurationError(
                f"conditioned_latent has {cond_lat.shape[2]} frames, "
                f"cond_frame_idx names {fidx.size}")

    a_k = int(audio_cond_frames)
    a_cond_mask = a_cond_lat = None
    if a_k > 0:
        if not a_k < audio_frames:
            raise InvalidConfigurationError(
                f"audio_cond_frames {a_k} must be < audio_frames "
                f"{audio_frames}")
        am = np.zeros((1, audio_frames), np.float32)
        am[:, :a_k] = 1.0
        a_cond_mask = jnp.asarray(am)
        if image_cond_noise_scale > 0:
            if audio_conditioned_latent is None:
                raise InvalidConfigurationError(
                    "audio_cond_frames with injection requires "
                    "audio_conditioned_latent (the clean source)")
            a_cond_lat = jnp.asarray(audio_conditioned_latent, jnp.float32)
            if a_cond_lat.shape[1] != a_k:
                raise InvalidConfigurationError(
                    f"audio_conditioned_latent has {a_cond_lat.shape[1]} "
                    f"frames, audio_cond_frames is {a_k}")

    @partial(jax.jit, donate_argnums=(5, 6))
    def _step(params, v_ctx, a_ctx, bias, ropes, video_latent, audio_packed,
              sigma, sigma_next, key, cond_latent=None,
              audio_cond_latent=None):
        sigma = jnp.asarray(sigma, jnp.float32)
        sigma_next = jnp.asarray(sigma_next, jnp.float32)

        # re-noise conditioned frames FROM THE CLEAN latent (no
        # accumulation; reference: LTXPipeline.swift:2224-2229)
        if cond_lat is not None:
            noise = jax.random.normal(key, cond_latent.shape,
                                      cond_latent.dtype)
            noised = cond_latent + image_cond_noise_scale * noise * sigma**2
            if fidx is not None:
                video_latent = video_latent.at[:, :, fidx].set(
                    noised.astype(video_latent.dtype))
            else:
                video_latent = video_latent.at[:, :, :cond_frames].set(
                    noised.astype(video_latent.dtype))

        # audio continuity: re-noise the conditioned AUDIO frames from
        # their clean source too (fold_in keeps the video draw unchanged)
        if a_cond_lat is not None:
            a_noise = jax.random.normal(jax.random.fold_in(key, 1),
                                        audio_cond_latent.shape,
                                        audio_cond_latent.dtype)
            a_noised = (audio_cond_latent
                        + image_cond_noise_scale * a_noise * sigma**2)
            audio_packed = audio_packed.at[:, :a_k].set(
                a_noised.astype(audio_packed.dtype))

        v_tokens = jnp.tile(patchify(video_latent).astype(jnp.bfloat16),
                            (g, 1, 1))
        a_tokens = jnp.tile(audio_packed.astype(jnp.bfloat16), (g, 1, 1))

        if cond_mask is not None:
            ts_v = jnp.tile(sigma * (1 - cond_mask), (g, 1))
        else:
            ts_v = jnp.full((g,), sigma, jnp.float32)
        if a_cond_mask is not None:
            ts_a = jnp.tile(sigma * (1 - a_cond_mask), (g, 1))
        else:
            ts_a = jnp.full((g,), sigma, jnp.float32)

        if pp_mesh is not None:
            from ltx_jax.parallel.pipeline import dit_av_forward_pp

            v_vel_tok, a_vel_tok = dit_av_forward_pp(
                params, v_tokens, a_tokens, v_ctx, a_ctx, ts_v, ts_a, ropes,
                tcfg, pp_mesh, video_bias=bias, audio_bias=bias,
                n_microbatches=pp_microbatches, sdpa_impl=sdpa_impl,
                remat=remat,
            )
        else:
            v_vel_tok, a_vel_tok = dit_av.dit_av_forward(
                params, v_tokens, a_tokens, v_ctx, a_ctx, ts_v, ts_a, ropes,
                tcfg, video_bias=bias, audio_bias=bias, sdpa_impl=sdpa_impl,
                remat=remat,
            )
        v_rows = unpatchify(
            v_vel_tok, dataclasses.replace(shape, batch=g)
        ).astype(jnp.float32)
        a_rows = a_vel_tok.astype(jnp.float32)

        if guidance.use_cfg:
            v_vel = apply_cfg(v_rows[0:1], v_rows[1:2], guidance.cfg_scale)
            a_vel = apply_cfg(a_rows[0:1], a_rows[1:2], guidance.cfg_scale)
            if guidance.guidance_rescale > 0:  # video only
                v_vel = apply_guidance_rescale(
                    v_vel, v_rows[1:2], guidance.guidance_rescale)
        else:
            v_vel, a_vel = v_rows[0:1], a_rows[0:1]

        if video_euler == "plain":
            def _vstep(lat, vel):
                return (lat.astype(jnp.float32)
                        + (sigma_next - sigma) * vel).astype(lat.dtype)
        else:
            def _vstep(lat, vel):
                return euler_step(lat, vel, sigma, sigma_next)

        if fidx is not None:
            # keyframe anchors at arbitrary positions: step everywhere,
            # carry conditioned frames via the mask (values identical to
            # the slice-and-concat leading path — _vstep is elementwise)
            new_video = jnp.where(fmask, video_latent,
                                  _vstep(video_latent, v_vel))
        elif cond_mask is not None:
            stepped = _vstep(video_latent[:, :, cond_frames:],
                             v_vel[:, :, cond_frames:])
            new_video = jnp.concatenate(
                [video_latent[:, :, :cond_frames], stepped], axis=2)
        else:
            new_video = _vstep(video_latent, v_vel)

        new_audio = (audio_packed.astype(jnp.float32)
                     + (sigma_next - sigma) * a_vel)
        if a_cond_mask is not None:
            # conditioned audio frames carry (like the video path)
            new_audio = jnp.concatenate(
                [audio_packed[:, :a_k].astype(jnp.float32),
                 new_audio[:, a_k:]], axis=1)
        return new_video, new_audio

    def step(video_latent, audio_packed, sigma, sigma_next, key):
        return _step(params, video_context, audio_context, context_bias,
                     ropes, video_latent, audio_packed, sigma, sigma_next,
                     key, cond_lat, a_cond_lat)

    step._jit = _step
    step._ropes = ropes  # expose for context/tail rebind (AV chain)
    return step


def run_av_denoise_loop(step_fn, video_latent, audio_packed, sigmas,
                        key=None, on_step=None):
    video_latent = jnp.array(video_latent)
    audio_packed = jnp.array(audio_packed)
    if key is None:
        key = jax.random.key(0)
    num_steps = len(sigmas) - 1
    for i in range(num_steps):
        key, sub = jax.random.split(key)
        video_latent, audio_packed = step_fn(
            video_latent, audio_packed, float(sigmas[i]), float(sigmas[i + 1]),
            sub,
        )
        if on_step is not None:
            device_sync(video_latent)
            on_step(i, num_steps, float(sigmas[i]))
    return video_latent, audio_packed


def run_denoise_loop(
    step_fn,
    latent,
    sigmas: np.ndarray,
    key=None,
    on_step=None,
    checkpoint=None,
    seed: int = 0,
):
    """Drive the compiled step over the host-side sigma schedule.

    The loop is host-side (progress callbacks, per-step timing) but each
    iteration is a single device program; sigma values are traced so every
    step shares the first compilation.

    checkpoint: optional utils.diagnostics.DenoiseCheckpoint — persists the
    latent every N steps and resumes an interrupted run exactly (PRNG key
    splits are fast-forwarded so resumed noise draws match).
    """
    from ltx_jax.utils.diagnostics import diag_stats

    # the step donates its latent input; copy so the caller's array survives
    latent = jnp.array(latent)
    velocity = jnp.zeros_like(latent)
    has_prev = jnp.asarray(False)
    if key is None:
        key = jax.random.key(0)
    num_steps = len(sigmas) - 1

    resume_from = -1
    if checkpoint is not None:
        state = checkpoint.load()
        if (state is not None
                and np.shape(state["sigmas"]) == np.shape(sigmas)
                and np.allclose(state["sigmas"], sigmas)):
            latent = jnp.asarray(state["latent"])
            velocity = jnp.asarray(state["velocity"])
            resume_from = state["step"]
            has_prev = jnp.asarray(True)

    for i in range(num_steps):
        key, sub = jax.random.split(key)  # advance even when skipping
        if i <= resume_from:
            continue
        latent, velocity = step_fn(
            latent, float(sigmas[i]), float(sigmas[i + 1]), velocity,
            has_prev, sub,
        )
        has_prev = jnp.asarray(True)
        if checkpoint is not None:
            checkpoint.save(i, latent, velocity, sigmas, seed)
        diag_stats(f"denoise step {i} latent", latent)
        if on_step is not None:
            device_sync(latent)
            on_step(i, num_steps, float(sigmas[i]))
    return latent
