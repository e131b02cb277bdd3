"""Rectified-flow (flow-matching) training objective for the LTX-2 DiT.

Uses the inference scheduler's exact conventions so a trained model plugs
straight into the denoise loop:

* forward process  x_t = (1 - t) x_0 + t * noise
  (ops/schedule.py::add_noise — reference LTXScheduler.swift:334-341);
* velocity target  v* = noise - x_0
  (ops/schedule.py::velocity_target; consistent with euler_step's
  `denoised = x - sigma * v`: substituting v* recovers x_0 exactly).

The model forward is the SAME dit_forward the denoise loop jits — stacked
blocks under lax.scan, remat-able — so everything measured about the
inference step (kernel choices, TP shardings) transfers to training.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ltx_jax.core.config import TransformerConfig
from ltx_jax.models import dit
from ltx_jax.ops.schedule import add_noise, velocity_target


def sample_sigmas(key, batch: int, scheme: str = "logit_normal",
                  mean: float = 0.0, std: float = 1.0):
    """Draw per-sample noise levels t in (0, 1).

    "uniform": t ~ U(0, 1); "logit_normal": sigmoid(N(mean, std)) — the
    SD3/rectified-flow density that concentrates samples at mid noise
    levels where the velocity is hardest to predict.
    """
    if scheme == "uniform":
        return jax.random.uniform(key, (batch,), jnp.float32,
                                  minval=1e-5, maxval=1.0 - 1e-5)
    if scheme == "logit_normal":
        z = jax.random.normal(key, (batch,), jnp.float32) * std + mean
        return jax.nn.sigmoid(z)
    raise ValueError(f"unknown sigma sampling scheme: {scheme}")


def flow_match_loss(
    params,
    tokens,            # (B, T, C) patchified clean latents, float32
    context,           # (B, S, caption_channels)
    rope,              # (cos, sin) from ops.rope for the latent grid
    key,
    cfg: TransformerConfig,
    context_bias=None,       # (B, 1, 1, S) additive text mask or None
    sigma_scheme: str = "logit_normal",
    sdpa_impl: str = "auto",
    remat: bool = True,
    remat_segments: int = 0,
    compute_dtype=jnp.bfloat16,
    pp_mesh=None,
    pp_microbatches=None,
):
    """Mean-squared velocity-matching loss. Returns (loss, aux dict).

    Noise levels and noise are drawn from `key` (threaded per step by the
    caller); the loss reduces in float32. pp_mesh (a ("data", "pipe") mesh,
    parallel/pipeline.py) swaps the forward for the GPipe pipeline schedule
    — numerics identical to the sequential scan.
    """
    b = tokens.shape[0]
    k_sigma, k_noise = jax.random.split(key)
    sigma = sample_sigmas(k_sigma, b, sigma_scheme)        # (B,)
    noise = jax.random.normal(k_noise, tokens.shape, jnp.float32)

    x0 = tokens.astype(jnp.float32)
    x_t = add_noise(x0, noise, sigma[:, None, None])
    target = velocity_target(x0, noise)

    if pp_mesh is not None:
        from ltx_jax.parallel.pipeline import dit_forward_pp

        v_pred = dit_forward_pp(
            params, x_t.astype(compute_dtype), context, sigma, rope, cfg,
            pp_mesh, context_bias=context_bias,
            n_microbatches=pp_microbatches, sdpa_impl=sdpa_impl,
            remat=remat,
        ).astype(jnp.float32)
    else:
        v_pred = dit.dit_forward(
            params, x_t.astype(compute_dtype), context, sigma, rope, cfg,
            context_bias=context_bias, sdpa_impl=sdpa_impl, remat=remat,
            remat_segments=remat_segments,
        ).astype(jnp.float32)

    err = v_pred - target
    loss = jnp.mean(jnp.square(err))
    return loss, {"loss": loss, "sigma_mean": jnp.mean(sigma)}


def av_flow_match_loss(
    params,
    video_tokens,      # (B, Tv, C) patchified clean video latents
    audio_tokens,      # (B, Ta, C_audio) packed clean audio latents
    video_context,     # (B, S, caption_channels)
    audio_context,     # (B, S, caption_channels)
    ropes,             # from models.dit_av.prepare_av_ropes
    key,
    cfg: TransformerConfig,
    video_bias=None,
    audio_bias=None,
    audio_loss_weight: float = 1.0,
    sigma_scheme: str = "logit_normal",
    sdpa_impl: str = "auto",
    remat: bool = True,
    remat_segments: int = 0,
    compute_dtype=jnp.bfloat16,
    pp_mesh=None,
    pp_microbatches=None,
):
    """Joint rectified-flow loss for the dual AV transformer.

    Video and audio streams draw INDEPENDENT noise levels (each stream's
    velocity must be correct at any (t_video, t_audio) pair — the joint
    denoise loop steps them on separate sigma schedules); the total is
    mse_video + audio_loss_weight * mse_audio, reduced in float32.
    """
    from ltx_jax.models import dit_av

    b = video_tokens.shape[0]
    k_sv, k_sa, k_nv, k_na = jax.random.split(key, 4)
    sigma_v = sample_sigmas(k_sv, b, sigma_scheme)
    sigma_a = sample_sigmas(k_sa, b, sigma_scheme)
    noise_v = jax.random.normal(k_nv, video_tokens.shape, jnp.float32)
    noise_a = jax.random.normal(k_na, audio_tokens.shape, jnp.float32)

    v0 = video_tokens.astype(jnp.float32)
    a0 = audio_tokens.astype(jnp.float32)
    v_t = add_noise(v0, noise_v, sigma_v[:, None, None])
    a_t = add_noise(a0, noise_a, sigma_a[:, None, None])

    if pp_mesh is not None:
        from ltx_jax.parallel.pipeline import dit_av_forward_pp

        v_pred, a_pred = dit_av_forward_pp(
            params, v_t.astype(compute_dtype), a_t.astype(compute_dtype),
            video_context, audio_context, sigma_v, sigma_a, ropes, cfg,
            pp_mesh, video_bias=video_bias, audio_bias=audio_bias,
            n_microbatches=pp_microbatches, sdpa_impl=sdpa_impl,
            remat=remat,
        )
    else:
        v_pred, a_pred = dit_av.dit_av_forward(
            params, v_t.astype(compute_dtype), a_t.astype(compute_dtype),
            video_context, audio_context, sigma_v, sigma_a, ropes, cfg,
            video_bias=video_bias, audio_bias=audio_bias,
            sdpa_impl=sdpa_impl, remat=remat,
            remat_segments=remat_segments,
        )
    loss_v = jnp.mean(jnp.square(v_pred.astype(jnp.float32)
                                 - velocity_target(v0, noise_v)))
    loss_a = jnp.mean(jnp.square(a_pred.astype(jnp.float32)
                                 - velocity_target(a0, noise_a)))
    loss = loss_v + audio_loss_weight * loss_a
    return loss, {"loss": loss, "loss_video": loss_v, "loss_audio": loss_a}
