"""Jittable flow-matching train step — full fine-tune or LoRA-only.

The reference is inference-only (SURVEY.md); this is beyond-parity
capability reusing the inference machinery wholesale:

* the loss forward IS the denoise-loop's dit_forward (stacked blocks under
  lax.scan, rematerialized per block with `remat=True` so the 48-block
  backward fits HBM — activation memory is O(1 block), recompute is one
  extra forward);
* dp+tp sharding reuses parallel/sharding.py's partition specs unchanged —
  grads and Adam moments inherit the param shardings via GSPMD, batch rides
  the data axis (`jax.jit` propagates input shardings; no shard_map needed);
* LoRA-only mode partitions the tree (base leaves become frozen residuals
  outside the grad), so optimizer state exists ONLY for the adapters —
  QLoRA over an int4/W8A8 base costs adapter-sized Adam moments, not 19B.

Params stay pure pytrees; the optimizer is optax (AdamW + global-norm clip
+ optional linear warmup).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax

from ltx_jax.core.config import TransformerConfig
from ltx_jax.train.flow_match import flow_match_loss
from ltx_jax.train.lora import lora_param_mask


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters for make_optimizer/make_train_step."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 0
    lora_only: bool = False
    sigma_scheme: str = "logit_normal"
    # "auto" (ops/attention.choose_impl: cuDNN flash attention on a GPU for
    # long sequences — no (T, T) logits buffer — else XLA), "xla"
    # (differentiable SDPA; backward remats f32 (T, T) logits per layer),
    # "pallas" (this repository's FA-2 fwd+bwd kernels), or "ring"
    # (sequence-parallel: token axis sharded over the mesh set via
    # ops.attention.set_sequence_parallel; forward AND backward ring the
    # flash kernels — parallel/ring_attention.py custom VJP).
    sdpa_impl: str = "auto"
    remat: bool = True
    # Segmented ("sqrt") remat: checkpoint groups of num_layers/S blocks
    # instead of every block — peak scan residuals drop from L to S + L/S
    # activations (models/dit.py). 0 = per-block remat.
    remat_segments: int = 0
    compute_dtype: Any = jnp.bfloat16
    # Gradient accumulation: params update every accum_steps calls with the
    # mean of the accumulated grads (optax.MultiSteps) — one-device
    # training of batches the SDPA backward cannot fit at once.
    accum_steps: int = 1
    # Pipeline parallelism: a ("data", "pipe") Mesh (parallel/pipeline.py)
    # routes the loss forward through the GPipe schedule — stages hold L/S
    # blocks each, activations hop via ppermute, grads are exactly the
    # sequential scan's (tests/test_pp.py). Video DiT step only. None = the
    # default dp+tp path (sharding specs applied by the caller).
    pp_mesh: Any = None
    pp_microbatches: Optional[int] = None


def _is_none(x):
    return x is None


def _wd_mask(tree):
    """AdamW decays only matrix-shaped leaves (not biases/norms/scales)."""
    return jax.tree.map(lambda p: jnp.ndim(p) >= 2, tree)


def make_optimizer(tc: TrainConfig) -> optax.GradientTransformation:
    if tc.warmup_steps > 0:
        lr = optax.join_schedules(
            [optax.linear_schedule(0.0, tc.learning_rate, tc.warmup_steps),
             optax.constant_schedule(tc.learning_rate)],
            [tc.warmup_steps],
        )
    else:
        lr = tc.learning_rate
    tx = optax.chain(
        optax.clip_by_global_norm(tc.grad_clip),
        optax.adamw(lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                    weight_decay=tc.weight_decay, mask=_wd_mask),
    )
    if tc.accum_steps > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=tc.accum_steps)
    return tx


def partition_trainable(params, tc: TrainConfig):
    """(trainable, frozen) pytrees. In LoRA-only mode the trainable tree
    keeps just the {lora_a, lora_b, lora_s} leaves (None elsewhere — None
    is an empty pytree, so optax state is adapter-sized); full fine-tune
    trains everything (frozen is None)."""
    if not tc.lora_only:
        return params, None
    mask = lora_param_mask(params)
    trainable = jax.tree.map(lambda p, m: p if m else None, params, mask)
    frozen = jax.tree.map(lambda p, m: None if m else p, params, mask)
    return trainable, frozen


def combine_params(trainable, frozen):
    """Inverse of partition_trainable."""
    if frozen is None:
        return trainable
    return jax.tree.map(lambda t, f: f if t is None else t,
                        trainable, frozen, is_leaf=_is_none)


def init_train_state(params, tc: TrainConfig,
                     optimizer: Optional[optax.GradientTransformation] = None):
    """-> (trainable, frozen, opt_state)."""
    trainable, frozen = partition_trainable(params, tc)
    tx = optimizer if optimizer is not None else make_optimizer(tc)
    return trainable, frozen, tx.init(trainable)


def make_train_step(cfg: TransformerConfig, tc: TrainConfig,
                    optimizer: Optional[optax.GradientTransformation] = None,
                    donate: bool = True):
    """Build the jitted step:

        step(trainable, frozen, opt_state, tokens, context, rope, key,
             context_bias=None) -> (trainable, opt_state, metrics)

    tokens (B, T, C) are clean patchified latents; rope/context/bias are jit
    ARGUMENTS (never closures — the no-program-constants invariant). For
    dp+tp: place trainable/frozen with transformer_param_specs shardings and
    the batch with P("data") on axis 0 — jit propagates the rest.
    """
    tx = optimizer if optimizer is not None else make_optimizer(tc)

    def step(trainable, frozen, opt_state, tokens, context, rope, key,
             context_bias=None):
        def loss_fn(tr):
            p = combine_params(tr, frozen)
            return flow_match_loss(
                p, tokens, context, rope, key, cfg,
                context_bias=context_bias, sigma_scheme=tc.sigma_scheme,
                sdpa_impl=tc.sdpa_impl, remat=tc.remat, remat_segments=tc.remat_segments,
                compute_dtype=tc.compute_dtype,
                pp_mesh=tc.pp_mesh, pp_microbatches=tc.pp_microbatches,
            )

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            trainable)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        aux["grad_norm"] = optax.global_norm(grads)
        return trainable, opt_state, aux

    donate_argnums = (0, 2) if donate else ()
    return jax.jit(step, donate_argnums=donate_argnums)


def ema_init(trainable):
    """f32 COPY of the trainable leaves — the EMA state (diffusion models
    conventionally sample from the EMA weights). Must be a real copy, not
    an astype view: a donated train step consumes the trainable buffers,
    and an aliased EMA would read deleted arrays."""
    return jax.tree.map(
        lambda p: jnp.array(p, dtype=jnp.float32, copy=True), trainable)


def make_ema_update(decay: float = 0.999):
    """Jitted EMA step: ema <- decay * ema + (1 - decay) * params.

    Kept OUT of the train step so the step signature (and its donation /
    sharding contract) stays unchanged; call after each optimizer update.
    The EMA tree inherits the trainable tree's shardings via jit.
    """
    @jax.jit
    def update(ema, trainable):
        return jax.tree.map(
            lambda e, p: e * decay + p.astype(jnp.float32) * (1.0 - decay),
            ema, trainable)

    return update


def make_av_train_step(cfg: TransformerConfig, tc: TrainConfig,
                       optimizer: Optional[optax.GradientTransformation] = None,
                       donate: bool = True,
                       audio_loss_weight: float = 1.0):
    """Joint AV variant of make_train_step:

        step(trainable, frozen, opt_state, video_tokens, audio_tokens,
             video_context, audio_context, ropes, key)
          -> (trainable, opt_state, metrics)

    Same partitioning/sharding rules as the video step; the loss is
    train.flow_match.av_flow_match_loss (independent per-stream sigmas).
    """
    from ltx_jax.train.flow_match import av_flow_match_loss

    tx = optimizer if optimizer is not None else make_optimizer(tc)

    def step(trainable, frozen, opt_state, video_tokens, audio_tokens,
             video_context, audio_context, ropes, key):
        def loss_fn(tr):
            p = combine_params(tr, frozen)
            return av_flow_match_loss(
                p, video_tokens, audio_tokens, video_context, audio_context,
                ropes, key, cfg, audio_loss_weight=audio_loss_weight,
                sigma_scheme=tc.sigma_scheme, sdpa_impl=tc.sdpa_impl,
                remat=tc.remat, remat_segments=tc.remat_segments, compute_dtype=tc.compute_dtype,
                pp_mesh=tc.pp_mesh, pp_microbatches=tc.pp_microbatches,
            )

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            trainable)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        aux["grad_norm"] = optax.global_norm(grads)
        return trainable, opt_state, aux

    donate_argnums = (0, 2) if donate else ()
    return jax.jit(step, donate_argnums=donate_argnums)
