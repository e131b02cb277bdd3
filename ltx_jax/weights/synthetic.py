"""Structured synthetic Gemma checkpoints — measurable speculation offline.

Random weights are ADVERSARIAL for prompt-lookup speculative decoding: the
sampled stream almost never repeats its own n-grams, so acceptance is ~0 and
the bench headline cannot show the spec gain. Real checkpoints repeat phrasing constantly — but zero
egress means no real weights. This module builds a CYCLE model: a Gemma
whose greedy/sampled output walks a fixed token cycle, so the generated
stream repeats its own n-grams by construction and prompt-lookup acceptance
is high, controllable, and measurable on the device.

Construction (all device-side — nothing big crosses from the host):

* Embedding rows: coordinate 0 pinned to `kappa` (a constant every hidden
  state carries), the rest i.i.d. normal with RMS ~1 -> every row has
  RMS ~1. Tied lm_head as usual.
* All layers zero EXCEPT layer 0's MLP, which implements a LINEAR map via
  the gelu-passthrough trick: gate_proj row 0 = gamma, so every
  intermediate channel's gate is gamma*kappa (constant, >> 0) and
  gelu(gate)*up ~= (gamma*kappa) * (h @ up_proj) — linear in h. up/down
  then factor S = sum_j u_{succ(j)} u_j^T (successor map over the cycle
  embeddings) + entry_bias * u_{c0} e_0^T (a constant pull INTO the cycle
  for any off-cycle state, riding the pinned coordinate).
* post_feedforward_layernorm weight = margin-1: the successor direction is
  re-normalized then amplified x margin over the residual's self
  direction, so logits rank succ(i) first by a controllable margin.
* Acceptance control is `branch` + `logit_scale`, NOT margin/temperature:
  any deterministic stream (sharp cycle OR degenerate self-repeat) is
  perfectly self-predictable, so prompt-lookup accepts ~fully at every
  margin (measured on-chip: 8.53 tok/forward at margins 24 and 0.15
  alike, and still at temperature 5). branch mixes a second equal-logit
  successor (real coin flips); logit_scale shrinks the logit gaps so
  bf16/int8 rounding can't silently break the tie at the 12B width.

The result is a REAL checkpoint for the real architecture: the full decode
program (48-layer scan, KV cache, sampler, penalty) runs unchanged; only
the weight VALUES are engineered. Verification: tests/test_spec_synthetic.py
pins cycle-following + >0.9 acceptance on the tiny config;
scripts/spec_acceptance_probe.py measures acceptance at full size.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ltx_jax.models.gemma3 import Gemma3Config


def default_cycle(cfg: Gemma3Config, period: int = 17) -> Tuple[int, ...]:
    """Cycle token ids: clear of special ids (0..3) and of each other."""
    lo = 100 if cfg.vocab_size > 100 + period else 4
    return tuple(range(lo, lo + period))


def make_cycle_gemma_params(
    cfg: Gemma3Config,
    key,
    cycle: Sequence[int] = (),
    margin: float = 24.0,
    entry_bias: float = 0.5,
    kappa: float = 4.0,
    gamma: float = 3.0,
    branch: float = 0.0,
    logit_scale: float = 1.0,
    dtype=jnp.float32,
):
    """Build the cycle-model params (device arrays; see module docstring).

    margin: amplification of the successor direction over the residual,
    in RESIDUAL-RMS units (the residual is the sqrt(hidden)-scaled
    embedding row, RMS sqrt(d)).
    entry_bias: pull toward cycle[0] from any off-cycle state (prompt
    tokens land here after one step).
    branch: the ACCEPTANCE knob — weight of a SECOND successor (skip-one,
    succ^2) mixed into the map: branch=1.0 makes the two successors
    equal-probability coin flips, drafts follow whichever branch history
    took last time, and verification rejects mid-stream — genuine
    rejection + correction traffic (module docstring has why margin and
    temperature cannot do this).
    logit_scale: final-norm gain on ALL logits; at the 12B width the raw
    logit magnitudes are large enough that bf16/int8 rounding noise breaks
    a branch=1.0 tie deterministically (measured on-chip) — scaling the
    logits down makes the branch a REAL coin flip under sampling.
    """
    d, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nl, hd = cfg.hidden_layers, cfg.head_dim
    cycle = tuple(cycle) or default_cycle(cfg)
    p = len(cycle)
    if inter < d:
        raise ValueError("intermediate_size must be >= hidden_size")

    k_emb, = jax.random.split(key, 1)
    # embedding: coordinate 0 = kappa, rest ~N(0, 1) -> row RMS ~1 (built
    # ON DEVICE: the full-size table is ~4 GB f32)
    emb = jax.random.normal(k_emb, (v, d), jnp.float32)
    emb = emb.at[:, 0].set(kappa)
    emb = emb / jnp.sqrt(jnp.mean(emb * emb, axis=1, keepdims=True))

    cyc = jnp.asarray(cycle, jnp.int32)
    succ = jnp.roll(cyc, -1)
    # matching basis u: the pinned coordinate is COMMON to every embedding
    # (that's its job — the entry term rides it), so it must be projected
    # OUT of the match directions or every state matches every cycle row
    # with coefficient ~kappa^2 and the successor drowns in cross-talk.
    u = emb[cyc]                       # (p, d), rows RMS ~1
    u = u.at[:, 0].set(0.0)
    u = u / jnp.linalg.norm(u, axis=1, keepdims=True)   # unit L2
    w = emb[succ]
    w = w / jnp.linalg.norm(w, axis=1, keepdims=True)
    if branch > 0.0:
        w2 = emb[jnp.roll(cyc, -2)]
        w2 = w2 / jnp.linalg.norm(w2, axis=1, keepdims=True)
        w = w + branch * w2
    # S: h ~ unit-L2-normalized cycle row u_i -> unit successor row w_i;
    # + entry: any state's pinned coordinate pulls toward cycle[0]
    s_map = u.T @ w                    # (d, d)
    # successor coefficient for an on-cycle state is <normed(E_i), u_i> =
    # sqrt(d) (unit-RMS row vs unit-L2 row). The entry pull rides the
    # pinned coordinate (value kappa in every state), so normalize its
    # strength to entry_bias * sqrt(d): below the successor (cycle states
    # keep advancing) but above the ~sqrt(p) cross-talk (off-cycle states
    # land on the cycle).
    e0 = jnp.zeros((d,), jnp.float32).at[0].set(1.0)
    s_map = s_map + (entry_bias * np.sqrt(d) / kappa) * jnp.outer(e0, w[0])

    def zeros(*shape):
        return jnp.zeros(shape, dtype)

    # layer 0 MLP: gate row 0 = gamma (gate == gamma*kappa' > 0 constant),
    # up carries S into the first d intermediate channels, down reads them
    # back with the 1/(gamma*kappa) correction folded in. kappa' is the
    # pinned coordinate AFTER the pre-FFN rms_norm (= kappa / row RMS = ~
    # kappa since rows are unit-RMS).
    gate = jnp.zeros((d, inter), jnp.float32).at[0, :].set(gamma)
    up = jnp.zeros((d, inter), jnp.float32).at[:, :d].set(s_map)
    down = (jnp.zeros((inter, d), jnp.float32)
            .at[:d, :].set(jnp.eye(d) / (gamma * kappa)))

    def stack(first, rest_shape_like):
        """(nl, ...) with `first` at layer 0, zeros after."""
        out = jnp.zeros((nl,) + first.shape, dtype)
        return out.at[0].set(first.astype(dtype))

    layers = {
        "q_proj": {"w": zeros(nl, d, cfg.attention_heads * hd)},
        "k_proj": {"w": zeros(nl, d, cfg.kv_heads * hd)},
        "v_proj": {"w": zeros(nl, d, cfg.kv_heads * hd)},
        "o_proj": {"w": zeros(nl, cfg.attention_heads * hd, d)},
        "q_norm": {"w": zeros(nl, hd)},
        "k_norm": {"w": zeros(nl, hd)},
        "gate_proj": {"w": stack(gate, None)},
        "up_proj": {"w": stack(up, None)},
        "down_proj": {"w": stack(down, None)},
        "input_layernorm": {"w": zeros(nl, d)},
        "post_attention_layernorm": {"w": zeros(nl, d)},
        # (1 + w) = margin*sqrt(d) on layer 0: the RESIDUAL is the
        # embedding row scaled by sqrt(hidden) (RMS sqrt(d), ~62 at 12B —
        # a flat `margin` RMS lost to it at full width and the stream
        # degenerated to a self-repeat, measured on-chip), so margin is
        # expressed in residual-RMS units; zero elsewhere
        "pre_feedforward_layernorm": {"w": zeros(nl, d)},
        "post_feedforward_layernorm": {
            "w": jnp.zeros((nl, d), dtype).at[0].set(
                jnp.full((d,), margin * np.sqrt(d) - 1.0, dtype))},
    }
    return {
        "embed_tokens": {"w": emb.astype(dtype)},
        "layers": layers,
        "norm": {"w": jnp.full((d,), logit_scale - 1.0, dtype)},
    }
