"""Structured synthetic Gemma checkpoint (VERDICT r3 #5): the cycle model
makes prompt-lookup speculation MEASURABLE offline — random weights are
zero-accept by construction, real weights are unavailable (zero egress).

Pins: (1) the cycle model actually walks its token cycle under the REAL
sampler settings (temp 0.7 / top-p 0.95 / penalty 1.1); (2) spec_k>0 on it
reaches high acceptance (few verify forwards per token); (3) speculative
output == sequential output at temperature 0 (exactness, on an accepting
stream rather than test_gemma_spec's synthetic streams); (4) the margin
knob trades acceptance down.
"""

import jax
import numpy as np
import pytest

from ltx_jax.models import gemma3
from ltx_jax.weights.synthetic import default_cycle, make_cycle_gemma_params

CFG = gemma3.Gemma3Config().tiny()
CYCLE = default_cycle(CFG, period=11)


@pytest.fixture(scope="module")
def params():
    return make_cycle_gemma_params(CFG, jax.random.key(0), cycle=CYCLE)


def _prompt():
    # ends ON the cycle so generation continues it immediately
    return np.asarray((5, 7, 9) + CYCLE + CYCLE[:4], np.int32)


def test_cycle_model_walks_cycle_greedy(params):
    toks = gemma3.generate_tokens(
        params, _prompt(), CFG, jax.random.key(1), max_new_tokens=24,
        temperature=0.0, stop_tokens=())
    period = len(CYCLE)
    start = CYCLE.index(toks[0])
    want = [CYCLE[(start + i) % period] for i in range(len(toks))]
    assert toks == want


def test_cycle_model_walks_cycle_sampled(params):
    """Under the REAL enhancement sampler settings the margin keeps
    p(successor) ~ 1 — the sampled stream follows the cycle with rare
    glitches (those glitches are exactly what gives the fixture a
    non-trivial acceptance rate instead of a synthetic 100%)."""
    toks = gemma3.generate_tokens(
        params, _prompt(), CFG, jax.random.key(2), max_new_tokens=24,
        temperature=0.7, top_p=0.95, repetition_penalty=1.1,
        stop_tokens=())
    follows = sum(
        1 for a, b in zip(toks, toks[1:])
        if a in CYCLE and b == CYCLE[(CYCLE.index(a) + 1) % len(CYCLE)])
    assert follows >= 0.85 * (len(toks) - 1), toks


def test_spec_acceptance_high_on_cycle(params):
    """The point of the fixture: prompt-lookup drafts verify — tokens per
    verify forward approach spec_k+1 instead of 1."""
    toks, stats = gemma3.generate_tokens(
        params, _prompt(), CFG, jax.random.key(3), max_new_tokens=48,
        temperature=0.7, top_p=0.95, repetition_penalty=1.1,
        stop_tokens=(), spec_k=4, return_stats=True)
    assert len(toks) == 48
    rate = len(toks) / stats["forwards"]
    assert rate > 3.0, f"commit rate {rate} (forwards={stats['forwards']})"


def test_spec_greedy_identical_on_cycle(params):
    seq = gemma3.generate_tokens(
        params, _prompt(), CFG, jax.random.key(4), max_new_tokens=32,
        temperature=0.0, stop_tokens=())
    spec = gemma3.generate_tokens(
        params, _prompt(), CFG, jax.random.key(4), max_new_tokens=32,
        temperature=0.0, stop_tokens=(), spec_k=6)
    assert spec == seq


def test_branch_lowers_acceptance_vs_deterministic():
    """The acceptance knob the on-chip probe sweeps: a branching cycle
    (real sampling entropy) commits fewer tokens per verify forward than
    the deterministic cycle. (Margin/temperature CANNOT do this — any
    deterministic stream self-predicts; module docstring.)"""
    det = make_cycle_gemma_params(CFG, jax.random.key(0), cycle=CYCLE,
                                  branch=0.0)
    branchy = make_cycle_gemma_params(CFG, jax.random.key(0), cycle=CYCLE,
                                      branch=1.0)

    def rate(p):
        toks, stats = gemma3.generate_tokens(
            p, _prompt(), CFG, jax.random.key(5), max_new_tokens=48,
            temperature=0.7, top_p=0.95, repetition_penalty=1.1,
            stop_tokens=(), spec_k=4, return_stats=True)
        return len(toks) / max(stats["forwards"], 1)

    assert rate(det) > rate(branchy) > 1.0


def test_batched_input_embeds_rows_match_single(params):
    """VERDICT r3 #8: the batched decode path accepts per-row input_embeds
    (VLM soft-token rows batch with text rows in one compiled program);
    greedy rows match their solo generate_tokens runs."""
    import jax.numpy as jnp

    scale = jnp.asarray(np.sqrt(CFG.hidden_size),
                        gemma3.embed_dtype(params))
    ids_a = [int(x) for x in _prompt()]
    # "image" row: 4 random soft tokens spliced between two text spans
    pre, post = ids_a[:4], ids_a[4:]
    soft = jax.random.normal(jax.random.key(9), (1, 4, CFG.hidden_size),
                             jnp.float32)
    e = jnp.concatenate([
        gemma3._embed_lookup(params, jnp.asarray(pre))[None] * scale,
        soft,
        gemma3._embed_lookup(params, jnp.asarray(post))[None] * scale,
    ], axis=1)
    ids_b = [0] * e.shape[1]

    solo_text = gemma3.generate_tokens(
        params, ids_a, CFG, jax.random.key(0), max_new_tokens=10,
        temperature=0.0, stop_tokens=())
    solo_vlm = gemma3.generate_tokens(
        params, [ids_b], CFG, jax.random.key(0), max_new_tokens=10,
        temperature=0.0, stop_tokens=(), input_embeds=e)

    batched = gemma3.generate_tokens_batched(
        params, [ids_a, ids_b], CFG, jax.random.key(0), max_new_tokens=10,
        temperature=0.0, stop_tokens=(), input_embeds=[None, e])
    assert batched[0] == solo_text
    assert batched[1] == solo_vlm


def test_branch_knob_gives_partial_acceptance():
    """branch=1.0 mixes a second equal-logit successor: the stream gains
    REAL sampling entropy, so speculation lands strictly between the
    sequential floor (1 tok/forward) and the full-accept ceiling — the
    regime real checkpoints live in."""
    p = make_cycle_gemma_params(CFG, jax.random.key(0), cycle=CYCLE,
                                branch=1.0)
    toks, stats = gemma3.generate_tokens(
        p, _prompt(), CFG, jax.random.key(3), max_new_tokens=48,
        temperature=0.7, top_p=0.95, repetition_penalty=1.1,
        stop_tokens=(), spec_k=4, return_stats=True)
    rate = len(toks) / max(stats["forwards"], 1)
    assert 1.2 < rate < 4.5, rate
