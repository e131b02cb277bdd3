"""Prompt-lookup speculative decoding (models/gemma3.py::_spec_loop).

The contract: speculative decoding is a pure LATENCY optimization —
the emitted token distribution must equal the sequential sampler's.
Greedy (temperature<=0) makes that testable as exact sequence equality;
the sampled path is pinned by a statistical test on the acceptance
primitive (spec_accept) against topp_sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.models import gemma3


@pytest.fixture(scope="module")
def tiny():
    cfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(0), cfg, jnp.float32)
    return cfg, params


PROMPT = np.asarray([5, 9, 11, 5, 9, 11, 5, 9], np.int32)


def test_greedy_sequence_identical(tiny):
    """Speculative greedy output == sequential greedy output, token for
    token, across draft widths and ngram lengths (accept AND reject paths:
    random tiny weights produce repetitive greedy output, so the lookup
    drafts both correct and wrong continuations)."""
    cfg, params = tiny
    seq = gemma3.generate_tokens(params, PROMPT, cfg, jax.random.key(1),
                                 max_new_tokens=40, temperature=0.0,
                                 stop_tokens=(), bucket=8)
    assert len(seq) == 40
    for k, ng in [(2, 2), (4, 3), (8, 3)]:
        spec = gemma3.generate_tokens(params, PROMPT, cfg, jax.random.key(1),
                                      max_new_tokens=40, temperature=0.0,
                                      stop_tokens=(), bucket=8,
                                      spec_k=k, spec_ngram=ng)
        assert spec == seq, (k, ng)


def test_full_accept_and_bonus_path():
    """Zero weights -> uniform logits -> greedy always emits token 0; the
    lookup then drafts all-zero spans that fully accept (bundle commits
    spec_k+1 per step, exercising the bonus token and the max_new cap)."""
    cfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(0), cfg, jnp.float32)
    zp = jax.tree.map(lambda a: jnp.zeros_like(a), params)
    for n in (33, 16):  # not multiples of spec_k+1: cap mid-bundle
        got = gemma3.generate_tokens(zp, PROMPT, cfg, jax.random.key(2),
                                     max_new_tokens=n, temperature=0.0,
                                     stop_tokens=(), bucket=8, spec_k=8)
        assert got == [0] * n


def test_stop_token_paths(tiny):
    cfg, params = tiny
    zp = jax.tree.map(lambda a: jnp.zeros_like(a), params)
    # stop on the very first sampled token: nothing emitted
    for sk in (0, 8):
        got = gemma3.generate_tokens(zp, PROMPT, cfg, jax.random.key(4),
                                     max_new_tokens=16, temperature=0.0,
                                     stop_tokens=(0,), bucket=8, spec_k=sk)
        assert got == []
    # stop mid-generation: spec greedy matches sequential greedy
    seq = gemma3.generate_tokens(params, PROMPT, cfg, jax.random.key(1),
                                 max_new_tokens=40, temperature=0.0,
                                 stop_tokens=(), bucket=8)
    stop = seq[7]  # terminate once this token would be emitted
    want = seq[:seq.index(stop)]
    for sk in (0, 5):
        got = gemma3.generate_tokens(params, PROMPT, cfg, jax.random.key(1),
                                     max_new_tokens=40, temperature=0.0,
                                     stop_tokens=(stop,), bucket=8,
                                     spec_k=sk)
        assert got == want, sk


def test_sampled_path_valid_and_spec_disabled_for_short_prompts(tiny):
    cfg, params = tiny
    sp = gemma3.generate_tokens(params, PROMPT, cfg, jax.random.key(3),
                                max_new_tokens=24, temperature=0.7,
                                stop_tokens=(), bucket=8, spec_k=6)
    assert len(sp) == 24 and all(0 <= x < cfg.vocab_size for x in sp)
    # prompt shorter than ngram+1: silently falls back to sequential
    short = gemma3.generate_tokens(params, np.asarray([5, 9], np.int32),
                                   cfg, jax.random.key(3),
                                   max_new_tokens=8, temperature=0.7,
                                   stop_tokens=(), bucket=8,
                                   spec_k=6, spec_ngram=3)
    assert len(short) == 8


def test_ngram_draft_lookup():
    """Most-recent-match semantics over a hand-built buffer."""
    # positions:        0  1  2  3  4  5  6  7  8   9  10 11  (cursor=12)
    buf = jnp.asarray([7, 1, 2, 3, 4, 9, 1, 2, 3, 8, 2, 3] + [-1] * 8,
                      jnp.int32)
    # trailing bigram at cursor 12 is (2, 3); matches at s=1 and s=6;
    # most recent is s=6 -> draft = tokens after it: [8, 2, 3]
    d = gemma3._ngram_draft(buf, jnp.asarray(12), jnp.asarray(0), 2, 3)
    assert list(np.asarray(d)) == [8, 2, 3]
    # draft truncates at the cursor: trailing (2,3) from cursor 9 matches
    # s=1 only; followers [4, 9, 1, 2] fit within cursor
    d = gemma3._ngram_draft(buf, jnp.asarray(9), jnp.asarray(0), 2, 6)
    assert list(np.asarray(d)) == [4, 9, 1, 2, 3, -1]
    # no match -> all -1
    d = gemma3._ngram_draft(
        jnp.asarray([1, 2, 3, 4, 5, 6, -1, -1], jnp.int32),
        jnp.asarray(6), jnp.asarray(0), 2, 3)
    assert list(np.asarray(d)) == [-1, -1, -1]
    # pad region is excluded from matching
    d = gemma3._ngram_draft(buf, jnp.asarray(12), jnp.asarray(5), 2, 3)
    assert list(np.asarray(d)) == [8, 2, 3]  # s=6 ok (>= pad)
    # self-repetitive history: must pick a match far enough back to leave
    # a FULL k followers (the most-recent match would leave only one)
    rep = jnp.asarray([0] * 10 + [-1] * 6, jnp.int32)
    d = gemma3._ngram_draft(rep, jnp.asarray(10), jnp.asarray(0), 3, 4)
    assert list(np.asarray(d)) == [0, 0, 0, 0]


def test_spec_accept_preserves_distribution():
    """Committed-token distribution == topp_sample's, for a draft with
    high, low, and zero target probability (the speculative-sampling
    correctness property, point-mass proposal case)."""
    rng = np.random.default_rng(0)
    lg = jnp.asarray(rng.standard_normal(64) * 2.0, jnp.float32)
    n = 4000
    keys = jax.random.split(jax.random.key(7), n)
    T, P, K = 0.9, 0.9, 16

    ref = jax.vmap(lambda k: gemma3.topp_sample(lg, k, T, P, K))(keys)
    ref_freq = np.bincount(np.asarray(ref), minlength=64) / n

    top1 = int(jnp.argmax(lg))
    for draft in (top1, int(jnp.argsort(lg)[-3]), 0):
        got = jax.vmap(
            lambda k: gemma3.spec_accept(lg, jnp.asarray(draft), k,
                                         T, P, K)[0])(keys)
        freq = np.bincount(np.asarray(got), minlength=64) / n
        # total-variation distance within Monte-Carlo noise
        tv = 0.5 * np.abs(freq - ref_freq).sum()
        assert tv < 0.05, (draft, tv)

    # zero-probability draft must never be emitted
    zlg = lg.at[0].set(-1e9)
    got = jax.vmap(
        lambda k: gemma3.spec_accept(zlg, jnp.asarray(0), k, T, P, K)[0]
    )(keys[:500])
    assert not np.any(np.asarray(got) == 0)


def test_spec_with_w8a8_leaves():
    """The verify bundle runs through quantized projection leaves too."""
    from ltx_jax.kernels.quantization import requant_int8_channel_np

    cfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(1), cfg, jnp.float32)
    qlayers = dict(params["layers"])
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        stacked = np.asarray(params["layers"][name]["w"], np.float32)
        per = [requant_int8_channel_np(stacked[i])
               for i in range(cfg.hidden_layers)]
        qlayers[name] = jax.tree.map(lambda *xs: jnp.stack(xs), *per)
    qp = {**params, "layers": qlayers}

    seq = gemma3.generate_tokens(qp, PROMPT, cfg, jax.random.key(5),
                                 max_new_tokens=20, temperature=0.0,
                                 stop_tokens=(), bucket=8)
    spec = gemma3.generate_tokens(qp, PROMPT, cfg, jax.random.key(5),
                                  max_new_tokens=20, temperature=0.0,
                                  stop_tokens=(), bucket=8, spec_k=4)
    assert spec == seq


# --- batched generation (serving path; no reference analog) ----------------


def test_batched_greedy_matches_single_rows(tiny):
    """Each batch row's greedy output == its own single-prompt greedy run,
    across different prompt lengths (per-row left pads / positions)."""
    cfg, params = tiny
    prompts = [
        np.asarray([5, 9, 11, 5, 9, 11, 5, 9], np.int32),
        np.asarray([3, 7], np.int32),
        np.asarray([12, 1, 4, 6, 2, 8, 10, 13, 3, 5], np.int32),
    ]
    got = gemma3.generate_tokens_batched(
        params, prompts, cfg, jax.random.key(1), max_new_tokens=12,
        temperature=0.0, stop_tokens=(), bucket=8)
    for i, p in enumerate(prompts):
        want = gemma3.generate_tokens(params, p, cfg, jax.random.key(1),
                                      max_new_tokens=12, temperature=0.0,
                                      stop_tokens=(), bucket=8)
        assert got[i] == want, i


def test_batched_per_row_stop(tiny):
    """A stopped row freezes while others continue to max_new_tokens."""
    cfg, params = tiny
    seq = gemma3.generate_tokens(params, PROMPT, cfg, jax.random.key(1),
                                 max_new_tokens=16, temperature=0.0,
                                 stop_tokens=(), bucket=8)
    stop = seq[5]
    want = seq[:seq.index(stop)]
    other = np.asarray([3, 7, 2, 9], np.int32)
    want_other = gemma3.generate_tokens(params, other, cfg,
                                        jax.random.key(1),
                                        max_new_tokens=16, temperature=0.0,
                                        stop_tokens=(stop,), bucket=8)
    got = gemma3.generate_tokens_batched(
        params, [PROMPT, other], cfg, jax.random.key(1), max_new_tokens=16,
        temperature=0.0, stop_tokens=(stop,), bucket=8)
    assert got[0] == want
    assert got[1] == want_other
    # all rows stopping ends the loop early (no hang, valid outputs)
    zp = jax.tree.map(lambda a: jnp.zeros_like(a), params)
    got = gemma3.generate_tokens_batched(
        zp, [PROMPT, other], cfg, jax.random.key(2), max_new_tokens=16,
        temperature=0.0, stop_tokens=(0,), bucket=8)
    assert got == [[], []]


def test_batched_sampled_rows_valid(tiny):
    cfg, params = tiny
    got = gemma3.generate_tokens_batched(
        params, [PROMPT, PROMPT[:4]], cfg, jax.random.key(3),
        max_new_tokens=10, temperature=0.7, stop_tokens=(), bucket=8)
    assert len(got) == 2
    for row in got:
        assert len(row) == 10
        assert all(0 <= t < cfg.vocab_size for t in row)


def test_enhance_prompts_batched_roundtrip(tiny):
    """Pipeline-level batched enhancement drives tokenize->generate->clean."""
    from ltx_jax.pipeline import enhance

    cfg, params = tiny

    class FakeTok:
        class _E:
            def __init__(self, ids):
                self.ids = ids

        def encode(self, text):
            if text in ("<end_of_turn>", "<eos>"):
                return self._E([1])
            return self._E([(ord(c) % 29) + 2 for c in text[:40]])

        def decode(self, toks):
            return "enhanced " + " ".join(str(t) for t in toks)

    out = enhance.enhance_prompts(params, cfg, FakeTok(),
                                  ["a cat", "a dog on a hill"],
                                  max_tokens=6, temperature=0.0)
    assert len(out) == 2 and all(isinstance(s, str) and s for s in out)


# --- batched + speculative (per-row bundle bases) --------------------------


def test_batched_spec_greedy_matches_sequential_rows(tiny):
    """Batched speculative greedy == batched sequential greedy == each
    row's single-prompt greedy run, across draft widths. Rows accept
    different counts per bundle, so their cache bases diverge — this is
    the per-row-offset KV write path."""
    cfg, params = tiny
    prompts = [
        np.asarray([5, 9, 11, 5, 9, 11, 5, 9], np.int32),
        np.asarray([3, 7, 2], np.int32),
        np.asarray([12, 1, 4, 6, 2, 8, 10, 13, 3, 5], np.int32),
    ]
    seq = gemma3.generate_tokens_batched(
        params, prompts, cfg, jax.random.key(1), max_new_tokens=24,
        temperature=0.0, stop_tokens=(), bucket=8)
    for k in (2, 4, 8):
        spec = gemma3.generate_tokens_batched(
            params, prompts, cfg, jax.random.key(1), max_new_tokens=24,
            temperature=0.0, stop_tokens=(), bucket=8, spec_k=k)
        assert spec == seq, k
    for i, p in enumerate(prompts):
        single = gemma3.generate_tokens(params, p, cfg, jax.random.key(1),
                                        max_new_tokens=24, temperature=0.0,
                                        stop_tokens=(), bucket=8)
        assert seq[i] == single, i


def test_batched_spec_per_row_stop(tiny):
    """Stops freeze rows independently under speculation (a stop token
    inside an accepted bundle must terminate that row exactly there)."""
    cfg, params = tiny
    seq = gemma3.generate_tokens(params, PROMPT, cfg, jax.random.key(1),
                                 max_new_tokens=16, temperature=0.0,
                                 stop_tokens=(), bucket=8)
    stop = seq[5]
    want0 = seq[:seq.index(stop)]
    other = np.asarray([3, 7, 2, 9], np.int32)
    want1 = gemma3.generate_tokens(params, other, cfg, jax.random.key(1),
                                   max_new_tokens=16, temperature=0.0,
                                   stop_tokens=(stop,), bucket=8)
    got = gemma3.generate_tokens_batched(
        params, [PROMPT, other], cfg, jax.random.key(1), max_new_tokens=16,
        temperature=0.0, stop_tokens=(stop,), bucket=8, spec_k=4)
    assert got[0] == want0
    assert got[1] == want1


def test_batched_spec_sampled_rows_valid(tiny):
    cfg, params = tiny
    got = gemma3.generate_tokens_batched(
        params, [PROMPT, PROMPT[:4]], cfg, jax.random.key(3),
        max_new_tokens=10, temperature=0.7, stop_tokens=(), bucket=8,
        spec_k=4)
    assert len(got) == 2
    for row in got:
        assert len(row) == 10
        assert all(0 <= t < cfg.vocab_size for t in row)


def test_batched_spec_with_w8a8_leaves():
    """Batched + speculative through quantized projection leaves: per-row
    bundle bases drive the vectorized KV writes while every matmul routes
    through the int8 path."""
    from ltx_jax.kernels.quantization import requant_int8_channel_np

    cfg = gemma3.Gemma3Config().tiny()
    params = gemma3.init_params(jax.random.key(1), cfg, jnp.float32)
    qlayers = dict(params["layers"])
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        stacked = np.asarray(params["layers"][name]["w"], np.float32)
        per = [requant_int8_channel_np(stacked[i])
               for i in range(cfg.hidden_layers)]
        qlayers[name] = jax.tree.map(lambda *xs: jnp.stack(xs), *per)
    qp = {**params, "layers": qlayers}

    prompts = [PROMPT, np.asarray([3, 7, 2], np.int32)]
    seq = gemma3.generate_tokens_batched(
        qp, prompts, cfg, jax.random.key(5), max_new_tokens=16,
        temperature=0.0, stop_tokens=(), bucket=8)
    spec = gemma3.generate_tokens_batched(
        qp, prompts, cfg, jax.random.key(5), max_new_tokens=16,
        temperature=0.0, stop_tokens=(), bucket=8, spec_k=4)
    assert spec == seq
