"""Gemma-3 backbone + feature extractor + connector tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.models import gemma3, text_encoder

GCFG = gemma3.Gemma3Config().tiny()  # 7 layers, pattern 3 -> globals at 2, 5
TCFG = text_encoder.TextEncoderConfig().tiny()


@pytest.fixture(scope="module")
def gparams():
    return gemma3.init_params(jax.random.key(0), GCFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams():
    return text_encoder.init_params(jax.random.key(1), TCFG, dtype=jnp.float32,
                                    include_audio=True)


def test_gemma_hidden_state_count_and_shapes(gparams):
    ids = jnp.asarray([[3, 5, 7, 9, 11, 2, 4, 6]])
    mask = jnp.ones((1, 8), jnp.int32)
    hs = gemma3.forward_hidden_states(gparams, ids, mask, GCFG)
    # layers + 1 embedding; last is the NORMED final layer
    assert hs.shape == (GCFG.hidden_layers + 1, 1, 8, GCFG.hidden_size)
    assert np.isfinite(np.asarray(hs)).all()
    # state 0 is the scaled embedding
    emb = gparams["embed_tokens"]["w"][np.asarray(ids)] * np.sqrt(GCFG.hidden_size)
    np.testing.assert_allclose(np.asarray(hs[0]), np.asarray(emb), rtol=1e-5)


def test_gemma_causality(gparams):
    """Changing a later token must not affect earlier positions' states."""
    ids1 = jnp.asarray([[3, 5, 7, 9, 11, 2, 4, 6]])
    ids2 = ids1.at[0, 6].set(99)
    mask = jnp.ones((1, 8), jnp.int32)
    h1 = gemma3.forward_hidden_states(gparams, ids1, mask, GCFG)
    h2 = gemma3.forward_hidden_states(gparams, ids2, mask, GCFG)
    np.testing.assert_allclose(
        np.asarray(h1[:, :, :6]), np.asarray(h2[:, :, :6]), atol=1e-5
    )
    assert not np.allclose(np.asarray(h1[-1, :, 6]), np.asarray(h2[-1, :, 6]))


def test_gemma_pad_mask_blocks_attention(gparams):
    """Padded (left) tokens must not influence valid positions."""
    ids = jnp.asarray([[0, 0, 7, 9, 11, 2, 4, 6]])
    ids_alt = jnp.asarray([[50, 60, 7, 9, 11, 2, 4, 6]])
    mask = jnp.asarray([[0, 0, 1, 1, 1, 1, 1, 1]], jnp.int32)
    h1 = gemma3.forward_hidden_states(gparams, ids, mask, GCFG)
    h2 = gemma3.forward_hidden_states(gparams, ids_alt, mask, GCFG)
    np.testing.assert_allclose(
        np.asarray(h1[:, :, 2:]), np.asarray(h2[:, :, 2:]), atol=1e-5
    )


def test_gemma_rms_norm_convention():
    x = jnp.asarray([[2.0, 2.0]], jnp.float32)
    w = jnp.asarray([0.5, -0.5], jnp.float32)
    out = np.asarray(gemma3.gemma_rms_norm(x, w))
    # normed = 1.0 each; * (1 + w)
    np.testing.assert_allclose(out, [[1.5, 0.5]], rtol=1e-5)


def test_gemma_rope_rotation():
    x = jnp.ones((1, 1, 2, 4), jnp.float32)
    cos, sin = gemma3.rope_tables(2, 4, 10000.0)
    out = np.asarray(gemma3.apply_gemma_rope(x, jnp.asarray(cos), jnp.asarray(sin)))
    # position 0: no rotation
    np.testing.assert_allclose(out[0, 0, 0], 1.0, rtol=1e-6)
    # position 1 dim 0: x1*cos(1) - x2*sin(1)
    np.testing.assert_allclose(
        out[0, 0, 1, 0], np.cos(1.0) - np.sin(1.0), rtol=1e-5
    )


def test_norm_and_concat_golden():
    """Hand-check the 8*(x-mean)/(range+eps) masked normalization."""
    l, b, t, d = 2, 1, 4, 2
    hs = jnp.arange(l * b * t * d, dtype=jnp.float32).reshape(l, b, t, d)
    mask = jnp.asarray([[0, 0, 1, 1]], jnp.int32)  # left-padded, 2 valid
    out = np.asarray(text_encoder.norm_and_concat(hs, mask))
    assert out.shape == (b, t, d * l)
    # padded rows zeroed
    np.testing.assert_array_equal(out[0, :2], 0.0)
    # stats over valid tokens only, computed PER LAYER (reduction over T, D)
    x = np.asarray(hs, np.float64).transpose(1, 2, 3, 0)  # (B,T,D,L)
    valid = x[0, 2:4]  # (T_valid=2, D, L)
    mean = valid.sum(axis=(0, 1)) / (2 * d + 1e-6)  # (L,)
    rng = valid.max(axis=(0, 1)) - valid.min(axis=(0, 1))  # (L,)
    expected = 8.0 * (valid - mean) / (rng + 1e-6)  # (2, D, L)
    np.testing.assert_allclose(
        out[0, 2:4], expected.reshape(2, d * l), rtol=1e-4
    )


def test_register_replacement():
    b, t, d, r = 1, 8, 4, 4
    hs = jnp.arange(b * t * d, dtype=jnp.float32).reshape(b, t, d)
    valid = jnp.asarray([[False, False, False, True, True, True, True, True]])
    regs = -jnp.ones((r, d), jnp.float32)
    out = np.asarray(
        text_encoder.replace_padded_with_registers(hs, valid, regs)
    )
    # valid tokens (positions 3..7) compacted to front
    np.testing.assert_array_equal(out[0, :5], np.asarray(hs[0, 3:]))
    # tail filled with registers
    np.testing.assert_array_equal(out[0, 5:], -1.0)


def test_full_encode(tparams):
    l, b, t, d = TCFG.num_gemma_layers, 2, TCFG.max_length, TCFG.hidden_dim
    hs = jax.random.normal(jax.random.key(3), (l, b, t, d), jnp.float32)
    mask = jnp.ones((b, t), jnp.int32).at[0, :5].set(0)  # left pad sample 0
    out = text_encoder.encode_from_hidden_states(tparams, hs, mask, TCFG)
    assert out["video"].shape == (b, t, TCFG.inner_dim)
    assert out["audio"].shape == (b, t, TCFG.inner_dim)
    assert out["mask"].shape == (b, t)
    # after register replacement, all positions valid
    np.testing.assert_array_equal(np.asarray(out["mask"]), 1)
    assert np.isfinite(np.asarray(out["video"])).all()
    # audio connector has different weights -> different output
    assert not np.allclose(np.asarray(out["video"]), np.asarray(out["audio"]))


def test_generate_tokens_smoke(gparams):
    toks = gemma3.generate_tokens(
        gparams, np.asarray([[5, 6, 7]]), GCFG, jax.random.key(0),
        max_new_tokens=4, temperature=0.0, stop_tokens=(1,),
    )
    assert len(toks) <= 4
    assert all(0 <= t < GCFG.vocab_size for t in toks)


def test_generate_stop_token_halts(gparams):
    """Re-running greedy with the first emitted token as a stop token must
    yield an empty generation (device-side stop check)."""
    ids = np.asarray([[5, 6, 7]])
    toks = gemma3.generate_tokens(
        gparams, ids, GCFG, jax.random.key(0), max_new_tokens=3,
        temperature=0.0, stop_tokens=(),
    )
    assert len(toks) == 3
    again = gemma3.generate_tokens(
        gparams, ids, GCFG, jax.random.key(0), max_new_tokens=3,
        temperature=0.0, stop_tokens=(toks[0],),
    )
    assert again == []


def test_generate_program_is_cached(gparams):
    """Same-bucket prompts share one compiled program (VERDICT weak #8:
    the old path unrolled 48 layers per jit and re-compiled per length)."""
    gemma3._build_generate_fn.cache_clear()
    for prompt in ([[5, 6, 7]], [[9, 2, 4, 8]]):
        gemma3.generate_tokens(
            gparams, np.asarray(prompt), GCFG, jax.random.key(0),
            max_new_tokens=2, temperature=0.0, stop_tokens=(),
        )
    info = gemma3._build_generate_fn.cache_info()
    assert info.misses == 1 and info.hits == 1


def test_generate_repetition_penalty_changes_output(gparams):
    """A huge penalty must forbid immediate greedy repeats."""
    ids = np.asarray([[5, 6, 7]])
    toks = gemma3.generate_tokens(
        gparams, ids, GCFG, jax.random.key(0), max_new_tokens=6,
        temperature=0.0, repetition_penalty=1e9, stop_tokens=(),
    )
    assert all(toks[i] != toks[i + 1] for i in range(len(toks) - 1))


def test_generate_greedy_matches_forward(gparams):
    """Greedy decode's first token must equal argmax of the forward logits."""
    ids = np.asarray([[5, 6, 7]])
    toks = gemma3.generate_tokens(
        gparams, ids, GCFG, jax.random.key(0), max_new_tokens=1,
        temperature=0.0, stop_tokens=(),
    )
    hs = gemma3.forward_hidden_states(
        gparams, jnp.asarray(ids), jnp.ones((1, 3), jnp.int32), GCFG
    )
    logits = np.asarray(hs[-1, 0, -1]) @ np.asarray(
        gparams["embed_tokens"]["w"]).T
    assert toks[0] == int(np.argmax(logits))

def test_topp_sample_nucleus_semantics():
    """top-p keeps the smallest descending prefix reaching top_p mass —
    matching the reference's MLX sampler ("ascending cumsum > 1-top_p",
    round-1 code had the predicate inverted). With probs [0.5, 0.3, 0.12,
    0.05, 0.03] and top_p=0.75 only tokens {0, 1} are ever drawn (0.5+0.3
    crosses 0.75; token 2's mass-before is 0.8 >= 0.75)."""
    probs = np.array([0.5, 0.3, 0.12, 0.05, 0.03] + [1e-9] * 123, np.float64)
    probs /= probs.sum()
    logits = jnp.asarray(np.log(probs), jnp.float32)
    seen = set()
    for i in range(200):
        tok = int(gemma3.topp_sample(logits, jax.random.key(i),
                                     temperature=1.0, top_p=0.75, top_k=8))
        seen.add(tok)
    assert seen == {0, 1}, seen


def test_topp_sample_flat_distribution_keeps_top():
    """A flat distribution must still sample from the TOP tokens (the
    inverted predicate dropped them)."""
    logits = np.full((128,), 0.0, np.float32)
    logits[:8] += 2.0  # 8 clearly-likelier tokens
    lg = jnp.asarray(logits)
    for i in range(50):
        tok = int(gemma3.topp_sample(lg, jax.random.key(i),
                                     temperature=0.7, top_p=0.5, top_k=16))
        assert tok < 8, tok
