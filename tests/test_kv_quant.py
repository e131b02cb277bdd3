"""int8 KV cache (serving capacity: halves cache HBM -> ~2x max batch).

Opt-in numerics change (per-position int8 K/V with f32 scales), so tests
pin closeness to the bf16 cache at the attention level and exercise every
generation variant (sequential, speculative, batched, batched+spec) with
the quantized cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.models import gemma3


CFG = gemma3.Gemma3Config().tiny()


@pytest.fixture(scope="module")
def params():
    return gemma3.init_params(jax.random.key(0), CFG, jnp.float32)


def test_attention_int8_cache_close_to_bf16(params):
    p = jax.tree.map(lambda x: x[0], params["layers"])
    b, t, d = 1, 6, CFG.hidden_size
    x = jax.random.normal(jax.random.key(1), (b, t, d), jnp.float32)
    cos, sin = gemma3.rope_tables(16, CFG.head_dim, CFG.rope_theta)
    cos, sin = jnp.asarray(cos[:t]), jnp.asarray(sin[:t])
    bias = jnp.zeros((1, 1, t, 16), jnp.float32).at[..., t:].set(-1e9)

    nkv, hd = CFG.kv_heads, CFG.head_dim
    base = (jnp.zeros((b, nkv, 16, hd), jnp.float32),
            jnp.zeros((b, nkv, 16, hd), jnp.float32))
    out_base, _ = gemma3._attention(p, x, bias, cos, sin, CFG, base, 0)

    q8 = tuple(gemma3._kv_cache_init("int8", (b, nkv, 16, hd), jnp.float32)
               for _ in range(2))
    out_q, new_cache = gemma3._attention(p, x, bias, cos, sin, CFG, q8, 0)

    np.testing.assert_allclose(np.asarray(out_q), np.asarray(out_base),
                               rtol=5e-2, atol=5e-2)
    ck, cv = new_cache
    assert ck["q"].dtype == jnp.int8 and ck["s"].dtype == jnp.float32
    assert cv["q"].shape == (b, nkv, 16, hd)


def test_attention_int8_per_row_offsets(params):
    # batched-spec write path: (B,) per-row cache offsets
    p = jax.tree.map(lambda x: x[0], params["layers"])
    b, t, d = 2, 3, CFG.hidden_size
    x = jax.random.normal(jax.random.key(2), (b, t, d), jnp.float32)
    cos, sin = gemma3.rope_tables(12, CFG.head_dim, CFG.rope_theta)
    cos, sin = jnp.asarray(cos[:t]), jnp.asarray(sin[:t])
    bias = jnp.zeros((b, 1, t, 12), jnp.float32)

    nkv, hd = CFG.kv_heads, CFG.head_dim
    cache = tuple(gemma3._kv_cache_init("int8", (b, nkv, 12, hd),
                                        jnp.float32) for _ in range(2))
    offs = jnp.asarray([0, 4], jnp.int32)
    out, (ck, cv) = gemma3._attention(p, x, bias, cos, sin, CFG, cache, offs)
    assert np.isfinite(np.asarray(out)).all()
    # row 0 wrote slots 0..2, row 1 wrote slots 4..6
    s = np.asarray(ck["s"])
    assert (s[0, :, :3] != 1.0).any() and (s[0, :, 3:] == 1.0).all()
    assert (s[1, :, 4:7] != 1.0).any() and (s[1, :, :4] == 1.0).all()


@pytest.mark.parametrize("spec_k", [0, 4])
def test_generate_int8_kv(params, spec_k):
    ids = np.arange(5, 20)[None].astype(np.int32)
    toks = gemma3.generate_tokens(
        params, ids, CFG, jax.random.key(3), max_new_tokens=8,
        stop_tokens=(), bucket=16, spec_k=spec_k, kv_quant="int8")
    assert len(toks) == 8
    assert all(isinstance(t, int) and 0 <= t < CFG.vocab_size for t in toks)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_generate_batched_int8_kv(params, spec_k):
    prompts = [list(range(5, 12)), list(range(30, 34))]
    outs = gemma3.generate_tokens_batched(
        params, prompts, CFG, jax.random.key(4), max_new_tokens=6,
        stop_tokens=(), bucket=16, spec_k=spec_k, kv_quant="int8")
    assert len(outs) == 2
    assert all(len(o) == 6 for o in outs)


def test_int8_roundtrip_exact_when_representable():
    """Values that ARE multiples of max/127 survive the int8 cache
    bit-exactly — pins the quantize/dequantize pair."""
    x = jnp.asarray(np.array([[1.0, -127.0, 64.0, 0.0]], np.float32) / 127.0)
    q, s = gemma3._quantize_kv(x)
    np.testing.assert_array_equal(
        np.asarray(q, np.float32) * np.asarray(s)[..., None],
        np.asarray(x))


# --------------------------------------------------------- int8 embeddings


def _int8_embed(params):
    w = np.asarray(params["embed_tokens"]["w"], np.float32)
    sr = np.abs(w).max(axis=1) / 127.0
    sr = np.where(sr == 0, 1.0, sr).astype(np.float32)
    w8r = np.clip(np.rint(w / sr[:, None]), -127, 127).astype(np.int8)
    return {**params, "embed_tokens": {"w8r": jnp.asarray(w8r),
                                       "sr": jnp.asarray(sr)}}


def test_embed_int8_lookup_and_lm_head_close(params):
    q = _int8_embed(params)
    ids = jnp.asarray([[3, 7, 200]])
    base = gemma3._embed_lookup(params, ids)
    got = gemma3._embed_lookup(q, ids)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(base, np.float32),
                               rtol=2e-2, atol=2e-3)
    h = jax.random.normal(jax.random.key(6), (2, CFG.hidden_size),
                          jnp.float32)
    lb = gemma3._lm_head(params, h)
    lq = gemma3._lm_head(q, h)
    assert lq.shape == lb.shape == (2, CFG.vocab_size)
    # int8 weights AND int8 activations: ~1% relative on the logits
    np.testing.assert_allclose(np.asarray(lq), np.asarray(lb),
                               rtol=0.15, atol=0.05)


def test_generate_with_int8_embed_and_kv(params):
    q = _int8_embed(params)
    ids = np.arange(5, 20)[None].astype(np.int32)
    toks = gemma3.generate_tokens(q, ids, CFG, jax.random.key(7),
                                  max_new_tokens=6, stop_tokens=(),
                                  bucket=16, kv_quant="int8")
    assert len(toks) == 6


def test_hidden_states_with_int8_embed(params):
    q = _int8_embed(params)
    ids = jnp.asarray(np.arange(5, 13)[None].astype(np.int32))
    mask = jnp.ones_like(ids)
    hs = gemma3.forward_hidden_states(q, ids, mask, CFG)
    assert hs.shape[0] == CFG.hidden_layers + 1  # 49-state convention
    assert np.isfinite(np.asarray(hs, np.float32)).all()


def test_load_gemma_params_embed_int8(tmp_path):
    import tests.weight_fixtures as wf
    from ltx_jax.weights import keymaps

    spec = wf.gemma_spec(layers=CFG.hidden_layers, hidden=CFG.hidden_size,
                         heads=CFG.attention_heads, kv_heads=CFG.kv_heads,
                         head_dim=CFG.head_dim,
                         intermediate=CFG.intermediate_size,
                         vocab=CFG.vocab_size)
    tensors = wf.materialize(spec, seed=8)
    ref = keymaps.load_gemma_params(dict(tensors), CFG.hidden_layers,
                                    mode="w8a8")
    got = keymaps.load_gemma_params(dict(tensors), CFG.hidden_layers,
                                    mode="w8a8", embed_int8=True)
    e = got["embed_tokens"]
    assert set(e) == {"w8r", "sr"}
    assert e["w8r"].dtype == np.int8 and e["w8r"].shape == (
        CFG.vocab_size, CFG.hidden_size)
    deq = e["w8r"].astype(np.float32) * e["sr"][:, None]
    np.testing.assert_allclose(
        deq, np.asarray(ref["embed_tokens"]["w"], np.float32),
        rtol=2e-2, atol=2e-3)


def test_generate_batched_with_int8_embed(params):
    # the batched decode hands _lm_head a 3-D (B, m, hidden) activation
    q = _int8_embed(params)
    prompts = [list(range(5, 12)), list(range(30, 34))]
    outs = gemma3.generate_tokens_batched(
        q, prompts, CFG, jax.random.key(8), max_new_tokens=5,
        stop_tokens=(), bucket=16, kv_quant="int8")
    assert [len(o) for o in outs] == [5, 5]
    outs2 = gemma3.generate_tokens_batched(
        q, prompts, CFG, jax.random.key(8), max_new_tokens=5,
        stop_tokens=(), bucket=16, kv_quant="int8", spec_k=3)
    assert [len(o) for o in outs2] == [5, 5]
