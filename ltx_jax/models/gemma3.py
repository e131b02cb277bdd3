"""Gemma-3 text backbone, run as a hidden-state extractor.

Reference behavior: Sources/LTXVideo/Models/TextEncoder/Gemma3/Gemma3Model.swift.
Functional pytree params with all 48 decoder layers stacked and run under
`lax.scan`; per-layer global-vs-sliding RoPE base and mask are selected with
jnp.where on precomputed tables, keeping one compiled layer body.

Key semantics preserved:
  * embeddings scaled by sqrt(hidden_size) in the embedding dtype;
  * Gemma RMSNorm uses the (1 + weight) convention;
  * q/k RMSNorm per head-dim AFTER the head split; attention scale is
    query_pre_attn_scalar^-0.5 (1/16 for 12B), NOT head_dim^-0.5;
  * RoPE: rotate-half, base 10k for sliding layers / 1M for global layers,
    NO rope scaling (reference: Gemma3Model.swift:56-67);
  * text-encoder path with a pad mask uses the FULL causal mask for sliding
    layers too (reference: Gemma3Model.swift:263-265 — matches the Python
    text encoder); generation applies the real sliding window;
  * returns 49 hidden states: embedding + layers 0..46 raw + final normed
    (reference: Gemma3Model.swift:198-303).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ltx_jax.kernels.quantization import linear_any, linear_many
from ltx_jax.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    """Gemma-3-12B text config (reference: Gemma3Config.swift:44-58)."""

    hidden_size: int = 3840
    hidden_layers: int = 48
    intermediate_size: int = 15360
    attention_heads: int = 16
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    vocab_size: int = 262208
    kv_heads: int = 8
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 1024
    sliding_window_pattern: int = 6
    max_position_embeddings: int = 131072

    @classmethod
    def from_hf_dict(cls, d: dict) -> "Gemma3Config":
        """Parse HF config.json (handles nested text_config for VLM exports)."""
        if "text_config" in d:
            d = d["text_config"]
        return cls(
            hidden_size=d.get("hidden_size", 3840),
            hidden_layers=d.get("num_hidden_layers", 48),
            intermediate_size=d.get("intermediate_size", 15360),
            attention_heads=d.get("num_attention_heads", 16),
            head_dim=d.get("head_dim", 256),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            vocab_size=d.get("vocab_size", 262208),
            kv_heads=d.get("num_key_value_heads", 8),
            rope_theta=d.get("rope_theta", 1_000_000.0),
            rope_local_base_freq=d.get("rope_local_base_freq", 10_000.0),
            query_pre_attn_scalar=d.get("query_pre_attn_scalar", 256.0),
            sliding_window=d.get("sliding_window", 1024),
            sliding_window_pattern=d.get("sliding_window_pattern", 6),
            max_position_embeddings=d.get("max_position_embeddings", 131072),
        )

    def tiny(self) -> "Gemma3Config":
        return dataclasses.replace(
            self,
            hidden_size=64,
            hidden_layers=7,
            intermediate_size=128,
            attention_heads=4,
            head_dim=16,
            vocab_size=256,
            kv_heads=2,
            query_pre_attn_scalar=16.0,
            sliding_window=4,
            sliding_window_pattern=3,
        )

    def is_global_layer(self, i: int) -> bool:
        return (i + 1) % self.sliding_window_pattern == 0


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def gemma_rms_norm(x, weight, eps: float = 1e-6):
    """Gemma convention: normed * (1 + weight), f32 statistics."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    inv = lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return (xf * inv * (1.0 + weight.astype(jnp.float32))).astype(dtype)


def clip_residual(x, y):
    """x + y with float16 overflow clamping (bf16/f32 pass through).
    Mirrors MLX Gemma.clipResidual used at Gemma3Model.swift:162,166."""
    if x.dtype == jnp.float16:
        return jnp.clip(
            x.astype(jnp.float32) + y.astype(jnp.float32), -65504.0, 65504.0
        ).astype(jnp.float16)
    return x + y


def rope_tables(seq_len: int, head_dim: int, base: float,
                positions: Optional[np.ndarray] = None):
    """cos/sin (T, head_dim/2) for rotate-half RoPE (host-side f32)."""
    if positions is None:
        positions = np.arange(seq_len, dtype=np.float32)
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = positions[:, None].astype(np.float32) * inv_freq[None, :]
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_gemma_rope(x, cos, sin):
    """Rotate-half RoPE on (B, H, T, D); cos/sin (T, D/2) shared across the
    batch, or (B, T, D/2) per-row (batched generation, where left-pad
    offsets differ per row). f32 math."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    d = xf.shape[-1]
    x1, x2 = xf[..., : d // 2], xf[..., d // 2 :]
    c = cos.astype(jnp.float32)
    s = sin.astype(jnp.float32)
    if c.ndim == 2:
        c, s = c[None], s[None]
    c, s = c[:, None], s[:, None]  # (B|1, 1, T, D/2)
    return jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1).astype(dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _dense(key, d_in, d_out, dtype):
    return {"w": (jax.random.normal(key, (d_in, d_out), jnp.float32) * d_in**-0.5
                  ).astype(dtype)}


def _layer_init(key, cfg: Gemma3Config, dtype):
    d, hd = cfg.hidden_size, cfg.head_dim
    ks = jax.random.split(key, 7)
    return {
        "q_proj": _dense(ks[0], d, cfg.attention_heads * hd, dtype),
        "k_proj": _dense(ks[1], d, cfg.kv_heads * hd, dtype),
        "v_proj": _dense(ks[2], d, cfg.kv_heads * hd, dtype),
        "o_proj": _dense(ks[3], cfg.attention_heads * hd, d, dtype),
        "q_norm": {"w": jnp.zeros((hd,), dtype)},
        "k_norm": {"w": jnp.zeros((hd,), dtype)},
        "gate_proj": _dense(ks[4], d, cfg.intermediate_size, dtype),
        "up_proj": _dense(ks[5], d, cfg.intermediate_size, dtype),
        "down_proj": _dense(ks[6], cfg.intermediate_size, d, dtype),
        "input_layernorm": {"w": jnp.zeros((d,), dtype)},
        "post_attention_layernorm": {"w": jnp.zeros((d,), dtype)},
        "pre_feedforward_layernorm": {"w": jnp.zeros((d,), dtype)},
        "post_feedforward_layernorm": {"w": jnp.zeros((d,), dtype)},
    }


def init_params(key, cfg: Gemma3Config, dtype=jnp.bfloat16):
    ks = jax.random.split(key, 3)
    # vmap: stacked leaves directly, same values as a per-layer loop
    layers = jax.vmap(lambda k: _layer_init(k, cfg, dtype))(
        jax.random.split(ks[0], cfg.hidden_layers))
    return {
        "embed_tokens": {
            "w": (jax.random.normal(ks[1], (cfg.vocab_size, cfg.hidden_size),
                                    jnp.float32) * 0.02).astype(dtype)
        },
        "layers": layers,
        "norm": {"w": jnp.zeros((cfg.hidden_size,), dtype)},
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _quantize_kv(x):
    """(..., D) -> per-row int8 values + f32 scale over the last axis."""
    xf = x.astype(jnp.float32)
    s = jnp.max(jnp.abs(xf), axis=-1) / 127.0
    s = jnp.where(s == 0, 1.0, s)
    q = jnp.clip(jnp.round(xf / s[..., None]), -127, 127).astype(jnp.int8)
    return q, s


def _kv_cache_init(kv_quant: str, shape, dtype):
    """Cache leaves for one stream (K or V). bf16: a plain array;
    int8: {"q", "s"} with the scale axis dropped from the head dim."""
    if kv_quant == "int8":
        return {"q": jnp.zeros(shape, jnp.int8),
                "s": jnp.ones(shape[:-1], jnp.float32)}
    return jnp.zeros(shape, dtype)


def _kv_constrain(cache, mesh):
    """Pin the KV cache's kv-head axis to the mesh "model" axis.

    Under TP (params sharded via parallel/sharding.shard_gemma_params) the
    k/v activations come out head-sharded, but the while_loop carry takes
    its sharding from the INITIAL cache value — zeros with no producer
    constraint — so without this GSPMD is free to replicate the cache and
    insert per-step all-gathers. Leaves are (nl, B, nkv, T[, hd]); axis 2
    is the kv-head axis for both bf16 arrays and int8 {"q","s"} dicts."""
    if mesh is None:
        return cache
    from jax.sharding import NamedSharding, PartitionSpec

    def leaf(a):
        axes = [None] * a.ndim
        axes[2] = "model"
        return jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh, PartitionSpec(*axes)))

    return jax.tree.map(leaf, cache)


def _attention(p, x, bias, cos, sin, cfg: Gemma3Config, kv_cache=None,
               cache_index=None):
    b, t, _ = x.shape
    nh, nkv, hd = cfg.attention_heads, cfg.kv_heads, cfg.head_dim

    q, k, v = linear_many((p["q_proj"], p["k_proj"], p["v_proj"]), x)

    q = q.reshape(b, t, nh, hd).transpose(0, 2, 1, 3)
    k = k.reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)
    v = v.reshape(b, t, nkv, hd).transpose(0, 2, 1, 3)

    q = gemma_rms_norm(q, p["q_norm"]["w"], cfg.rms_norm_eps)
    k = gemma_rms_norm(k, p["k_norm"]["w"], cfg.rms_norm_eps)

    q = apply_gemma_rope(q, cos, sin)
    k = apply_gemma_rope(k, cos, sin)

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        per_row = getattr(cache_index, "ndim", 0) == 1
        if isinstance(ck, dict):
            # int8 KV cache ({"q": int8 (B,Hkv,T,D), "s": f32 (B,Hkv,T)}):
            # halves cache memory -> ~2x serving batch ceiling; the dequant
            # multiply fuses into the attention dots. Per-(row,head,pos)
            # scales; decode is bound by weight reads, so the extra
            # elementwise work hides behind them.
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            if per_row:
                upd4 = jax.vmap(
                    lambda c, n, i: lax.dynamic_update_slice(c, n, (0, i, 0)))
                upd3 = jax.vmap(
                    lambda c, n, i: lax.dynamic_update_slice(c, n, (0, i)))
                ck = {"q": upd4(ck["q"], kq, cache_index),
                      "s": upd3(ck["s"], ks, cache_index)}
                cv = {"q": upd4(cv["q"], vq, cache_index),
                      "s": upd3(cv["s"], vs, cache_index)}
            else:
                ck = {"q": lax.dynamic_update_slice(
                          ck["q"], kq, (0, 0, cache_index, 0)),
                      "s": lax.dynamic_update_slice(
                          ck["s"], ks, (0, 0, cache_index))}
                cv = {"q": lax.dynamic_update_slice(
                          cv["q"], vq, (0, 0, cache_index, 0)),
                      "s": lax.dynamic_update_slice(
                          cv["s"], vs, (0, 0, cache_index))}
            new_cache = (ck, cv)
            k = (ck["q"].astype(jnp.float32)
                 * ck["s"][..., None]).astype(x.dtype)
            v = (cv["q"].astype(jnp.float32)
                 * cv["s"][..., None]).astype(x.dtype)
        else:
            if per_row:
                # (B,) per-row write offsets (batched speculative decoding:
                # rows commit different counts, so bundle bases diverge)
                upd = jax.vmap(
                    lambda c, n, i: lax.dynamic_update_slice(c, n, (0, i, 0)))
                ck = upd(ck, k, cache_index)
                cv = upd(cv, v, cache_index)
            else:
                ck = lax.dynamic_update_slice(ck, k, (0, 0, cache_index, 0))
                cv = lax.dynamic_update_slice(cv, v, (0, 0, cache_index, 0))
            k, v = ck, cv
            new_cache = (ck, cv)

    scale = cfg.query_pre_attn_scalar**-0.5
    out = sdpa(q, k, v, bias=bias, scale=scale)
    out = out.transpose(0, 2, 1, 3).reshape(b, t, nh * hd)
    out = linear_any(p["o_proj"], out)
    return out, new_cache


def _mlp(p, x):
    """down(gelu_tanh(gate) * up) (reference: Gemma3Model.swift:115-130)."""
    gate, up = linear_many((p["gate_proj"], p["up_proj"]), x)
    h = jax.nn.gelu(gate, approximate=True) * up
    return linear_any(p["down_proj"], h)


def _decoder_layer(p, x, bias, cos, sin, cfg: Gemma3Config, kv_cache=None,
                   cache_index=None):
    """Pre/post sandwich norms (reference: Gemma3Model.swift:154-167)."""
    eps = cfg.rms_norm_eps
    h_norm = gemma_rms_norm(x, p["input_layernorm"]["w"], eps)
    attn, new_cache = _attention(p, h_norm, bias, cos, sin, cfg, kv_cache,
                                 cache_index)
    attn = gemma_rms_norm(attn, p["post_attention_layernorm"]["w"], eps)
    h = clip_residual(x, attn)
    m = gemma_rms_norm(h, p["pre_feedforward_layernorm"]["w"], eps)
    m = _mlp(p, m)
    m = gemma_rms_norm(m, p["post_feedforward_layernorm"]["w"], eps)
    return clip_residual(h, m), new_cache


def _additive_causal_mask(attention_mask, seq_len: int, dtype):
    """Causal AND pad-valid -> additive (0 / dtype-min) mask (B, 1, T, T)
    (reference: Gemma3Model.swift:225-257)."""
    causal = jnp.tril(jnp.ones((seq_len, seq_len), bool))
    pad = attention_mask.astype(bool)[:, None, None, :]  # (B, 1, 1, T)
    combined = causal[None, None] & pad
    min_val = {
        jnp.bfloat16: -3.3895314e38,
        jnp.float16: -65504.0,
    }.get(jnp.dtype(dtype).type, -1e9)
    return jnp.where(combined, 0.0, min_val).astype(jnp.float32)


def forward_hidden_states(params, input_ids, attention_mask, cfg: Gemma3Config):
    """Token ids (B, T) + pad mask (B, T) -> (49, B, T, D) hidden states.

    States: [0]=scaled embedding, [1..47]=layers 0..46 raw, [48]=final norm of
    layer 47. Sliding layers use the SAME full causal+pad mask as global
    layers on this path (text-encoder parity).
    """
    b, t = input_ids.shape
    dtype = embed_dtype(params)
    h = (_embed_lookup(params, input_ids)
         * jnp.asarray(np.sqrt(cfg.hidden_size), dtype))

    bias = _additive_causal_mask(attention_mask, t, dtype)

    cos_g, sin_g = rope_tables(t, cfg.head_dim, cfg.rope_theta)
    cos_l, sin_l = rope_tables(t, cfg.head_dim, cfg.rope_local_base_freq)
    cos_g, sin_g = jnp.asarray(cos_g), jnp.asarray(sin_g)
    cos_l, sin_l = jnp.asarray(cos_l), jnp.asarray(sin_l)

    is_global = jnp.asarray(
        [cfg.is_global_layer(i) for i in range(cfg.hidden_layers)]
    )

    def body(carry, scanned):
        p, glob = scanned
        cos = jnp.where(glob, cos_g, cos_l)
        sin = jnp.where(glob, sin_g, sin_l)
        out, _ = _decoder_layer(p, carry, bias, cos, sin, cfg)
        return out, out

    last, ys = lax.scan(body, h, (params["layers"], is_global))
    final = gemma_rms_norm(last, params["norm"]["w"], cfg.rms_norm_eps)

    # (49, B, T, D): embedding + layers 0..46 + normed final
    return jnp.concatenate([h[None], ys[:-1], final[None]], axis=0)


# ---------------------------------------------------------------------------
# Autoregressive generation (prompt enhancement)
# ---------------------------------------------------------------------------
#
# Design: the reference's generateTokens (Gemma3Model.swift:390-513)
# drives 48 eager layer calls per token and round-trips logits to the CPU
# for the repetition penalty. Here the WHOLE generation — prefill + the
# token loop — is ONE compiled program: layers run under lax.scan (one
# compiled layer body), the token loop is lax.while_loop, and the
# repetition penalty / top-p sampling happen on device (a vocab-sized
# scatter mask instead of host mutation). Prompt lengths are bucketed to
# multiples of 128 (left-padded) so compile count is bounded.
#
# Semantics preserved from the reference:
#   * prefill: global layers full-causal, sliding layers windowed;
#   * decode: mask "none" — every layer attends to the FULL cache
#     (Gemma3Model.swift:482-487 passes mask: .none with KVCacheSimple,
#     so sliding layers are NOT windowed during decode);
#   * repetition penalty over the last `repetition_context` GENERATED
#     tokens only (positive logits divided, negative multiplied);
#   * top-p: keep tokens where descending cumulative prob > 1 - top_p.
#
# Speculative decoding (spec_k > 0): decode is bound by reading the
# weights once per token (not by FLOPs), so a (spec_k+1)-token verify
# forward costs nearly the same as a 1-token step. Drafts come from PROMPT LOOKUP (most recent earlier occurrence of
# the trailing `spec_ngram` tokens in prompt+output — no draft model);
# acceptance is exact rejection sampling for a deterministic draft
# (accept d w.p. p(d), else sample from p with d removed), so the output
# DISTRIBUTION equals the sequential sampler's, and at temperature<=0 the
# output SEQUENCE is identical to the non-speculative greedy loop. The KV
# cache carries spec_k+1 slack slots so bundle writes never clamp into
# valid history; slots past a rejection hold stale K/V that the row-wise
# causal bias makes unreachable until the next bundle overwrites them.


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def generate_tokens(
    params,
    input_ids: np.ndarray,
    cfg: Gemma3Config,
    key,
    max_new_tokens: int = 512,
    temperature: float = 0.7,
    top_p: float = 0.95,
    repetition_penalty: float = 1.1,
    repetition_context: int = 64,
    stop_tokens: Tuple[int, ...] = (1,),
    input_embeds=None,
    bucket: int = 128,
    top_k: int = 0,
    spec_k: int = 0,
    spec_ngram: int = 3,
    kv_quant: str = "bf16",
    mesh=None,
    return_stats: bool = False,
):
    """KV-cached autoregressive sampling, fully device-side.

    input_embeds: optional (1, T, D) PRE-SCALED prompt embeddings (text
    embeddings already multiplied by sqrt(hidden); used by the VLM path to
    splice SigLIP image soft-tokens into the prompt). When given, input_ids
    must still hold the token ids of the same length (for bookkeeping).
    top_k: candidate-set size for the top-p sampler; 0 picks 64 at
    temperature <= 1 (where the nucleus virtually never extends past 64)
    and 512 above (where it can) — see topp_sample for the cost tradeoff.
    spec_k: prompt-lookup speculative decoding with spec_k drafts per
    verify step (0 = off). Distribution-preserving (see module comment);
    worst case (no n-gram ever matches) decodes 1 token/step at the same
    per-step latency. spec_ngram: lookup pattern length.
    mesh: TP decode — params must already be sharded on this mesh via
    parallel/sharding.shard_gemma_params; the per-token weight reads
    (the decode bottleneck) split across the "model" axis. Greedy output is token-identical to mesh=None (tested).
    Returns the generated token list (without the prompt); with
    return_stats=True, returns (tokens, {"forwards": N}) where N counts
    decode forwards — tokens/forwards is the speculative commit rate
    (1.0 = sequential; up to spec_k+1 at full acceptance).
    """
    if top_k <= 0:
        top_k = 64 if temperature <= 1.0 else 512
    input_ids = np.asarray(input_ids)
    if input_ids.ndim == 1:
        input_ids = input_ids[None]
    b, t = input_ids.shape
    if b != 1:
        from ltx_jax.core.errors import InvalidConfigurationError

        raise InvalidConfigurationError(
            "prompt enhancement generates one prompt at a time")

    t_pad = _round_up(max(t, 1), bucket)
    pad = t_pad - t
    max_len = t_pad + max_new_tokens
    ids_padded = np.zeros((1, t_pad), np.int32)
    ids_padded[0, pad:] = input_ids[0]

    embeds_padded = None
    if input_embeds is not None:
        d = input_embeds.shape[-1]
        embeds_padded = jnp.zeros((1, t_pad, d), input_embeds.dtype)
        embeds_padded = embeds_padded.at[:, pad:].set(input_embeds)

    if spec_k > 0 and (t < spec_ngram + 1 or max_new_tokens < 2):
        spec_k = 0  # too short to look up / nothing to speculate on

    # spec bundles may write KV up to spec_k+1 slots past the last
    # committed position; slack keeps dynamic_update_slice from clamping
    # into (and corrupting) valid history.
    cache_len = max_len + (spec_k + 1 if spec_k > 0 else 0)
    cos_g, sin_g = rope_tables(cache_len, cfg.head_dim, cfg.rope_theta)
    cos_l, sin_l = rope_tables(cache_len, cfg.head_dim,
                               cfg.rope_local_base_freq)
    tables = tuple(jnp.asarray(a) for a in (cos_g, sin_g, cos_l, sin_l))
    stop_arr = (jnp.asarray(list(stop_tokens), jnp.int32)
                if stop_tokens else jnp.zeros((0,), jnp.int32))

    fn = _build_generate_fn(
        cfg, t_pad, max_new_tokens, float(temperature), float(top_p),
        float(repetition_penalty), int(repetition_context),
        with_embeds=embeds_padded is not None, top_k=int(top_k),
        spec_k=int(spec_k), spec_ngram=int(spec_ngram),
        kv_quant=str(kv_quant), mesh=mesh,
    )
    out, n_gen, fwds = fn(params, jnp.asarray(ids_padded), embeds_padded,
                          jnp.asarray(pad, jnp.int32), stop_arr, tables, key)
    n = int(n_gen)
    tokens = [int(x) for x in np.asarray(out[:n])]
    if return_stats:
        return tokens, {"forwards": int(fwds)}
    return tokens



@functools.lru_cache(maxsize=8)
def _build_generate_fn(cfg: Gemma3Config, t_pad: int, max_new_tokens: int,
                       temperature: float, top_p: float,
                       repetition_penalty: float, repetition_context: int,
                       with_embeds: bool, top_k: int = 64,
                       spec_k: int = 0, spec_ngram: int = 3,
                       kv_quant: str = "bf16", mesh=None):
    """Compile-cached generation program for one (config, bucket) pair.

    mesh: TP — the program body is mesh-agnostic (GSPMD propagates layer
    shardings from the param NamedShardings); the only explicit annotation
    is the KV-cache carry (_kv_constrain). jax.sharding.Mesh is hashable,
    so it participates in the compile cache key."""
    nl, nkv, hd = cfg.hidden_layers, cfg.kv_heads, cfg.head_dim
    vocab = cfg.vocab_size
    max_len = t_pad + max_new_tokens
    cache_len = max_len + (spec_k + 1 if spec_k > 0 else 0)
    scale_emb = float(np.sqrt(cfg.hidden_size))
    is_global = jnp.asarray(
        [cfg.is_global_layer(i) for i in range(nl)])
    ctx = max(repetition_context, 1)

    def run(params, ids, embeds, pad, stop_arr, tables, key):
        cos_g, sin_g, cos_l, sin_l = tables
        dtype = embed_dtype(params)

        if with_embeds:
            h = embeds.astype(dtype)
        else:
            h = _embed_lookup(params, ids) * jnp.asarray(scale_emb, dtype)

        # --- prefill biases: (1, 1, t_pad, cache_len)
        row = jnp.arange(t_pad)[:, None]
        col = jnp.arange(cache_len)[None, :]
        valid = (col <= row) & (col >= pad)
        bias_g = jnp.where(valid, 0.0, -1e9)[None, None].astype(jnp.float32)
        valid_s = valid & (col > row - cfg.sliding_window)
        bias_s = jnp.where(valid_s, 0.0, -1e9)[None, None].astype(jnp.float32)

        # position ids shifted by the left pad; junk slots clamp to 0
        pos_ids = jnp.maximum(jnp.arange(t_pad) - pad, 0)
        pcos_g, psin_g = cos_g[pos_ids], sin_g[pos_ids]
        pcos_l, psin_l = cos_l[pos_ids], sin_l[pos_ids]

        ck0 = _kv_constrain(
            _kv_cache_init(kv_quant, (nl, 1, nkv, cache_len, hd), dtype),
            mesh)
        cv0 = _kv_constrain(
            _kv_cache_init(kv_quant, (nl, 1, nkv, cache_len, hd), dtype),
            mesh)

        def prefill_layer(carry, scanned):
            h = carry
            p, glob, ck, cv = scanned
            cos = jnp.where(glob, pcos_g, pcos_l)
            sin = jnp.where(glob, psin_g, psin_l)
            bias = jnp.where(glob, bias_g, bias_s)
            h, (ck, cv) = _decoder_layer(p, h, bias, cos, sin, cfg,
                                         (ck, cv), 0)
            return h, (ck, cv)

        h, (cks, cvs) = lax.scan(
            prefill_layer, h, (params["layers"], is_global, ck0, cv0))
        cks, cvs = _kv_constrain(cks, mesh), _kv_constrain(cvs, mesh)
        h = gemma_rms_norm(h, params["norm"]["w"], cfg.rms_norm_eps)
        logits0 = _lm_head(params, h[:, -1])  # (1, vocab) f32

        def decode(carry_caches, toks, pos):
            """(m,) tokens through all layers; cache slots pos..pos+m-1.

            Row i's bias admits slots [pad, pos+i] only — within-bundle
            causality AND a firewall against stale slots past the bundle."""
            m = toks.shape[0]
            cks, cvs = carry_caches
            h = (_embed_lookup(params, toks[None])
                 * jnp.asarray(scale_emb, dtype))
            idx = jnp.arange(cache_len)[None, None, None, :]
            rows = jnp.arange(m)[None, None, :, None]
            # reference decode mask is .none: attend to every written slot
            ok = (idx >= pad) & (idx <= pos + rows)
            bias = jnp.where(ok, 0.0, -1e9).astype(jnp.float32)
            rp = pos - pad
            dcos_g = lax.dynamic_slice_in_dim(cos_g, rp, m)
            dsin_g = lax.dynamic_slice_in_dim(sin_g, rp, m)
            dcos_l = lax.dynamic_slice_in_dim(cos_l, rp, m)
            dsin_l = lax.dynamic_slice_in_dim(sin_l, rp, m)

            def layer(carry, scanned):
                h = carry
                p, glob, ck, cv = scanned
                cos = jnp.where(glob, dcos_g, dcos_l)
                sin = jnp.where(glob, dsin_g, dsin_l)
                h, (ck, cv) = _decoder_layer(p, h, bias, cos, sin, cfg,
                                             (ck, cv), pos)
                return h, (ck, cv)

            h, (cks, cvs) = lax.scan(
                layer, h, (params["layers"], is_global, cks, cvs))
            h = gemma_rms_norm(h, params["norm"]["w"], cfg.rms_norm_eps)
            return (cks, cvs), _lm_head(params, h[0])  # (m, vocab) f32

        def penalize(lg, ring):
            if repetition_penalty == 1.0:
                return lg
            hit = jnp.zeros((vocab + 1,), bool).at[ring].set(True)[:vocab]
            return jnp.where(
                hit, jnp.where(lg > 0, lg / repetition_penalty,
                               lg * repetition_penalty), lg)

        def sample(lg, key):
            if temperature <= 0:
                # top_k(1), not argmax: one selection primitive for the
                # greedy and the sampled path
                return lax.top_k(lg, 1)[1][0].astype(jnp.int32)
            return topp_sample(lg, key, temperature, top_p, top_k)

        def is_stop(tok):
            return jnp.any(tok == stop_arr) if stop_arr.shape[0] else \
                jnp.asarray(False)

        if spec_k > 0:
            return _spec_loop(
                params, ids, pad, stop_arr, key, (cks, cvs), logits0,
                decode, penalize, sample, is_stop,
                t_pad=t_pad, max_new_tokens=max_new_tokens,
                cache_len=cache_len, ctx=ctx, vocab=vocab,
                temperature=temperature, top_p=top_p, top_k=top_k,
                spec_k=spec_k, spec_ngram=spec_ngram)

        def cond(state):
            _, _, _, _, _, n_gen, done, _ = state
            return (~done) & (n_gen < max_new_tokens)

        def body(state):
            caches, logits, key, out, ring, n_gen, done, it = state
            key, sub = jax.random.split(key)
            lg = penalize(logits[0], ring)
            nxt = sample(lg, sub)
            stop_hit = is_stop(nxt)
            out = jnp.where(stop_hit, out, out.at[n_gen].set(nxt))
            ring = jnp.where(stop_hit, ring, ring.at[n_gen % ctx].set(nxt))
            pos = t_pad + n_gen
            caches, logits = decode(caches, nxt[None], pos)
            n_gen = n_gen + jnp.where(stop_hit, 0, 1)
            return caches, logits, key, out, ring, n_gen, stop_hit, it + 1

        out0 = jnp.full((max_new_tokens,), -1, jnp.int32)
        ring0 = jnp.full((ctx,), vocab, jnp.int32)  # out-of-range slot
        state = ((cks, cvs), logits0, key, out0, ring0,
                 jnp.asarray(0, jnp.int32), jnp.asarray(False),
                 jnp.asarray(0, jnp.int32))
        state = lax.while_loop(cond, body, state)
        _, _, _, out, _, n_gen, _, fwds = state
        return out, n_gen, fwds

    return jax.jit(run)


def _topp_filtered(lg, temperature: float, top_p: float, top_k: int):
    """(vocab,) logits -> (top_k candidate ids, nucleus-filtered probs).

    Keeps the smallest descending-probability prefix whose mass reaches
    top_p (the reference's MLX sampler expresses the same set as
    "ascending cumsum > 1 - top_p"). Probabilities normalize over the FULL
    vocab (logsumexp), but only the top_k candidates enter the sort — a
    full 262k argsort per decode token costs more than the top_k, and at
    temperature<=1 the nucleus virtually never
    extends past 64 tokens (the truncation only matters for mass beyond
    top_p anyway).
    """
    lgt = lg.astype(jnp.float32) / temperature
    lse = jax.nn.logsumexp(lgt)
    kvals, kidx = lax.top_k(lgt, top_k)      # descending
    kprobs = jnp.exp(kvals - lse)
    mass_before = jnp.cumsum(kprobs) - kprobs
    keep = mass_before < top_p               # token 0 always kept
    return kidx, jnp.where(keep, kprobs, 0.0)


def topp_sample(lg, key, temperature: float, top_p: float,
                top_k: int = 64):
    """Nucleus (top-p) sampling over a (vocab,) logit row
    (see _topp_filtered for the candidate-set semantics)."""
    kidx, filt = _topp_filtered(lg, temperature, top_p, top_k)
    choice = jax.random.categorical(key, jnp.log(filt + 1e-12))
    return kidx[choice].astype(jnp.int32)


def enhance_row_gb(cfg: Gemma3Config, kv_quant: str = "bf16",
                   slots: int = 1024 + 9) -> float:
    """Device memory one batched-enhancement row adds, in GB: its K and V
    caches over `slots` positions (the 1024-slot enhancement shape plus the
    speculative bundle's slack), plus a quarter for the row's logits and
    temporaries. int8 caches hold one byte per value and an f32 scale per
    (position, head)."""
    per_pos = (cfg.head_dim + 4 if kv_quant == "int8"
               else cfg.head_dim * 2)
    kv = cfg.hidden_layers * 2 * cfg.kv_heads * slots * per_pos
    return kv * 1.25 / 1e9


def generate_tokens_batched(
    params,
    prompts,
    cfg: Gemma3Config,
    key,
    max_new_tokens: int = 512,
    temperature: float = 0.7,
    top_p: float = 0.95,
    repetition_penalty: float = 1.1,
    repetition_context: int = 64,
    stop_tokens: Tuple[int, ...] = (1,),
    bucket: int = 128,
    top_k: int = 0,
    spec_k: int = 0,
    spec_ngram: int = 3,
    kv_quant: str = "bf16",
    mesh=None,
    input_embeds=None,
):
    """B prompts through ONE compiled KV-cached sampling program.

    input_embeds: optional list of B entries — each a (1, T_i, D)
    PRE-SCALED embedding row (the VLM path's SigLIP soft-token splice,
    same contract as generate_tokens) or None for a text-only row (its
    embeddings come from the table). Enables BATCHED image-conditioned
    enhancement: I2V requests ride the same compiled program as text rows.

    Serving-throughput path (no reference analog: the Swift loop is
    strictly one prompt at a time). Decode is bound by weight reads —
    every token streams the full weight set regardless of how many batch
    rows ride along — so B prompts decode at close to the latency of one:
    batching
    multiplies enhancement throughput ~B× for a service front-end.

    Rows are left-padded to a shared 128-token bucket; each row samples
    with its own PRNG stream, repetition-penalty ring, and stop state
    (a stopped row freezes its output while the others continue). Per-row
    GREEDY output is token-identical to generate_tokens (tested); sampled
    rows draw from the same distribution but with per-row key splits, so
    a fixed seed yields different (equally valid) tokens than the
    single-prompt loop.

    Memory: the KV cache adds nl·B·kv_heads·(t_pad+max_new)·head_dim·2
    bf16 — ~0.4 GB/row at the 1024-slot enhancement shape
    (enhance_row_gb sizes the serving batch from it).

    spec_k > 0 adds prompt-lookup SPECULATIVE decoding per row (same
    n-gram draft + exact rejection sampling as generate_tokens; greedy
    output is row-identical to sequential — tested). Rows accept
    independently, so their cache positions diverge; per-row bundle
    bases write the KV cache via vectorized per-row offsets. Bundles
    stay lock-step across rows (one compiled (B, k+1) verify forward
    per iteration), so the batch advances at the rate each iteration's
    per-row acceptance allows.

    Returns a list of B token lists (each without its prompt).
    """
    if top_k <= 0:
        top_k = 64 if temperature <= 1.0 else 512
    rows = [np.asarray(p).reshape(-1) for p in prompts]
    if not rows or any(r.size == 0 for r in rows):
        from ltx_jax.core.errors import InvalidConfigurationError

        raise InvalidConfigurationError(
            "generate_tokens_batched needs >= 1 non-empty prompt")
    b = len(rows)
    t_pad = _round_up(max(r.size for r in rows), bucket)
    pads = np.asarray([t_pad - r.size for r in rows], np.int32)
    ids_padded = np.zeros((b, t_pad), np.int32)
    for i, r in enumerate(rows):
        ids_padded[i, pads[i]:] = r

    embeds_padded = None
    if input_embeds is not None and any(e is not None for e in input_embeds):
        if len(input_embeds) != b:
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(
                f"{len(input_embeds)} input_embeds rows for {b} prompts")
        scale = jnp.asarray(np.sqrt(cfg.hidden_size), embed_dtype(params))
        erows = []
        for i, e in enumerate(input_embeds):
            if e is None:
                # text-only row in a mixed batch: table lookup, pre-scaled
                # like the with_embeds path expects
                e = (_embed_lookup(params, jnp.asarray(rows[i])[None])
                     * scale)
            if e.shape[1] != rows[i].size:
                from ltx_jax.core.errors import InvalidConfigurationError

                raise InvalidConfigurationError(
                    f"input_embeds[{i}] length {e.shape[1]} != prompt "
                    f"length {rows[i].size} (ids are the bookkeeping twin)")
            full = jnp.zeros((1, t_pad, e.shape[-1]), e.dtype)
            erows.append(full.at[:, int(pads[i]):].set(e))
        embeds_padded = jnp.concatenate(erows, axis=0)

    if spec_k > 0 and max_new_tokens < 2:
        spec_k = 0  # nothing to speculate on
    max_len = t_pad + max_new_tokens
    cache_len = max_len + (spec_k + 1 if spec_k > 0 else 0)
    cos_g, sin_g = rope_tables(cache_len, cfg.head_dim, cfg.rope_theta)
    cos_l, sin_l = rope_tables(cache_len, cfg.head_dim,
                               cfg.rope_local_base_freq)
    tables = tuple(jnp.asarray(a) for a in (cos_g, sin_g, cos_l, sin_l))
    stop_arr = (jnp.asarray(list(stop_tokens), jnp.int32)
                if stop_tokens else jnp.zeros((0,), jnp.int32))

    fn = _build_generate_batched_fn(
        cfg, b, t_pad, max_new_tokens, float(temperature), float(top_p),
        float(repetition_penalty), int(repetition_context), int(top_k),
        int(spec_k), int(spec_ngram), kv_quant=str(kv_quant), mesh=mesh,
        with_embeds=embeds_padded is not None)
    out, n_gen = fn(params, jnp.asarray(ids_padded), embeds_padded,
                    jnp.asarray(pads), stop_arr, tables, key)
    out, n_gen = np.asarray(out), np.asarray(n_gen)
    return [[int(x) for x in out[i, : n_gen[i]]] for i in range(b)]


@functools.lru_cache(maxsize=8)
def _build_generate_batched_fn(cfg: Gemma3Config, batch: int, t_pad: int,
                               max_new_tokens: int, temperature: float,
                               top_p: float, repetition_penalty: float,
                               repetition_context: int, top_k: int,
                               spec_k: int = 0, spec_ngram: int = 3,
                               kv_quant: str = "bf16", mesh=None,
                               with_embeds: bool = False):
    """Compile-cached batched generation program (one (config, B, bucket)).

    DELIBERATE twin of _build_generate_fn: delegating generate_tokens to
    B=1 here would change its sampled-path PRNG stream (per-row key
    splits) and drop the input_embeds path. Sampler / penalty / stop /
    spec-commit semantics must stay lock-step with the single-row loop —
    test_gemma_spec.py pins greedy equality across both."""
    nl, nkv, hd = cfg.hidden_layers, cfg.kv_heads, cfg.head_dim
    vocab = cfg.vocab_size
    max_len = t_pad + max_new_tokens
    cache_len = max_len + (spec_k + 1 if spec_k > 0 else 0)
    scale_emb = float(np.sqrt(cfg.hidden_size))
    is_global = jnp.asarray(
        [cfg.is_global_layer(i) for i in range(nl)])
    ctx = max(repetition_context, 1)

    def run(params, ids, embeds, pads, stop_arr, tables, key):
        cos_g, sin_g, cos_l, sin_l = tables
        dtype = embed_dtype(params)
        if with_embeds:
            h = embeds.astype(dtype)  # pre-scaled (VLM soft-token splice)
        else:
            h = _embed_lookup(params, ids) * jnp.asarray(scale_emb, dtype)

        # --- prefill biases: (B, 1, t_pad, cache_len), per-row left pad
        row = jnp.arange(t_pad)[None, :, None]
        col = jnp.arange(cache_len)[None, None, :]
        pad_b = pads[:, None, None]
        valid = (col <= row) & (col >= pad_b)
        bias_g = jnp.where(valid, 0.0, -1e9)[:, None].astype(jnp.float32)
        valid_s = valid & (col > row - cfg.sliding_window)
        bias_s = jnp.where(valid_s, 0.0, -1e9)[:, None].astype(jnp.float32)

        # per-row positions shifted by that row's pad; junk slots clamp to 0
        pos_ids = jnp.maximum(jnp.arange(t_pad)[None] - pads[:, None], 0)
        pcos_g, psin_g = cos_g[pos_ids], sin_g[pos_ids]  # (B, t_pad, hd/2)
        pcos_l, psin_l = cos_l[pos_ids], sin_l[pos_ids]

        ck0 = _kv_constrain(
            _kv_cache_init(kv_quant, (nl, batch, nkv, cache_len, hd),
                           dtype), mesh)
        cv0 = _kv_constrain(
            _kv_cache_init(kv_quant, (nl, batch, nkv, cache_len, hd),
                           dtype), mesh)

        def prefill_layer(carry, scanned):
            h = carry
            p, glob, ck, cv = scanned
            cos = jnp.where(glob, pcos_g, pcos_l)
            sin = jnp.where(glob, psin_g, psin_l)
            bias = jnp.where(glob, bias_g, bias_s)
            h, (ck, cv) = _decoder_layer(p, h, bias, cos, sin, cfg,
                                         (ck, cv), 0)
            return h, (ck, cv)

        h, (cks, cvs) = lax.scan(
            prefill_layer, h, (params["layers"], is_global, ck0, cv0))
        cks, cvs = _kv_constrain(cks, mesh), _kv_constrain(cvs, mesh)
        h = gemma_rms_norm(h, params["norm"]["w"], cfg.rms_norm_eps)
        logits0 = _lm_head(params, h[:, -1])  # (B, vocab) f32

        def decode(carry_caches, toks, pos_b, uniform_pos=None):
            """(B, m) token bundle; row i writes cache slots
            pos_b[i]..pos_b[i]+m-1 (per-row bases — they diverge under
            speculative acceptance). Within-bundle causal: bundle row j
            of batch row i attends to slots [pads[i], pos_b[i]+j].
            uniform_pos: traced scalar when every row shares the same
            base (lock-step sequential path) — keeps the cache write one
            dynamic_update_slice instead of a per-row scatter."""
            m = toks.shape[1]
            cks, cvs = carry_caches
            h = (_embed_lookup(params, toks)
                 * jnp.asarray(scale_emb, dtype))  # (B, m, D)
            idx = jnp.arange(cache_len)[None, None, None, :]
            rows = jnp.arange(m)[None, None, :, None]
            ok = (idx >= pads[:, None, None, None]) & \
                 (idx <= (pos_b[:, None, None, None] + rows))
            bias = jnp.where(ok, 0.0, -1e9).astype(jnp.float32)
            rp = (pos_b - pads)[:, None] + jnp.arange(m)[None]  # (B, m)
            dcos_g, dsin_g = cos_g[rp], sin_g[rp]  # (B, m, hd/2)
            dcos_l, dsin_l = cos_l[rp], sin_l[rp]
            ci = pos_b if uniform_pos is None else uniform_pos

            def layer(carry, scanned):
                h = carry
                p, glob, ck, cv = scanned
                cos = jnp.where(glob, dcos_g, dcos_l)
                sin = jnp.where(glob, dsin_g, dsin_l)
                h, (ck, cv) = _decoder_layer(p, h, bias, cos, sin, cfg,
                                             (ck, cv), ci)
                return h, (ck, cv)

            h, (cks, cvs) = lax.scan(
                layer, h, (params["layers"], is_global, cks, cvs))
            h = gemma_rms_norm(h, params["norm"]["w"], cfg.rms_norm_eps)
            return (cks, cvs), _lm_head(params, h)  # (B, m, vocab) f32

        def penalize_row(lg, ring):
            if repetition_penalty == 1.0:
                return lg
            hit = jnp.zeros((vocab + 1,), bool).at[ring].set(True)[:vocab]
            return jnp.where(
                hit, jnp.where(lg > 0, lg / repetition_penalty,
                               lg * repetition_penalty), lg)

        def sample(lg, keys):
            if temperature <= 0:
                return lax.top_k(lg, 1)[1][:, 0].astype(jnp.int32)
            return jax.vmap(
                lambda l, k: topp_sample(l, k, temperature, top_p, top_k)
            )(lg, keys)

        def is_stop(toks):
            return (jnp.any(toks[:, None] == stop_arr[None, :], axis=1)
                    if stop_arr.shape[0] else jnp.zeros((batch,), bool))

        if spec_k > 0:
            return _spec_loop_batched(
                ids, pads, key, (cks, cvs), logits0,
                decode, penalize_row, sample, is_stop,
                batch=batch, t_pad=t_pad, max_new_tokens=max_new_tokens,
                cache_len=cache_len, ctx=ctx, vocab=vocab,
                spec_k=spec_k, spec_ngram=spec_ngram,
                temperature=temperature, top_p=top_p, top_k=top_k)

        def cond(state):
            _, _, _, _, _, _, n, done = state
            return (n < max_new_tokens) & ~jnp.all(done)

        def body(state):
            caches, logits, key, out, ring, n_gen, n, done = state
            key, sub = jax.random.split(key)
            subs = jax.random.split(sub, batch)
            lg = jax.vmap(penalize_row)(logits, ring)
            nxt = sample(lg, subs)  # (B,)
            stop_hit = is_stop(nxt)
            write = ~done & ~stop_hit
            out = out.at[:, n].set(jnp.where(write, nxt, out[:, n]))
            ring = ring.at[:, n % ctx].set(
                jnp.where(write, nxt, ring[:, n % ctx]))
            n_gen = n_gen + write.astype(jnp.int32)
            done = done | stop_hit
            caches, logits = decode(
                caches, nxt[:, None], jnp.full((batch,), t_pad + n),
                uniform_pos=t_pad + n)
            return caches, logits[:, 0], key, out, ring, n_gen, n + 1, done

        out0 = jnp.full((batch, max_new_tokens), -1, jnp.int32)
        ring0 = jnp.full((batch, ctx), vocab, jnp.int32)  # out-of-range
        state = ((cks, cvs), logits0, key, out0, ring0,
                 jnp.zeros((batch,), jnp.int32), jnp.asarray(0, jnp.int32),
                 jnp.zeros((batch,), bool))
        state = lax.while_loop(cond, body, state)
        _, _, _, out, _, n_gen, _, _ = state
        return out, n_gen

    return jax.jit(run)


def spec_accept(lg, draft, key, temperature: float, top_p: float,
                top_k: int = 64):
    """Rejection-sample one draft candidate against the target row.

    For a DETERMINISTIC draft q = delta(draft): accept with probability
    p(draft); on rejection sample from the residual — p with the draft's
    mass removed, renormalized. The committed token is then distributed
    exactly as a direct topp_sample from p (speculative sampling
    specialized to a point-mass proposal). At temperature<=0 this reduces
    to "accept iff the draft IS the argmax, else emit the argmax", so
    speculative greedy output is token-identical to the sequential loop.
    Returns (token, accepted).
    """
    if temperature <= 0:
        tgt = lax.top_k(lg, 1)[1][0].astype(jnp.int32)  # argmax, fast path
        acc = tgt == draft
        return jnp.where(acc, draft, tgt).astype(jnp.int32), acc
    kidx, filt = _topp_filtered(lg, temperature, top_p, top_k)
    d_slot = kidx == draft
    p_d = jnp.sum(jnp.where(d_slot, filt, 0.0)) / jnp.sum(filt)
    ku, kc = jax.random.split(key)
    acc = jax.random.uniform(ku) < p_d
    resid = jnp.where(d_slot, 0.0, filt)
    alt = kidx[jax.random.categorical(kc, jnp.log(resid + 1e-12))]
    return jnp.where(acc, draft, alt).astype(jnp.int32), acc


def _ngram_draft(ctx_buf, cursor, pad, ngram: int, k: int):
    """Prompt-lookup draft over the token history.

    Finds a position s (pad <= s, s + ngram < cursor) where
    ctx_buf[s:s+ngram] equals the trailing ngram ending at `cursor`, and
    proposes the k tokens that followed it. Among matches it prefers the
    MOST RECENT one with a full k followers before the cursor, else the
    EARLIEST match (max followers): the naive most-recent rule degenerates
    on self-repetitive output — the match hugs the cursor and leaves ~1
    usable follower, capping commits at ~2/bundle (measured, probe v1).
    Unwritten slots hold -1 (never a token id) so they can't match; -1
    marks no-match/out-of-range draft slots (verification rejects them).
    """
    n = ctx_buf.shape[0]
    pat = lax.dynamic_slice_in_dim(ctx_buf, cursor - ngram, ngram)
    win = jnp.stack([ctx_buf[j:n - ngram + j] for j in range(ngram)], 1)
    starts = jnp.arange(n - ngram)
    match = jnp.all(win == pat[None], axis=1)
    match &= (starts >= pad) & (starts + ngram < cursor)
    full = match & (starts + ngram + k <= cursor)
    s_full = jnp.max(jnp.where(full, starts, -1))
    s_any = jnp.min(jnp.where(match, starts, n))
    s = jnp.where(s_full >= 0, s_full,
                  jnp.where(jnp.any(match), s_any, -1))
    src = jnp.maximum(s, 0) + ngram
    draft = lax.dynamic_slice_in_dim(ctx_buf, src, k)
    # beyond-cursor slots are unwritten; a clamped slice (src+k > n) is
    # misaligned but still verified, costing only acceptance rate
    ok = (s >= 0) & (jnp.arange(k) + src < cursor)
    return jnp.where(ok, draft, -1)


def _spec_loop(params, ids, pad, stop_arr, key, caches, logits0,
               decode, penalize, sample, is_stop, *, t_pad, max_new_tokens,
               cache_len, ctx, vocab, temperature, top_p, top_k,
               spec_k, spec_ngram):
    """Prompt-lookup speculative decode loop (module comment has the
    design). Traced inside _build_generate_fn's `run`; commits 1 to
    spec_k+1 tokens per (spec_k+1)-wide verify forward."""
    out0 = jnp.full((max_new_tokens,), -1, jnp.int32)
    ring0 = jnp.full((ctx,), vocab, jnp.int32)  # out-of-range slot
    ctx_buf0 = jnp.concatenate([
        jnp.where(jnp.arange(t_pad) >= pad, ids[0].astype(jnp.int32), -1),
        jnp.full((cache_len - t_pad,), -1, jnp.int32)])

    # the first token comes straight from the prefill logits
    key, k0 = jax.random.split(key)
    tok0 = sample(penalize(logits0[0], ring0), k0)
    stop0 = is_stop(tok0)
    out = jnp.where(stop0, out0, out0.at[0].set(tok0))
    ring = jnp.where(stop0, ring0, ring0.at[0].set(tok0))
    ctx_buf = jnp.where(stop0, ctx_buf0, ctx_buf0.at[t_pad].set(tok0))
    n_gen = jnp.where(stop0, 0, 1).astype(jnp.int32)

    def commit(tok, live, out, ring, ctx_buf, n_gen, done, last):
        """Bookkeeping for one committed candidate (mirrors the
        sequential body: a stop token terminates without being written)."""
        hit = is_stop(tok)
        write = live & ~hit
        out = jnp.where(write, out.at[n_gen].set(tok), out)
        ring = jnp.where(write, ring.at[n_gen % ctx].set(tok), ring)
        ctx_buf = jnp.where(write, ctx_buf.at[t_pad + n_gen].set(tok),
                            ctx_buf)
        n_gen = n_gen + write.astype(jnp.int32)
        done = done | (live & hit)
        last = jnp.where(write, tok, last)
        return write, out, ring, ctx_buf, n_gen, done, last

    def cond(state):
        _, _, _, _, _, _, n_gen, done, _ = state
        return (~done) & (n_gen < max_new_tokens)

    def body(state):
        caches, cur, key, out, ring, ctx_buf, n_gen, done, it = state
        pos = t_pad + n_gen - 1          # cache slot for cur
        cursor = t_pad + n_gen           # ctx_buf write cursor
        draft = _ngram_draft(ctx_buf, cursor, pad, spec_ngram, spec_k)
        toks = jnp.concatenate([cur[None], jnp.maximum(draft, 0)])
        caches, logits = decode(caches, toks, pos)  # (spec_k+1, vocab)

        keys = jax.random.split(key, spec_k + 2)

        def acc_step(carry, xs):
            out, ring, ctx_buf, n_gen, accepting, done, last = carry
            d, row, kk = xs
            tok, acc = spec_accept(penalize(row, ring), d, kk,
                                   temperature, top_p, top_k)
            live = accepting & ~done & (n_gen < max_new_tokens)
            write, out, ring, ctx_buf, n_gen, done, last = commit(
                tok, live, out, ring, ctx_buf, n_gen, done, last)
            accepting = write & acc  # a rejection commits the correction
            return (out, ring, ctx_buf, n_gen, accepting, done, last), None

        carry, _ = lax.scan(
            acc_step,
            (out, ring, ctx_buf, n_gen, jnp.asarray(True), done, cur),
            (draft, logits[:-1], keys[2:]))
        out, ring, ctx_buf, n_gen, accepting, done, last = carry

        # bonus token from the last row when the whole draft was accepted
        tokb = sample(penalize(logits[-1], ring), keys[1])
        live = accepting & ~done & (n_gen < max_new_tokens)
        _, out, ring, ctx_buf, n_gen, done, last = commit(
            tokb, live, out, ring, ctx_buf, n_gen, done, last)
        return caches, last, keys[0], out, ring, ctx_buf, n_gen, done, it + 1

    state = (caches, tok0, key, out, ring, ctx_buf, n_gen, stop0,
             jnp.asarray(0, jnp.int32))
    state = lax.while_loop(cond, body, state)
    _, _, _, out, _, _, n_gen, _, fwds = state
    return out, n_gen, fwds


def _spec_loop_batched(ids, pads, key, caches, logits0, decode,
                       penalize_row, sample, is_stop, *, batch, t_pad,
                       max_new_tokens, cache_len, ctx, vocab, spec_k,
                       spec_ngram, temperature, top_p, top_k):
    """Batched prompt-lookup speculative decode loop.

    Per-row semantics are IDENTICAL to _spec_loop: each row drafts from
    its own token history, rejection-samples against its own target
    logits, and freezes independently on its stop token. Rows accept
    different counts, so their cache bundle bases (pos_b) diverge —
    decode() writes the KV cache with per-row offsets. Bundles stay
    lock-step (one (B, spec_k+1) verify forward per iteration); a row
    that commits fewer tokens simply re-speculates from its corrected
    position next iteration.
    """
    b_idx = jnp.arange(batch)
    out0 = jnp.full((batch, max_new_tokens), -1, jnp.int32)
    ring0 = jnp.full((batch, ctx), vocab, jnp.int32)  # out-of-range slot
    ctx_buf0 = jnp.concatenate([
        jnp.where(jnp.arange(t_pad)[None] >= pads[:, None],
                  ids.astype(jnp.int32), -1),
        jnp.full((batch, cache_len - t_pad), -1, jnp.int32)], axis=1)

    # first token per row straight from the prefill logits
    key, k0 = jax.random.split(key)
    tok0 = sample(jax.vmap(penalize_row)(logits0, ring0),
                  jax.random.split(k0, batch))
    stop0 = is_stop(tok0)
    sel = lambda c, a, b: jnp.where(c[:, None], a, b)
    out = sel(stop0, out0, out0.at[:, 0].set(tok0))
    ring = sel(stop0, ring0, ring0.at[:, 0].set(tok0))
    ctx_buf = sel(stop0, ctx_buf0, ctx_buf0.at[:, t_pad].set(tok0))
    n_gen = jnp.where(stop0, 0, 1).astype(jnp.int32)

    def commit(tok, live, out, ring, ctx_buf, n_gen, done, last):
        """Per-row bookkeeping for one committed candidate (mirrors the
        sequential body: a stop token terminates without being written).
        n_gen==max_new rows have live=False; the clamped gather/scatter
        at their out-of-range index is discarded by the select."""
        hit = is_stop(tok)
        write = live & ~hit
        out = jnp.where(write[:, None],
                        out.at[b_idx, n_gen].set(tok), out)
        ring = jnp.where(write[:, None],
                         ring.at[b_idx, n_gen % ctx].set(tok), ring)
        ctx_buf = jnp.where(write[:, None],
                            ctx_buf.at[b_idx, t_pad + n_gen].set(tok),
                            ctx_buf)
        n_gen = n_gen + write.astype(jnp.int32)
        done = done | (live & hit)
        last = jnp.where(write, tok, last)
        return write, out, ring, ctx_buf, n_gen, done, last

    def cond(state):
        _, _, _, _, _, _, n_gen, done = state
        return jnp.any(~done & (n_gen < max_new_tokens))

    def body(state):
        caches, cur, key, out, ring, ctx_buf, n_gen, done = state
        pos_b = t_pad + n_gen - 1        # per-row cache slot for cur
        cursor = t_pad + n_gen           # per-row ctx_buf write cursor
        draft = jax.vmap(
            lambda cb, cu, pd: _ngram_draft(cb, cu, pd, spec_ngram, spec_k)
        )(ctx_buf, cursor, pads)         # (B, spec_k)
        toks = jnp.concatenate([cur[:, None], jnp.maximum(draft, 0)],
                               axis=1)   # (B, spec_k+1)
        caches, logits = decode(caches, toks, pos_b)  # (B, k+1, vocab)

        keys = jax.random.split(key, spec_k + 2)

        def acc_step(carry, xs):
            out, ring, ctx_buf, n_gen, accepting, done, last = carry
            d, row_lg, kk = xs           # (B,), (B, vocab), key
            lg = jax.vmap(penalize_row)(row_lg, ring)
            tok, acc = jax.vmap(
                lambda l, dd, k_: spec_accept(l, dd, k_, temperature,
                                              top_p, top_k)
            )(lg, d, jax.random.split(kk, batch))
            live = accepting & ~done & (n_gen < max_new_tokens)
            write, out, ring, ctx_buf, n_gen, done, last = commit(
                tok, live, out, ring, ctx_buf, n_gen, done, last)
            accepting = write & acc  # a rejection commits the correction
            return (out, ring, ctx_buf, n_gen, accepting, done, last), None

        carry, _ = lax.scan(
            acc_step,
            (out, ring, ctx_buf, n_gen, jnp.ones((batch,), bool), done,
             cur),
            (draft.T, logits[:, :-1].transpose(1, 0, 2), keys[2:]))
        out, ring, ctx_buf, n_gen, accepting, done, last = carry

        # bonus token from the last row when a row's whole draft accepted
        tokb = sample(jax.vmap(penalize_row)(logits[:, -1], ring),
                      jax.random.split(keys[1], batch))
        live = accepting & ~done & (n_gen < max_new_tokens)
        _, out, ring, ctx_buf, n_gen, done, last = commit(
            tokb, live, out, ring, ctx_buf, n_gen, done, last)
        return caches, last, keys[0], out, ring, ctx_buf, n_gen, done

    state = (caches, tok0, key, out, ring, ctx_buf, n_gen, stop0)
    state = lax.while_loop(cond, body, state)
    _, _, _, out, _, _, n_gen, _ = state
    return out, n_gen


def embed_dtype(params):
    """Activation dtype implied by the embedding table (bf16 when the
    table itself is int8-quantized)."""
    e = params["embed_tokens"]
    return e["w"].dtype if "w" in e else jnp.bfloat16


def _embed_lookup(params, ids):
    e = params["embed_tokens"]
    if "w8r" in e:
        # int8 table with per-ROW (per-token) scales: gather + dequant.
        # The source checkpoint's embedding is 4-bit QAT, so the int8
        # grid is strictly finer than the values' native precision.
        rows = e["w8r"][ids].astype(jnp.float32) * e["sr"][ids][..., None]
        return rows.astype(jnp.bfloat16)
    return e["w"][ids]


def _lm_head(params, h):
    """Tied embeddings as lm_head (reference: Gemma3Model.swift:434).

    bf16 table: plain bf16 matmul. int8 table (embed_int8 load option):
    the per-row scales make rows output channels, so the logits run the
    s8 x s8 dot with dynamically int8-quantized activations — and the 2 GB
    bf16 table is REPLACED, freeing ~1 GB for serving batch."""
    e = params["embed_tokens"]
    if "w8r" in e:
        from ltx_jax.kernels.quantization import quantize_act_int8

        h8, sx = quantize_act_int8(h)
        acc = jax.lax.dot_general(
            h8, e["w8r"], (((h8.ndim - 1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)
        # sx keeps a trailing singleton; sr broadcasts over the vocab axis
        return acc.astype(jnp.float32) * sx * e["sr"]
    return jnp.dot(h, e["w"].T, preferred_element_type=jnp.float32)


# Compiled entry point for the pipeline's text-encoding phase: eager
# layer-by-layer execution compiles a program per distinct op shape on
# first call and loses all cross-op fusion after. cfg is static — one
# executable per (config, shape).
forward_hidden_states_jit = jax.jit(forward_hidden_states, static_argnums=3)
