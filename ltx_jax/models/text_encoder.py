"""LTX text-encoding stack: Gemma feature extractor + 1D embeddings connector.

Reference behavior: Sources/LTXVideo/Models/TextEncoder/LTXTextEncoder.swift.

Pipeline: 49 Gemma hidden states -> masked norm&concat (f32) -> Linear
188160->3840 (f32) -> 2-layer 1D transformer with learnable registers
replacing pad positions -> weightless RMSNorm. An optional audio connector
with independent weights shares the feature-extractor output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ltx_jax.models.common import gelu_tanh, linear, linear_init
from ltx_jax.ops.attention import sdpa
from ltx_jax.ops.normalization import rms_norm
from ltx_jax.ops.rope import apply_rope_split, precompute_freqs_cis


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """Reference: LTXTextEncoder.swift:13-45."""

    hidden_dim: int = 3840
    num_gemma_layers: int = 49  # 48 layers + embedding
    connector_heads: int = 30
    connector_head_dim: int = 128
    connector_layers: int = 2
    num_registers: int = 128
    rope_theta: float = 10000.0
    rope_max_pos: Tuple[int, ...] = (4096,)
    norm_eps: float = 1e-6
    max_length: int = 1024  # token budget, left padding, pad_id 0

    @property
    def inner_dim(self) -> int:
        return self.connector_heads * self.connector_head_dim  # 3840

    def tiny(self) -> "TextEncoderConfig":
        return dataclasses.replace(
            self,
            hidden_dim=32,
            num_gemma_layers=3,
            connector_heads=2,
            connector_head_dim=16,
            num_registers=4,
            max_length=16,
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_connector_params(key, cfg: TextEncoderConfig, dtype=jnp.bfloat16):
    d = cfg.inner_dim
    ks = iter(jax.random.split(key, 6 * cfg.connector_layers + 1))
    blocks = []
    for _ in range(cfg.connector_layers):
        blocks.append({
            "attn1": {
                "to_q": linear_init(next(ks), d, d, dtype),
                "to_k": linear_init(next(ks), d, d, dtype),
                "to_v": linear_init(next(ks), d, d, dtype),
                "to_out": linear_init(next(ks), d, d, dtype),
                "q_norm": {"w": jnp.ones((d,), dtype)},
                "k_norm": {"w": jnp.ones((d,), dtype)},
            },
            "ff": {
                "project_in": linear_init(next(ks), d, 4 * d, dtype),
                "project_out": linear_init(next(ks), 4 * d, d, dtype),
            },
        })
    registers = jax.random.uniform(
        next(ks), (cfg.num_registers, d), jnp.float32, -1.0, 1.0
    ).astype(dtype)
    return {"transformer_1d_blocks": blocks, "learnable_registers": registers}


def init_params(key, cfg: TextEncoderConfig, dtype=jnp.bfloat16,
                include_audio: bool = False):
    ks = jax.random.split(key, 3)
    params = {
        "feature_extractor": {
            "aggregate_embed": linear_init(
                ks[0], cfg.hidden_dim * cfg.num_gemma_layers, cfg.hidden_dim,
                dtype, bias=False,
            )
        },
        "embeddings_connector": init_connector_params(ks[1], cfg, dtype),
    }
    if include_audio:
        params["audio_embeddings_connector"] = init_connector_params(
            ks[2], cfg, dtype
        )
    return params


# ---------------------------------------------------------------------------
# Feature extractor
# ---------------------------------------------------------------------------


def norm_and_concat(hidden_states, attention_mask, padding_side: str = "left"):
    """Masked per-sample normalization 8*(x - mean)/(max - min + eps) over
    (T, D) of all layers jointly, computed in float32, then concat layers
    (reference: LTXTextEncoder.swift:67-123).

    hidden_states: (L, B, T, D); attention_mask: (B, T) {0,1}.
    Returns (B, T, D*L) in the input dtype with pad rows zeroed.
    """
    num_layers, b, t, d = hidden_states.shape
    dtype = hidden_states.dtype
    x32 = hidden_states.astype(jnp.float32).transpose(1, 2, 3, 0)  # (B,T,D,L)

    seq_lens = jnp.sum(attention_mask, axis=-1).astype(jnp.int32)  # (B,)
    token_idx = jnp.arange(t)[None, :]
    if padding_side == "right":
        mask = token_idx < seq_lens[:, None]
    else:
        mask = token_idx >= (t - seq_lens)[:, None]
    m = mask[:, :, None, None]

    eps = jnp.float32(1e-6)
    masked = jnp.where(m, x32, 0.0)
    denom = (seq_lens * d).reshape(b, 1, 1, 1).astype(jnp.float32) + eps
    mean = jnp.sum(masked, axis=(1, 2), keepdims=True) / denom

    x_min = jnp.min(jnp.where(m, x32, jnp.inf), axis=(1, 2), keepdims=True)
    x_max = jnp.max(jnp.where(m, x32, -jnp.inf), axis=(1, 2), keepdims=True)

    normed = 8.0 * (x32 - mean) / (x_max - x_min + eps)
    normed = normed.astype(dtype).reshape(b, t, d * num_layers)
    return jnp.where(mask[:, :, None], normed, jnp.zeros((), dtype))


def feature_extractor(params, hidden_states, attention_mask,
                      padding_side: str = "left"):
    """norm&concat then the 188160->3840 projection, both in float32
    (reference: LTXTextEncoder.swift:155-186)."""
    dtype = hidden_states.dtype
    nc = norm_and_concat(hidden_states, attention_mask, padding_side)
    w = params["aggregate_embed"]["w"].astype(jnp.float32)
    out = jnp.dot(nc.astype(jnp.float32), w, preferred_element_type=jnp.float32)
    return out.astype(dtype)


# ---------------------------------------------------------------------------
# Connector
# ---------------------------------------------------------------------------


def replace_padded_with_registers(hidden_states, valid_mask, registers):
    """Compact valid tokens to the FRONT (stable argsort), fill the tail with
    tiled learnable registers (reference: LTXTextEncoder.swift:423-468).

    hidden_states: (B, T, D); valid_mask: (B, T) bool; registers: (R, D) with
    T % R == 0. Returns (B, T, D); afterwards every position is valid.
    """
    b, t, d = hidden_states.shape
    r = registers.shape[0]
    assert t % r == 0, f"seq len {t} must be divisible by num registers {r}"
    tiled = jnp.tile(registers[None], (b, t // r, 1))

    idx = jnp.arange(t)[None, :]
    sort_key = (1 - valid_mask.astype(jnp.int32)) * t + idx
    order = jnp.argsort(sort_key, axis=1)
    compacted = jnp.take_along_axis(hidden_states, order[:, :, None], axis=1)

    # Registers fill the tail: position j holds a real token iff
    # j < seq_len, which equals the REVERSED valid mask for left padding.
    flipped = valid_mask[:, ::-1].astype(hidden_states.dtype)[:, :, None]
    return flipped * compacted + (1 - flipped) * tiled


def connector_attention(params, x, pe, num_heads: int, head_dim: int,
                        eps: float = 1e-6):
    """Full-3840 QK norm on the flat tensor, RoPE AFTER head split — the
    opposite order from the DiT attention (reference:
    LTXTextEncoder.swift:197-269)."""
    b, t, _ = x.shape
    q = linear(params["to_q"], x)
    k = linear(params["to_k"], x)
    v = linear(params["to_v"], x)

    q = rms_norm(q, params["q_norm"]["w"], eps=eps)
    k = rms_norm(k, params["k_norm"]["w"], eps=eps)

    q = q.reshape(b, t, num_heads, head_dim).transpose(0, 2, 1, 3)
    k = k.reshape(b, t, num_heads, head_dim).transpose(0, 2, 1, 3)
    v = v.reshape(b, t, num_heads, head_dim).transpose(0, 2, 1, 3)

    cos, sin = pe
    q = apply_rope_split(q, cos, sin)
    k = apply_rope_split(k, cos, sin)

    out = sdpa(q, k, v, scale=head_dim**-0.5)
    out = out.transpose(0, 2, 1, 3).reshape(b, t, num_heads * head_dim)
    return linear(params["to_out"], out)


def connector_forward(params, hidden_states, attention_mask,
                      cfg: TextEncoderConfig):
    """Registers replace pads -> 2x (RMSNorm+attn, RMSNorm+ff) with 1D split
    RoPE -> weightless RMSNorm (reference: LTXTextEncoder.swift:470-521).

    attention_mask: (B, T) {0,1} or None. After register replacement every
    position is valid, so attention runs unmasked. Returns (x, ones-mask).
    """
    x = hidden_states
    b, t, _ = x.shape
    if attention_mask is not None:
        valid = attention_mask.astype(bool)
        x = replace_padded_with_registers(x, valid, params["learnable_registers"])

    grid = np.arange(t, dtype=np.float32)[None, :]  # 1D positions
    cos, sin = precompute_freqs_cis(
        grid, cfg.inner_dim, theta=cfg.rope_theta, max_pos=cfg.rope_max_pos,
        num_heads=cfg.connector_heads,
    )
    # Python computes f64 -> f32 -> casts to activation dtype
    pe = (jnp.asarray(cos).astype(x.dtype), jnp.asarray(sin).astype(x.dtype))

    for block in params["transformer_1d_blocks"]:
        normed = rms_norm(x, eps=cfg.norm_eps)
        x = x + connector_attention(
            block["attn1"], normed, pe, cfg.connector_heads,
            cfg.connector_head_dim, cfg.norm_eps,
        )
        normed = rms_norm(x, eps=cfg.norm_eps)
        ff = linear(block["ff"]["project_out"],
                    gelu_tanh(linear(block["ff"]["project_in"], normed)))
        x = x + ff

    x = rms_norm(x, eps=cfg.norm_eps)
    return x, jnp.ones((b, t), jnp.int32)


# ---------------------------------------------------------------------------
# Full encode
# ---------------------------------------------------------------------------


def encode_from_hidden_states(params, hidden_states, attention_mask,
                              cfg: TextEncoderConfig,
                              padding_side: str = "left"):
    """49 Gemma states (L, B, T, D) + mask (B, T) -> dict with
    video (B, T, 3840), mask (B, T), optional audio (B, T, 3840)
    (reference: LTXTextEncoder.swift:579-643)."""
    encoded = feature_extractor(params["feature_extractor"], hidden_states,
                                attention_mask, padding_side)
    video, out_mask = connector_forward(
        params["embeddings_connector"], encoded, attention_mask, cfg
    )
    video = video * out_mask[:, :, None].astype(video.dtype)
    result = {"video": video, "mask": out_mask}
    if "audio_embeddings_connector" in params:
        audio, audio_mask = connector_forward(
            params["audio_embeddings_connector"], encoded, attention_mask, cfg
        )
        result["audio"] = audio * audio_mask[:, :, None].astype(audio.dtype)
    return result


# Compiled entry point for the pipeline (see gemma3.forward_hidden_states_jit)
encode_from_hidden_states_jit = jax.jit(encode_from_hidden_states,
                                        static_argnums=(3, 4))
