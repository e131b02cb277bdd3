"""SigLIP vision tower + Gemma-3 multimodal projector (I2V prompt enhance).

The reference feeds the I2V conditioning image through MLXVLM's Gemma-3
vision pathway (reference: LTXPipeline.swift:2862-2971 via VLMModelFactory).
That pathway is SigLIP-So400m/14 @ 896x896 (27 layers, width 1152, 16 heads,
MLP 4304, learned position embeddings over the 64x64 patch grid) followed by
Gemma3's multimodal projector: 4x4 average pooling of the patch grid down to
256 soft tokens, Gemma RMSNorm, and a 1152->3840 projection. The 256 soft
tokens splice into the text-embedding stream (models/gemma3.py
generate_tokens input_embeds) WITHOUT the sqrt(hidden) text scaling.

Functional pytree params; one jit; bf16 weights. Weight loading handles the
HF-layout keys (vision_tower.vision_model.* / multi_modal_projector.*),
including MLX 4-bit quantized exports (dequantized to bf16 — the tower is
0.4B params, ~0.8 GB).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    """gemma-3-12b vision_config defaults (HF config.json)."""

    hidden_size: int = 1152
    image_size: int = 896
    patch_size: int = 14
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    layer_norm_eps: float = 1e-6
    # projector
    text_hidden_size: int = 3840
    mm_tokens_per_image: int = 256
    rms_norm_eps: float = 1e-6

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @property
    def pool_kernel(self) -> int:
        tokens_per_side = int(round(self.mm_tokens_per_image ** 0.5))
        return self.patches_per_side // tokens_per_side

    def tiny(self) -> "SigLIPConfig":
        return dataclasses.replace(
            self, hidden_size=32, image_size=56, patch_size=14, num_layers=2,
            num_heads=4, intermediate_size=64, text_hidden_size=48,
            mm_tokens_per_image=4,
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _dense(key, d_in, d_out, dtype):
    w = jax.random.normal(key, (d_in, d_out), jnp.float32) * d_in ** -0.5
    return {"w": w.astype(dtype), "b": jnp.zeros((d_out,), dtype)}


def _ln(d, dtype):
    return {"w": jnp.ones((d,), dtype), "b": jnp.zeros((d,), dtype)}


def _layer_init(key, cfg: SigLIPConfig, dtype):
    d = cfg.hidden_size
    ks = jax.random.split(key, 6)
    return {
        "layer_norm1": _ln(d, dtype),
        "q_proj": _dense(ks[0], d, d, dtype),
        "k_proj": _dense(ks[1], d, d, dtype),
        "v_proj": _dense(ks[2], d, d, dtype),
        "out_proj": _dense(ks[3], d, d, dtype),
        "layer_norm2": _ln(d, dtype),
        "fc1": _dense(ks[4], d, cfg.intermediate_size, dtype),
        "fc2": _dense(ks[5], cfg.intermediate_size, d, dtype),
    }


def init_params(key, cfg: SigLIPConfig, dtype=jnp.bfloat16):
    ks = jax.random.split(key, 5)
    d = cfg.hidden_size
    p = cfg.patch_size
    layers = [_layer_init(k, cfg, dtype)
              for k in jax.random.split(ks[0], cfg.num_layers)]
    return {
        "patch_embedding": {
            "w": (jax.random.normal(ks[1], (p, p, 3, d), jnp.float32)
                  * (3 * p * p) ** -0.5).astype(dtype),
            "b": jnp.zeros((d,), dtype),
        },
        "position_embedding": {
            "w": (jax.random.normal(ks[2], (cfg.num_patches, d), jnp.float32)
                  * 0.02).astype(dtype)
        },
        "layers": jax.tree.map(lambda *xs: jnp.stack(xs), *layers),
        "post_layernorm": _ln(d, dtype),
        "projector": {
            "mm_soft_emb_norm": {"w": jnp.zeros((d,), dtype)},
            "mm_input_projection": {
                "w": (jax.random.normal(ks[3], (d, cfg.text_hidden_size),
                                        jnp.float32) * d ** -0.5
                      ).astype(dtype)
            },
        },
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(p, x, eps):
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = ((xf - mu) ** 2).mean(-1, keepdims=True)
    out = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (out * p["w"].astype(jnp.float32)
            + p["b"].astype(jnp.float32)).astype(x.dtype)


def _attention(p, x, num_heads):
    b, t, d = x.shape
    hd = d // num_heads

    def proj(q):
        return (jnp.dot(x, q["w"], preferred_element_type=jnp.float32)
                + q["b"].astype(jnp.float32)).astype(x.dtype)

    q = proj(p["q_proj"]).reshape(b, t, num_heads, hd).transpose(0, 2, 1, 3)
    k = proj(p["k_proj"]).reshape(b, t, num_heads, hd).transpose(0, 2, 1, 3)
    v = proj(p["v_proj"]).reshape(b, t, num_heads, hd).transpose(0, 2, 1, 3)
    from ltx_jax.ops.attention import sdpa

    out = sdpa(q, k, v, scale=hd ** -0.5)
    out = out.transpose(0, 2, 1, 3).reshape(b, t, d)
    return (jnp.dot(out, p["out_proj"]["w"],
                    preferred_element_type=jnp.float32)
            + p["out_proj"]["b"].astype(jnp.float32)).astype(x.dtype)


def _mlp(p, x):
    h = (jnp.dot(x, p["fc1"]["w"], preferred_element_type=jnp.float32)
         + p["fc1"]["b"].astype(jnp.float32))
    h = jax.nn.gelu(h, approximate=True).astype(x.dtype)
    return (jnp.dot(h, p["fc2"]["w"], preferred_element_type=jnp.float32)
            + p["fc2"]["b"].astype(jnp.float32)).astype(x.dtype)


def vision_forward(params, pixels, cfg: SigLIPConfig):
    """pixels (B, H, W, 3) in [-1, 1] -> patch features (B, N, D)."""
    p = cfg.patch_size
    x = jax.lax.conv_general_dilated(
        pixels.astype(params["patch_embedding"]["w"].dtype),
        params["patch_embedding"]["w"],
        window_strides=(p, p), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    b, gh, gw, d = x.shape
    x = (x + params["patch_embedding"]["b"].astype(jnp.float32))
    x = x.reshape(b, gh * gw, d).astype(params["patch_embedding"]["w"].dtype)
    x = x + params["position_embedding"]["w"][None]

    def body(h, lp):
        h = h + _attention(lp, _layer_norm(lp["layer_norm1"], h,
                                           cfg.layer_norm_eps),
                           cfg.num_heads)
        h = h + _mlp(lp, _layer_norm(lp["layer_norm2"], h,
                                     cfg.layer_norm_eps))
        return h, None

    x, _ = jax.lax.scan(body, x, params["layers"])
    return _layer_norm(params["post_layernorm"], x, cfg.layer_norm_eps)


def project_to_soft_tokens(params, features, cfg: SigLIPConfig):
    """(B, N, D) patch features -> (B, mm_tokens, text_hidden) soft tokens.

    Gemma3MultiModalProjector: 4x4 average pool over the patch grid ->
    Gemma RMSNorm (1 + w convention) -> 1152x3840 projection.
    """
    b, n, d = features.shape
    side = cfg.patches_per_side
    k = cfg.pool_kernel
    grid = features.reshape(b, side, side, d).astype(jnp.float32)
    pooled = grid.reshape(b, side // k, k, side // k, k, d).mean(axis=(2, 4))
    pooled = pooled.reshape(b, -1, d)

    w = params["projector"]["mm_soft_emb_norm"]["w"].astype(jnp.float32)
    inv = jax.lax.rsqrt(jnp.mean(pooled * pooled, -1, keepdims=True)
                        + cfg.rms_norm_eps)
    normed = pooled * inv * (1.0 + w)
    proj = params["projector"]["mm_input_projection"]["w"]
    return jnp.dot(normed, proj.astype(jnp.float32),
                   preferred_element_type=jnp.float32)


def preprocess_image(path: str, cfg: SigLIPConfig) -> np.ndarray:
    """Image file -> (1, S, S, 3) float32 in [-1, 1] (SigLIP: bilinear
    resize to image_size, rescale 1/255, normalize mean/std 0.5)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize(
        (cfg.image_size, cfg.image_size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return ((arr - 0.5) / 0.5)[None]


def embed_image_for_gemma(params, image_path: str,
                          cfg: Optional[SigLIPConfig] = None):
    """Image file -> (1, mm_tokens, text_hidden) soft tokens for splicing
    into the Gemma prompt (NOT sqrt(d)-scaled; HF masked-scatter semantics).
    """
    cfg = cfg or SigLIPConfig()
    pixels = jnp.asarray(preprocess_image(image_path, cfg))
    feats = vision_forward(params, pixels, cfg)
    return project_to_soft_tokens(params, feats, cfg)


# ---------------------------------------------------------------------------
# Weight loading (HF / MLX gemma-3 VLM checkpoint)
# ---------------------------------------------------------------------------

_VT = "vision_tower.vision_model."


def load_vision_params(tensors: dict, cfg: Optional[SigLIPConfig] = None):
    """Map vision_tower.* / multi_modal_projector.* tensors to the pytree.

    Returns None when the checkpoint has no vision tower (text-only export).
    Handles MLX 4-bit quantized leaves ({k}.scales/.biases) by dequantizing.
    """
    if not any(k.startswith("vision_tower.") for k in tensors):
        return None
    cfg = cfg or SigLIPConfig()
    from ltx_jax.weights.keymaps import _bf16, _maybe_dequant_mlx_4bit

    def get(k):
        full = _VT + k
        base = full[: -len(".weight")] if full.endswith(".weight") else full
        if base + ".scales" in tensors:
            return _maybe_dequant_mlx_4bit(tensors, base)
        return tensors[full]

    def dense(prefix):
        return {"w": _bf16(np.asarray(get(prefix + ".weight")).T),
                "b": _bf16(get(prefix + ".bias"))}

    def ln(prefix):
        return {"w": _bf16(get(prefix + ".weight")),
                "b": _bf16(get(prefix + ".bias"))}

    layers = []
    for i in range(cfg.num_layers):
        lp = f"encoder.layers.{i}."
        layers.append({
            "layer_norm1": ln(lp + "layer_norm1"),
            "q_proj": dense(lp + "self_attn.q_proj"),
            "k_proj": dense(lp + "self_attn.k_proj"),
            "v_proj": dense(lp + "self_attn.v_proj"),
            "out_proj": dense(lp + "self_attn.out_proj"),
            "layer_norm2": ln(lp + "layer_norm2"),
            "fc1": dense(lp + "mlp.fc1"),
            "fc2": dense(lp + "mlp.fc2"),
        })

    pe = np.asarray(get("embeddings.patch_embedding.weight"))
    # HF conv weight (O, I, kh, kw) -> HWIO; MLX export may already be
    # (O, kh, kw, I)
    if pe.shape[1] == 3:
        pe = pe.transpose(2, 3, 1, 0)
    else:
        pe = pe.transpose(1, 2, 3, 0)

    proj_w = np.asarray(tensors["multi_modal_projector."
                                "mm_input_projection_weight"])
    if proj_w.shape[0] != cfg.hidden_size:
        proj_w = proj_w.T

    return {
        "patch_embedding": {
            "w": _bf16(pe),
            "b": _bf16(get("embeddings.patch_embedding.bias")),
        },
        "position_embedding": {
            "w": _bf16(get("embeddings.position_embedding.weight"))
        },
        "layers": jax.tree.map(lambda *xs: jnp.stack(xs), *layers),
        "post_layernorm": ln("post_layernorm"),
        "projector": {
            "mm_soft_emb_norm": {
                "w": _bf16(tensors["multi_modal_projector."
                                   "mm_soft_emb_norm.weight"])
            },
            "mm_input_projection": {"w": _bf16(proj_w)},
        },
    }
