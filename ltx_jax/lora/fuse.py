"""LoRA: parse, key-map, and fuse into the stacked DiT pytree.

Reference behavior: Sources/LTXVideo/LoRA/{LoRALoader,LoRAAdapter}.swift.
  * pairs: `lora_down/lora_up` (ComfyUI) or `lora_A/lora_B` (Diffusers/PEFT),
    optional per-layer `.alpha`;
  * delta = scale * (alpha/rank) * (up @ down) in torch (out, in) layout
    (LoRALoader.swift:162-178);
  * fusion is a permanent weight merge W' = W + delta; the quantized path is
    dequantize -> merge -> requantize (LoRAAdapter.swift:104-133).

Functional twist: our DiT stacks all blocks along a leading axis, so fusion
scatters each per-block delta into the (L, in, out) leaf with `.at[i].add`.
Unfusing = keep the pre-fusion pytree (params are immutable values here, so
the reference's save-originals dance is free).
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ltx_jax.kernels.quantization import (
    dequantize_weight,
    is_quantized,
    quantize_weight,
)

log = logging.getLogger("ltx_jax")


@dataclasses.dataclass(frozen=True)
class LoRALayer:
    original_key: str  # canonical model key, e.g. transformer_blocks.0.attn1.to_q
    down: np.ndarray   # (rank, in)
    up: np.ndarray     # (out, rank)
    alpha: Optional[float]

    @property
    def rank(self) -> int:
        return self.down.shape[0]

    @property
    def effective_scale(self) -> float:
        return (self.alpha / self.rank) if self.alpha is not None else 1.0

    def delta(self, scale: float = 1.0) -> np.ndarray:
        """(out, in) torch-layout delta (reference: LoRALoader.swift:162-178)."""
        d = (self.up.astype(np.float32) @ self.down.astype(np.float32))
        return d * (scale * self.effective_scale)


def map_lora_key(key: str) -> str:
    """LoRA originalKey -> canonical transformer key
    (reference: LoRALoader.swift:209-243, WITHOUT the .weight suffix —
    our pytree paths don't use it)."""
    k = key
    if k.startswith("diffusion_model."):
        k = k[len("diffusion_model."):]
    k = k.replace(".emb.timestep_embedder.", ".emb.")
    k = k.replace(".to_out.0", ".to_out")
    k = k.replace(".ff.net.0.proj", ".ff.project_in.proj")
    k = k.replace(".ff.net.2", ".ff.project_out")
    return k


def parse_lora(tensors: Dict[str, np.ndarray]) -> List[LoRALayer]:
    """Find down/up pairs + alphas (reference: LoRALoader.swift:64-112)."""
    layers = []
    for key in list(tensors):
        if "lora_down" in key:
            up_key = key.replace("lora_down", "lora_up")
            original = key.replace(".lora_down.weight", "").replace(
                ".lora_down", "")
        elif "lora_A" in key:
            up_key = key.replace("lora_A", "lora_B")
            original = key.replace(".lora_A.weight", "").replace(".lora_A", "")
        else:
            continue
        if up_key not in tensors:
            continue
        alpha_t = tensors.get(original + ".alpha")
        alpha = float(np.asarray(alpha_t).reshape(())) if alpha_t is not None \
            else None
        layers.append(LoRALayer(
            original_key=map_lora_key(original),
            down=np.asarray(tensors[key]),
            up=np.asarray(tensors[up_key]),
            alpha=alpha,
        ))
    return layers


_BLOCK_KEY = re.compile(r"^transformer_blocks\.(\d+)\.(.+)$")

# canonical suffix -> path inside a stacked block
_BLOCK_PATHS = {
    "attn1.to_q": ("attn1", "to_q"),
    "attn1.to_k": ("attn1", "to_k"),
    "attn1.to_v": ("attn1", "to_v"),
    "attn1.to_out": ("attn1", "to_out"),
    "attn2.to_q": ("attn2", "to_q"),
    "attn2.to_k": ("attn2", "to_k"),
    "attn2.to_v": ("attn2", "to_v"),
    "attn2.to_out": ("attn2", "to_out"),
    "ff.project_in.proj": ("ff", "project_in"),
    "ff.project_out": ("ff", "project_out"),
}

_TOP_PATHS = {
    "proj_in": ("patchify_proj",),
    "patchify_proj": ("patchify_proj",),
    "proj_out": ("proj_out",),
    "caption_projection.linear_1": ("caption_projection", "linear_1"),
    "caption_projection.linear_2": ("caption_projection", "linear_2"),
    "adaln_single.emb.linear_1": ("adaln_single", "emb", "linear_1"),
    "adaln_single.emb.linear_2": ("adaln_single", "emb", "linear_2"),
    "adaln_single.linear": ("adaln_single", "linear"),
    "time_embed.emb.linear_1": ("adaln_single", "emb", "linear_1"),
    "time_embed.emb.linear_2": ("adaln_single", "emb", "linear_2"),
    "time_embed.linear": ("adaln_single", "linear"),
}


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def _merge_leaf(leaf, layer_index: Optional[int], delta_t):
    """Add a (in, out) delta to a plain or quantized linear leaf.

    Device (jax) leaves update functionally via `.at[i].set`. HOST (numpy)
    leaves — how the weight loaders now deliver params — update IN PLACE:
    fuse_lora hands this function a private copy-on-write leaf, so the
    caller's tree is never mutated and the 19B host tree is never deep-
    copied wholesale.
    """
    from ltx_jax.kernels.quantization import (
        _quantize_weight_np,
        dequantize_weight_np,
    )

    if is_quantized(leaf):
        # dequant -> merge -> requant (reference: LoRAAdapter.swift:104-133)
        bits = 8 if "w_q" in leaf else 4
        qkey = "w_q" if bits == 8 else "w_q4"
        host = isinstance(leaf[qkey], np.ndarray)
        if layer_index is None:
            sl = {k: leaf[k] for k in leaf if k in ("w_q", "w_q4", "scale",
                                                    "bias")}
            group = leaf["scale"].shape[0]
            if host:
                w = dequantize_weight_np(sl) + np.asarray(delta_t, np.float32)
                new = _quantize_weight_np(w, bits, w.shape[0] // group)
            else:
                w = dequantize_weight(sl, jnp.float32) + delta_t
                new = quantize_weight(w, bits, w.shape[0] // group)
            out = dict(leaf)
            out.update(new)
            return out
        sl = {k: leaf[k][layer_index] for k in ("scale", "bias")}
        sl[qkey] = leaf[qkey][layer_index]
        group_count = leaf["scale"].shape[1]
        if host:
            w = dequantize_weight_np(sl) + np.asarray(delta_t, np.float32)
            new = _quantize_weight_np(w, bits, w.shape[0] // group_count)
            for k, v in new.items():
                leaf[k][layer_index] = v
            return leaf
        w = dequantize_weight(sl, jnp.float32) + delta_t
        new = quantize_weight(w, bits, w.shape[0] // group_count)
        out = dict(leaf)
        for k, v in new.items():
            out[k] = out[k].at[layer_index].set(v)
        return out

    w = leaf["w"]
    if isinstance(w, np.ndarray):
        delta = np.asarray(delta_t, np.float32)
        if layer_index is None:
            merged = w.astype(np.float32) + delta
            return {**leaf, "w": merged.astype(w.dtype)}
        w[layer_index] = (w[layer_index].astype(np.float32)
                          + delta).astype(w.dtype)
        return leaf
    if layer_index is None:
        merged = w.astype(jnp.float32) + delta_t
        return {**leaf, "w": merged.astype(w.dtype)}
    merged = w[layer_index].astype(jnp.float32) + delta_t
    return {**leaf, "w": w.at[layer_index].set(merged.astype(w.dtype))}


def _copy_structure(tree):
    """Copy nested dicts; alias leaves (copy-on-write happens per leaf)."""
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    return tree


def fuse_lora(params: dict, layers: List[LoRALayer], scale: float = 1.0,
              num_layers: Optional[int] = None) -> dict:
    """Permanently merge LoRA deltas into a DiT pytree; returns NEW params.

    The reference batches updates per transformer block to bound peak memory
    (LoRAAdapter.swift:64-166); here device leaves update functionally
    (`.at[i].set`, XLA fuses the scatter) and host leaves copy-on-write once
    per touched leaf — a full deep copy of a real 19B host tree would burn
    ~38 GB of host RAM for nothing.
    """
    out = _copy_structure(params)
    materialized = set()

    def leaf_for(path):
        leaf = _get(out, path)
        if path not in materialized:
            leaf = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                    for k, v in leaf.items()}
            _set(out, path, leaf)
            materialized.add(path)
        return leaf

    fused = skipped = 0
    for layer in layers:
        delta_t = layer.delta(scale).T  # -> (in, out), host
        m = _BLOCK_KEY.match(layer.original_key)
        try:
            if m:
                idx = int(m.group(1))
                path = ("blocks",) + _BLOCK_PATHS[m.group(2)]
                _set(out, path, _merge_leaf(leaf_for(path), idx, delta_t))
            else:
                path = _TOP_PATHS[layer.original_key]
                _set(out, path, _merge_leaf(leaf_for(path), None, delta_t))
            fused += 1
        except KeyError:
            skipped += 1
            log.debug("LoRA fuse: no model weight for %s", layer.original_key)
    log.info("LoRA: fused %d layers (%d skipped)", fused, skipped)
    return out


def fuse_multi_lora(params: dict, loras: List[Tuple[List[LoRALayer], float]]):
    """Additive multi-LoRA (reference: LoRAAdapter.swift:303-353)."""
    for layers, scale in loras:
        params = fuse_lora(params, layers, scale)
    return params


def fuse_lora_file(params: dict, path, scale: float = 1.0,
                   num_layers: Optional[int] = None) -> dict:
    from ltx_jax.weights.download import load_safetensors

    tensors = load_safetensors(path)
    return fuse_lora(params, parse_lora(tensors), scale, num_layers)


@dataclasses.dataclass(frozen=True)
class LoRASchedulerOverrides:
    """Scheduler overrides for specialized (Turbo-style) LoRAs
    (reference: LoRAConfig.swift:43-62 — declared there but never populated;
    here `apply_to` actually wires them into a GenerationConfig)."""

    num_steps: Optional[int] = None
    guidance_scale: Optional[float] = None
    sigmas: Optional[Tuple[float, ...]] = None

    def apply_to(self, config):
        """GenerationConfig -> GenerationConfig with overrides applied."""
        updates = {}
        if self.num_steps is not None:
            updates["num_steps"] = self.num_steps
        if self.guidance_scale is not None:
            updates["cfg_scale"] = self.guidance_scale
        if self.sigmas is not None:
            updates["sigmas_override"] = tuple(float(s) for s in self.sigmas)
        return dataclasses.replace(config, **updates) if updates else config


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """One LoRA to load (reference: LoRAConfig.swift:9-38)."""

    weights_path: str
    scale: float = 1.0
    fused: bool = True   # only fused inference exists (like the reference)
    name: Optional[str] = None
    scheduler_overrides: Optional[LoRASchedulerOverrides] = None


@dataclasses.dataclass(frozen=True)
class LoRAInfo:
    """Metadata about a loaded LoRA (reference: LoRAConfig.swift:95-116)."""

    name: str
    path: str
    layer_count: int
    rank: int
    target_modules: Tuple[str, ...]
    has_scheduler_overrides: bool
    file_size_bytes: Optional[int]


def lora_info(path, name: Optional[str] = None,
              scheduler_overrides=None) -> LoRAInfo:
    """Inspect a LoRA safetensors file without fusing it."""
    import os

    from ltx_jax.weights.download import load_safetensors

    layers = parse_lora(load_safetensors(path))
    modules = sorted({layer.original_key.rsplit(".", 1)[-1]
                      for layer in layers})
    return LoRAInfo(
        name=name or os.path.basename(str(path)),
        path=str(path),
        layer_count=len(layers),
        rank=max((l.rank for l in layers), default=0),
        target_modules=tuple(modules),
        has_scheduler_overrides=scheduler_overrides is not None,
        file_size_bytes=(os.path.getsize(path)
                         if os.path.exists(str(path)) else None),
    )


def fuse_lora_configs(params: dict, configs, num_layers=None) -> dict:
    """Fuse a sequence of LoRAConfig (multi-LoRA, reference:
    LoRAAdapter.swift:186-259) in order."""
    for cfg in configs:
        log.info("Fusing LoRA %s (scale %.2f)", cfg.name or cfg.weights_path,
                 cfg.scale)
        params = fuse_lora_file(params, cfg.weights_path, cfg.scale,
                                num_layers)
    return params
