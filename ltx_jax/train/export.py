"""Export trained LoRA adapters to the interchange safetensors format.

Closes the training loop: adapters trained by ltx_jax.train (side-path
{lora_a, lora_b, lora_s} leaves) serialize to the SAME ComfyUI-style
key schema the inference fusion path parses (`lora/fuse.py::parse_lora` /
`map_lora_key`, transcribed from LoRALoader.swift:64-112, 209-243) — i.e.
an exported file round-trips through `fuse_lora_file` onto a base model,
and is consumable by any loader of that ecosystem format:

    diffusion_model.transformer_blocks.{i}.attn1.to_q.lora_down.weight  (r, in)
    diffusion_model.transformer_blocks.{i}.attn1.to_q.lora_up.weight    (out, r)
    diffusion_model.transformer_blocks.{i}.attn1.to_q.alpha             ()

Tensors are torch-layout ((rank, in) / (out, rank) — our (in, rank) /
(rank, out) leaves transpose), alpha = lora_s * rank so the importer's
alpha/rank scaling reproduces lora_s exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# pytree path inside a stacked block -> exported ComfyUI key suffix
# (inverse of lora/fuse.py::map_lora_key + _BLOCK_PATHS)
_EXPORT_SUFFIX = {
    ("attn1", "to_q"): "attn1.to_q",
    ("attn1", "to_k"): "attn1.to_k",
    ("attn1", "to_v"): "attn1.to_v",
    ("attn1", "to_out"): "attn1.to_out.0",
    ("attn2", "to_q"): "attn2.to_q",
    ("attn2", "to_k"): "attn2.to_k",
    ("attn2", "to_v"): "attn2.to_v",
    ("attn2", "to_out"): "attn2.to_out.0",
    ("ff", "project_in"): "ff.net.0.proj",
    ("ff", "project_out"): "ff.net.2",
}

_PREFIX = "diffusion_model.transformer_blocks"


def lora_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """{export key: tensor} for every LoRA leaf under params["blocks"].

    Stacked leaves (L, in, r)/(L, r, out) unstack into per-block entries.
    """
    out: Dict[str, np.ndarray] = {}

    def emit(suffix: str, i: int, leaf: dict):
        a = np.asarray(leaf["lora_a"][i], np.float32)  # (in, r)
        b = np.asarray(leaf["lora_b"][i], np.float32)  # (r, out)
        s = float(np.asarray(leaf["lora_s"][i]))
        rank = a.shape[-1]
        key = f"{_PREFIX}.{i}.{suffix}"
        out[key + ".lora_down.weight"] = np.ascontiguousarray(a.T)  # (r, in)
        out[key + ".lora_up.weight"] = np.ascontiguousarray(b.T)    # (out, r)
        # 0-d ndarray, not a numpy scalar — safetensors needs .ctypes
        out[key + ".alpha"] = np.asarray(s * rank, np.float32)

    def walk(tree: dict, path: tuple):
        for k, v in tree.items():
            if not isinstance(v, dict):
                continue
            if "lora_a" in v:
                suffix = _EXPORT_SUFFIX.get(path + (k,))
                if suffix is None:
                    raise ValueError(
                        f"no export key mapping for LoRA leaf at "
                        f"{'.'.join(path + (k,))} — extend _EXPORT_SUFFIX")
                n_layers = v["lora_a"].shape[0]
                for i in range(n_layers):
                    emit(suffix, i, v)
            else:
                walk(v, path + (k,))

    walk(params["blocks"], ())
    return out


def save_lora(params: dict, path) -> int:
    """Write the adapter to `path` (.safetensors). Returns tensor count."""
    from safetensors.numpy import save_file

    sd = lora_state_dict(params)
    save_file(sd, str(path))
    return len(sd)
