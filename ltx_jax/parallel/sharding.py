"""Mesh + tensor-parallel sharding for every transformer in the pipeline.

The reference has NO parallelism of any kind (SURVEY.md §2.9); this module is
new capability, not a port. Strategy:

* 2D mesh ("data", "model"). Guidance branches / batch ride the data axis;
  attention heads and the FFN hidden dim shard over the model axis (classic
  megatron-style TP, expressed as NamedSharding on the stacked block params —
  XLA GSPMD inserts the all-reduces after to_out / project_out / o_proj).
* One generic spec walker covers the video DiT, the dual AV transformer and
  Gemma, in both bf16 ({"w","b"}) and quantized ({"w_q"|"w_q4","scale",
  "bias","b"}) forms: column-parallel leaves shard every array's LAST axis
  (output dim); row-parallel leaves shard the axis BEFORE it (input dim —
  w_q4's packed rows and the per-group scale/bias rows all follow the input
  dim, and PACK_BLOCK=256 planes stay shard-aligned for all real dims).
* The flat-tensor QK RMSNorm reduces over the full 4096 dim; with Q sharded
  by heads GSPMD turns the mean into a small all-reduce — semantics
  preserved. Gemma's per-head-dim q_norm/k_norm (256,) stays replicated.
* The dual AV transformer's 19B bf16 weights (~38 GB) fit one 80 GB card
  with the rest of the pipeline only barely; TP splits them across cards.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# Leaf-dict names by parallelism style. Covers models/dit.py,
# models/dit_av.py and models/gemma3.py layer pytrees.
COLUMN_PARALLEL = frozenset({
    "to_q", "to_k", "to_v", "project_in",
    "q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
})
ROW_PARALLEL = frozenset({
    "to_out", "project_out", "o_proj", "down_proj",
})
_WEIGHT_KEYS = ("w", "w_q", "w_q4", "w8", "scale", "bias")


def make_mesh(data: int = 1, model: Optional[int] = None,
              devices=None) -> Mesh:
    """Create a (data, model) mesh. Default: all devices on the model axis."""
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if model is None:
        model = n // data
    need = data * model
    if need > n:
        from ltx_jax.core.errors import InvalidConfigurationError

        raise InvalidConfigurationError(
            f"mesh {data}x{model} needs {need} devices, have {n}")
    arr = np.asarray(devices[:need]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def _shard_axis(arr, axis_from_end: int):
    """P with "model" at rank-1-axis_from_end, None elsewhere."""
    rank = np.ndim(arr)
    axes = [None] * rank
    idx = rank - 1 - axis_from_end
    if idx < 0:
        return P()
    axes[idx] = "model"
    return P(*axes)


def _linear_leaf_specs(name: str, leaf: dict):
    """Specs for one (possibly quantized) linear leaf-dict.

    Trainable LoRA leaves (train/lora.py) follow the base weight's parallel
    style on their OUTER dims only: column-parallel shards lora_b's out dim
    (lora_a replicated — its tiny rank axis must not shard); row-parallel
    shards lora_a's in dim (matching the sharded activation).
    """
    out = {}
    if name in COLUMN_PARALLEL:
        for k, v in leaf.items():
            if k in ("lora_a", "lora_s"):
                out[k] = P()
            elif k == "lora_b":
                out[k] = _shard_axis(v, 0)  # out dim, like "w"
            else:
                # output dim is the LAST axis of every array incl. "b"
                out[k] = _shard_axis(v, 0)
    else:  # row parallel
        for k, v in leaf.items():
            if k in ("lora_b", "lora_s"):
                out[k] = P()
            elif k == "lora_a":
                out[k] = _shard_axis(v, 1)  # in dim, like "w"
            elif k in ("b", "sw"):
                # bias adds after the all-reduce; the W8A8 per-output-
                # channel scale follows the (unsharded) output dim — the
                # second-to-last rule would wrongly shard its leading
                # LAYER axis on stacked (L, N) leaves
                out[k] = P()
            else:
                # input dim: second-to-last axis (w, w_q, w_q4 packed rows,
                # per-group scale/bias all follow the input dim)
                out[k] = _shard_axis(v, 1)
    return out


def transformer_param_specs(params) -> dict:
    """PartitionSpec pytree for any stacked-block transformer pytree.

    Rules: linear leaves in COLUMN_PARALLEL / ROW_PARALLEL shard over
    "model"; q_norm/k_norm shard IF they span the flat attention inner dim
    (DiT convention: norm before head split) and replicate if per-head-dim
    (Gemma convention); everything else (tables, norms, embeddings, small
    heads) replicates.
    """

    def walk(tree, attn_out_dim=None):
        specs = {}
        # detect attention scope: to_q/q_proj present => flat dim known
        local_attn_dim = attn_out_dim
        for probe in ("to_q", "q_proj"):
            if probe in tree and isinstance(tree[probe], dict):
                wk = next(k for k in _WEIGHT_KEYS if k in tree[probe])
                local_attn_dim = tree[probe][wk].shape[-1]
        for k, v in tree.items():
            if not isinstance(v, dict):
                specs[k] = P()
            elif k in COLUMN_PARALLEL or k in ROW_PARALLEL:
                specs[k] = _linear_leaf_specs(k, v)
            elif k in ("q_norm", "k_norm") and "w" in v:
                if (local_attn_dim is not None
                        and v["w"].shape[-1] == local_attn_dim):
                    specs[k] = {"w": _shard_axis(v["w"], 0)}
                else:
                    specs[k] = {"w": P()}  # per-head-dim (Gemma)
            else:
                specs[k] = walk(v, local_attn_dim)
        return specs

    return walk(params)


def dit_param_specs(params) -> dict:
    """Spec tree for the video DiT (round-1 name, now the generic walker —
    handles bf16 and quantized leaves)."""
    return transformer_param_specs(params)


def shard_transformer_params(params, mesh: Mesh):
    """Place any transformer pytree on the mesh with TP sharding."""
    specs = transformer_param_specs(params)
    return jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs
    )


# Round-1 name
shard_dit_params = shard_transformer_params


def gemma_param_specs(params) -> dict:
    """Gemma spec tree: layer leaves via the generic walker PLUS the
    embedding table sharded over the VOCAB axis.

    Decode is bound by reading the weights: every token streams the full
    weight set once, so TP's speedup is the split of those reads. The
    embedding/lm_head table is ~2 GB bf16 (262k x 3840) — replicating it
    would leave the largest single tensor unsplit. Vocab-sharding splits
    both the tied lm_head matmul (output logits sharded, gathered once for
    the top-k) and the table residency; the embed gather becomes a
    GSPMD-partitioned gather. Leaves: {"w"} bf16 or {"w8r","sr"} int8 —
    all shard axis 0 (vocab).
    """
    specs = transformer_param_specs(params)
    emb = params.get("embed_tokens")
    if isinstance(emb, dict):
        specs["embed_tokens"] = {
            k: P(*(["model"] + [None] * (np.ndim(v) - 1)))
            for k, v in emb.items()
        }
    return specs


def shard_gemma_params(params, mesh: Mesh):
    """Place a Gemma pytree on the mesh: megatron TP over layers + vocab-
    sharded embeddings (see gemma_param_specs)."""
    specs = gemma_param_specs(params)
    return jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs
    )


def replicate(tree, mesh: Mesh):
    return jax.tree.map(
        lambda p: jax.device_put(p, NamedSharding(mesh, P())), tree
    )


def data_sharding(mesh: Mesh):
    """Sharding for (G, ...) guidance-batched activations: G on data axis."""
    return NamedSharding(mesh, P("data"))
