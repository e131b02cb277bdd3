"""Static bf16-TP fit proof: the REAL 19B configs sharded over a 1x4 mesh
fit a stated per-card budget on 4 x H100 (80 GB each).

The budget is the share of an 80 GB card a JAX process gets by default
(XLA_PYTHON_CLIENT_MEM_FRACTION=0.75): 60 GB. Param shapes come from
jax.eval_shape over the real init_params (no materialization), per-card
bytes from the exact transformer_param_specs sharding rules, activations
from a TP-aware estimate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.models import dit, dit_av, gemma3
from ltx_jax.parallel.sharding import transformer_param_specs

N_CHIPS = 4
CARD_BUDGET_GB = 80 * 0.75  # H100 80 GB at JAX's default memory fraction


def _per_chip_gb(shapes_tree, specs_tree, n_model: int) -> tuple:
    """(per_chip_gb, replicated_gb, sharded_gb): bytes per device when every
    spec axis named 'model' divides by n_model."""
    shapes = jax.tree.leaves(shapes_tree)
    specs = jax.tree.leaves(
        specs_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(shapes) == len(specs)
    per_chip = repl = shard = 0
    for leaf, spec in zip(shapes, specs):
        nbytes = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        div = 1
        for axis, name in zip(leaf.shape, tuple(spec) + (None,) * 8):
            if name == "model":
                assert axis % n_model == 0, (leaf.shape, spec)
                div = n_model
        per_chip += nbytes // div
        if div == 1:
            repl += nbytes
        else:
            shard += nbytes
    return per_chip / 1e9, repl / 1e9, shard / 1e9


def _activation_gb(tokens: int, rows: int, cfg: TransformerConfig,
                   n_model: int) -> float:
    """TP-aware activation envelope for one denoise step: attention-width
    activations replicate across the model axis (a handful of live f32
    copies under XLA fusion + flash attention); FFN-hidden activations
    shard over the model axis (column-parallel project_in)."""
    inner_term = rows * tokens * cfg.inner_dim * 4 * 4
    ffn_term = rows * tokens * (cfg.ffn_dim // n_model) * 4 * 2
    return (inner_term + ffn_term) / 1e9


def _flagship_tokens() -> int:
    # stage-2 241f @ 1216x704: (241//8+1) * (704/32) * (1216/32) tokens
    return 31 * 22 * 38


def test_video_dit_bf16_tp_fits_4xh100(capsys):
    cfg = TransformerConfig()
    shapes = jax.eval_shape(
        lambda k: dit.init_params(k, cfg, jnp.bfloat16), jax.random.key(0))
    specs = transformer_param_specs(shapes)
    per_chip, repl, shard = _per_chip_gb(shapes, specs, N_CHIPS)
    act = _activation_gb(_flagship_tokens(), rows=3, cfg=cfg,
                         n_model=N_CHIPS)
    total = per_chip + act
    print(f"[TP-fit] video DiT bf16 1x{N_CHIPS}: params/chip {per_chip:.2f} "
          f"GB (replicated {repl:.2f} + sharded {shard:.2f}/{N_CHIPS}), "
          f"act {act:.2f} GB, total {total:.2f} GB")
    assert total < CARD_BUDGET_GB


def test_av_dit_bf16_tp_fits_4xh100():
    cfg = TransformerConfig()
    shapes = jax.eval_shape(
        lambda k: dit_av.init_params(k, cfg, jnp.bfloat16), jax.random.key(0))
    specs = transformer_param_specs(shapes)
    per_chip, repl, shard = _per_chip_gb(shapes, specs, N_CHIPS)
    # AV adds the short audio stream (~1.5k tokens) — covered by the video
    # envelope's slack; count it explicitly anyway
    act = _activation_gb(_flagship_tokens(), 3, cfg, N_CHIPS) + \
        _activation_gb(1536, 3, dataclasses.replace(
            cfg, num_heads=cfg.audio_num_heads, head_dim=cfg.audio_head_dim),
            N_CHIPS)
    total = per_chip + act
    print(f"[TP-fit] AV DiT bf16 1x{N_CHIPS}: params/chip {per_chip:.2f} GB "
          f"(replicated {repl:.2f} + sharded {shard:.2f}/{N_CHIPS}), "
          f"act {act:.2f} GB, total {total:.2f} GB")
    assert total < CARD_BUDGET_GB


def test_gemma_bf16_tp_fits_4xh100():
    cfg = gemma3.Gemma3Config()
    shapes = jax.eval_shape(
        lambda k: gemma3.init_params(k, cfg, jnp.bfloat16), jax.random.key(0))
    specs = transformer_param_specs(shapes)
    per_chip, repl, shard = _per_chip_gb(shapes, specs, N_CHIPS)
    # generation working set: 1k-token prefill + KV cache for 1536 tokens
    kv = (2 * cfg.hidden_layers * cfg.kv_heads * cfg.head_dim * 1536 * 2
          ) / 1e9
    act = 1024 * cfg.hidden_size * 4 * 6 / 1e9
    total = per_chip + kv + act
    print(f"[TP-fit] Gemma-12B bf16 1x{N_CHIPS}: params/chip {per_chip:.2f} "
          f"GB (replicated {repl:.2f} incl. 2.0 GB embeddings + sharded "
          f"{shard:.2f}/{N_CHIPS}), kv {kv:.2f} GB, act {act:.2f} GB, "
          f"total {total:.2f} GB")
    assert total < CARD_BUDGET_GB


def test_staged_pipeline_phases_all_fit():
    """With the default text-encoder offload only one big model is resident
    per phase; every phase fits independently (the three tests above).
    Co-residency (offload_text_encoder=False) fits too on 4 cards, at the
    north-star shape (25f@768x512, 1536 tokens) AND at the flagship
    stage-2 shape, so the offload is not what makes a 4-card bf16 run
    fit; this test pins that."""
    cfg = TransformerConfig()
    av = jax.eval_shape(
        lambda k: dit_av.init_params(k, cfg, jnp.bfloat16), jax.random.key(0))
    gm = jax.eval_shape(
        lambda k: gemma3.init_params(k, gemma3.Gemma3Config(), jnp.bfloat16),
        jax.random.key(0))
    av_chip, _, _ = _per_chip_gb(av, transformer_param_specs(av), N_CHIPS)
    gm_chip, _, _ = _per_chip_gb(gm, transformer_param_specs(gm), N_CHIPS)

    north_star_tokens = 4 * 16 * 24   # 25f @ 768x512
    act_ns = _activation_gb(north_star_tokens, 3, cfg, N_CHIPS)
    both_ns = av_chip + gm_chip + act_ns
    act_fs = _activation_gb(_flagship_tokens(), 3, cfg, N_CHIPS)
    both_fs = av_chip + gm_chip + act_fs
    print(f"[TP-fit] co-resident AV DiT + Gemma bf16 1x{N_CHIPS}: "
          f"north-star {both_ns:.2f} GB, flagship {both_fs:.2f} GB "
          f"(budget {CARD_BUDGET_GB:.0f} GB per card)")
    assert both_ns < CARD_BUDGET_GB
    assert both_fs < CARD_BUDGET_GB
