"""TP-sharded Gemma DECODE loop (VERDICT r3 next #1).

The decode is bound by weight reads, so TP splits the per-token reads over
the mesh. These tests pin the correctness of that on the virtual CPU mesh: the TP-sharded
generation program (prefill + while_loop, KV cache constrained to the
kv-head axis) is token-identical to the single-device loop under greedy
sampling, for the plain, batched, speculative and W8A8-quantized paths.

Reference: Gemma3Model.swift:376-513 (strictly single-device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.models import gemma3
from ltx_jax.parallel.sharding import (
    gemma_param_specs, make_mesh, shard_gemma_params,
)

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >=2 devices")


@pytest.fixture(scope="module")
def gcfg():
    return gemma3.Gemma3Config().tiny()


@pytest.fixture(scope="module")
def params(gcfg):
    # f32: TP all-reduce reorder must not flip greedy argmaxes
    return gemma3.init_params(jax.random.key(11), gcfg, jnp.float32)


def _prompt(n=12):
    # repeated trigram so prompt-lookup speculation actually drafts
    base = [5, 9, 13, 5, 9, 13, 21, 7]
    return np.asarray((base * 4)[:n], np.int32)


def test_gemma_embed_specs_vocab_sharded(params):
    specs = gemma_param_specs(params)
    assert specs["embed_tokens"]["w"][0] == "model"
    # layer leaves still follow the generic walker
    assert specs["layers"]["q_proj"]["w"][-1] == "model"


@needs_mesh
def test_tp_greedy_decode_token_identical(gcfg, params):
    base = gemma3.generate_tokens(
        params, _prompt(), gcfg, jax.random.key(0), max_new_tokens=16,
        temperature=0.0, stop_tokens=())
    mesh = make_mesh(data=1, model=2)  # tiny kv_heads=2 -> model<=2
    sharded = shard_gemma_params(params, mesh)
    out = gemma3.generate_tokens(
        sharded, _prompt(), gcfg, jax.random.key(0), max_new_tokens=16,
        temperature=0.0, stop_tokens=(), mesh=mesh)
    assert out == base
    assert len(out) == 16


@needs_mesh
def test_tp_spec_decode_greedy_token_identical(gcfg, params):
    """Speculative TP decode: per-row cache bases + the KV constraint must
    compose; greedy output stays identical to the sequential single-device
    loop (speculation is exact at temperature<=0)."""
    base = gemma3.generate_tokens(
        params, _prompt(), gcfg, jax.random.key(0), max_new_tokens=16,
        temperature=0.0, stop_tokens=())
    mesh = make_mesh(data=1, model=2)
    sharded = shard_gemma_params(params, mesh)
    out = gemma3.generate_tokens(
        sharded, _prompt(), gcfg, jax.random.key(0), max_new_tokens=16,
        temperature=0.0, stop_tokens=(), spec_k=4, mesh=mesh)
    assert out == base


@needs_mesh
def test_tp_batched_greedy_rows_match_sequential(gcfg, params):
    prompts = [_prompt(10), _prompt(12)[::-1].copy(), _prompt(8)]
    seq = [gemma3.generate_tokens(
        params, p, gcfg, jax.random.key(0), max_new_tokens=12,
        temperature=0.0, stop_tokens=()) for p in prompts]
    mesh = make_mesh(data=1, model=2)
    sharded = shard_gemma_params(params, mesh)
    out = gemma3.generate_tokens_batched(
        sharded, prompts, gcfg, jax.random.key(0), max_new_tokens=12,
        temperature=0.0, stop_tokens=(), mesh=mesh)
    assert out == seq


@needs_mesh
def test_tp_w8a8_greedy_decode_token_identical(gcfg, params):
    """The serving-default W8A8 base: int8 leaves shard like any linear
    (w8 column/row, sw with the output dim) and the s8 x s8 dot is
    GSPMD-partitionable — the whole decode program runs TP."""
    from ltx_jax.kernels.quantization import requant_int8_channel_np

    ql = dict(params["layers"])
    for nm in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj"):
        w = np.asarray(params["layers"][nm]["w"], np.float32)
        per = [requant_int8_channel_np(w[i])
               for i in range(gcfg.hidden_layers)]
        ql[nm] = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *per)
    p8 = {**params, "layers": ql}

    base = gemma3.generate_tokens(
        p8, _prompt(), gcfg, jax.random.key(0), max_new_tokens=12,
        temperature=0.0, stop_tokens=())
    mesh = make_mesh(data=1, model=2)
    sharded = shard_gemma_params(p8, mesh)
    out = gemma3.generate_tokens(
        sharded, _prompt(), gcfg, jax.random.key(0), max_new_tokens=12,
        temperature=0.0, stop_tokens=(), mesh=mesh)
    assert out == base


@needs_mesh
def test_pipeline_enhance_runs_tp_on_sharded_pipe():
    """Integration: a shard()ed pipeline routes enhancement through the
    TP decode (enhance_prompt(mesh=...)) — the full generate_video path
    with enhancement on, under the virtual mesh."""
    import dataclasses
    import types

    from ltx_jax.core.config import GenerationConfig
    from ltx_jax.pipeline.generate import LTXPipeline

    class Tok:
        def encode(self, text):
            ids = [(b % 90) + 4 for b in text.encode()][:48]
            return types.SimpleNamespace(ids=ids or [4])

        def decode(self, ids):
            return "an enhanced prompt"

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.memory = dataclasses.replace(pipe.memory,
                                      offload_text_encoder=False)
    pipe.tokenizer = Tok()
    pipe.shard(make_mesh(data=2, model=2))
    r = pipe.generate_video(
        "a cat", GenerationConfig(width=64, height=64, num_frames=9,
                                  num_steps=2, seed=5,
                                  enhance_prompt=True))
    f = np.asarray(r.frames)
    assert f.shape == (9, 64, 64, 3) and np.isfinite(f).all()
    assert r.timings.enhancement > 0
