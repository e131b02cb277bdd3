"""Phase staging: host-resident params placed per phase, released after.

A device whose memory cannot hold every phase's weights at once needs the
load path to keep params on host and the pipeline to place/release them
per phase (utils/staging.py,
MemoryConfig.phase_staging). The reference's analogue is whole-model
unloading between phases (LTXPipeline.swift:726-731, :988-999).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig, MemoryConfig
from ltx_jax.pipeline.generate import LTXPipeline
from ltx_jax.utils import staging


def _hostify(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _host_pipe(seed=0, **mem_kw):
    """random_tiny with every component converted to host numpy arrays,
    as the weights loaders now produce."""
    pipe = LTXPipeline.random_tiny(seed=seed)
    for name in ("transformer_params", "vae_decoder_params", "gemma_params",
                 "text_encoder_params", "vae_encoder_params",
                 "upscaler_params"):
        tree = getattr(pipe, name)
        if tree is not None:
            setattr(pipe, name, _hostify(tree))
    pipe.memory = dataclasses.replace(MemoryConfig(), **mem_kw)
    return pipe


def _cfg(**kw):
    defaults = dict(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    defaults.update(kw)
    return GenerationConfig(**defaults)


def test_staged_matches_device_resident():
    ref = LTXPipeline.random_tiny(seed=0)
    ref.memory = dataclasses.replace(ref.memory, offload_text_encoder=False)
    expected = ref.generate_video("a cat", _cfg())

    pipe = _host_pipe(seed=0, phase_staging=True)
    got = pipe.generate_video("a cat", _cfg())
    np.testing.assert_array_equal(np.asarray(expected.frames),
                                  np.asarray(got.frames))


def test_staging_releases_after_each_phase():
    pipe = _host_pipe(seed=0, phase_staging=True)
    pipe.generate_video("a cat", _cfg())
    # DiT device copy released before VAE decode; Gemma released after encode
    assert staging.is_host_tree(pipe.transformer_params)
    assert staging.is_host_tree(pipe.gemma_params)
    # host originals intact: a second generation works and matches
    r2 = pipe.generate_video("a cat", _cfg())
    r3 = pipe.generate_video("a cat", _cfg())
    np.testing.assert_array_equal(np.asarray(r2.frames), np.asarray(r3.frames))


def test_staged_encode_releases_gemma_before_connector():
    """encode_prompt under phase_staging stages the two halves: the Gemma
    tower runs alone, releases to host, and only then does the connector
    place — w8a8 Gemma (12.8 GB) + connector (~2.2 GB) never co-reside
    (generate.py::encode_prompt docstring)."""
    pipe = _host_pipe(seed=0, phase_staging=True)
    placed = []
    orig = LTXPipeline._on_device

    def spy(self, *names):
        placed.append(tuple(names))
        return orig(self, *names)

    pipe._on_device = spy.__get__(pipe)
    out = pipe.encode_prompt("a cat")
    assert np.isfinite(np.asarray(out["video"], np.float32)).all()
    assert ("gemma_params",) in placed
    assert ("text_encoder_params",) in placed
    gi = placed.index(("gemma_params",))
    ti = placed.index(("text_encoder_params",))
    assert gi < ti, placed
    # gemma was back on host by the time the connector placed
    assert staging.is_host_tree(pipe.gemma_params)
    # staged output == co-resident output
    ref = _host_pipe(seed=0, phase_staging=False)
    want = ref.encode_prompt("a cat")
    np.testing.assert_array_equal(np.asarray(out["video"]),
                                  np.asarray(want["video"]))


def test_non_staging_places_lazily_and_keeps_resident():
    pipe = _host_pipe(seed=0, phase_staging=False,
                      offload_text_encoder=False)
    pipe.generate_video("a cat", _cfg())
    assert not staging.is_host_tree(pipe.transformer_params)
    assert not staging.is_host_tree(pipe.gemma_params)


def test_two_stage_staged():
    pipe = _host_pipe(seed=0, phase_staging=True)
    got = pipe.generate_video_two_stage("a cat", _cfg(width=128, height=128))
    ref = LTXPipeline.random_tiny(seed=0)
    ref.memory = dataclasses.replace(ref.memory, offload_text_encoder=False)
    expected = ref.generate_video_two_stage("a cat",
                                            _cfg(width=128, height=128))
    np.testing.assert_array_equal(np.asarray(expected.frames),
                                  np.asarray(got.frames))
    assert staging.is_host_tree(pipe.transformer_params)


def test_host_quantization_matches_device():
    """quantize_transformer_params on a host tree == device tree (bitwise)."""
    from ltx_jax.kernels.quantization import quantize_transformer_params

    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 256, 256)).astype(np.float32)
    params = {"blocks": {"attn1": {"to_q": {"w": jnp.asarray(w),
                                            "b": jnp.zeros((2, 256))}}}}
    host_params = {"blocks": {"attn1": {"to_q": {"w": w,
                                                 "b": np.zeros((2, 256))}}}}
    dev = quantize_transformer_params(params, bits=4, group_size=64)
    host = quantize_transformer_params(host_params, bits=4, group_size=64)
    leaf_d = dev["blocks"]["attn1"]["to_q"]
    leaf_h = host["blocks"]["attn1"]["to_q"]
    assert isinstance(leaf_h["w_q4"], np.ndarray)
    np.testing.assert_array_equal(np.asarray(leaf_d["w_q4"]), leaf_h["w_q4"])
    np.testing.assert_allclose(np.asarray(leaf_d["scale"]), leaf_h["scale"],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(leaf_d["bias"]), leaf_h["bias"],
                               rtol=1e-6)


def test_keymaps_produce_host_trees():
    """Weight loaders must return numpy trees (no device staging at load)."""
    from ltx_jax.weights import keymaps

    num_layers = 2
    d, ffn, cap = 8, 16, 4

    def lin(i, o):
        return {"weight": np.ones((o, i), np.float32)}

    raw = {}
    for li in range(num_layers):
        p = f"transformer_blocks.{li}"
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                raw[f"{p}.{attn}.{proj}.weight"] = np.ones((d, d), np.float32)
                raw[f"{p}.{attn}.{proj}.bias"] = np.zeros((d,), np.float32)
            for nrm in ("q_norm", "k_norm"):
                raw[f"{p}.{attn}.{nrm}.weight"] = np.ones((d,), np.float32)
        raw[f"{p}.ff.project_in.proj.weight"] = np.ones((ffn, d), np.float32)
        raw[f"{p}.ff.project_in.proj.bias"] = np.zeros((ffn,), np.float32)
        raw[f"{p}.ff.project_out.weight"] = np.ones((d, ffn), np.float32)
        raw[f"{p}.ff.project_out.bias"] = np.zeros((d,), np.float32)
        raw[f"{p}.scale_shift_table"] = np.zeros((6, d), np.float32)
    raw["patchify_proj.weight"] = np.ones((d, d), np.float32)
    raw["patchify_proj.bias"] = np.zeros((d,), np.float32)
    for pre in ("adaln_single.emb.linear_1", "adaln_single.emb.linear_2",
                "adaln_single.linear", "caption_projection.linear_1",
                "caption_projection.linear_2", "proj_out"):
        o = 6 * d if pre == "adaln_single.linear" else d
        i = cap if pre == "caption_projection.linear_1" else d
        raw[f"{pre}.weight"] = np.ones((o, i), np.float32)
        raw[f"{pre}.bias"] = np.zeros((o,), np.float32)
    raw["scale_shift_table"] = np.zeros((2, d), np.float32)

    params = keymaps.assemble_transformer_params(raw, num_layers)
    leaves = jax.tree.leaves(params)
    assert all(isinstance(x, np.ndarray) for x in leaves), [
        type(x) for x in leaves if not isinstance(x, np.ndarray)][:3]
    # bf16 at load preserved through the numpy path
    assert params["patchify_proj"]["w"].dtype == jnp.bfloat16


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_staged_sharded_generation():
    """The production path: loader-style HOST trees + phase_staging + mesh.
    shard() defers placement for host trees; _on_device shards each phase's
    component (TP for the DiT, replicate for the rest), and the release
    restores the host original."""
    from ltx_jax.parallel.sharding import make_mesh

    ref = LTXPipeline.random_tiny(seed=0)
    ref.memory = dataclasses.replace(ref.memory, offload_text_encoder=False)
    expected = ref.generate_video("a cat", _cfg())

    pipe = _host_pipe(seed=0, phase_staging=True)
    pipe.shard(make_mesh(data=2, model=4))
    assert staging.is_host_tree(pipe.transformer_params)  # placement deferred
    got = pipe.generate_video("a cat", _cfg())
    np.testing.assert_allclose(
        np.asarray(expected.frames, np.float32),
        np.asarray(got.frames, np.float32), atol=3e-2, rtol=3e-2)
    assert staging.is_host_tree(pipe.transformer_params)  # released again
