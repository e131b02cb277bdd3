"""LoRA: key mapping, delta math, fusion into stacked + quantized pytrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.kernels.quantization import dequantize_weight, quantize_dit_params
from ltx_jax.lora import fuse
from ltx_jax.models import dit

CFG = TransformerConfig().tiny()


def test_key_mapping():
    cases = {
        "diffusion_model.transformer_blocks.0.attn1.to_out.0":
            "transformer_blocks.0.attn1.to_out",
        "diffusion_model.transformer_blocks.3.ff.net.0.proj":
            "transformer_blocks.3.ff.project_in.proj",
        "diffusion_model.transformer_blocks.3.ff.net.2":
            "transformer_blocks.3.ff.project_out",
        "diffusion_model.time_embed.emb.timestep_embedder.linear_1":
            "time_embed.emb.linear_1",
        "transformer_blocks.1.attn2.to_q": "transformer_blocks.1.attn2.to_q",
    }
    for src, expected in cases.items():
        assert fuse.map_lora_key(src) == expected


def _make_lora_tensors(d, rank=4, alpha=8.0, fmt="down_up"):
    rng = np.random.default_rng(0)
    down = rng.standard_normal((rank, d)).astype(np.float32) * 0.1
    up = rng.standard_normal((d, rank)).astype(np.float32) * 0.1
    key = "diffusion_model.transformer_blocks.1.attn1.to_q"
    if fmt == "down_up":
        t = {f"{key}.lora_down.weight": down, f"{key}.lora_up.weight": up,
             f"{key}.alpha": np.float32(alpha)}
    else:
        t = {f"{key}.lora_A.weight": down, f"{key}.lora_B.weight": up}
    return t, down, up


def test_parse_both_formats():
    d = CFG.inner_dim
    t1, down, up = _make_lora_tensors(d, fmt="down_up")
    layers = fuse.parse_lora(t1)
    assert len(layers) == 1
    assert layers[0].original_key == "transformer_blocks.1.attn1.to_q"
    assert layers[0].rank == 4 and layers[0].alpha == 8.0
    assert layers[0].effective_scale == 2.0  # alpha/rank

    t2, _, _ = _make_lora_tensors(d, fmt="AB")
    layers2 = fuse.parse_lora(t2)
    assert len(layers2) == 1 and layers2[0].alpha is None
    assert layers2[0].effective_scale == 1.0


def test_delta_math():
    d = CFG.inner_dim
    _, down, up = _make_lora_tensors(d)
    layer = fuse.LoRALayer("x", down, up, alpha=8.0)
    delta = layer.delta(scale=0.5)
    np.testing.assert_allclose(delta, (up @ down) * (0.5 * 2.0), rtol=1e-6)


def test_fuse_into_stacked_params():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    d = CFG.inner_dim
    t, down, up = _make_lora_tensors(d)
    layers = fuse.parse_lora(t)
    fused = fuse.fuse_lora(params, layers, scale=1.0)

    # only block 1 attn1.to_q changed
    w_old = np.asarray(params["blocks"]["attn1"]["to_q"]["w"])
    w_new = np.asarray(fused["blocks"]["attn1"]["to_q"]["w"])
    np.testing.assert_array_equal(w_new[0], w_old[0])
    expected_delta = ((up @ down) * 2.0).T
    np.testing.assert_allclose(w_new[1] - w_old[1], expected_delta, atol=1e-5)
    # originals untouched (functional fuse)
    np.testing.assert_array_equal(
        np.asarray(params["blocks"]["attn1"]["to_q"]["w"]), w_old
    )


def test_fuse_quantized_path():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    qparams = quantize_dit_params(params, bits=8)
    d = CFG.inner_dim
    # target the quantized FFN (project_out: ffn_dim -> d is below threshold in
    # tiny cfg? project_in d->4d = 128*512 = 65536 >= threshold -> quantized)
    rank = 4
    rng = np.random.default_rng(1)
    down = rng.standard_normal((rank, d)).astype(np.float32) * 0.05
    up = rng.standard_normal((CFG.ffn_dim, rank)).astype(np.float32) * 0.05
    t = {
        "diffusion_model.transformer_blocks.0.ff.net.0.proj.lora_down.weight":
            down,
        "diffusion_model.transformer_blocks.0.ff.net.0.proj.lora_up.weight":
            up,
    }
    layers = fuse.parse_lora(t)
    fused = fuse.fuse_lora(qparams, layers, scale=1.0)

    leaf_old = {k: qparams["blocks"]["ff"]["project_in"][k][0]
                for k in ("w_q", "scale", "bias")}
    leaf_new = {k: fused["blocks"]["ff"]["project_in"][k][0]
                for k in ("w_q", "scale", "bias")}
    w_old = np.asarray(dequantize_weight(leaf_old, jnp.float32))
    w_new = np.asarray(dequantize_weight(leaf_new, jnp.float32))
    expected = (up @ down).T
    got = w_new - w_old
    # requantization noise is bounded by the quant step; check correlation
    c = np.corrcoef(got.ravel(), expected.ravel())[0, 1]
    assert c > 0.95, f"quantized fuse delta corr {c}"
    # untouched layer 1 identical
    np.testing.assert_array_equal(
        np.asarray(fused["blocks"]["ff"]["project_in"]["w_q"][1]),
        np.asarray(qparams["blocks"]["ff"]["project_in"]["w_q"][1]),
    )


def test_fuse_skips_unknown_layers():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    t = {
        "diffusion_model.nonexistent.layer.lora_down.weight":
            np.zeros((2, 4), np.float32),
        "diffusion_model.nonexistent.layer.lora_up.weight":
            np.zeros((4, 2), np.float32),
    }
    fused = fuse.fuse_lora(params, fuse.parse_lora(t))
    # no crash; params unchanged
    np.testing.assert_array_equal(
        np.asarray(fused["blocks"]["attn1"]["to_q"]["w"]),
        np.asarray(params["blocks"]["attn1"]["to_q"]["w"]),
    )

def test_fuse_host_tree_matches_device():
    """Loaders now deliver HOST (numpy) trees; fusion must produce the same
    weights as the device path, leave originals untouched (copy-on-write),
    and keep the result on host."""
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    host_params = jax.tree.map(lambda x: np.asarray(x), params)
    host_orig = jax.tree.map(lambda x: x.copy(), host_params)
    d = CFG.inner_dim
    t, down, up = _make_lora_tensors(d)
    layers = fuse.parse_lora(t)

    fused_dev = fuse.fuse_lora(params, layers, scale=1.0)
    fused_host = fuse.fuse_lora(host_params, layers, scale=1.0)

    w_dev = np.asarray(fused_dev["blocks"]["attn1"]["to_q"]["w"])
    w_host = fused_host["blocks"]["attn1"]["to_q"]["w"]
    assert isinstance(w_host, np.ndarray)
    np.testing.assert_allclose(w_host, w_dev, atol=1e-6)
    # copy-on-write: caller's host tree unmodified
    np.testing.assert_array_equal(
        host_params["blocks"]["attn1"]["to_q"]["w"],
        host_orig["blocks"]["attn1"]["to_q"]["w"])


def test_fuse_host_quantized_matches_device():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    qparams = quantize_dit_params(params, bits=4)
    host_q = jax.tree.map(lambda x: np.asarray(x), qparams)
    d = CFG.inner_dim
    rank = 4
    rng = np.random.default_rng(1)
    down = rng.standard_normal((rank, d)).astype(np.float32) * 0.05
    up = rng.standard_normal((CFG.ffn_dim, rank)).astype(np.float32) * 0.05
    t = {
        "diffusion_model.transformer_blocks.0.ff.net.0.proj.lora_down.weight":
            down,
        "diffusion_model.transformer_blocks.0.ff.net.0.proj.lora_up.weight":
            up,
    }
    layers = fuse.parse_lora(t)
    fused_dev = fuse.fuse_lora(qparams, layers, scale=1.0)
    fused_host = fuse.fuse_lora(host_q, layers, scale=1.0)
    for k in ("w_q4", "scale", "bias"):
        got = fused_host["blocks"]["ff"]["project_in"][k]
        assert isinstance(got, np.ndarray), k
        np.testing.assert_allclose(
            got, np.asarray(fused_dev["blocks"]["ff"]["project_in"][k]),
            atol=1e-6, err_msg=k)
    # untouched layer 1 of the same leaf identical; untouched leaves alias
    # the input (structure-only copy)
    np.testing.assert_array_equal(
        fused_host["blocks"]["ff"]["project_in"]["w_q4"][1],
        host_q["blocks"]["ff"]["project_in"]["w_q4"][1])
    assert fused_host["blocks"]["ff"]["project_out"]["w_q4"] is \
        host_q["blocks"]["ff"]["project_out"]["w_q4"]


def test_lora_config_scheduler_overrides():
    """LoRAConfig + scheduler overrides (reference declares these,
    LoRAConfig.swift:43-62; here apply_to actually wires them in) — a
    Turbo-style sigma table drives the denoise loop."""
    import dataclasses

    import numpy as np

    from ltx_jax.core.config import GenerationConfig
    from ltx_jax.lora.fuse import LoRAConfig, LoRASchedulerOverrides
    from ltx_jax.pipeline.generate import LTXPipeline

    ov = LoRASchedulerOverrides(num_steps=4, guidance_scale=1.0,
                                sigmas=(1.0, 0.6, 0.3))
    lc = LoRAConfig(weights_path="/tmp/x.safetensors", scale=0.8,
                    name="turbo", scheduler_overrides=ov)
    cfg = ov.apply_to(GenerationConfig(width=64, height=64, num_frames=9,
                                       num_steps=40, cfg_scale=4.0))
    assert cfg.num_steps == 4 and cfg.cfg_scale == 1.0
    assert cfg.sigmas_override == (1.0, 0.6, 0.3)
    assert lc.fused and lc.scale == 0.8

    pipe = LTXPipeline.random_tiny(seed=0)
    r = pipe.generate_video("a cat", dataclasses.replace(cfg, seed=1))
    # 3 sigma values + appended terminal 0.0 -> 3 Euler steps
    assert len(r.timings.denoise_steps) == 3
    assert np.isfinite(np.asarray(r.frames)).all()


def test_lora_info_metadata(tmp_path):
    """lora_info mirrors the reference's LoRAInfo fields
    (LoRAConfig.swift:95-116) from a safetensors file, without fusing."""
    from safetensors.numpy import save_file

    d, rank = 16, 4
    tensors = {}
    for mod in ("to_q", "to_k"):
        key = f"diffusion_model.transformer_blocks.0.attn1.{mod}"
        tensors[f"{key}.lora_down.weight"] = np.zeros((rank, d), np.float32)
        tensors[f"{key}.lora_up.weight"] = np.zeros((d, rank), np.float32)
    p = tmp_path / "l.safetensors"
    save_file(tensors, str(p))

    info = fuse.lora_info(p)
    assert info.name == "l.safetensors"
    assert info.layer_count == 2 and info.rank == rank
    assert info.target_modules == ("to_k", "to_q")
    assert not info.has_scheduler_overrides
    assert info.file_size_bytes == p.stat().st_size
