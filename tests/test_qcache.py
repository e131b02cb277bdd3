"""Quantized-checkpoint cache (weights/qcache.py): quantize once, mmap
afterwards. The reference re-quantizes at every load
(LTXPipeline.swift:323-333); this is a deployment addition — load-time
quantization is real host work."""

import time

import ml_dtypes
import numpy as np
import pytest

from ltx_jax.weights import qcache


def _tree():
    rng = np.random.default_rng(0)
    return {
        "blocks": {
            "attn1": {
                "to_q": {
                    "w_q4": rng.integers(0, 255, (128, 64),
                                         dtype=np.uint8),
                    "scale": rng.random((4, 64), dtype=np.float32),
                    "bias": rng.random((4, 64), dtype=np.float32),
                    "b": rng.standard_normal((2, 64)).astype(
                        ml_dtypes.bfloat16),
                },
            },
            "norm": {"w": rng.standard_normal((2, 64)).astype(
                ml_dtypes.bfloat16)},
        },
        "scale_shift_table": rng.standard_normal((2, 6, 64)).astype(
            np.float32),
        "maybe": None,
    }


def _source(tmp_path):
    src = tmp_path / "unified.safetensors"
    src.write_bytes(b"x" * 128)
    return src


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(k for k, v in b.items() if v is not None) \
            or set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], path + "/" + str(k))
    else:
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32), err_msg=path)


class TestQCache:
    SIG = {"component": "dit", "mode": "int4", "group": 64}

    def test_roundtrip_preserves_tree_and_dtypes(self, tmp_path):
        src = _source(tmp_path)
        tree = _tree()
        assert qcache.save_quantized_tree(tree, src, "dit-int4",
                                          self.SIG) is not None
        got = qcache.load_quantized_tree(src, "dit-int4", self.SIG)
        assert got is not None
        tree.pop("maybe")  # None leaves are dropped by design
        _assert_trees_equal(tree, got)
        assert got["blocks"]["attn1"]["to_q"]["b"].dtype == ml_dtypes.bfloat16
        assert got["blocks"]["attn1"]["to_q"]["w_q4"].dtype == np.uint8

    def test_miss_without_cache(self, tmp_path):
        assert qcache.load_quantized_tree(_source(tmp_path), "dit-int4",
                                          self.SIG) is None

    def test_source_change_invalidates(self, tmp_path):
        src = _source(tmp_path)
        qcache.save_quantized_tree(_tree(), src, "dit-int4", self.SIG)
        time.sleep(0.01)
        src.write_bytes(b"y" * 256)  # size + mtime change
        assert qcache.load_quantized_tree(src, "dit-int4", self.SIG) is None

    def test_signature_change_invalidates(self, tmp_path):
        src = _source(tmp_path)
        qcache.save_quantized_tree(_tree(), src, "dit-int4", self.SIG)
        other = dict(self.SIG, mode="w8a8")
        assert qcache.load_quantized_tree(src, "dit-int4", other) is None

    def test_lora_scale_in_signature(self, tmp_path):
        src = _source(tmp_path)
        sig1 = dict(self.SIG, lora="a.safetensors:10:1:0.8")
        qcache.save_quantized_tree(_tree(), src, "dit-int4", sig1)
        sig2 = dict(self.SIG, lora="a.safetensors:10:1:1.0")
        assert qcache.load_quantized_tree(src, "dit-int4", sig2) is None
        assert qcache.load_quantized_tree(src, "dit-int4", sig1) is not None

    def test_device_leaf_not_cached(self, tmp_path):
        import jax.numpy as jnp

        src = _source(tmp_path)
        tree = {"w": jnp.ones((4, 4))}
        assert qcache.save_quantized_tree(tree, src, "t", self.SIG) is None
        assert not qcache.cache_path(src, "t").exists()

    def test_dir_source_and_self_exclusion(self, tmp_path):
        # directory sources (Gemma): the cache lives INSIDE the dir and
        # must not invalidate (or load) itself
        from safetensors.numpy import save_file

        d = tmp_path / "gemma"
        d.mkdir()
        save_file({"a": np.ones((2, 2), np.float32)},
                  str(d / "model-00001.safetensors"))
        sig = {"component": "gemma", "mode": "w8a8"}
        assert qcache.save_quantized_tree(_tree(), d, "gemma-w8a8",
                                          sig) is not None
        assert qcache.load_quantized_tree(d, "gemma-w8a8", sig) is not None
        # second save/load cycle: still a hit (cache file excluded from
        # the dir signature)
        assert qcache.load_quantized_tree(d, "gemma-w8a8", sig) is not None
        from ltx_jax.weights.download import load_safetensors_dir

        merged = load_safetensors_dir(d)
        assert set(merged) == {"a"}  # qcache file skipped

    def test_corrupt_cache_ignored(self, tmp_path):
        src = _source(tmp_path)
        qcache.save_quantized_tree(_tree(), src, "dit-int4", self.SIG)
        qcache.cache_path(src, "dit-int4").write_bytes(b"garbage")
        assert qcache.load_quantized_tree(src, "dit-int4", self.SIG) is None

    def test_quantized_dit_roundtrip_runs(self, tmp_path):
        # real shape of the integration: quantize a tiny DiT, cache it,
        # reload, and run a forward step on the cached tree
        import jax
        import jax.numpy as jnp

        from ltx_jax.core.config import TransformerConfig
        from ltx_jax.kernels.quantization import quantize_dit_params
        from ltx_jax.models import dit
        from ltx_jax.ops import rope as rope_ops

        cfg = TransformerConfig().tiny()
        params = jax.tree.map(
            np.asarray, dit.init_params(jax.random.key(0), cfg,
                                        jnp.float32))
        qparams = quantize_dit_params(params, 4, 32)
        src = _source(tmp_path)
        sig = {"component": "dit", "mode": "int4", "group": 32,
               "layers": cfg.num_layers}
        assert qcache.save_quantized_tree(qparams, src, "dit-int4",
                                          sig) is not None
        got = qcache.load_quantized_tree(src, "dit-int4", sig)
        _assert_trees_equal(qparams, got)
