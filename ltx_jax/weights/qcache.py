"""Quantized-checkpoint cache: quantize once, mmap afterwards.

The reference quantizes on the fly at every load (MLX `quantize(model:)`,
reference: LTXPipeline.swift:323-333) — cheap on unified memory, but here
load-time quantization is real host work even with the native C++ kernels.
This module persists the quantized HOST tree
next to the source checkpoint the first time, and later loads mmap it back
in seconds.

Format: one safetensors file, nested pytree paths flattened with "/"
(safetensors keys are flat); numpy-bf16 leaves (ml_dtypes has no
safetensors.numpy support) are stored as uint16 views with a "@bf16" key
suffix. Staleness: the header metadata records the SOURCE file's
(size, mtime_ns) plus the full quantization signature — any mismatch means
the cache is silently ignored and rebuilt.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("ltx_jax")

_FORMAT = "ltx-qcache-v1"


def cache_path(source_path, tag: str) -> Path:
    """<source>.<tag>.qcache.safetensors next to the source file (inside it
    for a directory source)."""
    p = Path(source_path)
    if p.is_dir():
        return p / f"{tag}.qcache.safetensors"
    return p.with_name(p.name + f".{tag}.qcache.safetensors")


def _signature(source_path, quant_sig: dict) -> dict:
    p = Path(source_path)
    if p.is_dir():
        # exclude qcache files: the cache must not invalidate itself
        files = sorted(f for f in p.glob("*.safetensors")
                       if not f.name.endswith(".qcache.safetensors"))
        size = sum(f.stat().st_size for f in files)
        mtime = max((f.stat().st_mtime_ns for f in files), default=0)
        ident = {"source_size": str(size), "source_mtime_ns": str(mtime),
                 "source_files": str(len(files))}
    else:
        st = os.stat(source_path)
        ident = {"source_size": str(st.st_size),
                 "source_mtime_ns": str(st.st_mtime_ns)}
    return {"format": _FORMAT, **ident,
            **{k: str(v) for k, v in quant_sig.items()}}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str) or "/" in k or k.endswith("@bf16"):
                raise ValueError(f"uncacheable tree key: {k!r}")
            yield from _flatten(v, f"{prefix}{k}/")
    elif tree is None:
        pass
    else:
        yield prefix[:-1], tree  # leaf as-is; caller checks it's host numpy


def save_quantized_tree(tree, source_path, tag: str,
                        quant_sig: dict) -> Optional[Path]:
    """Persist a HOST (numpy) quantized tree; returns the path or None when
    the tree has non-host leaves (device trees are never cached) or the
    directory is read-only."""
    import ml_dtypes
    from safetensors.numpy import save_file

    flat = {}
    try:
        for key, arr in _flatten(tree):
            if not isinstance(arr, np.ndarray):
                return None
            if arr.dtype == ml_dtypes.bfloat16:
                flat[key + "@bf16"] = np.ascontiguousarray(arr) \
                    .view(np.uint16)
            else:
                flat[key] = np.ascontiguousarray(arr)
    except ValueError as e:
        log.info("quantized cache skipped: %s", e)
        return None
    path = cache_path(source_path, tag)
    # pid-unique tmp: two concurrent loaders racing the same cache would
    # otherwise interleave writes into one tmp file; os.replace keeps the
    # final rename atomic either way
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        save_file(flat, str(tmp), metadata=_signature(source_path,
                                                      quant_sig))
        os.replace(tmp, path)
    except OSError as e:
        log.info("quantized cache not written (%s): %s", path, e)
        tmp.unlink(missing_ok=True)
        return None
    log.info("quantized cache written: %s (%d tensors)", path, len(flat))
    return path


def load_quantized_tree(source_path, tag: str, quant_sig: dict):
    """-> nested numpy tree, or None (no cache / stale / wrong signature)."""
    import ml_dtypes
    from safetensors import safe_open

    path = cache_path(source_path, tag)
    if not path.exists():
        return None
    try:
        want = _signature(source_path, quant_sig)
        with safe_open(str(path), framework="numpy") as f:
            meta = f.metadata() or {}
            if meta != want:
                log.info("quantized cache stale (%s); requantizing", path)
                return None
            tree: dict = {}
            for key in f.keys():
                arr = f.get_tensor(key)
                leaf_key = key
                if key.endswith("@bf16"):
                    leaf_key = key[:-len("@bf16")]
                    arr = arr.view(ml_dtypes.bfloat16)
                parts = leaf_key.split("/")
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = arr
    except Exception as e:  # noqa: BLE001 — a bad cache (truncated write,
        # version skew, SafetensorError) must never break loading; fall
        # back to re-quantizing
        log.warning("quantized cache unreadable (%s): %s", path, e)
        return None
    log.info("quantized cache hit: %s", path)
    return tree
