"""JAX's persistent compilation cache, in one place.

A compiled program is keyed by, among other things, the cache directory's
path, so the directory must not move between runs: it is either the one
`JAX_COMPILATION_CACHE_DIR` names (JAX reads that variable itself, and this
module then sets nothing) or one fixed directory inside the checkout,
`<repo>/.jax_cache`, which `.gitignore` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory. Called by the
    CLI, `serve`, bench.py and chip_smoke.py before their first compile."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
