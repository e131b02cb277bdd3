"""Host <-> device parameter staging (phase choreography).

The reference fits Apple unified memory by unloading whole models between
phases (LTXPipeline.swift:726-731, :988-999). The equivalent here: weight
loaders build HOST (numpy) pytrees, each pipeline phase places just the
params it needs into device memory (plain `device_put`, or sharded over the
mesh),
and — with `MemoryConfig.phase_staging` — drops the device copy afterwards
while keeping the host original (params are immutable at inference, so the
release is free: no device->host readback ever happens).

A device whose memory cannot hold every phase's weights at once (the CLI
compares its estimate with the device's limit) needs this choreography.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def is_host_tree(tree) -> bool:
    """True when the pytree's leaves are host (numpy) arrays."""
    leaves = jax.tree.leaves(tree)
    return bool(leaves) and isinstance(leaves[0], np.ndarray)


def to_device(tree):
    """Place a host pytree into device memory (replicated single-device)."""
    return jax.tree.map(jnp.asarray, tree)
