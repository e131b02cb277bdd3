"""Multi-process distributed runtime.

The reference is a single-process, single-device program (SURVEY.md §5.8:
no distributed backend of any kind); everything here is new capability.
One host's devices need none of it — `sharding.make_mesh` /
`pipeline.make_pp_mesh` suffice. Across processes:

* `initialize_distributed()` — thin, idempotent wrapper over
  `jax.distributed.initialize`. Every process calls it before touching
  devices; after it, `jax.devices()` is the GLOBAL device list and the
  existing mesh builders work unchanged.
* `process_local_batch()` — assembles a global batch-sharded array from
  the rows each process loaded.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import jax
from jax.sharding import Mesh

log = logging.getLogger("ltx_jax")

_INITIALIZED = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids=None) -> bool:
    """Initialize JAX's multi-process runtime; returns True if it did.

    No-ops (returns False) when called twice, or when nothing indicates a
    multi-process deployment (no args and no coordinator in the
    environment). Off a managed cluster, pass coordinator_address
    (host:port), num_processes and process_id.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return False
    has_env = bool(os.environ.get("COORDINATOR_ADDRESS")
                   or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None and not has_env:
        return False
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _INITIALIZED = True
    log.info("jax.distributed initialized: process %d/%d, %d local / %d "
             "global devices", jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return True


def process_local_batch(local_data, mesh: Mesh, axis: str = "data"):
    """Assemble a GLOBAL batch-sharded jax.Array from per-process data.

    Training input pipeline for multi-host: each process loads only its
    own batch rows (global_batch/process_count) and this stitches them
    into one global array sharded over `axis`. Single-process it is just
    device_put with the batch sharding.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(local_data, sh)
    global_shape = (local_data.shape[0] * jax.process_count(),
                    *local_data.shape[1:])
    return jax.make_array_from_process_local_data(sh, local_data,
                                                  global_shape)
