"""Multi-process runtime layer (parallel/runtime.py) on the virtual CPU
devices: the single-process behaviour of both entry points."""

import numpy as np

from ltx_jax.parallel import runtime, sharding


def test_initialize_distributed_noop_single_process(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert runtime.initialize_distributed() is False


def test_process_local_batch_single_process():
    mesh = sharding.make_mesh(data=8, model=1)
    data = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = runtime.process_local_batch(data, mesh)
    assert arr.shape == (8, 3)
    np.testing.assert_array_equal(np.asarray(arr), data)
    # sharded over the data axis: each device holds one row
    assert arr.sharding.shard_shape(arr.shape) == (1, 3)
