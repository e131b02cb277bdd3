"""Test configuration: force CPU with 8 virtual devices for mesh tests.

An environment may import jax before this file runs (with JAX_PLATFORMS
pointing at an accelerator), so env vars set here can be too late — but
backends initialize lazily, so jax.config.update still wins. XLA_FLAGS is
read at backend-init time and must be set before the first jax.devices()
call. Tests that need a GPU carry the `gpu` marker and skip here.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "float32")


# ---------------------------------------------------------------------------
# Test tiering (round 5): `pytest -m fast` = the <10-min core tier —
# goldens, schedulers, key-map parity pins, and the cheap pure-ops suites.
# The full suite is ~45 min on this 1-core CPU; iterate on the core tier
# and leave the full run to CI / end-of-round.
# ---------------------------------------------------------------------------

_FAST_MODULES = {
    "test_goldens",          # fixed-seed frame goldens — THE regression pin
    "test_schedule",         # sigma tables vs reference constants
    "test_rope",             # RoPE goldens
    "test_latents",          # patchify/CFG/AdaIN pure ops
    "test_weights",          # key-map parity pins
    "test_weight_contract",  # checkpoint-inventory contract
    "test_errors",           # error taxonomy
    "test_diagnostics",      # [DIAG]/checkpoint utilities
    "test_metrics",          # Prometheus exposition
    "test_io_video",         # MP4/WAV/image IO
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "fast: core regression tier (pytest -m fast, <10 min)")


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        if item.module.__name__ in _FAST_MODULES:
            item.add_marker(pytest.mark.fast)
