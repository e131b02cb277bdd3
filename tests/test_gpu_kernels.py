"""Kernel checks on a GPU, at real widths (ltx_jax/kernels/checks.py).

Marked `gpu`: each test asks the `gpu` fixture for a card and skips without
one. The suite's conftest holds JAX to the CPU, so on the card these same
check functions run as the first phase of `python3 chip_smoke.py`.
"""

import jax
import pytest

from ltx_jax.kernels import checks

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devices[0].platform}")
    return devices[0]


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_forward_on_gpu(gpu, with_bias):
    row = checks.check_flash_forward(with_bias=with_bias)
    assert row["max_err"] <= row["tol"]


def test_flash_cross_attention_on_gpu(gpu):
    row = checks.check_flash_forward(with_bias=True, tk=1024)
    assert row["max_err"] <= row["tol"]


def test_cudnn_forward_on_gpu(gpu):
    row = checks.check_cudnn_forward()
    assert row["max_err"] <= row["tol"]


def test_flash_stats_on_gpu(gpu):
    row = checks.check_flash_stats()
    assert row["max_err"] <= row["tol"]


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_backward_on_gpu(gpu, with_bias):
    row = checks.check_flash_backward(with_bias=with_bias)
    assert row["max_err"] <= row["tol"]


def test_int4_linear_on_gpu(gpu):
    row = checks.check_int4_linear()
    assert row["max_err"] <= row["tol"]


def test_w8a8_linear_on_gpu(gpu):
    row = checks.check_w8a8_linear()
    assert row["max_err"] <= row["tol"]
