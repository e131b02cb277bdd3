"""Memory budgets read from the device (utils/device_memory.py) and the
decisions that use them: no decision falls back to a built-in budget."""

import types

import jax
import pytest

from ltx_jax.core.config import LTXModel
from ltx_jax.core.errors import InvalidConfigurationError
from ltx_jax.models import gemma3
from ltx_jax.ops import latents
from ltx_jax.utils import device_memory


def _device(limit):
    stats = None if limit is None else {"bytes_limit": limit,
                                        "bytes_in_use": 0}
    return types.SimpleNamespace(memory_stats=lambda: stats)


def test_device_limit_is_read_from_memory_stats():
    assert device_memory.device_memory_gb(_device(60e9)) == 60.0


def test_device_without_limit_reports_none():
    assert device_memory.device_memory_gb(_device(None)) is None
    # the CPU backend reports no memory statistics
    assert device_memory.device_memory_gb(jax.devices("cpu")[0]) is None


def test_budget_needs_a_limit_or_an_explicit_value():
    with pytest.raises(InvalidConfigurationError, match="explicitly"):
        device_memory.memory_budget_gb(device=_device(None))
    assert device_memory.memory_budget_gb(24, device=_device(None)) == 24.0
    assert device_memory.memory_budget_gb(device=_device(80e9)) == 80.0


@pytest.mark.parametrize("budget,resident,per_row,cap,want", [
    (60.0, 12.0, 0.5, 64, 64),    # room for 96 rows, capped
    (16.0, 12.0, 0.5, 64, 8),
    (12.0, 12.5, 0.5, 64, 1),     # never below one row
    (60.0, 12.0, 0.0, 4, 4),
])
def test_batch_rows_that_fit(budget, resident, per_row, cap, want):
    assert device_memory.batch_rows_that_fit(
        budget, resident, per_row, cap) == want


def test_preset_and_model_follow_the_device(monkeypatch):
    shape = latents.VideoLatentShape.from_pixels(1, 241, 640, 1024)
    monkeypatch.setattr(device_memory, "device_memory_gb",
                        lambda device=None: None)
    with pytest.raises(InvalidConfigurationError):
        latents.recommended_memory_preset(shape, 3, None, audio=True)
    from ltx_jax.weights.registry import recommended_model

    with pytest.raises(InvalidConfigurationError):
        recommended_model(n_devices=1)
    monkeypatch.setattr(device_memory, "device_memory_gb",
                        lambda device=None: 200.0)
    assert latents.recommended_memory_preset(shape, 3, None,
                                             audio=True) == "light"
    assert recommended_model(n_devices=1) == (LTXModel.DEV, None)


def test_enhance_row_memory():
    cfg = gemma3.Gemma3Config()
    bf16 = gemma3.enhance_row_gb(cfg)
    # 48 layers x K,V x 8 kv heads x 1033 slots x 256 x 2 B, + a quarter
    assert bf16 == pytest.approx(48 * 2 * 8 * 1033 * 512 * 1.25 / 1e9)
    assert gemma3.enhance_row_gb(cfg, "int8") < 0.6 * bf16


def test_encode_chunk_follows_device_memory(monkeypatch):
    from ltx_jax.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny()
    assert pipe._encode_batch() == 4            # no limit: full chunks
    resident = device_memory.tree_gb(pipe.gemma_params)
    monkeypatch.setattr(device_memory, "device_memory_gb",
                        lambda device=None: resident)
    assert pipe._encode_batch() == 1            # nothing spare: one row


def test_enhance_max_batch_needs_a_budget(monkeypatch, capsys):
    from ltx_jax.io import cli

    pipe = types.SimpleNamespace(gemma_params={}, gcfg=gemma3.Gemma3Config())
    args = types.SimpleNamespace(max_batch=0, kv_quant="bf16")
    monkeypatch.setattr(device_memory, "device_memory_gb",
                        lambda device=None: None)
    assert cli._enhance_max_batch(args, pipe.gemma_params, pipe.gcfg) is None
    assert "--max-batch" in capsys.readouterr().err
    args.max_batch = 3
    assert cli._enhance_max_batch(args, pipe.gemma_params, pipe.gcfg) == 3
    args.max_batch = 0
    monkeypatch.setattr(device_memory, "device_memory_gb",
                        lambda device=None: 20.0)
    want = int(20.0 // gemma3.enhance_row_gb(pipe.gcfg))
    assert cli._enhance_max_batch(args, pipe.gemma_params, pipe.gcfg) == want
