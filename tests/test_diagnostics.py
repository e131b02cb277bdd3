"""Observability + denoise resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.ops.latents import VideoLatentShape
from ltx_jax.pipeline.denoise import (
    GuidanceSpec,
    make_denoise_step,
    run_denoise_loop,
)
from ltx_jax.pipeline.generate import LTXPipeline
from ltx_jax.utils import diagnostics


def test_diag_stats_format(monkeypatch):
    monkeypatch.setattr(diagnostics, "DIAG_ENABLED", True)
    msg = diagnostics.diag_stats("test", jnp.asarray([1.0, 2.0, 3.0]))
    assert msg.startswith("[DIAG] test:")
    assert "mean=2.0" in msg and "first5=[1.0, 2.0, 3.0]" in msg


def test_diag_disabled_returns_none():
    assert diagnostics.diag_stats("x", jnp.zeros(3)) is None


def test_denoise_checkpoint_resume(tmp_path):
    """A loop interrupted mid-way must resume to the EXACT same result."""
    pipe = LTXPipeline.random_tiny(seed=0)
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 2, 2)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    step = make_denoise_step(pipe.transformer_params, pipe.tcfg, g, shape,
                             ctx, None)
    latent0 = jax.random.normal(jax.random.key(0), shape.shape)
    sigmas = np.asarray([1.0, 0.7, 0.4, 0.2, 0.0], np.float32)
    key = jax.random.key(5)

    # uninterrupted reference
    full = run_denoise_loop(step, latent0, sigmas, key=key)

    # interrupted: run with checkpointing, stop after step 1
    ckpt = diagnostics.DenoiseCheckpoint(str(tmp_path / "state.pkl"),
                                         every_n_steps=1)
    calls = {"n": 0}

    def bomb(i, n, s):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run_denoise_loop(step, latent0, sigmas, key=key, on_step=bomb,
                         checkpoint=ckpt)
    assert os.path.exists(ckpt.path)

    # resume from the checkpoint and finish
    resumed = run_denoise_loop(step, latent0, sigmas, key=key,
                               checkpoint=ckpt)
    np.testing.assert_allclose(
        np.asarray(resumed), np.asarray(full), atol=1e-6
    )


def test_checkpoint_sigma_mismatch_restarts(tmp_path):
    """Different schedule -> checkpoint ignored, fresh run."""
    ckpt = diagnostics.DenoiseCheckpoint(str(tmp_path / "s.pkl"), 1)
    ckpt.save(0, jnp.ones((2,)), jnp.zeros((2,)),
              np.asarray([1.0, 0.0]), seed=1)
    state = ckpt.load()
    assert state is not None
    # loop with different sigmas must not resume
    pipe = LTXPipeline.random_tiny(seed=0)
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 2, 2)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    step = make_denoise_step(pipe.transformer_params, pipe.tcfg, g, shape,
                             ctx, None)
    latent0 = jax.random.normal(jax.random.key(0), shape.shape)
    out = run_denoise_loop(step, latent0,
                           np.asarray([1.0, 0.5, 0.0], np.float32),
                           checkpoint=ckpt)
    assert out.shape == shape.shape

def test_device_sync_blocks_on_device_and_host_trees():
    """device_sync waits with block_until_ready on any pytree; host arrays
    and scalars pass straight through."""
    import jax.numpy as jnp
    import numpy as np

    from ltx_jax.utils.diagnostics import device_sync

    tree = {"a": jnp.arange(4) * 2, "b": np.ones(3), "c": 1.0}
    assert device_sync(tree) is None
    assert tree["a"].is_ready()
