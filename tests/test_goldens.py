"""Golden-output regression fixtures (VERDICT r3 #7).

The reference commits frame-12 PNGs per benchmark config
(/root/reference/docs/examples/beaver-dam/README.md) so numerical drift is
visible in review. Offline analog: committed fixed-seed tiny-pipeline
goldens (tests/goldens/*.npz, a few KB) — a refactor that silently changes
the numerics of the full pipeline (scheduler, DiT, guidance combine, VAE)
fails HERE, not in a future real-weight run.

Tolerances are tight-but-not-bitwise (2e-4 on frames): XLA CPU is
deterministic for a fixed jax version, but the goldens must survive
benign jax/XLA upgrades that re-associate reductions. Regenerate with
scripts/make_goldens.py ONLY for intentional numerics changes, and say so
in the commit message.
"""

import pathlib

import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.pipeline.generate import LTXPipeline

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


@pytest.fixture(scope="module")
def pipe():
    import dataclasses

    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def _check(name, frames):
    path = GOLDEN_DIR / f"{name}.npz"
    assert path.exists(), (
        f"missing golden {path} — run scripts/make_goldens.py")
    with np.load(path) as z:
        want_first = z["first_frame"].astype(np.float32)
        want_stats = z["stats"].astype(np.float32)
    got = np.asarray(frames, np.float32)
    got_stats = np.asarray(
        [got.mean(), got.std(), got.min(), got.max()], np.float32)
    np.testing.assert_allclose(got[0], want_first, atol=2e-4, rtol=2e-4,
                               err_msg=f"{name}: first frame drifted")
    np.testing.assert_allclose(got_stats, want_stats, atol=2e-4, rtol=2e-4,
                               err_msg=f"{name}: full-video stats drifted")


def test_golden_t2v(pipe):
    r = pipe.generate_video("golden fixed-seed prompt", _cfg())
    _check("tiny_t2v", r.frames)


def test_golden_t2v_cfg_guided(pipe):
    """CFG + STG guidance combine (3 rows) — a different denoise program."""
    r = pipe.generate_video(
        "golden guided prompt",
        _cfg(cfg_scale=4.0, stg_scale=1.0, stg_blocks=(1,), seed=7))
    _check("tiny_t2v_guided", r.frames)


def test_golden_two_stage(pipe):
    r = pipe.generate_video_two_stage("golden two-stage prompt",
                                      _cfg(num_frames=9))
    _check("tiny_two_stage", r.frames)


def test_golden_chain(pipe):
    """Round 5: pins the chain's latent-carry + extension-step numerics
    (segment 0 + the conditioned continuation + overlap trim)."""
    r = pipe.generate_video_chain("golden chain prompt",
                                  _cfg(num_frames=17), segments=2,
                                  cond_frames=9)
    _check("tiny_chain", r.frames)


def test_golden_av():
    """Round 5: pins the dual AV path — frames AND waveform stats."""
    import dataclasses

    av = LTXPipeline.random_tiny(seed=0, include_audio=True)
    av.memory = dataclasses.replace(av.memory, offload_text_encoder=False)
    r = av.generate_video_with_audio("golden av prompt", _cfg())
    _check("tiny_av", r.frames)
    with np.load(GOLDEN_DIR / "tiny_av.npz") as z:
        want = z["audio_stats"].astype(np.float32)
    a = np.asarray(r.audio, np.float32)
    got = np.asarray([a.mean(), a.std(), a.min(), a.max(),
                      float(a.shape[-1])], np.float32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4,
                               err_msg="tiny_av: waveform stats drifted")
