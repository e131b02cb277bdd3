"""Two-stage audio+video generation (reference: LTXPipeline.swift:1485-1860)
and the fixed end-to-end I2V two-stage flow, including CLI wiring."""

import dataclasses

import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.pipeline.generate import LTXPipeline


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0, include_audio=True)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("img") / "cond.png"
    Image.fromarray(arr).save(path)
    return str(path)


def test_av_two_stage(pipe):
    cfg = GenerationConfig(width=128, height=128, num_frames=9, num_steps=2,
                           seed=7, two_stage=True)
    result = pipe.generate_video_with_audio_two_stage("a river", cfg)
    assert result.frames.shape == (9, 128, 128, 3)
    assert result.audio is not None
    a = np.asarray(result.audio)
    assert np.isfinite(a).all() and a.min() >= -1.0 and a.max() <= 1.0
    # stage 1 distilled table (8 steps) + stage 2 (3 steps)
    assert len(result.timings.denoise_steps) == 11
    f = np.asarray(result.frames)
    assert np.isfinite(f).all() and f.min() >= 0.0 and f.max() <= 1.0


def test_av_two_stage_i2v_from_path(pipe, image_file):
    """I2V with per-stage in-pipeline image encoding (half then full res)."""
    cfg = GenerationConfig(width=128, height=128, num_frames=9, num_steps=2,
                           seed=7, two_stage=True, image_path=image_file,
                           image_cond_noise_scale=0.15)
    result = pipe.generate_video_with_audio_two_stage("a river", cfg)
    assert result.frames.shape == (9, 128, 128, 3)
    assert result.audio is not None


def test_av_two_stage_requires_audio_models():
    from ltx_jax.core.errors import ModelNotLoadedError

    p = LTXPipeline.random_tiny(seed=0, include_audio=False)
    cfg = GenerationConfig(width=128, height=128, num_frames=9, num_steps=2,
                           two_stage=True)
    with pytest.raises(ModelNotLoadedError):
        p.generate_video_with_audio_two_stage("x", cfg)


def test_two_stage_i2v_from_path(pipe, image_file):
    """The VERDICT round-1 break: --image --two-stage must encode at half
    res for stage 1 and full res for stage 2 inside the pipeline."""
    cfg = GenerationConfig(width=128, height=128, num_frames=9, num_steps=2,
                           seed=5, two_stage=True, image_path=image_file,
                           image_cond_noise_scale=0.15)
    result = pipe.generate_video_two_stage("a river", cfg)
    assert result.frames.shape == (9, 128, 128, 3)
    assert np.isfinite(np.asarray(result.frames)).all()


def test_i2v_single_stage_from_path(pipe, image_file):
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=5, image_path=image_file,
                           image_cond_noise_scale=0.15)
    result = pipe.generate_video("a river", cfg)
    assert result.frames.shape == (9, 64, 64, 3)


def _run_cli(monkeypatch, pipe, argv, tmp_path):
    """Drive cmd_generate with the tiny pipeline patched in."""
    import ltx_jax.pipeline.loader as loader_mod
    from ltx_jax.io import cli

    monkeypatch.setattr(loader_mod, "load_pipeline",
                        lambda **kw: pipe, raising=True)
    out = str(tmp_path / "out.mp4")
    return cli.main(argv + ["-o", out]), out


@pytest.mark.parametrize("extra", [
    ["--two-stage"],
    ["--two-stage", "--audio"],
])
def test_cli_image_two_stage_end_to_end(monkeypatch, tmp_path, pipe,
                                        image_file, extra):
    """The exact invocation that shipped broken in round 1: --image with
    --two-stage (and now --audio --two-stage) through the REAL CLI dispatch."""
    import os

    argv = ["generate", "a cat", "-w", "128", "-H", "128", "-f", "9",
            "--seed", "3", "--image", image_file] + extra
    rc, out = _run_cli(monkeypatch, pipe, argv, tmp_path)
    assert rc == 0
    assert os.path.exists(out) and os.path.getsize(out) > 0
