"""Host media IO: export config parity with the reference's
VideoExportConfig (VideoExporter.swift:14-51)."""

import wave

import numpy as np
import pytest

from ltx_jax.io.video import (
    VideoExportConfig,
    export_video,
    export_wav,
    frames_to_uint8,
)


def _frames(n=5, h=32, w=32):
    rng = np.random.default_rng(0)
    return rng.random((n, h, w, 3), dtype=np.float32)


def test_default_config_matches_reference():
    cfg = VideoExportConfig()
    assert (cfg.fps, cfg.codec, cfg.quality) == (24.0, "h264", 0.8)
    assert cfg.ffmpeg_codec == "libx264"


def test_high_quality_preset():
    cfg = VideoExportConfig.high_quality()
    assert (cfg.codec, cfg.quality) == ("hevc", 0.95)
    assert cfg.ffmpeg_codec == "libx265"


def test_unknown_codec_rejected():
    with pytest.raises(ValueError, match="unknown codec"):
        _ = VideoExportConfig(codec="av1").ffmpeg_codec


def test_export_video_with_config(tmp_path):
    out = tmp_path / "clip.mp4"
    export_video(_frames(), str(out), config=VideoExportConfig(fps=8.0))
    assert out.exists() and out.stat().st_size > 0


def test_export_video_fps_only_builds_config(tmp_path):
    out = tmp_path / "clip2.mp4"
    export_video(_frames(), str(out), fps=12.0)
    assert out.exists() and out.stat().st_size > 0


def test_export_wav_roundtrip(tmp_path):
    out = tmp_path / "a.wav"
    audio = np.stack([np.linspace(-1, 1, 480, dtype=np.float32),
                      np.zeros(480, np.float32)])
    export_wav(audio, str(out), sample_rate=24000)
    with wave.open(str(out)) as w:
        assert w.getnchannels() == 2
        assert w.getframerate() == 24000
        assert w.getnframes() == 480


def test_frames_to_uint8_rounding():
    x = np.array([[[[0.0, 0.5, 1.0]]]], np.float32)
    np.testing.assert_array_equal(frames_to_uint8(x)[0, 0, 0],
                                  [0, 128, 255])


def test_quality_out_of_range_rejected():
    with pytest.raises(ValueError, match="quality"):
        VideoExportConfig(quality=8.0)  # someone assuming the 0..10 scale


def test_frames_to_uint8_device_matches_host():
    """Device arrays quantize ON DEVICE before the pull (4x fewer transfer
    bytes); the bytes must equal the host-numpy path's."""
    import jax
    import jax.numpy as jnp

    from ltx_jax.io.video import frames_to_uint8

    host = np.random.default_rng(0).uniform(size=(3, 16, 16, 3)) \
        .astype(np.float32)
    dev = jnp.asarray(host)
    np.testing.assert_array_equal(frames_to_uint8(dev),
                                  frames_to_uint8(host))
