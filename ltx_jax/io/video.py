"""Host-side media IO: MP4/PNG/WAV export, image loading.

Equivalent of the reference's AVFoundation/CoreGraphics layer
(reference: Sources/LTXVideo/Utils/VideoExporter.swift:114-748,
AudioExporter.swift:19-103, Pipeline/LatentUtils.swift:343-392). Strictly
host-side Python, never inside jit. Uses imageio(-ffmpeg) when available
with an OpenCV fallback; WAV via the stdlib.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
import wave
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("ltx_jax.io")


@dataclasses.dataclass(frozen=True)
class VideoExportConfig:
    """Codec/quality/fps/pixel-format knobs for MP4 export
    (reference: VideoExporter.swift:14-51 — fps 24, h264, quality 0.8).

    quality is the reference's 0..1 scale, mapped onto imageio-ffmpeg's
    0..10 quantizer. pixel_format defaults to yuv420p (the broadly playable
    choice; the reference's 32ARGB is an AVFoundation input format, not the
    encoded format).
    """

    fps: float = 24.0
    codec: str = "h264"          # "h264" | "hevc"
    quality: float = 0.8
    pixel_format: str = "yuv420p"

    _CODECS = {"h264": "libx264", "hevc": "libx265"}

    def __post_init__(self):
        if not 0.0 <= self.quality <= 1.0:
            # the reference's 0..1 scale; out-of-range would otherwise
            # fail inside imageio and silently degrade to the cv2 fallback
            raise ValueError(
                f"export quality {self.quality} must be in [0, 1]")

    @property
    def ffmpeg_codec(self) -> str:
        try:
            return self._CODECS[self.codec]
        except KeyError:
            raise ValueError(
                f"unknown codec {self.codec!r}; pick from "
                f"{sorted(self._CODECS)}") from None

    def requires_ffmpeg(self) -> bool:
        """True when the caller asked for non-default codec/quality/pixfmt —
        settings the cv2 mp4v fallback cannot honor, so export must fail
        loudly rather than silently re-encode (fps is fine: cv2 honors it).
        """
        return (self.codec != "h264" or self.quality != 0.8
                or self.pixel_format != "yuv420p")

    @classmethod
    def high_quality(cls) -> "VideoExportConfig":
        """Reference's .highQuality preset (VideoExporter.swift:44-50)."""
        return cls(fps=24.0, codec="hevc", quality=0.95)


def frames_to_uint8(frames) -> np.ndarray:
    """(F, H, W, 3) floats in [0, 1] -> uint8, single host transfer.

    DEVICE arrays quantize on device before the pull: the encoder consumes
    uint8 anyway, so transferring f32 moves 4x the bytes for zero benefit
    (e.g. 121f@768x512 = 339 MB f32 vs 85 MB uint8 — minutes vs seconds
    through a slow link; PCIe pays per byte too). Same clip/round formula
    either way; host numpy input is untouched (byte-identical output)."""
    if hasattr(frames, "devices"):  # jax array: quantize device-side
        import jax.numpy as jnp

        q = jnp.clip(frames.astype(jnp.float32) * 255.0 + 0.5,
                     0, 255).astype(jnp.uint8)
        return np.asarray(q)
    arr = np.asarray(frames, dtype=np.float32)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def export_video(
    frames,
    path: str,
    fps: float = 24.0,
    audio: Optional[np.ndarray] = None,
    audio_sample_rate: int = 24000,
    config: Optional[VideoExportConfig] = None,
) -> str:
    """Write (F, H, W, 3) [0,1] frames to MP4 (H.264 when available).

    `config` selects codec/quality (VideoExportConfig; fps there wins when
    both are given). With audio (2, samples) in [-1, 1]: writes the video,
    a temp WAV, and muxes via imageio-ffmpeg's bundled ffmpeg binary —
    mirroring the reference's separate-tracks-then-compose design that
    avoids interleaving deadlocks (reference: VideoExporter.swift:422-487).
    """
    if config is None:
        config = VideoExportConfig(fps=fps)
    pixels = frames_to_uint8(frames)
    path = str(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)

    video_path = path
    if audio is not None:
        video_path = path + ".video.mp4"

    _write_mp4(pixels, video_path, config)

    if audio is not None:
        wav_path = path + ".audio.wav"
        export_wav(audio, wav_path, sample_rate=audio_sample_rate)
        try:
            _mux_av(video_path, wav_path, path)
            for p in (video_path, wav_path):
                Path(p).unlink(missing_ok=True)
        except (ImportError, ModuleNotFoundError, OSError) as e:
            # No ffmpeg binary: keep silent video at `path` + side WAV
            log.warning("AAC mux unavailable (%s); wrote side WAV %s",
                        e, wav_path)
            Path(video_path).rename(path)
    return path


def _write_mp4(pixels: np.ndarray, path: str,
               config: VideoExportConfig) -> None:
    codec = config.ffmpeg_codec  # validate before the fallback chain
    try:
        import imageio

        with imageio.get_writer(path, fps=config.fps, codec=codec,
                                quality=config.quality * 10.0,
                                pixelformat=config.pixel_format) as writer:
            for frame in pixels:
                writer.append_data(frame)
        return
    except Exception as e:  # imageio-ffmpeg missing or codec unavailable
        # The cv2 fallback encodes mp4v at default quality — it cannot
        # honor explicit codec/quality/pixel_format. If the caller asked
        # for non-defaults (e.g. a serve request that was validated and
        # 200'd), failing loudly beats silently shipping a different
        # encoding; defaults degrade gracefully (smoke/test environments).
        if config.requires_ffmpeg():
            from ltx_jax.core.errors import ExportFailedError

            raise ExportFailedError(
                f"ffmpeg mp4 writer failed ({e}) and the requested "
                f"codec={config.codec} quality={config.quality} "
                f"pixel_format={config.pixel_format} cannot be honored by "
                "the OpenCV fallback (mp4v, fixed quality)") from e
        log.warning("imageio mp4 writer failed (%s); falling back to "
                    "OpenCV mp4v at default quality", e)

    import cv2

    f, h, w, _ = pixels.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    vw = cv2.VideoWriter(path, fourcc, config.fps, (w, h))
    if not vw.isOpened():
        from ltx_jax.core.errors import ExportFailedError

        raise ExportFailedError(f"cannot open video writer for {path}")
    for frame in pixels:
        vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    vw.release()


def _mux_av(video_path: str, wav_path: str, out_path: str) -> None:
    """Mux video + AAC audio with the imageio-ffmpeg binary."""
    import subprocess

    import imageio_ffmpeg

    ffmpeg = imageio_ffmpeg.get_ffmpeg_exe()
    subprocess.run(
        [ffmpeg, "-y", "-i", video_path, "-i", wav_path,
         "-c:v", "copy", "-c:a", "aac", "-shortest", out_path],
        check=True, capture_output=True,
    )


def export_wav(audio, path: str, sample_rate: int = 24000) -> str:
    """(C, samples) or (samples,) floats in [-1, 1] -> 16-bit PCM WAV
    (reference: AudioExporter.swift:19-103)."""
    arr = np.asarray(audio, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    channels, _ = arr.shape
    pcm = np.clip(arr * 32767.0, -32768, 32767).astype(np.int16)
    interleaved = pcm.T.reshape(-1)  # (samples, C) interleaved

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(interleaved.tobytes())
    return str(path)


def export_frames_png(frames, directory: str, prefix: str = "frame") -> list:
    """Dump frames as PNGs (debug / golden comparisons)."""
    from PIL import Image

    pixels = frames_to_uint8(frames)
    Path(directory).mkdir(parents=True, exist_ok=True)
    paths = []
    for i, frame in enumerate(pixels):
        p = Path(directory) / f"{prefix}_{i:04d}.png"
        Image.fromarray(frame).save(p)
        paths.append(str(p))
    return paths


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """Image file -> (1, 3, 1, H, W) float32 in [-1, 1] for I2V conditioning
    (reference: LatentUtils.swift:343-392: /127.5 - 1, high-quality resize)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize(
        (width, height), Image.LANCZOS
    )
    arr = np.asarray(img, np.float32) / 127.5 - 1.0  # (H, W, 3)
    return arr.transpose(2, 0, 1)[None, :, None]  # (1, 3, 1, H, W)


def load_video(path: str, width: int, height: int,
               num_frames: int, sample: str = "even") -> np.ndarray:
    """Video file -> (1, 3, F, H, W) float32 in [-1, 1] (training data prep).

    sample="even": frames are evenly sampled (np.linspace over the clip)
    when the clip length differs from num_frames, then LANCZOS-resized —
    the temporal analog of load_image's treatment (reference pixel
    convention: LatentUtils.swift:343-392, /127.5 - 1). sample="tail":
    the clip's LAST num_frames consecutive frames (video extension needs
    the exact tail, not a resample; raises if the clip is shorter).
    Reader: OpenCV first (the writer's reliable backend in this
    environment), imageio fallback.
    """
    frames = _read_frames(str(path))
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    if sample == "tail":
        if len(frames) < num_frames:
            raise IOError(
                f"clip has {len(frames)} frames < {num_frames} requested "
                "tail frames")
        idx = np.arange(len(frames) - num_frames, len(frames))
    elif sample == "even":
        idx = np.linspace(0, len(frames) - 1, num_frames).round().astype(int)
    else:
        raise ValueError(f"unknown sample mode {sample!r}")
    from PIL import Image

    out = np.empty((num_frames, height, width, 3), np.float32)
    for j, i in enumerate(idx):
        img = Image.fromarray(frames[i]).resize((width, height),
                                                Image.LANCZOS)
        out[j] = np.asarray(img, np.float32) / 127.5 - 1.0
    return out.transpose(3, 0, 1, 2)[None]  # (1, 3, F, H, W)


def _read_frames(path: str) -> list:
    """Decode every frame as (H, W, 3) uint8 RGB."""
    try:
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        cap.release()
        if frames:
            return frames
    except ImportError:
        pass
    import imageio.v2 as iio

    return [np.asarray(f)[..., :3] for f in iio.mimread(path, memtest=False)]
