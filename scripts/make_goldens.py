"""Regenerate the committed golden fixtures (tests/goldens/*.npz).

Run ONLY for intentional numerics changes (new scheduler semantics, a
deliberate kernel change) — and say so in the commit message. CPU-forced
so goldens are independent of the accelerator:

    python scripts/make_goldens.py
"""

import os
import pathlib
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "float32")

import numpy as np  # noqa: E402

from ltx_jax.core.config import GenerationConfig  # noqa: E402
from ltx_jax.pipeline.generate import LTXPipeline  # noqa: E402

OUT = pathlib.Path(__file__).parent.parent / "tests" / "goldens"


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


def save(name, frames, audio=None):
    OUT.mkdir(exist_ok=True)
    f = np.asarray(frames, np.float32)
    stats = np.asarray([f.mean(), f.std(), f.min(), f.max()], np.float32)
    extra = {}
    if audio is not None:
        a = np.asarray(audio, np.float32)
        extra["audio_stats"] = np.asarray(
            [a.mean(), a.std(), a.min(), a.max(), float(a.shape[-1])],
            np.float32)
    # first frame stays f32: the 2e-4 test tolerance is below f16
    # resolution; savez_compressed keeps the file small anyway
    np.savez_compressed(OUT / f"{name}.npz", first_frame=f[0], stats=stats,
                        **extra)
    print(f"{name}: frames {f.shape} mean {stats[0]:.5f} std {stats[1]:.5f}")


def main():
    import dataclasses

    pipe = LTXPipeline.random_tiny(seed=0)
    # keep the text encoder resident: the guided golden needs a SECOND
    # encode (negative prompt) after the first generation
    pipe.memory = dataclasses.replace(pipe.memory,
                                      offload_text_encoder=False)
    save("tiny_t2v",
         pipe.generate_video("golden fixed-seed prompt", _cfg()).frames)
    save("tiny_t2v_guided",
         pipe.generate_video(
             "golden guided prompt",
             _cfg(cfg_scale=4.0, stg_scale=1.0, stg_blocks=(1,), seed=7)).frames)
    save("tiny_two_stage",
         pipe.generate_video_two_stage("golden two-stage prompt",
                                       _cfg(num_frames=9)).frames)
    # round-5 additions: the chain (latent-carry + extension step) and the
    # dual AV path (frames + waveform stats)
    save("tiny_chain",
         pipe.generate_video_chain("golden chain prompt",
                                   _cfg(num_frames=17), segments=2,
                                   cond_frames=9).frames)
    av = LTXPipeline.random_tiny(seed=0, include_audio=True)
    av.memory = dataclasses.replace(av.memory, offload_text_encoder=False)
    r = av.generate_video_with_audio("golden av prompt", _cfg())
    save("tiny_av", r.frames, audio=r.audio)


if __name__ == "__main__":
    main()
