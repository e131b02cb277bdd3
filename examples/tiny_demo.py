"""Runnable offline demo of the public LTXPipeline API.

Real checkpoints are multi-GB downloads; this demo builds a
structurally-faithful TINY pipeline with random weights instead, so the
whole T2V path — tokenizer-free random text embeddings, denoise loop,
VAE decode, MP4 export — runs in about a minute on CPU with zero
downloads. Swap `LTXPipeline.random_tiny()` for `LTXPipeline.load(...)`
(see README "Quick start") to run the real model; every call below is
unchanged.

    python examples/tiny_demo.py [out.mp4]
"""

import sys

import jax

# CPU is fine for the tiny config; on a GPU host, delete this line.
jax.config.update("jax_platforms", "cpu")

from ltx_jax.core.config import GenerationConfig          # noqa: E402
from ltx_jax.io.video import export_video                 # noqa: E402
from ltx_jax.pipeline.generate import LTXPipeline         # noqa: E402


def main(out_path: str = "tiny_demo.mp4") -> None:
    pipe = LTXPipeline.random_tiny(seed=0)

    cfg = GenerationConfig(
        width=64, height=64, num_frames=9,   # 8n+1 frames, /32 dims
        num_steps=4, seed=7,
    )
    cfg.validate()

    result = pipe.generate_video("a tiny test pattern", cfg)
    print(f"frames: {result.frames.shape}  seed: {result.seed}")
    if result.timings is not None:
        print(f"timings: {result.timings}")

    export_video(result.frames, out_path, fps=cfg.fps)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
