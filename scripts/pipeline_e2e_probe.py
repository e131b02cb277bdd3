"""REAL-shape LTXPipeline e2e on one GPU — the PRODUCTION code path.

The contract benches (bench.py, scripts/contract_bench.py) measure each
phase's compiled program directly; this probe drives the same shapes
through `LTXPipeline.generate_video` itself — tokenize -> compiled text
encode -> guidance batching -> jitted denoise loop -> jitted VAE decode —
with int4 fixtures built on the device (Gemma int4 6 GB, then the DiT int4
8 GB after the text phase). chip_smoke.py drives the default formats (bf16
DiT, W8A8 Gemma) with enhancement and serving.

Run: python scripts/pipeline_e2e_probe.py [--frames 25]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--height", type=int, default=512)
    args = ap.parse_args()

    from e2e_bench import build_gemma_int4
    from bench import build_params as build_dit_int4
    from ltx_jax.core.config import GenerationConfig, TransformerConfig
    from ltx_jax.models import gemma3, text_encoder, vae
    from ltx_jax.pipeline.generate import LTXPipeline

    def sync(x):
        jax.block_until_ready(x)

    def log(msg):
        print(f"[pipeline_e2e] {msg}", file=sys.stderr, flush=True)

    t_all = time.time()
    tcfg = TransformerConfig()
    gcfg = gemma3.Gemma3Config()
    tecfg = text_encoder.TextEncoderConfig()
    vcfg = vae.VAEConfig()

    t0 = time.time()
    gparams = build_gemma_int4(gcfg)  # int4: 6 GB (see module docstring)
    teparams = text_encoder.init_params(jax.random.key(0), tecfg,
                                        jnp.bfloat16)
    sync(gparams["norm"]["w"])
    log(f"gemma int4 + connector fixtures: {time.time() - t0:.1f} s")

    # DiT params build AFTER construction; placeholder now, real later
    pipe = LTXPipeline(
        transformer_params=None,
        transformer_config=tcfg,
        vae_decoder_params=None,
        vae_config=vcfg,
        gemma_params=gparams,
        gemma_config=gcfg,
        text_encoder_params=teparams,
        text_encoder_config=tecfg,
        tokenizer=None,  # byte-fallback tokenizer path
        is_distilled=True,
    )

    config = GenerationConfig(width=args.width, height=args.height,
                              num_frames=args.frames, num_steps=8, seed=7)

    # --- text phase through the pipeline (offloads Gemma+connector after)
    t0 = time.time()
    out = pipe.encode_prompt("a beaver building a dam at sunset, "
                             "cinematic lighting, 4k")
    emb_host = np.asarray(out["video"], np.float32)
    log(f"encode_prompt (pipeline): {time.time() - t0:.1f} s "
        f"emb={emb_host.shape} finite={np.isfinite(emb_host).all()}")
    pipe.offload_text_encoder()
    del gparams, teparams, out

    # --- heavy params for the remaining phases
    t0 = time.time()
    pipe.transformer_params = build_dit_int4(tcfg, bits=4)
    sync(pipe.transformer_params["scale_shift_table"])
    log(f"DiT int4 fixture: {time.time() - t0:.1f} s")
    t0 = time.time()
    pipe.vae_decoder_params = vae.init_decoder_params(
        jax.random.key(1), vcfg, dtype=jnp.bfloat16)
    sync(pipe.vae_decoder_params["conv_in"]["b"])
    log(f"VAE fixture: {time.time() - t0:.1f} s")

    # --- full generate_video (re-encodes the prompt? no: Gemma offloaded
    # -> generate_video would fail; use precomputed embeddings, the
    # parity-injection surface)
    t0 = time.time()
    result = pipe.generate_video(
        "ignored", config,
        precomputed_embeddings={
            "video": jnp.asarray(emb_host, jnp.bfloat16),
            "mask": jnp.ones(emb_host.shape[:2], jnp.int32),
        })
    frames = np.asarray(result.frames)
    wall = time.time() - t0
    log(f"generate_video: {wall:.1f} s frames={frames.shape} "
        f"finite={np.isfinite(frames).all()}")
    log("timings:\n" + result.timings.report())
    assert frames.shape == (args.frames, args.height, args.width, 3), \
        frames.shape
    assert np.isfinite(frames).all()
    print(f"PIPELINE E2E OK: {frames.shape} in {wall:.1f} s "
          f"(total wall {time.time() - t_all:.1f} s)")


if __name__ == "__main__":
    main()
