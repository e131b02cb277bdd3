"""End-to-end benchmark at the real architecture on one GPU.

Stages construction the way the pipeline does under phase staging (text
encoder freed before the DiT phase):
  1. build int4 Gemma-12B + bf16 FE/connector, tokenize + encode, FREE
  2. build int4 19B DiT, run the full distilled 8-step denoise
  3. build bf16 VAE decoder, decode 121 frames

Random weights at the exact production shapes — timing-faithful, output is
noise. Reference e2e at this config: 363 s (BASELINE.md).

Run: python scripts/e2e_bench.py [--frames 121] [--width 768] [--height 512]
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def sync(x):
    jax.block_until_ready(x)


def _tile_layers(host_2d, layers):
    """Upload ONE layer's weight and tile on DEVICE: a (1/layers) upload +
    on-device broadcast is timing-identical to shipping the 6-13 GB
    stacked fixture from the host (the scan still streams every layer
    slice from device memory)."""
    one = jnp.asarray(host_2d)
    return jax.jit(
        lambda a: jnp.tile(a[None], (layers,) + (1,) * a.ndim)
    )(one)


def build_gemma_int4(cfg, mode="int4"):
    def qlin4(layers, i, o):
        host = np.empty((i // 2, o), np.uint8)
        host[:] = 137
        return {"w_q4": _tile_layers(host, layers),
                "scale": jnp.full((layers, i // 64, o), 2e-3, jnp.float32),
                "bias": jnp.full((layers, i // 64, o), -0.25, jnp.float32)}

    def qlin8(layers, i, o):
        host = np.empty((i, o), np.int8)
        host[:] = 53
        return {"w8": _tile_layers(host, layers),
                "sw": jnp.full((layers, o), 1e-3, jnp.float32)}

    qlin = qlin4 if mode == "int4" else qlin8
    nl, d, hd = cfg.hidden_layers, cfg.hidden_size, cfg.head_dim
    layers = {
        "q_proj": qlin(nl, d, cfg.attention_heads * hd),
        "k_proj": qlin(nl, d, cfg.kv_heads * hd),
        "v_proj": qlin(nl, d, cfg.kv_heads * hd),
        "o_proj": qlin(nl, cfg.attention_heads * hd, d),
        "gate_proj": qlin(nl, d, cfg.intermediate_size),
        "up_proj": qlin(nl, d, cfg.intermediate_size),
        "down_proj": qlin(nl, cfg.intermediate_size, d),
    }
    for nrm in ("q_norm", "k_norm"):
        layers[nrm] = {"w": jnp.zeros((nl, hd), jnp.bfloat16)}
    for nrm in ("input_layernorm", "post_attention_layernorm",
                "pre_feedforward_layernorm", "post_feedforward_layernorm"):
        layers[nrm] = {"w": jnp.zeros((nl, d), jnp.bfloat16)}
    params = {
        "embed_tokens": {"w": jnp.zeros((cfg.vocab_size, d), jnp.bfloat16)},
        "layers": layers,
        "norm": {"w": jnp.zeros((d,), jnp.bfloat16)},
    }
    return params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=121)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--height", type=int, default=512)
    args = ap.parse_args()

    from ltx_jax.core.config import TransformerConfig
    from ltx_jax.models import gemma3, text_encoder, vae
    from ltx_jax.ops import schedule
    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.pipeline.denoise import (
        GuidanceSpec, make_denoise_step, run_denoise_loop,
    )
    import bench as dit_bench

    timings = {}
    t_total = time.time()

    # === Phase 1: text encoding (Gemma int4 + FE/connector bf16) ===
    gcfg = gemma3.Gemma3Config()
    tecfg = text_encoder.TextEncoderConfig()
    gparams = build_gemma_int4(gcfg)
    teparams = text_encoder.init_params(jax.random.key(0), tecfg, jnp.bfloat16)
    sync(gparams["norm"]["w"])

    ids = jnp.ones((1, 1024), jnp.int32)
    mask = jnp.ones((1, 1024), jnp.int32)
    enc = jax.jit(lambda gp, tp, i, m: text_encoder.encode_from_hidden_states(
        tp, gemma3.forward_hidden_states(gp, i, m, gcfg), m, tecfg))
    t0 = time.time()
    out = enc(gparams, teparams, ids, mask)
    sync(out["video"])
    timings["text_encode_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    out = enc(gparams, teparams, ids, mask)
    embeddings = jnp.array(out["video"])
    emb_mask = jnp.array(out["mask"])
    sync(embeddings)
    timings["text_encode_s"] = round(time.time() - t0, 2)
    del gparams, teparams, out, enc
    gc.collect()

    # === Phase 2: DiT denoise (int4, distilled 8 steps) ===
    tcfg = TransformerConfig()
    dit_params = dit_bench.build_params(tcfg, bits=4)
    sync(dit_params["scale_shift_table"])
    shape = VideoLatentShape.from_pixels(1, args.frames, args.height,
                                         args.width)
    guidance = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    step = make_denoise_step(dit_params, tcfg, guidance, shape,
                             embeddings.astype(jnp.bfloat16), None)
    sigmas = schedule.get_sigmas(8, distilled=True,
                                 token_count=shape.token_count)
    latent = jax.random.normal(jax.random.key(1), shape.shape) * float(sigmas[0])
    vel = jnp.zeros_like(latent)
    t0 = time.time()
    l1, v1 = step(jnp.array(latent), float(sigmas[0]), float(sigmas[1]),
                  vel, jnp.asarray(False), jax.random.key(2))
    sync(l1)
    timings["dit_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    latent = run_denoise_loop(step, latent, sigmas, key=jax.random.key(3))
    sync(latent)
    timings["denoise_8steps_s"] = round(time.time() - t0, 2)
    del dit_params, step, l1, v1
    gc.collect()

    # === Phase 3: VAE decode (bf16) ===
    vcfg = vae.VAEConfig()
    vparams = vae.init_decoder_params(jax.random.key(4), vcfg,
                                      dtype=jnp.bfloat16)
    sync(vparams["conv_in"]["b"])
    dec = jax.jit(lambda p, l: vae.decoder_forward(
        p, l.astype(jnp.bfloat16), vcfg, timestep=None))
    t0 = time.time()
    frames = dec(vparams, latent)
    sync(frames)
    timings["vae_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    frames = dec(vparams, latent)
    sync(frames)
    timings["vae_decode_s"] = round(time.time() - t0, 2)

    timings["e2e_steady_s"] = round(
        timings["text_encode_s"] + timings["denoise_8steps_s"]
        + timings["vae_decode_s"], 2)
    timings["total_incl_compile_s"] = round(time.time() - t_total, 1)
    print(json.dumps(timings))


if __name__ == "__main__":
    main()
