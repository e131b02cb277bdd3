"""Contract benchmarks: every headline config from BASELINE.md on one GPU.

Measures, at the REAL production shapes (random weights — timing-faithful,
output is noise), each phase ending in block_until_ready:

  1. prompt enhancement   — Gemma-12B int4 generate, 512 new tokens
  2. text encoding        — Gemma forward + feature extractor + connector
  3. north star           — 25f@768x512 distilled 8-step denoise + VAE decode
                            (e2e = 1 + 2 + denoise + decode; ref M3 Max 113 s)
  4. dev 40-step CFG      — s/step with 2 guidance rows, e2e estimate
                            (ref 799 s at 25f; per-step at 121f: 80.5 s)
  5. two-stage 8+3        — stage-1 half-res denoise + upscaler + 3-step
                            full-res refine + decode (ref 81 s at 25f)
  6. 121f distilled step  — s/step at T=6144

Stages construction phase-by-phase the way the pipeline does under phase
staging (Gemma freed before the DiT phase).

Run: python scripts/contract_bench.py [--fast]  (--fast skips 121f + dev-CFG)
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

BASE = {  # reference M3 Max numbers (BASELINE.md)
    "north_star_e2e_s": 113.0,
    "dev_cfg_e2e_s": 799.0,
    "two_stage_e2e_s": 81.0,
    "dit_121f_s_per_step": 30.9,
    "flagship_e2e_s": 1243.0,  # 241f@1024x640 two-stage + audio
}


def sync(x):
    jax.block_until_ready(x)


def log(msg):
    print(f"[contract_bench] {msg}", file=sys.stderr, flush=True)


def phase_gemma(results):
    """Enhancement + text encoding with Gemma-12B at true shapes.

    W8A8 (per-channel int8, s8 x s8 dots) — the production default
    (pipeline/loader.py gemma_quant="w8a8"). Sequential decode: random
    weights are adversarial zero-accept for the spec-decode default, so the
    speculative path is measured separately (bench.py spec_enhance_demo)."""
    from ltx_jax.models import gemma3, text_encoder
    from scripts.e2e_bench import build_gemma_int4

    gcfg = gemma3.Gemma3Config()
    tecfg = text_encoder.TextEncoderConfig()
    gparams = build_gemma_int4(gcfg, mode="w8a8")
    sync(gparams["norm"]["w"])

    # --- prompt enhancement: ~800-token chat prompt (system prompt + user),
    # 512 new tokens, device-side loop (reference: LTXPipeline.swift:2862)
    ids = np.random.randint(5, gcfg.vocab_size - 5, (1, 800)).astype(np.int32)
    # stop_tokens=() -> full 512 tokens (random weights sample near-
    # uniformly and would hit the stop id after a few tokens); worst case.
    t0 = time.time()
    toks = gemma3.generate_tokens(gparams, ids, gcfg, jax.random.key(1),
                                  max_new_tokens=512, stop_tokens=())
    results["enhance_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    toks = gemma3.generate_tokens(gparams, ids, gcfg, jax.random.key(2),
                                  max_new_tokens=512, stop_tokens=())
    results["enhance_s"] = round(time.time() - t0, 2)
    results["enhance_tokens"] = len(toks)
    log(f"enhance: {results['enhance_s']} s for {len(toks)} tokens "
        f"(compile {results['enhance_compile_s']} s)")

    # --- text encoding (1024-token padded prompt), STAGED like the
    # pipeline (generate.py::encode_prompt with phase_staging): w8a8 Gemma
    # (12.8 GB) and the connector (~2.2 GB) never co-reside — the Gemma
    # tower runs first, its (49, 1, 1024, 3840) hidden states stay on
    # device, gparams free, then the connector comes up.
    ids = jnp.ones((1, 1024), jnp.int32)
    mask = jnp.ones((1, 1024), jnp.int32)
    tower = jax.jit(lambda gp, i, m: gemma3.forward_hidden_states(
        gp, i, m, gcfg))
    conn = jax.jit(lambda tp, h, m: text_encoder.encode_from_hidden_states(
        tp, h, m, tecfg))
    t0 = time.time()
    hidden = tower(gparams, ids, mask)
    sync(hidden)
    tower_compile = time.time() - t0
    t0 = time.time()
    hidden = tower(gparams, ids, mask)
    sync(hidden)
    tower_s = time.time() - t0
    del gparams
    gc.collect()
    teparams = text_encoder.init_params(jax.random.key(0), tecfg, jnp.bfloat16)
    sync(jax.tree.leaves(teparams)[0])
    t0 = time.time()
    out = conn(teparams, hidden, mask)
    sync(out["video"])
    results["text_encode_compile_s"] = round(
        tower_compile + time.time() - t0, 1)
    t0 = time.time()
    out = conn(teparams, hidden, mask)
    emb = np.asarray(out["video"])
    results["text_encode_s"] = round(tower_s + time.time() - t0, 2)
    log(f"text encode: {results['text_encode_s']} s (staged: tower "
        f"{tower_s:.2f} + connector)")
    del teparams, out, conn, tower, hidden
    gc.collect()
    return emb


def time_denoise(step, latent0, sigmas, key, warm_steps=1):
    """Compile (first call) then run the full schedule; returns
    (compile_s, total_s, s_per_step)."""
    vel = jnp.zeros_like(latent0)
    t0 = time.time()
    # the step DONATES its latent input: warm up on a copy
    l1, v1 = step(jnp.array(latent0), float(sigmas[0]), float(sigmas[1]), vel,
                  jnp.asarray(False), key)
    sync(l1)
    compile_s = time.time() - t0
    from ltx_jax.pipeline.denoise import run_denoise_loop

    t0 = time.time()
    out = run_denoise_loop(step, latent0, sigmas, key=key)
    sync(out)
    total = time.time() - t0
    return compile_s, total, total / max(len(sigmas) - 1, 1), out


def phase_dit(results, emb, fast):
    from ltx_jax.core.config import TransformerConfig
    from ltx_jax.ops import schedule
    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.pipeline.denoise import (
        GuidanceSpec, build_guidance_context, make_denoise_step,
    )
    import bench as dit_bench

    tcfg = TransformerConfig()
    params = dit_bench.build_params(tcfg, bits=4)
    sync(params["scale_shift_table"])
    emb = jnp.asarray(emb, jnp.bfloat16)
    mask = jnp.ones(emb.shape[:2], jnp.float32)

    no_guide = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx1, bias1 = build_guidance_context(no_guide, emb, mask, None, None)

    # --- north-star: 25f@768x512 distilled, 8 steps (1536 tokens)
    shape = VideoLatentShape.from_pixels(1, 25, 512, 768)
    step = make_denoise_step(params, tcfg, no_guide, shape, ctx1, bias1)
    sig = schedule.get_sigmas(8, distilled=True, token_count=shape.token_count)
    lat = jax.random.normal(jax.random.key(3), shape.shape) * float(sig[0])
    c, tot, sps, lat_out = time_denoise(step, lat, sig, jax.random.key(4))
    results["ns_dit_compile_s"] = round(c, 1)
    results["ns_denoise_8steps_s"] = round(tot, 2)
    results["ns_s_per_step"] = round(sps, 3)
    log(f"north-star denoise: {tot:.2f} s (compile {c:.1f} s)")

    # --- stage-2 refine (same step fn + shapes -> no recompile), 3 steps
    sig2 = schedule.STAGE_2_SIGMAS
    t0 = time.time()
    from ltx_jax.pipeline.denoise import run_denoise_loop

    out = run_denoise_loop(step, lat, sig2, key=jax.random.key(5))
    sync(out)
    results["stage2_3steps_s"] = round(time.time() - t0, 2)
    log(f"stage-2 3-step refine: {results['stage2_3steps_s']} s")

    # --- two-stage stage 1: half res 384x256 (384 tokens), 8 steps
    shape_h = VideoLatentShape.from_pixels(1, 25, 256, 384)
    step_h = make_denoise_step(params, tcfg, no_guide, shape_h, ctx1, bias1)
    sig_h = schedule.get_sigmas(8, distilled=True,
                                token_count=shape_h.token_count)
    lat_h = jax.random.normal(jax.random.key(6), shape_h.shape) * float(sig_h[0])
    c, tot, _, stage1_lat = time_denoise(step_h, lat_h, sig_h,
                                         jax.random.key(7))
    results["stage1_dit_compile_s"] = round(c, 1)
    results["stage1_denoise_8steps_s"] = round(tot, 2)
    log(f"stage-1 half-res denoise: {tot:.2f} s (compile {c:.1f} s)")

    if not fast:
        # --- dev 40-step CFG (2 guidance rows) at 25f: s/step
        cfg_guide = GuidanceSpec(True, 4.0, 0.0, 0.0, (29,), 0.0, 1.0)
        ctx2, bias2 = build_guidance_context(cfg_guide, emb, mask, emb, mask)
        step_cfg = make_denoise_step(params, tcfg, cfg_guide, shape,
                                     ctx2, bias2)
        sig_dev = schedule.get_sigmas(40, distilled=False,
                                      token_count=shape.token_count)
        vel = jnp.zeros_like(lat)
        t0 = time.time()
        l1, _ = step_cfg(jnp.array(lat), float(sig_dev[0]), float(sig_dev[1]),
                         vel, jnp.asarray(False), jax.random.key(8))
        sync(l1)
        results["dev_cfg_compile_s"] = round(time.time() - t0, 1)
        n = 4
        t0 = time.time()
        cur = jnp.array(lat)
        for i in range(n):
            cur, vel = step_cfg(cur, float(sig_dev[i]), float(sig_dev[i + 1]),
                                vel, jnp.asarray(i > 0), jax.random.key(9))
        sync(cur)
        results["dev_cfg_s_per_step"] = round((time.time() - t0) / n, 3)
        log(f"dev CFG: {results['dev_cfg_s_per_step']} s/step")

        # --- 121f distilled s/step
        shape_l = VideoLatentShape.from_pixels(1, 121, 512, 768)
        step_l = make_denoise_step(params, tcfg, no_guide, shape_l,
                                   ctx1, bias1)
        sig_l = schedule.get_sigmas(8, distilled=True,
                                    token_count=shape_l.token_count)
        lat_l = jax.random.normal(jax.random.key(10), shape_l.shape) \
            * float(sig_l[0])
        vel = jnp.zeros_like(lat_l)
        t0 = time.time()
        l1, _ = step_l(jnp.array(lat_l), float(sig_l[0]), float(sig_l[1]),
                       vel, jnp.asarray(False), jax.random.key(11))
        sync(l1)
        results["dit121_compile_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        cur = jnp.array(lat_l)
        for i in range(4):
            cur, vel = step_l(cur, float(sig_l[i]), float(sig_l[i + 1]), vel,
                              jnp.asarray(i > 0), jax.random.key(12))
        sync(cur)
        results["dit_121f_s_per_step"] = round((time.time() - t0) / 4, 3)
        log(f"121f distilled: {results['dit_121f_s_per_step']} s/step")

    del params
    gc.collect()
    return np.asarray(lat_out), np.asarray(stage1_lat)


def phase_upscaler(results, stage1_lat):
    from ltx_jax.models import upscaler as up_mod

    ucfg = up_mod.UpscalerConfig()
    uparams = up_mod.init_params(jax.random.key(13), ucfg, dtype=jnp.bfloat16)
    sync(uparams["initial_conv"]["b"])
    mean = jnp.zeros((128,), jnp.float32)
    std = jnp.ones((128,), jnp.float32)
    up = jax.jit(lambda p, x: up_mod.upsample_latents(p, x, mean, std, ucfg))
    x = jnp.asarray(stage1_lat)
    t0 = time.time()
    y = up(uparams, x)
    sync(y)
    results["upscaler_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    y = up(uparams, x)
    sync(y)
    results["upscale_s"] = round(time.time() - t0, 2)
    log(f"upscaler: {results['upscale_s']} s")
    del uparams
    gc.collect()


def phase_vae(results, latent):
    from ltx_jax.models import vae

    vcfg = vae.VAEConfig()
    vparams = vae.init_decoder_params(jax.random.key(14), vcfg,
                                      dtype=jnp.bfloat16)
    sync(vparams["conv_in"]["b"])
    dec = jax.jit(lambda p, l: vae.decoder_forward(
        p, l.astype(jnp.bfloat16), vcfg, timestep=None))
    lat = jnp.asarray(latent)
    t0 = time.time()
    frames = dec(vparams, lat)
    sync(frames)
    results["vae_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    frames = dec(vparams, lat)
    sync(frames)
    results["vae_decode_25f_s"] = round(time.time() - t0, 2)
    log(f"VAE decode 25f: {results['vae_decode_25f_s']} s")


def build_av_params_int4(tcfg):
    """Production-shape int4 dual AV transformer (models/dit_av.py layout),
    host-built like bench.build_params. ~11.5 GB int4 on device."""
    import bench as dit_bench
    from ltx_jax.models import dit_av  # noqa: F401 (layout reference)

    dv, da = tcfg.inner_dim, tcfg.audio_inner_dim
    nl = tcfg.num_layers

    def q(i, o):
        return dit_bench.build_quantized_linear(nl, i, o, bits=4)

    def attn(qd, cd, inner):
        return {
            "to_q": q(qd, inner), "to_k": q(cd, inner), "to_v": q(cd, inner),
            "to_out": q(inner, qd),
            "q_norm": {"w": jnp.ones((nl, inner), jnp.bfloat16)},
            "k_norm": {"w": jnp.ones((nl, inner), jnp.bfloat16)},
        }

    def norm(d):
        return {"w": jnp.ones((nl, d), jnp.bfloat16)}

    blocks = {
        "norm1": norm(dv), "attn1": attn(dv, dv, dv),
        "norm2": norm(dv),
        "attn2": attn(dv, tcfg.cross_attention_dim, dv),
        "norm3": norm(dv),
        "ff": {"project_in": q(dv, tcfg.ffn_dim),
               "project_out": q(tcfg.ffn_dim, dv)},
        "scale_shift_table": jnp.zeros((nl, 6, dv), jnp.float32),
        "audio_norm1": norm(da), "audio_attn1": attn(da, da, da),
        "audio_norm2": norm(da),
        "audio_attn2": attn(da, tcfg.audio_cross_attention_dim, da),
        "audio_norm3": norm(da),
        "audio_ff": {"project_in": q(da, 4 * da),
                     "project_out": q(4 * da, da)},
        "audio_scale_shift_table": jnp.zeros((nl, 6, da), jnp.float32),
        "audio_to_video_norm": norm(dv),
        "audio_to_video_attn": attn(dv, da, da),
        "video_to_audio_norm": norm(da),
        "video_to_audio_attn": attn(da, dv, da),
        "scale_shift_table_a2v_ca_video": jnp.zeros((nl, 5, dv), jnp.float32),
        "scale_shift_table_a2v_ca_audio": jnp.zeros((nl, 5, da), jnp.float32),
    }

    def dense(i, o):
        return {"w": jnp.zeros((i, o), jnp.bfloat16),
                "b": jnp.zeros((o,), jnp.bfloat16)}

    def adaln(d, n):
        return {"emb": {"linear_1": dense(256, d), "linear_2": dense(d, d)},
                "linear": dense(d, n * d)}

    return {
        "blocks": blocks,
        "patchify_proj": dense(tcfg.in_channels, dv),
        "adaln_single": adaln(dv, 6),
        "caption_projection": {
            "linear_1": dense(tcfg.caption_channels, dv),
            "linear_2": dense(dv, dv)},
        "proj_out": dense(dv, tcfg.out_channels),
        "scale_shift_table": jnp.zeros((2, dv), jnp.float32),
        "audio_patchify_proj": dense(tcfg.audio_in_channels, da),
        "audio_adaln_single": adaln(da, 6),
        "audio_caption_projection": {
            "linear_1": dense(tcfg.caption_channels, da),
            "linear_2": dense(da, da)},
        "audio_proj_out": dense(da, tcfg.audio_out_channels),
        "audio_scale_shift_table": jnp.zeros((2, da), jnp.float32),
        "av_ca_video_scale_shift_adaln_single": adaln(dv, 4),
        "av_ca_a2v_gate_adaln_single": adaln(dv, 1),
        "av_ca_audio_scale_shift_adaln_single": adaln(da, 4),
        "av_ca_v2a_gate_adaln_single": adaln(da, 1),
    }


def phase_flagship(results, emb):
    """The 241f@1024x640 two-stage + audio FLAGSHIP config
    (reference: flying-car/README.md:13-14 — 1243-1289 s e2e on M3 Max).

    Stage 1: dual AV denoise at 512x320 (4960 video tokens), 8 steps.
    Upscale 2x + stage 2: 3-step dual refine at 1024x640 (19840 tokens).
    Decode: temporally-tiled video decode of all 241 frames + audio
    VAE/vocoder. Every phase at production shapes, int4 AV transformer.
    """
    from ltx_jax.core.config import TransformerConfig
    from ltx_jax.models import audio_vae as av_mod
    from ltx_jax.models import dit_av, upscaler as up_mod, vae
    from ltx_jax.ops import schedule
    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.pipeline.denoise import (
        GuidanceSpec, build_guidance_context, make_av_denoise_step,
        run_av_denoise_loop,
    )

    tcfg = TransformerConfig()
    frames, width, height, fps = 241, 1024, 640, 24.0
    e2e = results["enhance_s"] + results["text_encode_s"]

    params = build_av_params_int4(tcfg)
    sync(params["scale_shift_table"])
    emb = jnp.asarray(emb, jnp.bfloat16)
    mask = jnp.ones(emb.shape[:2], jnp.float32)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    v_ctx, bias = build_guidance_context(g, emb, mask, None, None)
    # the audio connector emits the same (1, S, 3840) caption width; the AV
    # transformer's audio_caption_projection maps it to the audio stream
    a_ctx, _ = build_guidance_context(g, emb, mask, None, None)

    audio_frames = dit_av.audio_frame_count(frames / fps)
    s1_shape = VideoLatentShape.from_pixels(1, frames, height // 2,
                                            width // 2)
    s1_sig = schedule.get_sigmas(8, distilled=True,
                                 token_count=s1_shape.token_count)
    key = jax.random.key(0)
    vlat = jax.random.normal(key, s1_shape.shape) * float(s1_sig[0])
    alat = (jax.random.normal(jax.random.key(1),
                              (1, audio_frames, tcfg.audio_in_channels))
            * float(s1_sig[0]))

    step1 = make_av_denoise_step(params, tcfg, g, s1_shape, audio_frames,
                                 v_ctx, a_ctx, bias)
    t0 = time.time()
    v1, a1 = step1(jnp.array(vlat), jnp.array(alat), float(s1_sig[0]),
                   float(s1_sig[1]), jax.random.key(2))
    sync(v1)
    results["flagship_s1_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    vlat, alat = run_av_denoise_loop(step1, vlat, alat, s1_sig,
                                     key=jax.random.key(3))
    sync(vlat)
    results["flagship_s1_denoise_s"] = round(time.time() - t0, 2)
    e2e += results["flagship_s1_denoise_s"]
    log(f"flagship stage-1 (4960 tok, 8 steps): "
        f"{results['flagship_s1_denoise_s']} s")

    # upscale 2x (bf16 upscaler)
    ucfg = up_mod.UpscalerConfig()
    uparams = up_mod.init_params(jax.random.key(4), ucfg, dtype=jnp.bfloat16)
    mean = jnp.zeros((128,), jnp.float32)
    std = jnp.ones((128,), jnp.float32)
    up = jax.jit(lambda p, x: up_mod.upsample_latents(p, x, mean, std, ucfg))
    _ = up(uparams, jnp.array(vlat)); sync(_)
    t0 = time.time()
    vlat2 = up(uparams, vlat)
    sync(vlat2)
    results["flagship_upscale_s"] = round(time.time() - t0, 2)
    e2e += results["flagship_upscale_s"]
    del uparams
    gc.collect()

    # stage 2: 19840 tokens, 3 steps
    s2_shape = VideoLatentShape.from_pixels(1, frames, height, width)
    s2_sig = schedule.STAGE_2_SIGMAS
    vlat2 = (float(s2_sig[0]) * jax.random.normal(jax.random.key(5),
                                                  s2_shape.shape)
             + (1 - float(s2_sig[0])) * vlat2)
    step2 = make_av_denoise_step(params, tcfg, g, s2_shape, audio_frames,
                                 v_ctx, a_ctx, bias, video_euler="plain")
    t0 = time.time()
    v1, a1 = step2(jnp.array(vlat2), jnp.array(alat), float(s2_sig[0]),
                   float(s2_sig[1]), jax.random.key(6))
    sync(v1)
    results["flagship_s2_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    vlat2, alat = run_av_denoise_loop(step2, vlat2, alat, s2_sig,
                                      key=jax.random.key(7))
    sync(vlat2)
    results["flagship_s2_denoise_s"] = round(time.time() - t0, 2)
    e2e += results["flagship_s2_denoise_s"]
    log(f"flagship stage-2 (19840 tok, 3 steps): "
        f"{results['flagship_s2_denoise_s']} s")
    del params, step1, step2, v1, a1
    gc.collect()

    # tiled video decode of all 241 frames
    vcfg = vae.VAEConfig()
    vparams = vae.init_decoder_params(jax.random.key(8), vcfg,
                                      dtype=jnp.bfloat16)
    sync(vparams["conv_in"]["b"])
    t0 = time.time()
    frames_px = vae.decode_video(vparams, vlat2, vcfg, timestep=None,
                                 tile_size=8, tile_overlap=1,
                                 transfer_uint8=True)
    results["flagship_vae_decode_compile_incl_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    frames_px = vae.decode_video(vparams, vlat2, vcfg, timestep=None,
                                 tile_size=8, tile_overlap=1,
                                 transfer_uint8=True)
    results["flagship_vae_decode_s"] = round(time.time() - t0, 2)
    e2e += results["flagship_vae_decode_s"]
    log(f"flagship VAE decode (241f tiled): "
        f"{results['flagship_vae_decode_s']} s  shape={frames_px.shape}")
    del vparams
    gc.collect()

    # audio decode (audio VAE + vocoder) at production shapes
    avcfg = av_mod.AudioVAEConfig()
    voccfg = av_mod.VocoderConfig()
    avp = av_mod.init_audio_vae_params(jax.random.key(9), avcfg)
    vocp = av_mod.init_vocoder_params(jax.random.key(10), voccfg)
    lat = dit_av.unpack_audio_latents(alat, channels=8,
                                      mel=tcfg.audio_in_channels // 8)
    wav = av_mod.decode_audio(avp, vocp, lat, avcfg, voccfg)
    sync(wav)
    t0 = time.time()
    wav = av_mod.decode_audio(avp, vocp, lat, avcfg, voccfg)
    sync(wav)
    results["flagship_audio_decode_s"] = round(time.time() - t0, 2)
    e2e += results["flagship_audio_decode_s"]
    results["flagship_e2e_s"] = round(e2e, 2)
    log(f"flagship e2e: {e2e:.2f} s (ref 1243 s)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="skip dev-CFG and 121f measurements")
    ap.add_argument("--flagship", action="store_true",
                    help="also run the 241f@1024x640 two-stage+audio config")
    args = ap.parse_args()

    results = {}
    t_all = time.time()
    emb = phase_gemma(results)
    lat25, stage1 = phase_dit(results, emb, args.fast)
    phase_upscaler(results, stage1)
    phase_vae(results, lat25)
    if args.flagship:
        phase_flagship(results, emb)

    enh = results["enhance_s"]
    te = results["text_encode_s"]
    vae_s = results["vae_decode_25f_s"]

    results["north_star_e2e_s"] = round(
        enh + te + results["ns_denoise_8steps_s"] + vae_s, 2)
    results["two_stage_e2e_s"] = round(
        enh + te + results["stage1_denoise_8steps_s"] + results["upscale_s"]
        + results["stage2_3steps_s"] + vae_s, 2)
    if "dev_cfg_s_per_step" in results:
        results["dev_cfg_e2e_s"] = round(
            enh + 2 * te + 40 * results["dev_cfg_s_per_step"] + vae_s, 2)

    for k, base in BASE.items():
        if k in results:
            results[f"{k}_vs_ref"] = round(base / results[k], 1)
    results["wall_total_s"] = round(time.time() - t_all, 1)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
