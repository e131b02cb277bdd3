"""Smoke run of the LTX-2 pipeline on one NVIDIA GPU, at full model width.

Builds random weights on the device from --seed at the published widths —
the 48-block video DiT in bf16 (the `generate` default), Gemma-3-12B in
W8A8 (the Gemma default), the text connector and the VAE decoder — and
drives them through `LTXPipeline` and `serve.build_app`:

  0. the kernel checks (ltx_jax.kernels.checks): every kernel path against
     its plain f32 reference at T=6144, 32 heads, head dim 128;
  1. prompt enhancement: 32 new tokens, speculative decoding spec_k=8;
  2. text encoding;
  3. the 8-step distilled denoise at 25 frames, 768x512 (T=1536);
  4. the VAE decode;
  5. two concurrent POST /v1/enhance requests on the same pipeline.

Phases 1-5 run twice: the first pass compiles, the second measures; the
difference is reported as compile time. MP4 export is skipped (its packages
are not needed to prove the device path).

--four-cards runs one phase only: the DiT sharded with
`LTXPipeline.shard(make_mesh(1, 4))` and ring attention, one bf16 denoise
step at 121 frames 768x512 (T=6144), compared with the same step on one
card.

Exits non-zero on any failure, and without a result line when JAX finds no
GPU or the repository is not beside this file. The last line of stdout is
{"ok": true, "device": {"platform", "kind", "count"}}.

Run from the repository root: python3 chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

# one process owns the card: let it use most of the memory
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")

OFF_PATH_MODULES = ("tokenizers", "safetensors", "PIL", "imageio", "cv2",
                    "huggingface_hub")
PROMPT = "a beaver building a dam at sunset, cinematic lighting"
ENHANCE_TOKENS = 32
# --four-cards: RMS of (ring step - one-card step) over RMS of the one-card
# step. Both run the bf16 DiT; they differ only in summation order (TP
# all-reduces, the ring's merge, flash kernel vs cuDNN inside attention),
# i.e. in bf16 roundings (2^-9 relative) that random-walk through 48 blocks.
FOUR_CARD_RTOL = 2.0 ** -5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit, read by a child that stays off
    JAX (the card's limit bounds every time printed below)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


class ByteTokenizer:
    """UTF-8 bytes as token ids, past Gemma's pad/eos/bos ids. Stands in
    for tokenizer.json so the run needs no `tokenizers` package."""

    OFFSET = 3

    def encode(self, text: str):
        return types.SimpleNamespace(
            ids=[b + self.OFFSET for b in text.encode()])

    def decode(self, ids) -> str:
        return bytes((int(i) - self.OFFSET) % 256 for i in ids
                     if int(i) >= self.OFFSET).decode("utf-8", "replace")


def peak_gb() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def build_gemma_w8a8(key, gcfg):
    """Gemma-3 params with every block linear in W8A8, built on the
    device: bf16 random init, then per-channel int8 (the loader's schema)."""
    import jax
    import jax.numpy as jnp

    from ltx_jax.kernels.quantization import (
        QUANTIZABLE_LEAVES, quantize_int8_channel,
    )
    from ltx_jax.models import gemma3

    def build(k):
        p = gemma3.init_params(k, gcfg, jnp.bfloat16)
        p["layers"] = {
            name: (quantize_int8_channel(leaf["w"])
                   if name in QUANTIZABLE_LEAVES else leaf)
            for name, leaf in p["layers"].items()}
        return p

    return jax.jit(build)(key)


def build_pipeline(seed: int, tcfg=None, gcfg=None, tecfg=None, vcfg=None):
    """LTXPipeline at the published widths with random weights (device-
    built from `seed`). Configs default to the published ones; a caller
    may pass smaller ones to rehearse the flow."""
    import jax
    import jax.numpy as jnp

    from ltx_jax.core.config import MemoryConfig, TransformerConfig
    from ltx_jax.models import dit, gemma3, text_encoder, vae
    from ltx_jax.pipeline.generate import LTXPipeline

    tcfg = tcfg or TransformerConfig()
    gcfg = gcfg or gemma3.Gemma3Config()
    tecfg = tecfg or text_encoder.TextEncoderConfig()
    vcfg = vcfg or vae.VAEConfig()
    k_gemma, k_te, k_vae, k_dit = jax.random.split(jax.random.key(seed), 4)
    t0 = time.perf_counter()
    gemma = build_gemma_w8a8(k_gemma, gcfg)
    te = jax.jit(lambda k: text_encoder.init_params(
        k, tecfg, jnp.bfloat16))(k_te)
    vae_p = jax.jit(lambda k: vae.init_decoder_params(
        k, vcfg, jnp.bfloat16))(k_vae)
    dit_p = jax.jit(lambda k: dit.init_params(k, tcfg, jnp.bfloat16))(k_dit)
    jax.block_until_ready((gemma, te, vae_p, dit_p))
    n_params = sum(x.size for x in jax.tree.leaves((gemma, te, vae_p, dit_p)))
    log(f"weights: {n_params / 1e9:.2f}e9 values built on the device in "
        f"{time.perf_counter() - t0:.1f} s (seed {seed}); "
        f"peak {peak_gb():.1f} GB")
    return LTXPipeline(
        transformer_params=dit_p, transformer_config=tcfg,
        vae_decoder_params=vae_p, vae_config=vcfg,
        gemma_params=gemma, gemma_config=gcfg,
        text_encoder_params=te, text_encoder_config=tecfg,
        tokenizer=ByteTokenizer(), is_distilled=True,
        # Gemma stays resident: the second pass and serve use it again
        memory=MemoryConfig(offload_text_encoder=False))


def describe_paths(pipe, frames: int, height: int, width: int) -> None:
    """Print the attention and matmul implementation each path takes."""
    import jax.numpy as jnp

    from ltx_jax.ops.attention import choose_impl
    from ltx_jax.ops.latents import VideoLatentShape

    tcfg = pipe.tcfg
    t = VideoLatentShape.from_pixels(1, frames, height, width,
                                     channels=tcfg.in_channels).token_count
    q = (1, tcfg.num_heads, t, tcfg.head_dim)
    text = (1, tcfg.num_heads, pipe.tecfg.max_length, tcfg.head_dim)
    key_bias = jnp.zeros((1, 1, 1, pipe.tecfg.max_length))
    causal = jnp.zeros((1, 1, 1024, 1024))
    g = pipe.gcfg
    dit_leaf = pipe.transformer_params["blocks"]["attn1"]["to_q"]
    gemma_leaf = pipe.gemma_params["layers"]["q_proj"]
    log(f"path: DiT self-attention (T={t}): "
        f"{choose_impl(q, q, None, jnp.bfloat16)}")
    log(f"path: DiT cross-attention (T={t} x {text[2]} text, key bias): "
        f"{choose_impl(q, text, key_bias, jnp.bfloat16)}")
    gq = (1, g.attention_heads, 1024, g.head_dim)
    gkv = (1, g.kv_heads, 1024, g.head_dim)
    log(f"path: Gemma attention ({g.attention_heads} q / {g.kv_heads} kv "
        f"heads, causal (Tq, Tk) mask): "
        f"{choose_impl(gq, gkv, causal)} (grouped, no KV repeat)")
    log("path: DiT linears: "
        + ("bf16 dot (XLA -> cuBLAS)" if "w" in dit_leaf else str(dit_leaf)))
    log("path: Gemma linears: "
        + ("W8A8 int8_matmul (s8 x s8 -> s32 dot_general)"
           if "w8" in gemma_leaf else "bf16 dot"))


def run_phases(pipe, seed: int, frames: int, height: int, width: int,
               enhance_tokens: int) -> dict:
    """Enhance -> encode -> denoise -> decode once; returns phase times."""
    import jax
    import numpy as np

    from ltx_jax.core.config import GenerationConfig
    from ltx_jax.pipeline.enhance import enhance_prompts

    times = {}
    t0 = time.perf_counter()
    enhanced = enhance_prompts(
        pipe.gemma_params, pipe.gcfg, pipe.tokenizer, [PROMPT],
        max_tokens=enhance_tokens, spec_k=8, seed=seed, strict=True)[0]
    times["enhance"] = time.perf_counter() - t0
    if not isinstance(enhanced, str) or not enhanced:
        raise RuntimeError(f"enhancement returned {enhanced!r}")

    t0 = time.perf_counter()
    emb = pipe.encode_prompt(enhanced)
    jax.block_until_ready(emb)
    times["text_encode"] = time.perf_counter() - t0
    if not np.isfinite(np.asarray(emb["video"], np.float32)).all():
        raise RuntimeError("text embeddings are not finite")

    config = GenerationConfig(width=width, height=height, num_frames=frames,
                              num_steps=8, seed=seed)
    t0 = time.perf_counter()
    result = pipe.generate_video(enhanced, config,
                                 precomputed_embeddings=emb)
    frames_np = np.asarray(result.frames)
    times["denoise_decode_wall"] = time.perf_counter() - t0
    times["denoise"] = float(sum(result.timings.denoise_steps))
    times["denoise_steps"] = len(result.timings.denoise_steps)
    times["vae_decode"] = float(result.timings.vae_decode)
    want = (frames, height, width, 3)
    if frames_np.shape != want:
        raise RuntimeError(f"frames {frames_np.shape}, expected {want}")
    if not np.isfinite(frames_np).all():
        raise RuntimeError("decoded frames are not finite")
    if times["denoise_steps"] != 8:
        raise RuntimeError(f"{times['denoise_steps']} denoise steps, not 8")
    return times


def serve_enhance(pipe, seed: int, enhance_tokens: int) -> float:
    """Two concurrent /v1/enhance requests through serve.build_app; returns
    the wall time until both answered."""
    from ltx_jax.serve.app import build_app
    from ltx_jax.serve.server import serve_forever_threaded

    with tempfile.TemporaryDirectory() as out_dir:
        app = build_app(pipe, output_dir=out_dir, port=0, max_batch=4,
                        spec_k=8)
        serve_forever_threaded(app.server)
        url = f"http://127.0.0.1:{app.server.server_address[1]}/v1/enhance"
        answers = {}

        def call(name):
            body = json.dumps({"prompts": [f"{name}: {PROMPT}"],
                               "max_tokens": enhance_tokens,
                               "seed": seed}).encode()
            req = urllib.request.Request(
                url, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=900) as r:
                    answers[name] = (r.status, json.loads(r.read()))
            except Exception as e:  # reported below as a failed answer
                answers[name] = (None, repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(n,))
                   for n in ("first", "second")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=1200)
        wall = time.perf_counter() - t0
        app.close()
    for name, (status, body) in sorted(answers.items()):
        ok = (status == 200 and isinstance(body, dict)
              and len(body.get("prompts", [])) == 1
              and isinstance(body["prompts"][0], str))
        if not ok:
            raise RuntimeError(f"/v1/enhance {name}: {status} {body}")
        log(f"serve: /v1/enhance {name} -> {body['prompts'][0][:60]!r}")
    if len(answers) != 2:
        raise RuntimeError(f"/v1/enhance answered {len(answers)} of 2")
    return wall


def one_card(seed: int) -> None:
    from ltx_jax.kernels import checks

    t0 = time.perf_counter()
    for row in checks.run_all():
        log(f"kernel check: {json.dumps(row)}")
    log(f"phase kernel_checks: {time.perf_counter() - t0:.2f} s "
        f"(compile included); peak {peak_gb():.1f} GB")

    pipe = build_pipeline(seed)
    frames, height, width = 25, 512, 768
    describe_paths(pipe, frames, height, width)
    runs = [run_phases(pipe, seed, frames, height, width, ENHANCE_TOKENS)
            for _ in range(2)]
    for name in ("enhance", "text_encode", "denoise", "vae_decode"):
        cold, warm = runs[0][name], runs[1][name]
        log(f"phase {name}: {warm:.3f} s warm; first run {cold:.3f} s, "
            f"compile ~{max(cold - warm, 0.0):.3f} s")
    log(f"phase denoise: {runs[1]['denoise'] / 8 * 1e3:.1f} ms/step warm "
        f"(T=1536, 8 steps)")
    serve = [serve_enhance(pipe, seed, ENHANCE_TOKENS) for _ in range(2)]
    log(f"phase serve_enhance (2 concurrent requests): {serve[1]:.3f} s "
        f"warm; first {serve[0]:.3f} s, compile ~"
        f"{max(serve[0] - serve[1], 0.0):.3f} s")
    log(f"memory: peak_bytes_in_use {peak_gb():.2f} GB")


def denoise_step_velocity(params, tcfg, shape, context, bias, sdpa_impl):
    """One distilled denoise step (sigma 1.0 -> 0.99375) -> velocity (host
    f32)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ltx_jax.pipeline.denoise import GuidanceSpec, make_denoise_step

    guidance = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    step = make_denoise_step(params, tcfg, guidance, shape, context, bias,
                             sdpa_impl=sdpa_impl)
    latent = jax.random.normal(jax.random.key(7), shape.shape, jnp.float32)
    t0 = time.perf_counter()
    _, vel = step(latent, 1.0, 0.99375, jnp.zeros_like(latent),
                  jnp.asarray(False), jax.random.key(8))
    out = np.asarray(vel, np.float32)
    return out, time.perf_counter() - t0


def four_card_compare(seed: int, tcfg=None, frames: int = 121,
                      height: int = 512, width: int = 768,
                      text_len: int = 1024) -> dict:
    """TP + ring denoise step on a (1, 4) mesh against one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ltx_jax.core.config import TransformerConfig
    from ltx_jax.models import dit, vae
    from ltx_jax.ops.attention import prepare_additive_mask, \
        set_sequence_parallel
    from ltx_jax.ops.latents import VideoLatentShape
    from ltx_jax.parallel.sharding import make_mesh
    from ltx_jax.pipeline.denoise import build_guidance_context, GuidanceSpec
    from ltx_jax.pipeline.generate import LTXPipeline

    tcfg = tcfg or TransformerConfig()
    shape = VideoLatentShape.from_pixels(1, frames, height, width,
                                         channels=tcfg.in_channels)
    k_dit, k_ctx = jax.random.split(jax.random.key(seed))
    params = jax.jit(lambda k: dit.init_params(k, tcfg, jnp.bfloat16))(k_dit)
    text = jax.random.normal(k_ctx, (1, text_len, tcfg.caption_channels),
                             jnp.bfloat16)
    mask = (jnp.arange(text_len)[None] < text_len * 3 // 4).astype(jnp.int32)
    guidance = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    context, bias = build_guidance_context(guidance, text, mask)
    if bias is None:
        bias = prepare_additive_mask(mask)

    ref, t_one = denoise_step_velocity(params, tcfg, shape, context, bias,
                                       "auto")
    log(f"four-cards: one-card step {t_one:.2f} s (T={shape.token_count}, "
        "compile included)")
    mesh = make_mesh(data=1, model=4)
    pipe = LTXPipeline(transformer_params=params, transformer_config=tcfg,
                       vae_decoder_params=None, vae_config=vae.VAEConfig(),
                       sdpa_impl="ring")
    del params
    pipe.shard(mesh)
    set_sequence_parallel(mesh)
    try:
        got, t_four = denoise_step_velocity(pipe.transformer_params, tcfg,
                                            shape, context, bias, "ring")
        _, t_four_warm = denoise_step_velocity(
            pipe.transformer_params, tcfg, shape, context, bias, "ring")
    finally:
        set_sequence_parallel(None)
    rms = float(np.sqrt(np.mean(ref ** 2)))
    rel = float(np.sqrt(np.mean((got - ref) ** 2))) / rms
    row = {"tokens": shape.token_count, "rel_rms_err": rel,
           "tol": FOUR_CARD_RTOL,
           "max_abs_err": float(np.max(np.abs(got - ref))),
           "ref_rms": rms, "one_card_first_s": t_one,
           "four_card_first_s": t_four, "four_card_again_s": t_four_warm}
    log(f"four-cards: {json.dumps(row)}")
    if not (np.isfinite(got).all() and rel <= FOUR_CARD_RTOL):
        raise RuntimeError(f"TP+ring step differs from one card: {row}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the TP + ring denoise step on 4 cards "
                         "against one card")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 2
    try:
        import ltx_jax  # noqa: F401
    except ImportError:
        print("chip_smoke: the ltx_jax package is not beside this script; "
              "run it from the repository root", file=sys.stderr)
        return 2
    import jaxlib

    from ltx_jax.utils.compile_cache import enable_compile_cache

    log(card_line())  # verbatim: one "name, power limit" line per card
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"{len(devices)} x {devices[0].device_kind}; compile cache "
        f"{enable_compile_cache()}")
    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{len(devices)}", file=sys.stderr)
            return 2
        four_card_compare(args.seed)
    else:
        one_card(args.seed)
    loaded = [m for m in OFF_PATH_MODULES if m in sys.modules]
    if loaded:
        raise RuntimeError(f"the device path imported {loaded}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
