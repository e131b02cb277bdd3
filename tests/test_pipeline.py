"""End-to-end tiny pipeline + denoise step semantics + sharding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.ops.latents import VideoLatentShape
from ltx_jax.pipeline.denoise import (
    GuidanceSpec,
    build_guidance_context,
    make_denoise_step,
    run_denoise_loop,
)
from ltx_jax.pipeline.generate import LTXPipeline


@pytest.fixture(scope="module")
def pipe():
    return LTXPipeline.random_tiny(seed=0)


def _tiny_config(**kw):
    defaults = dict(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    defaults.update(kw)
    return GenerationConfig(**defaults)


def test_t2v_end_to_end(pipe):
    cfg = _tiny_config()
    pipe.memory = dataclasses.replace(pipe.memory, offload_text_encoder=False)
    result = pipe.generate_video("a cat plays piano", cfg)
    assert result.frames.shape == (9, 64, 64, 3)
    f = np.asarray(result.frames)
    assert np.isfinite(f).all() and f.min() >= 0.0 and f.max() <= 1.0
    # distilled schedule: fixed 9-sigma table -> 8 steps regardless of num_steps
    assert len(result.timings.denoise_steps) == 8
    assert result.seed == 42


def test_tokenize_truncation_keeps_last_tokens(pipe):
    """Over-long prompts keep the LAST max_length tokens — the reference
    uses `encoded.suffix(maxLength)` (LTXPipeline.swift:3260-3262); enhanced
    prompts routinely exceed 1024 tokens so head-vs-tail truncation changes
    the embeddings."""
    import types

    max_len = pipe.tecfg.max_length
    n = max_len + 7

    class Tok:
        def encode(self, text):
            return types.SimpleNamespace(ids=list(range(100, 100 + n)))

    old_tok = pipe.tokenizer
    pipe.tokenizer = Tok()
    try:
        ids, mask = pipe.tokenize("x" * n)
    finally:
        pipe.tokenizer = old_tok
    assert ids.shape == (1, max_len) and np.asarray(mask).all()
    np.testing.assert_array_equal(
        np.asarray(ids)[0], np.arange(100 + 7, 100 + n))


def test_tokenize_bos_via_post_processor(pipe):
    """BOS comes from the tokenizer.json post-processor (Gemma's template
    adds BOS=2, LTXPipeline.swift:3259) and must land at the first unpadded
    slot after left-padding. Built with a real `tokenizers` pipeline
    mirroring the Gemma schema (offline stand-in for the real file)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "a": 4, "cat": 5, "sat": 6}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<eos>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<bos> $A", special_tokens=[("<bos>", 2)])

    old_tok = pipe.tokenizer
    pipe.tokenizer = tok
    try:
        ids, mask = pipe.tokenize("a cat sat")
    finally:
        pipe.tokenizer = old_tok
    max_len = pipe.tecfg.max_length
    ids, mask = np.asarray(ids)[0], np.asarray(mask)[0]
    pad = max_len - 4
    assert (ids[:pad] == 0).all() and (mask[:pad] == 0).all()
    np.testing.assert_array_equal(ids[pad:], [2, 4, 5, 6])  # BOS first
    assert mask[pad:].all()


def test_warm_compile_lowering_matches_real_step(pipe):
    """The abstract-input lowering used by the enhancement-overlapped warm
    compile must be IDENTICAL to what the real denoise phase traces —
    otherwise the warm-up compiles a program that is never hit."""
    from ltx_jax.pipeline.denoise import (
        GuidanceSpec, build_guidance_context, make_denoise_step,
    )

    cfg = _tiny_config()
    guidance = GuidanceSpec.from_config(cfg)
    warm_text = pipe._warm_lowering(cfg, guidance).as_text()

    # real path: encode -> context -> step -> lower with concrete inputs
    pos = pipe.encode_prompt("a cat")
    context, bias = build_guidance_context(guidance, pos["video"],
                                           pos["mask"])
    shape = VideoLatentShape.from_pixels(1, cfg.num_frames, cfg.height,
                                         cfg.width,
                                         channels=pipe.tcfg.in_channels)
    step = make_denoise_step(pipe.transformer_params, pipe.tcfg, guidance,
                             shape, context, bias, fps=cfg.fps,
                             sdpa_impl=pipe.sdpa_impl)
    latent = jnp.zeros(shape.shape, jnp.float32)
    real_text = step._jit.lower(
        pipe.transformer_params, context, bias, step._pe,
        latent, 0.9, 0.5, jnp.zeros_like(latent), jnp.asarray(False),
        jax.random.key(0),
    ).as_text()
    assert warm_text == real_text


def test_warm_vae_lowering_matches_real_decode(pipe):
    """The abstract VAE-decoder lowering warmed during enhancement must be
    IDENTICAL to the program the real decode phase traces (same
    _decoder_exec cache key, same argument structs)."""
    import jax

    from ltx_jax.models import vae as vae_mod

    cfg = _tiny_config()
    warm_text = pipe._warm_vae_lowering(cfg).as_text()

    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height, cfg.width,
        channels=pipe.vcfg.latent_channels)
    dt = pipe.vae_decoder_params["conv_in"]["w"].dtype
    latent = jnp.zeros(shape.shape, jnp.float32).astype(dt)
    ts = 0.05 if pipe.vcfg.timestep_conditioning else None
    nkey = jax.random.key(0) if ts is not None else None
    real_text = vae_mod._decoder_exec(pipe.vcfg, ts, False).lower(
        pipe.vae_decoder_params, latent, nkey).as_text()
    assert warm_text == real_text


def test_warm_compile_thread_runs(pipe):
    """End-to-end: enhancement-overlapped warm compile records its timing
    and generation still produces frames."""
    import types

    class Tok:
        def encode(self, text):
            ids = [(b % 90) + 4 for b in text.encode()][:64]
            return types.SimpleNamespace(ids=ids or [4])

        def decode(self, ids):
            return "an enhanced prompt"

    old_tok = pipe.tokenizer
    pipe.tokenizer = Tok()
    try:
        r = pipe.generate_video("a cat", _tiny_config(enhance_prompt=True))
    finally:
        pipe.tokenizer = old_tok
    assert r.frames.shape == (9, 64, 64, 3)
    assert r.timings.warm_compile > 0
    assert "overlapped" in r.timings.report()


def test_t2v_deterministic_by_seed(pipe):
    cfg = _tiny_config()
    r1 = pipe.generate_video("a dog", cfg)
    r2 = pipe.generate_video("a dog", cfg)
    np.testing.assert_array_equal(np.asarray(r1.frames), np.asarray(r2.frames))


def test_t2v_with_cfg_and_stg(pipe):
    cfg = _tiny_config(cfg_scale=3.0, guidance_rescale=0.7, stg_scale=0.5,
                       stg_blocks=(1,), negative_prompt="blurry")
    result = pipe.generate_video("a cat", cfg)
    assert result.frames.shape == (9, 64, 64, 3)
    assert np.isfinite(np.asarray(result.frames)).all()


def test_i2v_keeps_frame0_clean(pipe):
    cfg = _tiny_config(image_cond_noise_scale=0.0)
    img = jax.random.uniform(jax.random.key(7), (1, 3, 1, 64, 64),
                             minval=-1, maxval=1)
    image_latent = pipe.encode_image(img)
    assert image_latent.shape == (1, pipe.vcfg.latent_channels, 1, 2, 2)
    result = pipe.generate_video("a cat", cfg, image_latent=image_latent)
    assert result.frames.shape == (9, 64, 64, 3)


def test_guidance_rows():
    g1 = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    g2 = GuidanceSpec(True, 4.0, 0.0, 0.0, (29,), 0.0, 1.0)
    g3 = GuidanceSpec(True, 4.0, 0.7, 0.5, (29,), 0.0, 1.0)
    assert (g1.num_rows, g2.num_rows, g3.num_rows) == (1, 2, 3)


def test_guidance_context_row_order():
    pos = jnp.ones((1, 4, 8))
    neg = -jnp.ones((1, 4, 8))
    pm = jnp.ones((1, 4), jnp.int32)
    g = GuidanceSpec(True, 4.0, 0.0, 0.5, (0,), 0.0, 1.0)
    ctx, bias = build_guidance_context(g, pos, pm, neg, pm)
    assert ctx.shape == (3, 4, 8)
    # row order [neg, pos, pos]
    np.testing.assert_array_equal(np.asarray(ctx[0]), -1.0)
    np.testing.assert_array_equal(np.asarray(ctx[1]), 1.0)
    np.testing.assert_array_equal(np.asarray(ctx[2]), 1.0)
    assert bias.shape == (3, 1, 1, 4)


def test_denoise_step_single_compilation(pipe):
    """Every sigma pair must reuse one compiled step."""
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 2, 2)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    step = make_denoise_step(pipe.transformer_params, pipe.tcfg, g, shape,
                             ctx, None)
    latent = jax.random.normal(jax.random.key(0), shape.shape)
    vel = jnp.zeros_like(latent)
    out1, v1 = step(latent, 0.9, 0.5, vel, jnp.asarray(False), jax.random.key(1))
    out2, _ = step(out1, 0.5, 0.0, v1, jnp.asarray(True), jax.random.key(2))
    assert step._jit._cache_size() == 1
    assert out2.shape == shape.shape


def test_denoise_loop_ge_gamma(pipe):
    """GE momentum path must run and differ from plain velocity."""
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 2, 2)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    latent = jax.random.normal(jax.random.key(3), shape.shape)
    sigmas = np.asarray([1.0, 0.6, 0.3, 0.0], np.float32)

    g0 = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    g_ge = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.9, 1.0)
    s0 = make_denoise_step(pipe.transformer_params, pipe.tcfg, g0, shape, ctx, None)
    s1 = make_denoise_step(pipe.transformer_params, pipe.tcfg, g_ge, shape, ctx, None)
    o0 = run_denoise_loop(s0, latent, sigmas)
    o1 = run_denoise_loop(s1, latent, sigmas)
    assert not np.allclose(np.asarray(o0), np.asarray(o1))


def test_tp_sharded_matches_single_device(pipe):
    """TP over the 8-device CPU mesh must match unsharded numerics."""
    from ltx_jax.parallel.sharding import make_mesh, shard_dit_params

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(data=1, model=4)  # tiny cfg: 4 heads -> model<=4
    shape = VideoLatentShape(1, pipe.tcfg.in_channels, 2, 2, 2)
    g = GuidanceSpec(False, 1.0, 0.0, 0.0, (29,), 0.0, 1.0)
    ctx = jnp.ones((1, 8, pipe.tcfg.caption_channels), jnp.bfloat16)
    latent = jax.random.normal(jax.random.key(0), shape.shape)
    vel = jnp.zeros_like(latent)

    step = make_denoise_step(pipe.transformer_params, pipe.tcfg, g, shape,
                             ctx, None)
    base, _ = step(jnp.array(latent), 0.9, 0.5, vel, jnp.asarray(False),
                   jax.random.key(1))

    sharded_params = shard_dit_params(pipe.transformer_params, mesh)
    step_s = make_denoise_step(sharded_params, pipe.tcfg, g, shape,
                               ctx, None)
    out, _ = step_s(jnp.array(latent), 0.9, 0.5, vel, jnp.asarray(False),
                    jax.random.key(1))
    np.testing.assert_allclose(
        np.asarray(base, np.float32), np.asarray(out, np.float32),
        atol=2e-2, rtol=2e-2,
    )

def test_enhance_prompt_e2e_and_timing(pipe):
    """enhance_prompt=True runs device-side Gemma generation on the T2V
    path and records the phase in GenerationTimings (reference profiles
    enhancement; LTXVideo.swift:255-297)."""
    import types

    class Tok:
        def encode(self, text):
            ids = [(b % 90) + 4 for b in text.encode()][:128]
            return types.SimpleNamespace(ids=ids or [4])

        def decode(self, ids):
            return "a cinematic, richly detailed scene"

    old_tok = pipe.tokenizer
    pipe.tokenizer = Tok()
    try:
        cfg = _tiny_config(enhance_prompt=True)
        r = pipe.generate_video("a cat", cfg)
        assert r.frames.shape == (9, 64, 64, 3)
        assert r.timings.enhancement > 0
        assert "Prompt enhancement" in r.timings.report()
    finally:
        pipe.tokenizer = old_tok


def test_encode_prompts_matches_encode_prompt(pipe):
    """Batched multi-prompt encoding (one staging cycle per call, padded
    tail chunk) must reproduce the per-prompt path exactly — both with the
    straight-through path and with the staged host-hop of the Gemma hidden
    states."""
    prompts = ["a cat", "a much longer prompt about a dog on a beach",
               "x", "two foxes", "rain"]
    singles = [pipe.encode_prompt(p) for p in prompts]
    for stage in (False, True):
        outs = pipe.encode_prompts(prompts, batch=2, stage=stage)
        assert len(outs) == len(prompts)
        for one, many in zip(singles, outs):
            assert many["video"].shape == tuple(one["video"].shape)
            assert np.array_equal(np.asarray(one["mask"]), many["mask"])
            np.testing.assert_allclose(
                np.asarray(one["video"], np.float32),
                np.asarray(many["video"], np.float32),
                atol=2e-5, rtol=0,
                err_msg=f"stage={stage}")


def test_encode_prompts_staged_releases_gemma(pipe):
    """Under phase_staging the call must end with the tower back on host
    and the connector resident (the prep loop relies on one upload per
    call, not per prompt)."""
    old_mem = pipe.memory
    old_gemma = pipe.gemma_params
    pipe.memory = dataclasses.replace(pipe.memory, phase_staging=True)
    # staging choreography applies to host-loaded trees (real checkpoints
    # load as numpy); random_tiny builds device trees, so convert first
    pipe.gemma_params = jax.tree_util.tree_map(np.asarray, old_gemma)
    try:
        outs = pipe.encode_prompts(["a", "bb", "ccc"], batch=2)
        assert len(outs) == 3
        assert isinstance(jax.tree_util.tree_leaves(pipe.gemma_params)[0],
                          np.ndarray), "gemma must be released to host"
    finally:
        pipe.memory = old_mem
        pipe.gemma_params = old_gemma
        pipe._host_store.pop("gemma_params", None)


def test_warm_compile_lowering_matches_real_step_on_mesh():
    """MESH warm compile (round 4): the abstract-input lowering now carries
    the real call's NamedShardings (sharding-annotated ShapeDtypeStructs),
    so mesh runs overlap their denoise compile with enhancement exactly
    like single-device runs — the lowered program must be IDENTICAL to what the
    sharded denoise phase traces."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ltx_jax.parallel.sharding import make_mesh

    mpipe = LTXPipeline.random_tiny(seed=3)
    mpipe.shard(make_mesh(data=2, model=4))
    cfg = _tiny_config()
    guidance = GuidanceSpec.from_config(cfg)
    warm_text = mpipe._warm_lowering(cfg, guidance).as_text()

    pos = mpipe.encode_prompt("a cat")
    context, bias = build_guidance_context(guidance, pos["video"],
                                           pos["mask"])
    shape = VideoLatentShape.from_pixels(1, cfg.num_frames, cfg.height,
                                         cfg.width,
                                         channels=mpipe.tcfg.in_channels)
    step = make_denoise_step(mpipe.transformer_params, mpipe.tcfg, guidance,
                             shape, context, bias, fps=cfg.fps,
                             sdpa_impl=mpipe.sdpa_impl)
    latent = jnp.zeros(shape.shape, jnp.float32)
    real_text = step._jit.lower(
        mpipe.transformer_params, context, bias, step._pe,
        latent, 0.9, 0.5, jnp.zeros_like(latent), jnp.asarray(False),
        jax.random.key(0),
    ).as_text()
    assert warm_text == real_text


def test_warm_vae_lowering_matches_real_decode_on_mesh():
    """Replicated-VAE mesh case: when the mesh decode stays on the tiled
    _decoder_exec path, the warm lowering (replicated-sharding structs)
    matches the real decode's program."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ltx_jax.parallel.sharding import make_mesh

    mpipe = LTXPipeline.random_tiny(seed=4)
    mpipe.shard(make_mesh(data=8, model=1))  # model=1 -> sequential decode
    cfg = _tiny_config()
    from ltx_jax.models import vae as vae_mod

    warm_text = mpipe._warm_vae_lowering(cfg).as_text()
    shape = VideoLatentShape.from_pixels(
        1, cfg.num_frames, cfg.height, cfg.width,
        channels=mpipe.vcfg.latent_channels)
    dt = mpipe.vae_decoder_params["conv_in"]["w"].dtype
    latent = jnp.zeros(shape.shape, jnp.float32).astype(dt)
    ts = 0.05 if mpipe.vcfg.timestep_conditioning else None
    nkey = jax.random.key(0) if ts is not None else None
    real_text = vae_mod._decoder_exec(mpipe.vcfg, ts, False).lower(
        mpipe.vae_decoder_params, latent, nkey).as_text()
    assert warm_text == real_text
