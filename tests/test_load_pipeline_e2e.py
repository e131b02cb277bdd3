"""FULL file-to-frames integration: synthetic checkpoints in the real
on-disk layout -> load_pipeline -> generate_video.

This is the strongest offline evidence for the weight-loading surface:
every file the reference's ModelDownloader lays out (unified transformer +
VAE + connector, Gemma snapshot with config.json + tokenizer.json) is
materialized at tiny-but-structurally-real shapes from the independently-
transcribed fixture specs (tests/weight_fixtures.py), then the PRODUCTION
loader assembles a pipeline from the FILES and runs an actual generation.
Also proves the quantized-weight cache end-to-end (a second int4 load must
not re-quantize).
"""

import dataclasses
import json

import numpy as np
import pytest
from safetensors.numpy import save_file

import tests.weight_fixtures as wf
from ltx_jax.core.config import (
    GenerationConfig,
    LTXModel,
    MemoryConfig,
    QuantizationConfig,
    TransformerConfig,
)
from ltx_jax.models import gemma3, text_encoder, vae


def _tiny_configs():
    tcfg = TransformerConfig().tiny()
    gcfg = gemma3.Gemma3Config().tiny()
    tecfg = dataclasses.replace(
        text_encoder.TextEncoderConfig().tiny(),
        hidden_dim=gcfg.hidden_size,
        num_gemma_layers=gcfg.hidden_layers + 1,
        connector_heads=4,
        connector_head_dim=gcfg.hidden_size // 4,
    )
    tcfg = dataclasses.replace(tcfg, caption_channels=tecfg.inner_dim)
    vcfg = dataclasses.replace(vae.VAEConfig().tiny(),
                               latent_channels=tcfg.in_channels)
    return tcfg, gcfg, tecfg, vcfg


def _write_models_dir(tmp_path):
    """The exact on-disk layout download_all_components produces, with
    synthetic checkpoints (skip-if-exists caching then avoids all
    network)."""
    tcfg, gcfg, tecfg, vcfg = _tiny_configs()
    base = tmp_path / "models"

    # --- unified file: video DiT + VAE decoder + connector (fmt 2)
    unified = {}
    vspec = wf.video_transformer_spec(
        num_layers=tcfg.num_layers, inner=tcfg.inner_dim,
        in_channels=tcfg.in_channels, out_channels=tcfg.out_channels,
        cross_dim=tcfg.cross_attention_dim,
        caption_dim=tcfg.caption_channels)
    for k, v in wf.materialize(vspec, seed=1).items():
        unified[f"model.diffusion_model.{k}"] = v
    cspec = wf.connector_spec(
        fmt=2, dim=tecfg.hidden_dim, gemma_layers=tecfg.num_gemma_layers,
        layers=2, registers=tecfg.num_registers)
    for k, v in wf.materialize(cspec, seed=2).items():
        unified[f"model.diffusion_model.{k}"] = v
    dspec = wf.vae_decoder_spec(base=vcfg.base_channels,
                                latent=vcfg.latent_channels,
                                blocks_per_group=vcfg.blocks_per_group,
                                layout="unified")
    for k, v in wf.materialize(dspec, seed=3).items():
        # safetensors needs ndarrays; scalar spec entries (e.g.
        # timestep_scale_multiplier, shape ()) materialize as numpy scalars
        unified[f"vae.{k}"] = np.asarray(v)
    variant = base / "ltx-distilled"
    variant.mkdir(parents=True)
    save_file(unified, str(
        variant / LTXModel.DISTILLED.unified_weights_filename))

    # --- gemma snapshot (config.json + tokenizer.json + weights)
    gdir = base / "vlm-gemma"
    gdir.mkdir()
    gspec = wf.gemma_spec(
        layers=gcfg.hidden_layers, hidden=gcfg.hidden_size,
        heads=gcfg.attention_heads, kv_heads=gcfg.kv_heads,
        head_dim=gcfg.head_dim, intermediate=gcfg.intermediate_size,
        vocab=gcfg.vocab_size)
    save_file(wf.materialize(gspec, seed=4),
              str(gdir / "model.safetensors"))
    (gdir / "config.json").write_text(json.dumps({
        "hidden_size": gcfg.hidden_size,
        "num_hidden_layers": gcfg.hidden_layers,
        "intermediate_size": gcfg.intermediate_size,
        "num_attention_heads": gcfg.attention_heads,
        "head_dim": gcfg.head_dim,
        "vocab_size": gcfg.vocab_size,
        "num_key_value_heads": gcfg.kv_heads,
        "query_pre_attn_scalar": gcfg.query_pre_attn_scalar,
        "sliding_window": gcfg.sliding_window,
        "sliding_window_pattern": gcfg.sliding_window_pattern,
    }))
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2}
    vocab.update({w: i + 4 for i, w in enumerate(
        ["a", "cat", "plays", "piano", "dog"])})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<eos>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<bos> $A", special_tokens=[("<bos>", 2)])
    tok.save(str(gdir / "tokenizer.json"))

    # --- standalone connector/VAE/LoRA placeholders (valid safetensors;
    # the loader only opens the VAE one, to look for encoder keys)
    for d in ("ltx-connector", "ltx-vae", "ltx-lora"):
        (base / d).mkdir()
    save_file({"placeholder": np.zeros((1,), np.float32)},
              str(base / "ltx-connector" / "diffusion_pytorch_model"
                  ".safetensors"))
    save_file({"decoder.placeholder": np.zeros((1,), np.float32)},
              str(base / "ltx-vae" / "diffusion_pytorch_model.safetensors"))
    (base / "ltx-vae" / "config.json").write_text(
        json.dumps({"timestep_conditioning": False}))
    from ltx_jax.weights.download import DISTILLED_LORA_FILE
    from pathlib import Path as _P

    save_file({"dummy.lora_down.weight": np.zeros((2, 4), np.float32),
               "dummy.lora_up.weight": np.zeros((4, 2), np.float32)},
              str(base / "ltx-lora" / _P(DISTILLED_LORA_FILE).name))
    return base, (tcfg, gcfg, tecfg, vcfg)


def _load(base, cfgs, **kw):
    from ltx_jax.pipeline.loader import load_pipeline

    tcfg, gcfg, tecfg, vcfg = cfgs
    return load_pipeline(
        model=LTXModel.DISTILLED,
        models_dir=str(base),
        memory=MemoryConfig(offload_text_encoder=False),
        transformer_config=tcfg,
        vae_config=vcfg,
        text_encoder_config=tecfg,
        **kw,
    )


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    return _write_models_dir(tmp_path_factory.mktemp("ckpt"))


def test_files_to_frames_bf16(models_dir):
    base, cfgs = models_dir
    pipe = _load(base, cfgs, gemma_quant="bf16")
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=7)
    result = pipe.generate_video("a cat plays piano", cfg)
    frames = np.asarray(result.frames)
    assert frames.shape == (9, 64, 64, 3)
    assert np.isfinite(frames).all()


def test_files_to_frames_w8a8_gemma(models_dir):
    base, cfgs = models_dir
    pipe = _load(base, cfgs, gemma_quant="w8a8", quant_cache=False)
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=8)
    result = pipe.generate_video("a dog", cfg)
    assert np.isfinite(np.asarray(result.frames)).all()


def test_int4_quant_cache_hit_skips_requantize(models_dir, monkeypatch):
    base, cfgs = models_dir
    q = QuantizationConfig(mode="int4")
    pipe1 = _load(base, cfgs, quantization=q, gemma_quant="bf16")
    from ltx_jax.weights import qcache

    unified = (base / "ltx-distilled"
               / LTXModel.DISTILLED.unified_weights_filename)
    assert qcache.cache_path(unified, "dit-int4").exists()
    gcache = qcache.cache_path(base / "vlm-gemma", "gemma-bf16")
    assert not gcache.exists()  # bf16 gemma is never cached

    # second load MUST come from the cache: re-quantizing now fails loudly
    import ltx_jax.kernels.quantization as qz

    def boom(*a, **kw):
        raise AssertionError("cache miss: quantize_dit_params re-ran")

    monkeypatch.setattr(qz, "quantize_dit_params", boom)
    import ltx_jax.pipeline.loader as loader_mod

    monkeypatch.setattr(loader_mod, "quantize_dit_params", boom,
                        raising=False)
    pipe2 = _load(base, cfgs, quantization=q, gemma_quant="bf16")

    # cached tree == freshly quantized tree, leaf for leaf
    import jax

    for a, b in zip(jax.tree.leaves(pipe1.transformer_params),
                    jax.tree.leaves(pipe2.transformer_params)):
        np.testing.assert_array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32))

    # and the cached pipeline still generates
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=9)
    assert np.isfinite(np.asarray(
        pipe2.generate_video("a cat", cfg).frames)).all()


# ------------------------------------------------- audio / two-stage / i2v


def _write_full_models_dir(tmp_path):
    """Superset layout: AV unified file + upscaler + audio VAE + vocoder +
    VAE-encoder standalone — every optional component the loader can
    assemble, at tiny-but-structurally-real shapes."""
    from pathlib import Path as _P

    from ltx_jax.models import audio_vae as av_mod
    from ltx_jax.models import upscaler as up_mod
    from ltx_jax.weights.download import (
        AUDIO_VAE_FILE, UPSCALER_FILE, VOCODER_FILE,
    )

    base, (tcfg, gcfg, tecfg, vcfg) = _write_models_dir(tmp_path)

    # rebuild the unified file with the DUAL AV transformer (superset of
    # the video keys) + audio connector
    unified = {}
    avspec = wf.av_transformer_spec(
        num_layers=tcfg.num_layers, inner=tcfg.inner_dim,
        audio_inner=tcfg.audio_inner_dim, in_channels=tcfg.in_channels,
        out_channels=tcfg.out_channels, cross_dim=tcfg.cross_attention_dim,
        caption_dim=tcfg.caption_channels, audio_in=tcfg.audio_in_channels,
        audio_out=tcfg.audio_out_channels)
    for k, v in wf.materialize(avspec, seed=11).items():
        unified[f"model.diffusion_model.{k}"] = np.asarray(v)
    cspec = wf.connector_spec(
        fmt=2, include_audio=True, dim=tecfg.hidden_dim,
        gemma_layers=tecfg.num_gemma_layers, layers=2,
        registers=tecfg.num_registers)
    for k, v in wf.materialize(cspec, seed=12).items():
        unified[f"model.diffusion_model.{k}"] = np.asarray(v)
    dspec = wf.vae_decoder_spec(base=vcfg.base_channels,
                                latent=vcfg.latent_channels,
                                blocks_per_group=vcfg.blocks_per_group,
                                layout="unified")
    for k, v in wf.materialize(dspec, seed=13).items():
        unified[f"vae.{k}"] = np.asarray(v)
    save_file(unified, str(base / "ltx-distilled"
                           / LTXModel.DISTILLED.unified_weights_filename))

    # standalone VAE file now carries the ENCODER (loader reads it for I2V)
    # encoder base == latent channels: conv_out emits base+1 and the
    # encoder keeps the first `base` (mean-only) as the latent
    encspec = wf.vae_encoder_spec(base=vcfg.latent_channels)
    save_file({k: np.asarray(v)
               for k, v in wf.materialize(encspec, seed=14).items()},
              str(base / "ltx-vae" / "diffusion_pytorch_model.safetensors"))
    b = vcfg.latent_channels
    vcfg = dataclasses.replace(
        vcfg, encoder_channels=(b, 2 * b, 4 * b, 8 * b, 16 * b),
        encoder_resnets=(4, 6, 6, 2))

    # upscaler / audio VAE / vocoder at tiny-config shapes
    ucfg = dataclasses.replace(up_mod.UpscalerConfig().tiny(),
                               in_channels=tcfg.in_channels)
    (base / "ltx-upscaler").mkdir()
    uspec = wf.upscaler_spec(in_ch=ucfg.in_channels, mid=ucfg.mid_channels,
                             blocks_per_stage=ucfg.blocks_per_stage)
    save_file({k: np.asarray(v)
               for k, v in wf.materialize(uspec, seed=15).items()},
              str(base / "ltx-upscaler" / _P(UPSCALER_FILE).name))

    avcfg = av_mod.AudioVAEConfig().tiny()
    voccfg = av_mod.VocoderConfig().tiny()
    (base / "ltx-audio-vae").mkdir()
    aspec = wf.audio_vae_spec(
        latent=avcfg.latent_channels, base=avcfg.base_channels,
        num_res=avcfg.num_res_blocks,
        mel_bins_packed=avcfg.latent_channels * avcfg.mel_latent_bins)
    save_file({k: np.asarray(v)
               for k, v in wf.materialize(aspec, seed=16).items()},
              str(base / "ltx-audio-vae" / _P(AUDIO_VAE_FILE).name))
    (base / "ltx-vocoder").mkdir()
    vospec = wf.vocoder_spec(
        in_ch=voccfg.in_channels, hidden=voccfg.hidden_channels,
        up_factors=voccfg.upsample_factors,
        up_kernels=voccfg.upsample_kernels,
        res_kernels=voccfg.resnet_kernels,
        dils_per_res=len(voccfg.resnet_dilations[0]))
    save_file({k: np.asarray(v)
               for k, v in wf.materialize(vospec, seed=17).items()},
              str(base / "ltx-vocoder" / _P(VOCODER_FILE).name))
    return base, (tcfg, gcfg, tecfg, vcfg), (ucfg, avcfg, voccfg)


@pytest.fixture(scope="module")
def full_models_dir(tmp_path_factory):
    return _write_full_models_dir(tmp_path_factory.mktemp("ckpt_full"))


def test_files_to_frames_audio(full_models_dir):
    base, cfgs, (ucfg, avcfg, voccfg) = full_models_dir
    pipe = _load(base, cfgs, gemma_quant="bf16", include_audio=True)
    pipe.audio_vae_config = avcfg
    pipe.vocoder_config = voccfg
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=10)
    result = pipe.generate_video_with_audio("a cat plays piano", cfg)
    assert np.isfinite(np.asarray(result.frames)).all()
    assert result.audio is not None
    assert np.isfinite(np.asarray(result.audio)).all()


def test_files_to_frames_two_stage_i2v(full_models_dir, tmp_path):
    from PIL import Image

    base, cfgs, (ucfg, avcfg, voccfg) = full_models_dir
    pipe = _load(base, cfgs, gemma_quant="bf16", include_upscaler=True)
    pipe.upscaler_config = ucfg
    img = tmp_path / "cond.png"
    Image.fromarray(
        (np.random.default_rng(0).random((64, 64, 3)) * 255).astype(
            np.uint8)).save(img)
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=11, two_stage=True, image_path=str(img))
    result = pipe.generate_video_two_stage("a cat", cfg)
    frames = np.asarray(result.frames)
    assert frames.shape == (9, 64, 64, 3)
    assert np.isfinite(frames).all()


def test_files_to_frames_tp_sharded(models_dir):
    """File-loaded pipeline -> TP shard over a virtual mesh -> generate:
    the load+shard COMPOSITION (each side is tested separately elsewhere;
    a real multi-chip deployment always runs both)."""
    import jax

    from ltx_jax.parallel.sharding import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    base, cfgs = models_dir
    pipe = _load(base, cfgs, gemma_quant="bf16")
    pipe.shard(make_mesh(data=2, model=4))
    cfg = GenerationConfig(width=64, height=64, num_frames=9, num_steps=2,
                           seed=12)
    frames = np.asarray(pipe.generate_video("a cat", cfg).frames)
    assert frames.shape == (9, 64, 64, 3) and np.isfinite(frames).all()
