"""Audio VAE decoder + HiFi-GAN vocoder.

Reference behavior: Sources/LTXVideo/Models/AudioVAE/AudioVAE.swift (decoder:
latent (B, 8, T, 16) -> stereo mel (B, 2, 4T-3, 64)) and Vocoder.swift
(HiFi-GAN: mel -> 24 kHz stereo waveform, 240x upsample via strides
6*5*2*2*2, tanh output).

Internals are channels-last (NHWC / NTC); public interfaces keep the
reference's channels-first shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ltx_jax.models.common import silu


@dataclasses.dataclass(frozen=True)
class AudioVAEConfig:
    latent_channels: int = 8
    output_channels: int = 2
    base_channels: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2  # decoder levels use num_res_blocks + 1
    mel_bins: int = 64
    mel_latent_bins: int = 16  # latent width; packed dim = 8 * this = 128
    latent_downsample: int = 4

    def tiny(self) -> "AudioVAEConfig":
        return dataclasses.replace(self, base_channels=16, num_res_blocks=0,
                                   mel_bins=8, mel_latent_bins=2)


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    in_channels: int = 128
    hidden_channels: int = 1024
    out_channels: int = 2
    upsample_factors: Tuple[int, ...] = (6, 5, 2, 2, 2)
    upsample_kernels: Tuple[int, ...] = (16, 15, 8, 4, 4)
    resnet_kernels: Tuple[int, ...] = (3, 7, 11)
    resnet_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_slope: float = 0.1
    sample_rate: int = 24000

    def tiny(self) -> "VocoderConfig":
        return dataclasses.replace(
            self, in_channels=16, hidden_channels=32, upsample_factors=(2, 2),
            upsample_kernels=(4, 4), resnet_kernels=(3,),
            resnet_dilations=((1, 3),),
        )


# ---------------------------------------------------------------------------
# Audio VAE decoder (NHWC; H = time is the causal axis)
# ---------------------------------------------------------------------------


def audio_pixel_norm(x, eps: float = 1e-6):
    """Channel RMS norm, channels-last (reference: AudioVAE.swift:14-27)."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    ms = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf / jnp.sqrt(ms + eps)).astype(dtype)


def causal_conv2d(p, x, stride: int = 1):
    """Height-causal 2D conv on NHWC: all H padding at the TOP (zeros),
    symmetric zero W padding (reference: AudioVAE.swift:37-104).

    p["w"]: (kh, kw, ci, co)."""
    kh, kw = p["w"].shape[0], p["w"].shape[1]
    pad_h = kh - 1
    pad_w = kw - 1
    x = jnp.pad(x, [(0, 0), (pad_h, 0), (pad_w // 2, pad_w - pad_w // 2),
                    (0, 0)])
    out = lax.conv_general_dilated(
        x, p["w"].astype(x.dtype), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
    return out + p["b"].astype(x.dtype) if "b" in p else out


def _resnet_block(p, x):
    """PixelNorm -> SiLU -> conv, x2, + (optionally projected) residual
    (reference: AudioVAE.swift:112-161)."""
    h = causal_conv2d(p["conv1"], silu(audio_pixel_norm(x)))
    h = causal_conv2d(p["conv2"], silu(audio_pixel_norm(h)))
    res = x
    if "nin_shortcut" in p:
        res = causal_conv2d(p["nin_shortcut"], x)
    return h + res


def _upsample(p, x):
    """Nearest 2x in H and W -> causal conv -> trim first row
    (reference: AudioVAE.swift:169-199)."""
    b, h, w, c = x.shape
    up = jnp.broadcast_to(x[:, :, None, :, None, :], (b, h, 2, w, 2, c))
    up = up.reshape(b, h * 2, w * 2, c)
    out = causal_conv2d(p["conv"], up)
    return out[:, 1:]


def audio_decoder_forward(params, latents, cfg: AudioVAEConfig):
    """(B, 8, T, 16) raw latent -> (B, 2, H_out, W_out) mel before cropping
    (reference: AudioVAE.swift:325-347). Input here is channels-first to
    match the reference; converted to NHWC internally (channels last)."""
    x = latents.transpose(0, 2, 3, 1)  # (B, T, 16, 8) -> NHWC with C=latent
    x = causal_conv2d(params["conv_in"], x)
    x = _resnet_block(params["mid"]["block_1"], x)
    x = _resnet_block(params["mid"]["block_2"], x)
    # traverse levels high->low: up[2], up[1], up[0]
    for level in reversed(params["up"]):
        for blk in level["block"]:
            x = _resnet_block(blk, x)
        if "upsample" in level:
            x = _upsample(level["upsample"], x)
    x = silu(audio_pixel_norm(x))
    x = causal_conv2d(params["conv_out"], x)
    return x.transpose(0, 3, 1, 2)  # -> (B, 2, H, W)


def audio_vae_decode(params, latents, cfg: AudioVAEConfig = AudioVAEConfig()):
    """Full decode: denormalize packed latents, decode, causal crop
    (reference: AudioVAE.swift:403-456).

    latents: (B, 8, T, 16). Returns mel (B, 2, 4T-3, 64).
    """
    b, c, t, m = latents.shape
    target = max(t * cfg.latent_downsample - (cfg.latent_downsample - 1), 1)

    packed = latents.transpose(0, 2, 1, 3).reshape(b, t, c * m)  # (B, T, 128)
    mean = params["latents_mean"].reshape(1, 1, -1).astype(jnp.float32)
    std = params["latents_std"].reshape(1, 1, -1).astype(jnp.float32)
    packed = (packed.astype(jnp.float32) * std + mean).astype(latents.dtype)
    sample = packed.reshape(b, t, c, m).transpose(0, 2, 1, 3)

    out = audio_decoder_forward(params["decoder"], sample, cfg)
    out = out[:, :, :target, : cfg.mel_bins]
    return out


def init_audio_vae_params(key, cfg: AudioVAEConfig = AudioVAEConfig(),
                          dtype=jnp.float32):
    ks = iter(jax.random.split(key, 128))

    def conv(ci, co, k=3):
        return {
            "w": (jax.random.normal(next(ks), (k, k, ci, co), jnp.float32)
                  * (ci * k * k) ** -0.5).astype(dtype),
            "b": jnp.zeros((co,), dtype),
        }

    def res(ci, co):
        p = {"conv1": conv(ci, co), "conv2": conv(co, co)}
        if ci != co:
            p["nin_shortcut"] = conv(ci, co, 1)
        return p

    top = cfg.base_channels * cfg.ch_mult[-1]
    levels: List[dict] = []
    # build reversed (level 2 -> 0), then store [0, 1, 2]
    specs = []
    block_in = top
    for i in reversed(range(len(cfg.ch_mult))):
        block_out = cfg.base_channels * cfg.ch_mult[i]
        specs.append((block_in, block_out, i != 0))
        block_in = block_out
    specs.reverse()
    for ci, co, has_up in specs:
        level = {"block": [res(ci, co)] + [
            res(co, co) for _ in range(cfg.num_res_blocks)
        ]}
        if has_up:
            level["upsample"] = {"conv": conv(co, co)}
        levels.append(level)

    pack = cfg.latent_channels * cfg.mel_latent_bins
    return {
        "decoder": {
            "conv_in": conv(cfg.latent_channels, top),
            "mid": {"block_1": res(top, top), "block_2": res(top, top)},
            "up": levels,
            "conv_out": conv(cfg.base_channels, cfg.output_channels),
        },
        "latents_mean": jnp.zeros((pack,), jnp.float32),
        "latents_std": jnp.ones((pack,), jnp.float32),
    }


def load_audio_vae_params(tensors: Dict[str, np.ndarray]) -> dict:
    """decoder.* + latents_mean/std from safetensors; conv weights transpose
    (O, I, H, W) -> (H, W, I, O) (reference: AudioVAE.swift:466-481,
    ModelDownloader.swift:1116-1160)."""

    def conv(prefix):
        w = tensors[f"{prefix}.conv.weight"]
        p = {"w": jnp.asarray(np.transpose(w, (2, 3, 1, 0)), jnp.float32)}
        b = tensors.get(f"{prefix}.conv.bias")
        if b is not None:
            p["b"] = jnp.asarray(b, jnp.float32)
        return p

    def res(prefix, ci_co_differ):
        p = {"conv1": conv(f"{prefix}.conv1"), "conv2": conv(f"{prefix}.conv2")}
        if f"{prefix}.nin_shortcut.conv.weight" in tensors:
            p["nin_shortcut"] = conv(f"{prefix}.nin_shortcut")
        return p

    levels = []
    i = 0
    while f"decoder.up.{i}.block.0.conv1.conv.weight" in tensors:
        blocks = []
        j = 0
        while f"decoder.up.{i}.block.{j}.conv1.conv.weight" in tensors:
            blocks.append(res(f"decoder.up.{i}.block.{j}", False))
            j += 1
        level = {"block": blocks}
        if f"decoder.up.{i}.upsample.conv.conv.weight" in tensors:
            level["upsample"] = {"conv": conv(f"decoder.up.{i}.upsample.conv")}
        levels.append(level)
        i += 1

    return {
        "decoder": {
            "conv_in": conv("decoder.conv_in"),
            "mid": {
                "block_1": res("decoder.mid.block_1", False),
                "block_2": res("decoder.mid.block_2", False),
            },
            "up": levels,
            "conv_out": conv("decoder.conv_out"),
        },
        "latents_mean": jnp.asarray(
            np.squeeze(tensors["latents_mean"]), jnp.float32),
        "latents_std": jnp.asarray(
            np.squeeze(tensors["latents_std"]), jnp.float32),
    }


# ---------------------------------------------------------------------------
# HiFi-GAN vocoder (NTC)
# ---------------------------------------------------------------------------


def _conv1d(p, x, stride=1, dilation=1):
    """Same-padded 1D conv on (B, T, C); w: (k, ci, co)."""
    k = p["w"].shape[0]
    pad = dilation * (k - 1) // 2
    out = lax.conv_general_dilated(
        x, p["w"].astype(x.dtype), (stride,), [(pad, pad)],
        rhs_dilation=(dilation,),
        dimension_numbers=("NTC", "TIO", "NTC"),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
    return out + p["b"].astype(x.dtype)


def _conv_transpose1d(p, x, stride, padding):
    """ConvTranspose1d on (B, T, C); w stored (k, out, in) — the forward-conv
    orientation lax.conv_transpose(transpose_kernel=True) expects, matching
    PyTorch semantics: out_len = (T-1)*stride - 2*padding + k."""
    k = p["w"].shape[0]
    out = lax.conv_transpose(
        x, p["w"].astype(x.dtype), (stride,),
        [(k - 1 - padding, k - 1 - padding)],
        dimension_numbers=("NTC", "TIO", "NTC"),
        transpose_kernel=True,
    ).astype(x.dtype)
    return out + p["b"].astype(x.dtype)


def _leaky(x, slope):
    return jnp.where(x >= 0, x, slope * x)


def _vocoder_resblock(p, x, kernel: int, dilations, slope: float):
    """leaky -> dilated conv -> leaky -> conv(d=1), residual per pair
    (reference: Vocoder.swift:17-70)."""
    h = x
    for i, dil in enumerate(dilations):
        xt = _conv1d(p["convs1"][i], _leaky(h, slope), dilation=dil)
        xt = _conv1d(p["convs2"][i], _leaky(xt, slope))
        h = h + xt
    return h


def vocoder_forward(params, mel, cfg: VocoderConfig = VocoderConfig()):
    """(B, 2, T_mel, 64) stereo mel -> (B, 2, samples) waveform in (-1, 1)
    (reference: Vocoder.swift:215-262)."""
    b = mel.shape[0]
    t = mel.shape[2]
    # (B, 2, T, 64) -> (B, 2, 64, T) -> (B, 128, T) -> (B, T, 128)
    x = mel.transpose(0, 1, 3, 2).reshape(b, -1, t).transpose(0, 2, 1)

    x = _conv1d(params["conv_in"], x)
    n_res = len(cfg.resnet_kernels)
    for i, (factor, ksize) in enumerate(
            zip(cfg.upsample_factors, cfg.upsample_kernels)):
        x = _leaky(x, cfg.leaky_slope)
        pad = (ksize - factor) // 2
        x = _conv_transpose1d(params["upsamplers"][i], x, factor, pad)
        outs = []
        for j in range(n_res):
            outs.append(_vocoder_resblock(
                params["resnets"][i * n_res + j], x, cfg.resnet_kernels[j],
                cfg.resnet_dilations[j], cfg.leaky_slope))
        x = jnp.mean(jnp.stack(outs, axis=0), axis=0)

    x = _leaky(x, 0.01)  # final uses default slope, NOT 0.1
    x = _conv1d(params["conv_out"], x)
    x = jnp.tanh(x)
    return x.transpose(0, 2, 1)  # (B, 2, samples)


def init_vocoder_params(key, cfg: VocoderConfig = VocoderConfig(),
                        dtype=jnp.float32):
    ks = iter(jax.random.split(key, 256))

    def conv1(ci, co, k):
        return {
            "w": (jax.random.normal(next(ks), (k, ci, co), jnp.float32)
                  * (ci * k) ** -0.5).astype(dtype),
            "b": jnp.zeros((co,), dtype),
        }

    def convt(ci, co, k):
        # (k, out, in) orientation for transpose_kernel=True
        return {
            "w": (jax.random.normal(next(ks), (k, co, ci), jnp.float32)
                  * (ci * k) ** -0.5).astype(dtype),
            "b": jnp.zeros((co,), dtype),
        }

    params = {"conv_in": conv1(cfg.in_channels, cfg.hidden_channels, 7)}
    ups, resnets = [], []
    ch = cfg.hidden_channels
    for factor, ksize in zip(cfg.upsample_factors, cfg.upsample_kernels):
        out_ch = ch // 2
        ups.append(convt(ch, out_ch, ksize))
        for kern, dils in zip(cfg.resnet_kernels, cfg.resnet_dilations):
            resnets.append({
                "convs1": [conv1(out_ch, out_ch, kern) for _ in dils],
                "convs2": [conv1(out_ch, out_ch, kern) for _ in dils],
            })
        ch = out_ch
    params["upsamplers"] = ups
    params["resnets"] = resnets
    params["conv_out"] = conv1(ch, cfg.out_channels, 7)
    return params


def load_vocoder_params(tensors: Dict[str, np.ndarray]) -> dict:
    """Conv1d (O, I, K) -> (K, I, O); ConvTranspose1d (I, O, K) -> (K, I, O)
    (reference: Vocoder.swift:264-312)."""

    def conv1(prefix):
        w = tensors[f"{prefix}.weight"]
        return {
            "w": jnp.asarray(np.transpose(w, (2, 1, 0)), jnp.float32),
            "b": jnp.asarray(tensors[f"{prefix}.bias"], jnp.float32),
        }

    def convt(prefix):
        w = tensors[f"{prefix}.weight"]  # torch (in, out, k)
        return {
            "w": jnp.asarray(np.transpose(w, (2, 1, 0)), jnp.float32),
            "b": jnp.asarray(tensors[f"{prefix}.bias"], jnp.float32),
        }

    params = {"conv_in": conv1("conv_in"), "conv_out": conv1("conv_out")}
    ups = []
    i = 0
    while f"upsamplers.{i}.weight" in tensors:
        ups.append(convt(f"upsamplers.{i}"))
        i += 1
    params["upsamplers"] = ups
    resnets = []
    i = 0
    while f"resnets.{i}.convs1.0.weight" in tensors:
        c1, c2 = [], []
        j = 0
        while f"resnets.{i}.convs1.{j}.weight" in tensors:
            c1.append(conv1(f"resnets.{i}.convs1.{j}"))
            c2.append(conv1(f"resnets.{i}.convs2.{j}"))
            j += 1
        resnets.append({"convs1": c1, "convs2": c2})
        i += 1
    params["resnets"] = resnets
    return params


def decode_audio(vae_params, vocoder_params, latents,
                 vae_cfg: AudioVAEConfig = AudioVAEConfig(),
                 voc_cfg: VocoderConfig = VocoderConfig()):
    """latents (B, 8, T, 16) -> stereo waveform (B, 2, samples) @ 24 kHz
    (reference: Vocoder.swift:325-361). No normalization — the vocoder's
    tanh already bounds output to (-1, 1)."""
    if latents.ndim == 3:
        latents = latents[None]
    mel = audio_vae_decode(vae_params, latents, vae_cfg)
    return vocoder_forward(vocoder_params, mel, voc_cfg)


# Compiled entry point for the pipeline's audio decode phase (see
# gemma3.forward_hidden_states_jit for why eager is the wrong default here)
decode_audio_jit = jax.jit(decode_audio, static_argnums=(3, 4))
