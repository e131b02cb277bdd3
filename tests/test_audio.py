"""Audio stack: VAE decoder, vocoder, dual AV transformer, packing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.models import audio_vae, dit_av

AV_CFG = audio_vae.AudioVAEConfig().tiny()
VOC_CFG = audio_vae.VocoderConfig().tiny()
TCFG = TransformerConfig().tiny()


def test_audio_vae_decode_shape():
    params = audio_vae.init_audio_vae_params(jax.random.key(0), AV_CFG)
    latents = jax.random.normal(
        jax.random.key(1), (1, 8, 5, AV_CFG.mel_latent_bins))
    mel = audio_vae.audio_vae_decode(params, latents, AV_CFG)
    # target frames: 4*5 - 3 = 17; tiny mel bins 8
    assert mel.shape == (1, 2, 17, AV_CFG.mel_bins)
    assert np.isfinite(np.asarray(mel)).all()


def test_audio_causal_conv_time_causality():
    """Output row t must not depend on input rows > t."""
    p = {
        "w": jax.random.normal(jax.random.key(2), (3, 3, 4, 4)) * 0.1,
        "b": jnp.zeros((4,)),
    }
    x1 = jax.random.normal(jax.random.key(3), (1, 6, 8, 4))
    x2 = x1.at[:, 4:].set(0.0)
    o1 = audio_vae.causal_conv2d(p, x1)
    o2 = audio_vae.causal_conv2d(p, x2)
    np.testing.assert_allclose(
        np.asarray(o1[:, :4]), np.asarray(o2[:, :4]), atol=1e-5
    )
    assert not np.allclose(np.asarray(o1[:, 4]), np.asarray(o2[:, 4]))


def test_vocoder_upsample_ratio_and_range():
    params = audio_vae.init_vocoder_params(jax.random.key(4), VOC_CFG)
    t_mel = 8
    mel = jax.random.normal(jax.random.key(5),
                            (1, 2, t_mel, VOC_CFG.in_channels // 2))
    wav = audio_vae.vocoder_forward(params, mel, VOC_CFG)
    factor = int(np.prod(VOC_CFG.upsample_factors))
    assert wav.shape == (1, 2, t_mel * factor)
    w = np.asarray(wav)
    assert w.min() >= -1.0 and w.max() <= 1.0  # tanh bounded


def test_vocoder_full_240x_config_shapes():
    """Real config: 240x upsample, 1024->32 channels."""
    cfg = audio_vae.VocoderConfig()
    factor = 1
    for f in cfg.upsample_factors:
        factor *= f
    assert factor == 240
    # channel halving over 5 stages: 1024 -> 32
    assert cfg.hidden_channels // (2 ** len(cfg.upsample_factors)) == 32


def test_audio_pack_roundtrip():
    x = jax.random.normal(jax.random.key(6), (2, 8, 5, 16))
    packed = dit_av.pack_audio_latents(x)
    assert packed.shape == (2, 5, 128)
    back = dit_av.unpack_audio_latents(packed)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_audio_frame_count():
    # round(dur * 16000/160/4) = round(dur * 25)
    assert dit_av.audio_frame_count(5.0) == 125
    assert dit_av.audio_frame_count(1.0) == 25


@pytest.fixture(scope="module")
def av_setup():
    params = dit_av.init_params(jax.random.key(0), TCFG, dtype=jnp.float32)
    f, h, w = 2, 2, 2
    tv = f * h * w
    ta = 5
    b, s = 1, 8
    ks = jax.random.split(jax.random.key(1), 4)
    video = jax.random.normal(ks[0], (b, tv, TCFG.in_channels), jnp.float32)
    audio = jax.random.normal(ks[1], (b, ta, TCFG.audio_in_channels),
                              jnp.float32)
    ctx_v = jax.random.normal(ks[2], (b, s, TCFG.caption_channels), jnp.float32)
    ctx_a = jax.random.normal(ks[3], (b, s, TCFG.caption_channels), jnp.float32)
    ropes = dit_av.prepare_av_ropes(TCFG, f, h, w, ta)
    return params, video, audio, ctx_v, ctx_a, ropes


def test_dit_av_forward_shapes(av_setup):
    params, video, audio, ctx_v, ctx_a, ropes = av_setup
    ts = jnp.full((1,), 0.5)
    v_out, a_out = dit_av.dit_av_forward(
        params, video, audio, ctx_v, ctx_a, ts, ts, ropes, TCFG
    )
    assert v_out.shape == (1, video.shape[1], TCFG.out_channels)
    assert a_out.shape == (1, audio.shape[1], TCFG.audio_out_channels)
    assert np.isfinite(np.asarray(v_out)).all()
    assert np.isfinite(np.asarray(a_out)).all()


def test_dit_av_cross_modal_coupling(av_setup):
    """Changing the audio input must change the video output (A2V gate is
    zero-init SST + random adaln weights -> nonzero gate)."""
    params, video, audio, ctx_v, ctx_a, ropes = av_setup
    ts = jnp.full((1,), 0.5)
    v1, a1 = dit_av.dit_av_forward(params, video, audio, ctx_v, ctx_a,
                                   ts, ts, ropes, TCFG)
    audio2 = audio + 1.0
    v2, a2 = dit_av.dit_av_forward(params, video, audio2, ctx_v, ctx_a,
                                   ts, ts, ropes, TCFG)
    assert not np.allclose(np.asarray(v1), np.asarray(v2)), \
        "audio change must propagate to video via A2V attention"
    assert not np.allclose(np.asarray(a1), np.asarray(a2))


def test_dit_av_per_token_timesteps(av_setup):
    """I2V path: per-token video timesteps flow through cross-modal adaln."""
    params, video, audio, ctx_v, ctx_a, ropes = av_setup
    tv = video.shape[1]
    ts_v = jnp.full((1, tv), 0.5).at[:, 0].set(0.0)
    ts_a = jnp.full((1,), 0.5)
    v_out, a_out = dit_av.dit_av_forward(
        params, video, audio, ctx_v, ctx_a, ts_v, ts_a, ropes, TCFG
    )
    assert v_out.shape == (1, tv, TCFG.out_channels)
    v_scalar, _ = dit_av.dit_av_forward(
        params, video, audio, ctx_v, ctx_a, jnp.full((1,), 0.5), ts_a,
        ropes, TCFG)
    assert not np.allclose(np.asarray(v_out), np.asarray(v_scalar))


def test_audio_vae_weight_loading():
    rng = np.random.default_rng(0)
    cfg = AV_CFG
    t = {}

    def conv(prefix, ci, co, k=3):
        t[f"{prefix}.conv.weight"] = rng.standard_normal(
            (co, ci, k, k)).astype(np.float32) * 0.05
        t[f"{prefix}.conv.bias"] = np.zeros((co,), np.float32)

    def res(prefix, ci, co):
        conv(f"{prefix}.conv1", ci, co)
        conv(f"{prefix}.conv2", co, co)
        if ci != co:
            conv(f"{prefix}.nin_shortcut", ci, co, 1)

    top = cfg.base_channels * cfg.ch_mult[-1]
    conv("decoder.conv_in", cfg.latent_channels, top)
    res("decoder.mid.block_1", top, top)
    res("decoder.mid.block_2", top, top)
    # levels stored [0, 1, 2]: ch 16*(1,2,4) = (16, 32, 64)
    level_specs = [(32, 16, False), (64, 32, True), (64, 64, True)]
    for i, (ci, co, has_up) in enumerate(level_specs):
        res(f"decoder.up.{i}.block.0", ci, co)
        if has_up:
            conv(f"decoder.up.{i}.upsample.conv", co, co)
    conv("decoder.conv_out", cfg.base_channels, 2)
    pack = cfg.latent_channels * cfg.mel_latent_bins
    t["latents_mean"] = np.zeros((pack,), np.float32)
    t["latents_std"] = np.ones((pack,), np.float32)
    t["encoder.conv_in.conv.weight"] = np.zeros((4, 4, 3, 3), np.float32)

    params = audio_vae.load_audio_vae_params(t)
    latents = jax.random.normal(jax.random.key(7),
                                (1, 8, 3, cfg.mel_latent_bins))
    mel = audio_vae.audio_vae_decode(params, latents, cfg)
    assert mel.shape == (1, 2, 9, cfg.mel_bins)


def test_vocoder_weight_loading():
    rng = np.random.default_rng(1)
    cfg = VOC_CFG
    t = {}

    def conv1(prefix, ci, co, k):
        t[f"{prefix}.weight"] = rng.standard_normal(
            (co, ci, k)).astype(np.float32) * 0.05
        t[f"{prefix}.bias"] = np.zeros((co,), np.float32)

    conv1("conv_in", 128, cfg.hidden_channels, 7)
    ch = cfg.hidden_channels
    ridx = 0
    for i, (f, k) in enumerate(zip(cfg.upsample_factors, cfg.upsample_kernels)):
        out_ch = ch // 2
        # ConvTranspose torch layout (in, out, k)
        t[f"upsamplers.{i}.weight"] = rng.standard_normal(
            (ch, out_ch, k)).astype(np.float32) * 0.05
        t[f"upsamplers.{i}.bias"] = np.zeros((out_ch,), np.float32)
        for kern, dils in zip(cfg.resnet_kernels, cfg.resnet_dilations):
            for j in range(len(dils)):
                conv1(f"resnets.{ridx}.convs1.{j}", out_ch, out_ch, kern)
                conv1(f"resnets.{ridx}.convs2.{j}", out_ch, out_ch, kern)
            ridx += 1
        ch = out_ch
    conv1("conv_out", ch, 2, 7)

    params = audio_vae.load_vocoder_params(t)
    mel = jax.random.normal(jax.random.key(8), (1, 2, 4, 64))
    wav = audio_vae.vocoder_forward(params, mel, cfg)
    assert wav.shape == (1, 2, 4 * 4)