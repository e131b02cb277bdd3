"""Video VAE: shapes, frame formula, patchify inverses, tiling, padding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.models import vae

CFG = vae.VAEConfig().tiny()


@pytest.fixture(scope="module")
def dec_params():
    return vae.init_decoder_params(jax.random.key(0), CFG)


@pytest.fixture(scope="module")
def enc_params():
    return vae.init_encoder_params(jax.random.key(1), CFG)


def test_decoder_frame_formula(dec_params):
    """F' latent frames -> 8*(F'-1)+1 pixel frames; 32x spatial."""
    latent = jax.random.normal(jax.random.key(2), (1, CFG.latent_channels, 3, 2, 2))
    out = vae.decoder_forward(dec_params, latent, CFG, timestep=None)
    assert out.shape == (1, 3, 8 * (3 - 1) + 1, 64, 64)
    assert np.isfinite(np.asarray(out)).all()


def test_decoder_single_latent_frame(dec_params):
    latent = jax.random.normal(jax.random.key(3), (1, CFG.latent_channels, 1, 2, 2))
    out = vae.decoder_forward(dec_params, latent, CFG, timestep=None)
    assert out.shape == (1, 3, 1, 64, 64)


def test_decoder_timestep_conditioning_changes_output(dec_params):
    latent = jax.random.normal(jax.random.key(4), (1, CFG.latent_channels, 2, 2, 2))
    # no noise key -> deterministic; timestep still conditions the AdaLN path
    out_ts = vae.decoder_forward(dec_params, latent, CFG, timestep=0.05)
    out_none = vae.decoder_forward(dec_params, latent, CFG, timestep=None)
    assert out_ts.shape == out_none.shape
    # random-init embedder weights are nonzero -> outputs must differ
    assert not np.allclose(np.asarray(out_ts), np.asarray(out_none))


def test_decode_noise_injection_uses_key(dec_params):
    latent = jax.random.normal(jax.random.key(5), (1, CFG.latent_channels, 1, 2, 2))
    a = vae.decoder_forward(dec_params, latent, CFG, 0.05, jax.random.key(1))
    b = vae.decoder_forward(dec_params, latent, CFG, 0.05, jax.random.key(2))
    assert not np.allclose(np.asarray(a), np.asarray(b))


def test_patchify_unpatchify_inverse():
    """decoder_unpatchify must invert encoder_patchify exactly."""
    x = jax.random.normal(jax.random.key(6), (2, 3, 8, 8, 3))  # NDHWC pixels
    patched = vae.encoder_patchify(x)
    assert patched.shape == (2, 3, 2, 2, 48)
    back = vae.decoder_unpatchify(patched)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-6)


def test_d2s_s2d_inverse():
    x = jax.random.normal(jax.random.key(7), (1, 2, 4, 4, 16))
    s2d = vae.space_to_depth(x, (2, 2, 2))
    assert s2d.shape == (1, 1, 2, 2, 128)
    back = vae.depth_to_space(s2d, (2, 2, 2), 16)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-6)


def test_causal_conv_first_frame_independence():
    """Causal conv: output frame 0 must not depend on later input frames."""
    key = jax.random.key(8)
    params = vae.conv3d_init(key, 4, 4)
    x1 = jax.random.normal(jax.random.key(9), (1, 5, 4, 4, 4))
    x2 = x1.at[:, 2:].set(0.0)
    o1 = vae.causal_conv3d(params, x1, causal=True)
    o2 = vae.causal_conv3d(params, x2, causal=True)
    np.testing.assert_allclose(
        np.asarray(o1[:, 0]), np.asarray(o2[:, 0]), atol=1e-5
    )
    # frame 1 sees only inputs [pad, 0, 1] -> also unchanged
    np.testing.assert_allclose(
        np.asarray(o1[:, 1]), np.asarray(o2[:, 1]), atol=1e-5
    )
    # frame 2 sees inputs [0, 1, 2] -> differs (frame 2 was zeroed in x2)
    assert not np.allclose(np.asarray(o1[:, 2]), np.asarray(o2[:, 2]))


def test_noncausal_conv_symmetric():
    params = vae.conv3d_init(jax.random.key(10), 2, 2)
    x = jax.random.normal(jax.random.key(11), (1, 4, 4, 4, 2))
    out = vae.causal_conv3d(params, x, causal=False)
    assert out.shape == x.shape
    # flipping time should flip output when weights are time-symmetric:
    # instead just check frame count preserved and finite
    assert np.isfinite(np.asarray(out)).all()


def test_spatial_padding_modes_differ():
    params = vae.conv3d_init(jax.random.key(12), 2, 2)
    x = jax.random.normal(jax.random.key(13), (1, 2, 4, 4, 2))
    r = vae.causal_conv3d(params, x, causal=True, spatial_mode="reflect")
    z = vae.causal_conv3d(params, x, causal=True, spatial_mode="zeros")
    assert not np.allclose(np.asarray(r), np.asarray(z))
    # interior is identical; only the border differs
    np.testing.assert_allclose(
        np.asarray(r[:, :, 1:-1, 1:-1]), np.asarray(z[:, :, 1:-1, 1:-1]), atol=1e-5
    )


def test_decode_video_tiling_matches_shape(dec_params):
    """Aligned tiling must return exactly 8*(F-1)+1 frames (the reference's
    misaligned blend loses 7 frames per seam — deliberately fixed here)."""
    latent = jax.random.normal(jax.random.key(14), (1, CFG.latent_channels, 5, 2, 2))
    full = vae.decode_video(dec_params, latent, CFG, timestep=None)
    tiled = vae.decode_video(dec_params, latent, CFG, timestep=None,
                             tile_size=3, tile_overlap=1)
    assert full.shape == tiled.shape == (8 * 4 + 1, 64, 64, 3)
    # ranges clipped
    assert np.asarray(tiled).min() >= 0.0 and np.asarray(tiled).max() <= 1.0

    # With CAUSAL convs the first chunk's frames are exactly the full
    # decode's prefix (no lookahead across the seam).
    import dataclasses

    ccfg = dataclasses.replace(CFG, causal=True)
    full_c = vae.decode_video(dec_params, latent, ccfg, timestep=None)
    tiled_c = vae.decode_video(dec_params, latent, ccfg, timestep=None,
                               tile_size=3, tile_overlap=1)
    np.testing.assert_allclose(
        np.asarray(tiled_c[:17]), np.asarray(full_c[:17]), atol=1e-4
    )


def test_decode_video_tiling_overlap2(dec_params):
    latent = jax.random.normal(jax.random.key(17), (1, CFG.latent_channels, 5, 2, 2))
    tiled = vae.decode_video(dec_params, latent, CFG, timestep=None,
                             tile_size=3, tile_overlap=2)
    assert tiled.shape == (33, 64, 64, 3)


def test_encoder_shapes(enc_params):
    # 25 pixel frames -> patchify keeps T, downsamples give (2,1,1)+(2,2,2)x2 = /8 +pad
    pixels = jax.random.normal(jax.random.key(15), (1, 3, 9, 64, 64))
    out = vae.encoder_forward(enc_params, pixels, CFG)
    # T: 9 -> s2d(1,2,2): 9 -> (2,1,1): pad to 10/2=5 -> (2,2,2): pad 6/2=3 -> (2,2,2): pad 4/2=2
    assert out.shape[0:2] == (1, CFG.latent_channels)
    assert out.shape[3] == 64 // 32 and out.shape[4] == 64 // 32
    assert np.isfinite(np.asarray(out)).all()


def test_encoder_single_frame(enc_params):
    """I2V: single image encode (1, 3, 1, H, W) -> (1, 128, 1, H/32, W/32)."""
    pixels = jax.random.normal(jax.random.key(16), (1, 3, 1, 64, 64))
    out = vae.encoder_forward(enc_params, pixels, CFG)
    assert out.shape == (1, CFG.latent_channels, 1, 2, 2)


def test_decode_video_tiling_uint8_transfer(dec_params):
    """transfer_uint8 tiled decode matches the f32 tiled decode within the
    uint8 grid (1/255) — the pipeline uses it to cut device->host bytes 4x.

    overlap=1 has no seam blending, isolating pure quantization error.
    (With blending, u8 clips each tile BEFORE the seam mix while f32 blends
    pre-clip values; random test weights put many pixels out of range, so
    seams differ — irrelevant at real weights where outputs are in-range.)"""
    latent = jax.random.normal(jax.random.key(16),
                               (1, CFG.latent_channels, 5, 2, 2))
    f32 = vae.decode_video(dec_params, latent, CFG, timestep=None,
                           tile_size=3, tile_overlap=1)
    u8 = vae.decode_video(dec_params, latent, CFG, timestep=None,
                          tile_size=3, tile_overlap=1, transfer_uint8=True)
    assert u8.shape == f32.shape
    np.testing.assert_allclose(np.asarray(u8), np.asarray(f32),
                               atol=1.01 / 255)
    # blended variant: shape + range sanity
    u8b = vae.decode_video(dec_params, latent, CFG, timestep=None,
                           tile_size=3, tile_overlap=2, transfer_uint8=True)
    a = np.asarray(u8b)
    assert a.shape == (33, 64, 64, 3)
    assert np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0


def test_yuv420_transfer_close_to_f32():
    """The yuv420 tiled-transfer mode (1.5 B/px on the wire) must stay
    within chroma-subsample error of the exact f32 tiled decode: Y carries
    full resolution (luma error ~1/255), chroma averages 2x2 (bounded
    local error, zero mean). Codec output is yuv420p anyway — this moves
    the same lossy step before the wire."""
    cfg = vae.VAEConfig().tiny()
    params = vae.init_decoder_params(jax.random.key(0), cfg)
    latent = jax.random.normal(jax.random.key(1),
                               (1, cfg.latent_channels, 7, 4, 4))
    exact = np.asarray(vae.decode_video(params, latent, cfg, timestep=None,
                                        tile_size=3, tile_overlap=1))
    yuv = np.asarray(vae.decode_video(params, latent, cfg, timestep=None,
                                      tile_size=3, tile_overlap=1,
                                      transfer_uint8="yuv420"))
    assert yuv.shape == exact.shape
    assert np.isfinite(yuv).all() and yuv.min() >= 0 and yuv.max() <= 1
    # LUMA is transferred at full resolution: it must match the exact
    # decode to quantization + seam-blend error. Chroma error on a RANDOM
    # decoder output is large by construction (2x2 averaging of
    # uncorrelated noise) — real video is chroma-smooth, and the MP4
    # encoder applies the same 4:2:0 subsample regardless.
    def luma(x):
        return (0.299 * x[..., 0] + 0.587 * x[..., 1]
                + 0.114 * x[..., 2])

    lerr = np.abs(luma(yuv) - luma(exact))
    assert lerr.mean() < 5e-3, lerr.mean()
    # max: reconstructed RGB clips at the gamut edge where chroma
    # averaging of NOISE pushes the inverse out of [0,1], shifting the
    # re-derived luma (random-decoder artifact; mean stays at the
    # quantization level)
    assert lerr.max() < 0.15, lerr.max()


def test_yuv420_roundtrip_helpers():
    """Device quantize -> host inverse round-trips within quantization +
    subsample error on a smooth field (exact on flat colors)."""
    from ltx_jax.models.vae import _rgb_to_yuv420_u8, _yuv420_to_rgb_np

    flat = jnp.ones((1, 3, 2, 8, 8), jnp.float32) * jnp.asarray(
        [0.2, -0.4, 0.6]).reshape(1, 3, 1, 1, 1)
    packed = jax.jit(_rgb_to_yuv420_u8)(flat)
    assert packed.shape == (1, 2, 12, 8)  # I420: 3H/2 rows, ONE array
    rgb = _yuv420_to_rgb_np(np.asarray(packed))
    want = np.clip((np.asarray(flat) + 1.0) / 2.0, 0, 1)
    np.testing.assert_allclose(rgb, want, atol=3e-2)
