"""Sharded VAE decode: frame-axis shard_map with halo exchange
(SURVEY.md §2.9 item 5; VERDICT r1 missing #7).

Exactness contract: decode_video_sharded(latent) over n devices equals the
SEQUENTIAL host tiling loop run on the edge-padded latent (padded to
n*stride + overlap frames, which tiles into n FULL chunks) trimmed to the
true pixel count. The pad-then-trim is the only deviation from the ragged
host loop — the decoder's symmetric (non-causal) temporal padding makes a
ragged last tile unreproducible with uniform shard shapes, and an
edge-replicated future frame is the same class of boundary approximation as
the replicate pad it replaces.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.models import vae
from ltx_jax.parallel.sharding import make_mesh

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CFG = dataclasses.replace(vae.VAEConfig().tiny(), timestep_conditioning=False)


@pytest.fixture(scope="module")
def params():
    return vae.init_decoder_params(jax.random.key(0), CFG)


def _seq_reference(params, latent, cfg, n, ov, timestep=None, noise_key=None):
    """Sequential tiled decode of the edge-padded latent, trimmed."""
    f = latent.shape[2]
    stride = -(-f // n)
    pad_total = n * stride + ov - f
    padded = jnp.concatenate(
        [latent, jnp.repeat(latent[:, :, -1:], pad_total, axis=2)], axis=2)
    out = vae.decode_video(params, padded, cfg, timestep=timestep,
                           noise_key=noise_key,
                           tile_size=stride + ov, tile_overlap=ov)
    return out[: 8 * (f - 1) + 1]


@needs_mesh
@pytest.mark.parametrize("f,ov", [(8, 1), (12, 2), (7, 1)])
def test_sharded_matches_padded_sequential(params, f, ov):
    mesh = make_mesh(data=1, model=4)
    latent = jax.random.normal(
        jax.random.key(f * 10 + ov), (1, CFG.latent_channels, f, 2, 2))
    seq = _seq_reference(params, latent, CFG, 4, ov)
    shd = vae.decode_video_sharded(params, latent, CFG, mesh, timestep=None,
                                   tile_overlap=ov)
    assert shd.shape == seq.shape == (8 * (f - 1) + 1, 64, 64, 3)
    np.testing.assert_allclose(np.asarray(shd), np.asarray(seq),
                               atol=2e-5, rtol=2e-5)


@needs_mesh
def test_sharded_interior_matches_unpadded_sequential(params):
    """Away from the final tile, the sharded decode is also bit-identical
    to the RAGGED host loop (real-halo tiles see identical inputs)."""
    mesh = make_mesh(data=1, model=4)
    f, ov = 8, 1
    latent = jax.random.normal(
        jax.random.key(3), (1, CFG.latent_channels, f, 2, 2))
    seq = vae.decode_video(params, latent, CFG, timestep=None,
                           tile_size=2 + ov, tile_overlap=ov)
    shd = vae.decode_video_sharded(params, latent, CFG, mesh, timestep=None,
                                   tile_overlap=ov)
    # devices 0..2 decode all-real tiles: pixels [0, 8*6+1) exact
    np.testing.assert_allclose(np.asarray(shd[:49]), np.asarray(seq[:49]),
                               atol=2e-5, rtol=2e-5)
    assert np.isfinite(np.asarray(shd)).all()


@needs_mesh
def test_sharded_with_decode_noise_matches(params):
    """fold_in(key, device_index) reproduces the host loop's per-tile noise
    on the padded reference exactly."""
    cfg = dataclasses.replace(CFG, timestep_conditioning=True)
    mesh = make_mesh(data=1, model=4)
    latent = jax.random.normal(
        jax.random.key(4), (1, CFG.latent_channels, 8, 2, 2))
    key = jax.random.key(9)
    seq = _seq_reference(params, latent, cfg, 4, 2, timestep=0.05,
                         noise_key=key)
    shd = vae.decode_video_sharded(params, latent, cfg, mesh, timestep=0.05,
                                   noise_key=key, tile_overlap=2)
    assert shd.shape == seq.shape == (8 * 7 + 1, 64, 64, 3)
    np.testing.assert_allclose(np.asarray(shd), np.asarray(seq),
                               atol=2e-5, rtol=2e-5)
    f = np.asarray(shd)
    assert f.min() >= 0.0 and f.max() <= 1.0


@needs_mesh
def test_sharded_decode_uint8_transfer():
    """uint8 device-side quantization after the seam blend matches the f32
    sharded decode within the uint8 grid."""
    params = vae.init_decoder_params(jax.random.key(0), CFG)
    mesh = make_mesh(data=1, model=4)
    latent = jax.random.normal(jax.random.key(5),
                               (1, CFG.latent_channels, 8, 2, 2))
    f32 = vae.decode_video_sharded(params, latent, CFG, mesh, timestep=None,
                                   tile_overlap=2)
    u8 = vae.decode_video_sharded(params, latent, CFG, mesh, timestep=None,
                                  tile_overlap=2, transfer_uint8=True)
    assert u8.shape == f32.shape
    # the u8 path quantizes the SAME post-blend values -> pure grid error
    # wherever f32 lands in [0,1]; clipped pixels are exact too
    np.testing.assert_allclose(np.asarray(u8), np.asarray(f32),
                               atol=1.01 / 255)


@needs_mesh
def test_sharded_yuv420_luma_matches_f32(params):
    """The yuv420 gather format on the SHARDED decode: full-res luma must
    match the exact f32 sharded decode at quantization level (chroma error
    is the codec's own 4:2:0 subsample — see test_vae.py)."""
    mesh = make_mesh(data=1, model=4)
    latent = jax.random.normal(jax.random.key(2),
                               (1, CFG.latent_channels, 6, 4, 4))
    exact = np.asarray(vae.decode_video_sharded(
        params, latent, CFG, mesh, timestep=None, tile_overlap=1))
    yuv = np.asarray(vae.decode_video_sharded(
        params, latent, CFG, mesh, timestep=None, tile_overlap=1,
        transfer_uint8="yuv420"))
    assert yuv.shape == exact.shape

    def luma(x):
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    lerr = np.abs(luma(yuv) - luma(exact))
    assert lerr.mean() < 5e-3, lerr.mean()
    assert lerr.max() < 0.15, lerr.max()
