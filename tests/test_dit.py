"""Video DiT: shapes, scan-vs-unrolled equivalence, STG skips, AdaLN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx_jax.core.config import TransformerConfig
from ltx_jax.models import dit
from ltx_jax.ops import rope as rope_ops

CFG = TransformerConfig().tiny()  # 2 layers, 4 heads x 32 = 128 inner


@pytest.fixture(scope="module")
def setup():
    key = jax.random.key(0)
    params = dit.init_params(key, CFG, dtype=jnp.float32)
    f, h, w = 2, 2, 3
    t = f * h * w
    b, s = 2, 16
    ks = jax.random.split(jax.random.key(1), 3)
    latent = jax.random.normal(ks[0], (b, t, CFG.in_channels), jnp.float32)
    context = jax.random.normal(ks[1], (b, s, CFG.caption_channels), jnp.float32)
    timesteps = jnp.full((b,), 0.5, jnp.float32)
    cos, sin = rope_ops.video_rope(f, h, w, CFG.inner_dim, CFG.num_heads)
    return params, latent, context, timesteps, (jnp.asarray(cos), jnp.asarray(sin))


def test_forward_shape(setup):
    params, latent, context, ts, pe = setup
    out = dit.dit_forward(params, latent, context, ts, pe, CFG)
    assert out.shape == (2, 12, CFG.out_channels)
    assert np.isfinite(np.asarray(out)).all()


def test_scan_matches_unrolled(setup):
    """The lax.scan over stacked blocks must equal a hand-unrolled loop."""
    params, latent, context, ts, pe = setup
    out_scan = dit.dit_forward(params, latent, context, ts, pe, CFG)

    # Manual unroll using block_forward with per-layer params
    b = latent.shape[0]
    from ltx_jax.models.common import linear
    from ltx_jax.ops.normalization import layer_norm_no_affine

    x = linear(params["patchify_proj"], latent)
    ts_emb, embedded = dit.prepare_timestep(params, ts, b, CFG, latent.dtype)
    ctx = dit.caption_projection(params["caption_projection"], context)
    for i in range(CFG.num_layers):
        block_i = jax.tree.map(lambda p: p[i], params["blocks"])
        x = dit.block_forward(block_i, x, ctx, ts_emb, pe, None, CFG)
    table = params["scale_shift_table"].astype(jnp.float32)
    vals = table[None, None] + embedded[:, :, None].astype(jnp.float32)
    shift, scale = vals[:, :, 0], vals[:, :, 1]
    out = layer_norm_no_affine(x, eps=CFG.norm_eps) * (1 + scale) + shift
    out_manual = linear(params["proj_out"], out.astype(latent.dtype))

    np.testing.assert_allclose(
        np.asarray(out_scan), np.asarray(out_manual), atol=2e-5
    )


def test_per_token_timesteps(setup):
    """I2V path: (B, T) per-token sigmas must work and differ from scalar."""
    params, latent, context, ts, pe = setup
    b, t, _ = latent.shape
    per_token = jnp.full((b, t), 0.5, jnp.float32).at[:, 0].set(0.0)
    out = dit.dit_forward(params, latent, context, per_token, pe, CFG)
    out_scalar = dit.dit_forward(params, latent, context, ts, pe, CFG)
    assert out.shape == out_scalar.shape
    assert not np.allclose(np.asarray(out), np.asarray(out_scalar))
    # scalar-equivalent per-token should match scalar exactly
    out_eq = dit.dit_forward(
        params, latent, context, jnp.full((b, t), 0.5, jnp.float32), pe, CFG
    )
    np.testing.assert_allclose(
        np.asarray(out_eq), np.asarray(out_scalar), atol=1e-5
    )


def test_stg_skip_affects_only_perturbed_row(setup):
    params, latent, context, ts, pe = setup
    skip_sa, skip_ff = dit.stg_skip_masks(CFG, batch=2, stg_blocks=[1],
                                          perturbed_rows=[1])
    out_skip = dit.dit_forward(params, latent, context, ts, pe, CFG,
                               skip_self_attn=skip_sa, skip_ff=skip_ff)
    out_base = dit.dit_forward(params, latent, context, ts, pe, CFG)
    # row 0 unchanged, row 1 changed
    np.testing.assert_allclose(
        np.asarray(out_skip[0]), np.asarray(out_base[0]), atol=1e-6
    )
    assert not np.allclose(np.asarray(out_skip[1]), np.asarray(out_base[1]))


def test_cross_attention_scale(setup):
    params, latent, context, ts, pe = setup
    out1 = dit.dit_forward(params, latent, context, ts, pe, CFG,
                           cross_attn_scale=1.0)
    out_base = dit.dit_forward(params, latent, context, ts, pe, CFG)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out_base), atol=1e-6)
    out2 = dit.dit_forward(params, latent, context, ts, pe, CFG,
                           cross_attn_scale=1.5)
    assert not np.allclose(np.asarray(out2), np.asarray(out_base))


def test_context_mask_bias(setup):
    """Masking out pad tokens must change the output; all-ones mask must not."""
    from ltx_jax.ops.attention import prepare_additive_mask

    params, latent, context, ts, pe = setup
    b, s = context.shape[0], context.shape[1]
    ones = prepare_additive_mask(jnp.ones((b, s), jnp.int32))
    out_ones = dit.dit_forward(params, latent, context, ts, pe, CFG,
                               context_bias=ones)
    out_none = dit.dit_forward(params, latent, context, ts, pe, CFG)
    np.testing.assert_allclose(
        np.asarray(out_ones), np.asarray(out_none), atol=1e-5
    )
    half = prepare_additive_mask(
        jnp.concatenate([jnp.ones((b, s // 2), jnp.int32),
                         jnp.zeros((b, s // 2), jnp.int32)], axis=1)
    )
    out_half = dit.dit_forward(params, latent, context, ts, pe, CFG,
                               context_bias=half)
    assert not np.allclose(np.asarray(out_half), np.asarray(out_none))


def test_remat_matches(setup):
    params, latent, context, ts, pe = setup
    out = dit.dit_forward(params, latent, context, ts, pe, CFG, remat=True)
    out_base = dit.dit_forward(params, latent, context, ts, pe, CFG)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_base), atol=1e-6)


def test_jit_compiles_once_across_sigmas(setup):
    """Timesteps are traced values — same compiled fn for every sigma."""
    params, latent, context, ts, pe = setup
    fwd = jax.jit(lambda p, l, c, t: dit.dit_forward(p, l, c, t, pe, CFG))
    o1 = fwd(params, latent, context, jnp.full((2,), 0.9))
    o2 = fwd(params, latent, context, jnp.full((2,), 0.1))
    assert fwd._cache_size() == 1
    assert not np.allclose(np.asarray(o1), np.asarray(o2))
