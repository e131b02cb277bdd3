"""Offline weight-loading contract: loaders vs the independently-transcribed
checkpoint inventories in tests/weight_fixtures.py.

Every test asserts some combination of:
  * key COUNT of the real-scale spec matches a hand-derived constant
    (a drifted key table changes the count);
  * the mapping function maps 100% of source keys with no collisions;
  * the loader consumes 100% of a materialized fixture (strict mode /
    TrackingDict) and leaves nothing unmapped;
  * transposed shapes land where the (in, out) / channels-last layouts say.

Real-scale param totals double as the reconciliation of the '19B' claims:
  video DiT 13.04e9, AV DiT 18.88e9, Gemma-12B 12.77e9 (incl. lm_head).
"""

import numpy as np
import pytest

import weight_fixtures as wf
from ltx_jax.core.errors import WeightLoadingFailedError
from ltx_jax.models import audio_vae, upscaler
from ltx_jax.weights import keymaps

# Tiny dims for materialized loads; layer/block COUNTS stay real so the
# key sets are count-identical to the real checkpoints.
TINY = dict(inner=32, audio_inner=16, in_channels=8, out_channels=8,
            cross_dim=32, caption_dim=24)
VIDEO_TINY = {k: v for k, v in TINY.items() if k != "audio_inner"}


# ---------------------------------------------------------------------------
# Video DiT
# ---------------------------------------------------------------------------


def test_video_dit_spec_counts():
    spec = wf.video_transformer_spec()
    assert len(spec) == 1215                      # 15 top + 48 x 25
    assert wf.param_count(spec) == 13_041_520_768


def test_video_dit_mapping_total_and_collision_free():
    spec = wf.video_transformer_spec()
    mapped = {}
    for key in spec:
        out = keymaps.map_transformer_key(key)
        assert out is not None, key
        assert out not in mapped, f"collision: {key} and {mapped[out]} -> {out}"
        mapped[out] = key
    assert len(mapped) == len(spec)


def test_video_dit_loader_consumes_everything():
    spec = wf.video_transformer_spec(
        num_layers=48, inner=TINY["inner"], in_channels=TINY["in_channels"],
        out_channels=TINY["out_channels"], cross_dim=TINY["cross_dim"],
        caption_dim=TINY["caption_dim"])
    tensors = wf.materialize(spec)
    params = keymaps.load_transformer_params(tensors, 48, strict=True)
    # (in, out) transpose: proj_in torch (inner, in_ch) -> (in_ch, inner)
    assert params["patchify_proj"]["w"].shape == (TINY["in_channels"],
                                                  TINY["inner"])
    assert params["blocks"]["attn2"]["to_k"]["w"].shape == (
        48, TINY["cross_dim"], TINY["inner"])
    np.testing.assert_allclose(
        np.asarray(params["blocks"]["ff"]["project_out"]["w"][7],
                   np.float32),
        tensors["transformer_blocks.7.ff.net.2.weight"].T,
        rtol=0.01, atol=1e-4)


def test_video_dit_strict_flags_extra_key():
    spec = wf.video_transformer_spec(num_layers=2, **VIDEO_TINY)
    tensors = wf.materialize(spec)
    tensors["mystery_module.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(WeightLoadingFailedError, match="mystery_module"):
        keymaps.load_transformer_params(tensors, 2, strict=True)
    # escape hatch still loads
    keymaps.load_transformer_params(tensors, 2, strict=False)


# ---------------------------------------------------------------------------
# AV DiT
# ---------------------------------------------------------------------------


def test_av_dit_spec_counts():
    spec = wf.av_transformer_spec()
    assert len(spec) == 3894                      # 54 top + 48 x 80
    assert wf.param_count(spec) == 18_877_354_240  # the "19B" checkpoint


def test_av_dit_mapping_total_and_collision_free():
    spec = wf.av_transformer_spec()
    mapped = {}
    for key in spec:
        out = keymaps.map_transformer_key(key, include_audio=True)
        assert out is not None, key
        assert out not in mapped, f"collision: {key} and {mapped[out]} -> {out}"
        mapped[out] = key
    # With include_audio=False the reference's skip rules
    # (ModelDownloader.swift:758-767) drop the audio stream + cross-modal
    # block keys...
    for k in ("audio_patchify_proj.weight",
              "audio_adaln_single.linear.weight",
              "transformer_blocks.0.audio_attn1.to_q.weight",
              "transformer_blocks.0.audio_ff.net.0.proj.weight",
              "transformer_blocks.0.audio_to_video_attn.to_q.weight",
              "transformer_blocks.0.video_to_audio_attn.to_q.weight",
              "transformer_blocks.0.scale_shift_table_a2v_ca_video",
              "transformer_blocks.0.scale_shift_table_a2v_ca_audio"):
        assert keymaps.map_transformer_key(k) is None, k
    # ...and ALSO the av_ca_* top-level singles and the AV blocks'
    # learnable norm1-3. The reference's skip patterns don't match these —
    # it drops them LATER as unmatched module keys
    # (ModelDownloader.swift:990-1003); our assembler is STRICT (no
    # drop-unmatched stage), so the video mapping drops them here instead.
    # Same end state: a video DiT built from an AV checkpoint carries
    # neither (its adaln norms are weightless, LTXTransformerBlock.swift:
    # 72-83). Caught by tests/test_load_pipeline_e2e.py.
    for k in ("av_ca_video_scale_shift_adaln_single.linear.weight",
              "av_ca_a2v_gate_adaln_single.linear.weight",
              "transformer_blocks.0.norm1.weight"):
        assert keymaps.map_transformer_key(k) is None, k
        assert keymaps.map_transformer_key(k, include_audio=True) is not None, k


def test_av_dit_loader_consumes_everything():
    spec = wf.av_transformer_spec(num_layers=48, **TINY)
    tensors = wf.materialize(spec)
    params = keymaps.load_av_transformer_params(tensors, 48, strict=True)
    ai, vi = TINY["audio_inner"], TINY["inner"]
    # cross-modal attention dims (LTX2TransformerBlock.swift:150-163):
    # A2V q: video->audio_inner; to_out: audio_inner->video
    assert params["blocks"]["audio_to_video_attn"]["to_q"]["w"].shape == (
        48, vi, ai)
    assert params["blocks"]["audio_to_video_attn"]["to_out"]["w"].shape == (
        48, ai, vi)
    assert params["blocks"]["video_to_audio_attn"]["to_k"]["w"].shape == (
        48, vi, ai)
    assert params["av_ca_video_scale_shift_adaln_single"]["linear"][
        "w"].shape == (vi, 4 * vi)
    assert params["av_ca_v2a_gate_adaln_single"]["linear"]["w"].shape == (
        ai, 1 * ai)


def test_av_dit_alt_spellings_accepted():
    """The loader also accepts the plausible Diffusers-side spellings
    audio_proj_in / audio_time_embed (one test per spelling)."""
    spec = wf.av_transformer_spec(num_layers=1, **TINY)
    base = wf.materialize(spec)

    def renamed(prefix_from, prefix_to):
        return {k.replace(prefix_from, prefix_to, 1)
                if k.startswith(prefix_from) else k: v
                for k, v in base.items()}

    canonical = keymaps.load_av_transformer_params(dict(base), 1)
    for a, b in (("audio_patchify_proj.", "audio_proj_in."),
                 ("audio_adaln_single.", "audio_time_embed.")):
        variant = keymaps.load_av_transformer_params(renamed(a, b), 1)
        np.testing.assert_array_equal(
            np.asarray(variant["audio_patchify_proj"]["w"], np.float32),
            np.asarray(canonical["audio_patchify_proj"]["w"], np.float32))
        np.testing.assert_array_equal(
            np.asarray(variant["audio_adaln_single"]["emb"]["linear_1"]["w"],
                       np.float32),
            np.asarray(canonical["audio_adaln_single"]["emb"]["linear_1"]["w"],
                       np.float32))


# ---------------------------------------------------------------------------
# VAE decoder / encoder
# ---------------------------------------------------------------------------


def test_vae_decoder_spec_counts():
    assert len(wf.vae_decoder_spec(layout="unified")) == 134
    assert len(wf.vae_decoder_spec(layout="diffusers")) == 117


@pytest.mark.parametrize("layout", ["unified", "diffusers"])
def test_vae_decoder_mapping_total(layout):
    spec = wf.vae_decoder_spec(layout=layout)
    mapped = {}
    for key in spec:
        out = keymaps.map_vae_decoder_key(key)
        assert out is not None, key
        assert out not in mapped, f"collision: {key} and {mapped[out]}"
        mapped[out] = key


@pytest.mark.parametrize("layout", ["unified", "diffusers"])
def test_vae_decoder_loader_consumes_everything(layout):
    spec = wf.vae_decoder_spec(base=32, latent=8, layout=layout)
    tensors = wf.materialize(spec)
    params = keymaps.load_vae_decoder_params(tensors, strict=True)
    assert len(params["up_blocks_0"]["res_blocks"]) == 5
    # channels-last conv: torch (O=32, I=8, 3,3,3) -> (3,3,3,8,32)
    assert params["conv_in"]["w"].shape == (3, 3, 3, 8, 32)
    if layout == "unified":
        assert "time_embedder" in params["up_blocks_0"]
        # 256 -> 4*ch embedder, (in, out) layout
        assert params["up_blocks_2"]["time_embedder"]["timestep_embedder"][
            "linear_2"]["w"].shape == (256, 4 * 16)
    assert params["mean_of_means"].shape == (8,)


def test_vae_decoder_time_embedder_collision_pinned():
    """Swift's legacy up_blocks.{i} fall-through sends BOTH
    mid_block.time_embedder and up_blocks.0.time_embedder to
    up_blocks_0.time_embedder (ModelDownloader.swift:856-885) — the flat
    (unified) layout is the unambiguous one; pin the behavior so a future
    'fix' is a conscious decision."""
    a = keymaps.map_vae_decoder_key(
        "decoder.mid_block.time_embedder.timestep_embedder.linear_1.weight")
    b = keymaps.map_vae_decoder_key(
        "decoder.up_blocks.0.time_embedder.timestep_embedder.linear_1.weight")
    assert a == b == \
        "up_blocks_0.time_embedder.timestep_embedder.linear_1.weight"


def test_vae_encoder_spec_and_loader():
    spec = wf.vae_encoder_spec()
    assert len(spec) == 92
    tiny = wf.vae_encoder_spec(base=8)
    tensors = wf.materialize(tiny)
    params = keymaps.load_vae_encoder_params(tensors, strict=True)
    assert [len(b["resnets"]) for b in params["down_blocks"]] == [4, 6, 6, 2]
    assert len(params["mid_block"]["resnets"]) == 2
    # downsampler conv emits out/stride-product channels: block1 (2,1,1):
    # 8*4 / 2 = 16 out channels, channels-last
    assert params["down_blocks"][1]["downsamplers"]["conv"]["w"].shape == \
        (3, 3, 3, 16, 16)
    # conv_out emits latent+logvar channels: base + 1 (129 at real scale)
    assert params["conv_out"]["w"].shape[-1] == 8 + 1


# ---------------------------------------------------------------------------
# Text-encoder connector (both formats)
# ---------------------------------------------------------------------------


def test_connector_spec_counts():
    assert len(wf.connector_spec(1)) == 30
    assert len(wf.connector_spec(1, include_audio=True)) == 59
    assert len(wf.connector_spec(2)) == 30
    assert len(wf.connector_spec(2, include_audio=True)) == 59


@pytest.mark.parametrize("fmt", [1, 2])
@pytest.mark.parametrize("audio", [False, True])
def test_connector_loader_consumes_everything(fmt, audio):
    spec = wf.connector_spec(fmt, include_audio=audio, dim=16,
                             gemma_layers=3)
    # aggregate_embed is bias-free (LTXTextEncoder.swift:138-142)
    assert not any(k.endswith("aggregate_embed.bias") or
                   k == "text_proj_in.bias" for k in spec)
    tensors = wf.materialize(spec)
    params = keymaps.load_text_encoder_params(tensors, strict=True)
    assert params["feature_extractor"]["aggregate_embed"]["w"].shape == \
        (16 * 3, 16)
    assert len(params["embeddings_connector"]["transformer_1d_blocks"]) == 2
    assert ("audio_embeddings_connector" in params) == audio


def test_connector_mapping_total():
    for fmt in (1, 2):
        spec = wf.connector_spec(fmt, include_audio=True)
        mapped = {}
        for key in spec:
            out = keymaps.map_text_encoder_key(key)
            assert out is not None, key
            assert out not in mapped
            mapped[out] = key
    # formats 1 and 2 land on the SAME canonical keys
    c1 = {keymaps.map_text_encoder_key(k)
          for k in wf.connector_spec(1, include_audio=True)}
    c2 = {keymaps.map_text_encoder_key(k)
          for k in wf.connector_spec(2, include_audio=True)}
    assert c1 == c2


# ---------------------------------------------------------------------------
# Audio VAE / vocoder / upscaler (TrackingDict consumption)
# ---------------------------------------------------------------------------


def test_audio_vae_loader_consumes_everything():
    spec = wf.audio_vae_spec()
    assert len(spec) == 58
    tiny = wf.audio_vae_spec(latent=4, base=8, mel_bins_packed=8)
    tensors = wf.TrackingDict(wf.materialize(tiny))
    params = audio_vae.load_audio_vae_params(tensors)
    assert tensors.unconsumed == set()
    assert len(params["decoder"]["up"]) == 3
    assert "nin_shortcut" in params["decoder"]["up"][0]["block"][0]
    assert "nin_shortcut" not in params["decoder"]["up"][2]["block"][0]
    assert "upsample" not in params["decoder"]["up"][0]
    assert "upsample" in params["decoder"]["up"][2]
    # conv (O, I, H, W) -> (H, W, I, O): conv_in 4 -> 32
    assert params["decoder"]["conv_in"]["w"].shape == (3, 3, 4, 32)


def test_vocoder_loader_consumes_everything():
    spec = wf.vocoder_spec()
    assert len(spec) == 194
    tiny = wf.vocoder_spec(in_ch=8, hidden=64)
    tensors = wf.TrackingDict(wf.materialize(tiny))
    params = audio_vae.load_vocoder_params(tensors)
    assert tensors.unconsumed == set()
    assert len(params["upsamplers"]) == 5
    assert len(params["resnets"]) == 15
    # ConvT torch (in=64, out=32, k=16) -> (k, out...) our (K, I, O) layout
    assert params["upsamplers"][0]["w"].shape == (16, 32, 64)
    assert params["resnets"][3]["convs1"][0]["w"].shape[0] == 3  # k=3 stage 2


def test_upscaler_loader_skips_only_blur_down():
    spec = wf.upscaler_spec()
    assert len(spec) == 73
    tiny = wf.upscaler_spec(in_ch=4, mid=8)
    tensors = wf.TrackingDict(wf.materialize(tiny))
    params = upscaler.load_params(tensors)
    # the fixed blur kernel is the ONLY unconsumed key
    # (SpatialUpscaler.swift:302-305 skips it)
    assert tensors.unconsumed == {"blur_down_kernel"}
    assert len(params["res_blocks"]) == 4
    assert len(params["post_upsample_res_blocks"]) == 4
    assert params["upsampler"]["conv"]["w"].shape == (3, 3, 8, 32)


# ---------------------------------------------------------------------------
# Gemma-3
# ---------------------------------------------------------------------------


def test_gemma_spec_counts():
    assert len(wf.gemma_spec()) == 627
    assert len(wf.gemma_spec(mlx_4bit=True)) == 1303
    # 12.77B incl. the lm_head the loader drops
    assert wf.param_count(wf.gemma_spec()) == 12_772_912_896


@pytest.mark.parametrize("vlm", [False, True])
def test_gemma_loader_consumes_everything(vlm):
    spec = wf.gemma_spec(layers=48, hidden=32, heads=2, kv_heads=1,
                         head_dim=8, intermediate=64, vocab=128,
                         vlm_prefix=vlm)
    tensors = wf.materialize(spec)
    params = keymaps.load_gemma_params(tensors, 48, strict=True)
    assert params["layers"]["q_proj"]["w"].shape == (48, 32, 16)
    assert params["layers"]["q_norm"]["w"].shape == (48, 8)
    assert params["embed_tokens"]["w"].shape == (128, 32)


def test_gemma_4bit_loader_consumes_everything():
    spec = wf.gemma_spec(layers=2, hidden=512, heads=2, kv_heads=1,
                         head_dim=256, intermediate=512, vocab=64,
                         mlx_4bit=True)
    tensors = wf.materialize(spec)
    params = keymaps.load_gemma_params(tensors, 2, strict=True,
                                       keep_quantized=False)
    assert params["layers"]["q_proj"]["w"].shape == (2, 512, 512)
    # embeddings always dequantize to a dense bf16 table
    assert params["embed_tokens"]["w"].shape == (64, 512)


# ---------------------------------------------------------------------------
# Unified-file split end-to-end
# ---------------------------------------------------------------------------


def _unified_fixture(include_audio: bool):
    diff = "model.diffusion_model."
    dit_spec = (wf.av_transformer_spec(num_layers=2, **TINY) if include_audio
                else wf.video_transformer_spec(num_layers=2, **VIDEO_TINY))
    spec = {diff + k: v for k, v in dit_spec.items()}
    spec.update({diff + k: v for k, v in wf.connector_spec(
        2, include_audio=include_audio, dim=16, gemma_layers=3).items()})
    spec.update({"vae." + k: v
                 for k, v in wf.vae_decoder_spec(base=32, latent=8).items()})
    # FP8 scale keys the split must drop (ModelDownloader.swift:1368)
    spec[diff + "proj_in.weight_scale"] = (1,)
    spec[diff + "proj_in.input_scale"] = (1,)
    return spec


@pytest.mark.parametrize("include_audio", [False, True])
def test_unified_split_routes_every_key(include_audio):
    spec = _unified_fixture(include_audio)
    tensors = wf.materialize(spec)
    tr, va, conn = keymaps.split_unified(tensors,
                                         include_audio=include_audio)
    # every non-dropped key lands in exactly one bucket
    routed = len(tr) + len(va) + len(conn)
    dropped = 2   # the two fp8 scale keys
    if include_audio:
        assert routed == len(spec) - dropped
    else:
        audio_keys = len(spec) - 2 - len(_unified_fixture(False)) + 2
        assert routed == len(_unified_fixture(False)) - dropped
    # and the three loaders consume their buckets fully
    if include_audio:
        keymaps.load_av_transformer_params(tr, 2, strict=True)
    else:
        keymaps.load_transformer_params(tr, 2, strict=True)
    keymaps.load_vae_decoder_params(va, strict=True)
    keymaps.load_text_encoder_params(conn, strict=True)
