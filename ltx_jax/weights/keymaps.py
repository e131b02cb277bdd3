"""Safetensors key mapping + pytree assembly for every model component.

Ports the reference's six key-map tables faithfully
(reference: Sources/LTXVideo/Utils/ModelDownloader.swift:605-1399) and then
goes one step further: the reference maps strings onto an isomorphic Swift
module tree, while our DiT/Gemma pytrees STACK all layers along a leading
axis for lax.scan, and all linear weights use the (in, out) layout. So each
loader = (string map) -> (group by layer) -> (stack + transpose).

All functions take a flat {key: np.ndarray} dict (from safetensors) and
return ready-to-use parameter pytrees of HOST (numpy) arrays — real-scale
weights (19B DiT bf16 = 38 GB) must never stage through device HBM during
load; device placement (plain, or sharded over a mesh) happens explicitly in
pipeline.loader / LTXPipeline per phase.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import ml_dtypes
import numpy as np

Tensors = Dict[str, np.ndarray]

bfloat16 = ml_dtypes.bfloat16


def _t(x):
    """(out, in) torch linear -> (in, out).

    Cache-blocked native transpose when available: numpy's strided bf16
    copy measured 0.13 GB/s (1.06 s for one 67M-element layer — minutes
    over a real checkpoint); ltx_jax.native does it L1-tiled."""
    if isinstance(x, np.ndarray) and x.ndim == 2 and x.itemsize in (1, 2, 4):
        from ltx_jax import native

        if native.available():
            return native.transpose(x)
    return np.ascontiguousarray(np.transpose(x))


def _check_consumed(leftover, what: str, strict: bool):
    """Every loader ends with this: a non-empty leftover means the key table
    drifted from the checkpoint (or vice versa) — fail loudly instead of
    silently dropping weights (the reference merely logs unmatched keys,
    ModelDownloader.swift:999-1003; we treat that as a load error unless
    strict=False)."""
    if strict and leftover:
        from ltx_jax.core.errors import WeightLoadingFailedError

        sample = ", ".join(sorted(leftover)[:8])
        raise WeightLoadingFailedError(
            f"{len(leftover)} unconsumed {what} keys (table drift?): {sample}"
        )


def _conv3d_t(x):
    """(O, I, T, H, W) torch conv3d -> (T, H, W, I, O) for NDHWC."""
    return np.ascontiguousarray(np.transpose(x, (2, 3, 4, 1, 0)))


def _bf16(x):
    """float32 -> bfloat16 at load (reference: ModelDownloader.swift:1005-1015).
    Host-side — no device staging during load. Native round-to-nearest-even
    cast when available (ml_dtypes' ufunc is scalar-loop slow; same bits)."""
    arr = np.asarray(x)
    if arr.dtype == np.float32:
        from ltx_jax import native

        out = native.f32_to_bf16(arr)
        return out if out is not None else arr.astype(bfloat16)
    return arr


# ---------------------------------------------------------------------------
# Transformer (video DiT + dual AV)
# ---------------------------------------------------------------------------


def map_transformer_key(key: str, include_audio: bool = False) -> Optional[str]:
    """Diffusers/unified key -> canonical key
    (reference: ModelDownloader.swift:732-803). Returns None to skip."""
    if not include_audio:
        if (key.startswith("audio_") or ".audio_" in key
                or key.startswith("av_cross_attn_")
                or key.startswith("av_ca_")  # resolved AV spellings
                or "video_to_audio" in key or "video_a2v" in key
                or "a2v_ca" in key or "scale_shift_table_a2v" in key):
            return None
        # dual-AV-block-only leaves: the video model's adaln norms are
        # weightless (LTXTransformerBlock.swift:72-83), so a video DiT
        # extracted from an AV checkpoint (which carries LEARNABLE
        # norm1/2/3 per dual block, LTX2TransformerBlock.swift:71-86)
        # drops them — exactly what the reference's drop-unmatched apply
        # does (ModelDownloader.swift:990-1003).
        if re.search(r"(^|\.)norm[123]\.", key):
            return None

    k = key
    if k.startswith("proj_in."):
        k = "patchify_proj." + k[len("proj_in."):]
    if k.startswith("time_embed.emb.timestep_embedder."):
        k = "adaln_single.emb." + k[len("time_embed.emb.timestep_embedder."):]
    elif k.startswith("time_embed.linear."):
        k = "adaln_single." + k[len("time_embed."):]
    elif k.startswith("adaln_single.emb.timestep_embedder."):
        k = "adaln_single.emb." + k[len("adaln_single.emb.timestep_embedder."):]
    k = k.replace(".emb.timestep_embedder.", ".emb.")
    k = k.replace(".norm_q.", ".q_norm.")
    k = k.replace(".norm_k.", ".k_norm.")
    k = k.replace(".to_out.0.", ".to_out.")
    k = k.replace("ff.net.0.proj.", "ff.project_in.proj.")
    k = k.replace("ff.net.2.", "ff.project_out.")
    return k


_BLOCK_RE = re.compile(r"^transformer_blocks\.(\d+)\.(.+)$")


def _set_path(tree: dict, path: Tuple[str, ...], value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def assemble_transformer_params(raw: Tensors, num_layers: int,
                                include_audio: bool = False,
                                strict: bool = True) -> dict:
    """Canonical-keyed tensors -> stacked DiT pytree (models/dit.py layout).

    Canonical keys look like:
      patchify_proj.{weight,bias}
      adaln_single.emb.linear_{1,2}.{weight,bias}; adaln_single.linear.*
      caption_projection.linear_{1,2}.*
      transformer_blocks.{i}.attn{1,2}.{to_q,to_k,to_v,to_out}.{weight,bias}
      transformer_blocks.{i}.attn{1,2}.{q,k}_norm.weight
      transformer_blocks.{i}.ff.project_in.proj.*; ff.project_out.*
      transformer_blocks.{i}.scale_shift_table
      norm_out has no params (affine-free); proj_out.*; scale_shift_table
    """
    per_layer: list = [dict() for _ in range(num_layers)]
    top: dict = {}

    for key, value in raw.items():
        m = _BLOCK_RE.match(key)
        if m:
            idx = int(m.group(1))
            if idx >= num_layers:
                raise KeyError(f"block index {idx} >= num_layers {num_layers}")
            per_layer[idx][m.group(2)] = value
        else:
            top[key] = value

    def linear(d: dict, prefix: str, dest: dict, dest_key: str):
        w = d.pop(f"{prefix}.weight")
        p = {"w": _bf16(_t(w))}
        if f"{prefix}.bias" in d:
            p["b"] = _bf16(d.pop(f"{prefix}.bias"))
        dest[dest_key] = p

    # --- per-layer blocks -> stacked
    layers = []
    for i, d in enumerate(per_layer):
        blk: dict = {"attn1": {}, "attn2": {}, "ff": {}}
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                linear(d, f"{attn}.{proj}", blk[attn], proj)
            for nrm in ("q_norm", "k_norm"):
                blk[attn][nrm] = {"w": _bf16(d.pop(f"{attn}.{nrm}.weight"))}
        linear(d, "ff.project_in.proj", blk["ff"], "project_in")
        linear(d, "ff.project_out", blk["ff"], "project_out")
        blk["scale_shift_table"] = np.asarray(
            d.pop("scale_shift_table"), np.float32
        )
        if d:
            leftover = sorted(d)[:5]
            raise KeyError(f"unconsumed block-{i} keys: {leftover}")
        layers.append(blk)

    import jax

    stacked = jax.tree.map(lambda *xs: np.stack(xs), *layers)

    params: dict = {"blocks": stacked}
    linear(top, "patchify_proj", params, "patchify_proj")
    params["adaln_single"] = {"emb": {}}
    linear(top, "adaln_single.emb.linear_1", params["adaln_single"]["emb"],
           "linear_1")
    linear(top, "adaln_single.emb.linear_2", params["adaln_single"]["emb"],
           "linear_2")
    linear(top, "adaln_single.linear", params["adaln_single"], "linear")
    params["caption_projection"] = {}
    linear(top, "caption_projection.linear_1", params["caption_projection"],
           "linear_1")
    linear(top, "caption_projection.linear_2", params["caption_projection"],
           "linear_2")
    linear(top, "proj_out", params, "proj_out")
    params["scale_shift_table"] = np.asarray(
        top.pop("scale_shift_table"), np.float32
    )
    _check_consumed(top, "top-level transformer", strict)
    return params


def load_transformer_params(tensors: Tensors, num_layers: int,
                            include_audio: bool = False,
                            strict: bool = True) -> dict:
    """Unified-file or pre-stripped tensors -> DiT pytree."""
    diffusion = "model.diffusion_model."
    raw: Tensors = {}
    for key, value in tensors.items():
        if key.endswith(".weight_scale") or key.endswith(".input_scale"):
            continue
        k = key
        if k.startswith(diffusion):
            k = k[len(diffusion):]
        if k.startswith("video_embeddings_connector.") or \
                k.startswith("audio_embeddings_connector.") or \
                k.startswith("text_embedding_projection.") or \
                k.startswith("vae.") or "per_channel_statistics" in k or \
                k.startswith("vocoder"):
            continue
        mapped = map_transformer_key(k, include_audio)
        if mapped is not None:
            raw[mapped] = value
    return assemble_transformer_params(raw, num_layers, include_audio,
                                       strict=strict)


def assemble_av_transformer_params(raw: Tensors, num_layers: int,
                                   strict: bool = True) -> dict:
    """Canonical-keyed tensors -> dual AV DiT pytree (models/dit_av.py).

    Accepts both plausible checkpoint spellings for the audio top-level
    modules (audio_proj_in|audio_patchify_proj,
    audio_time_embed|audio_adaln_single, audio_proj_out) — the reference's
    Swift key map leaves audio keys untouched while its module keys use the
    patchify/adaln names (ModelDownloader.swift:744-760), so the real
    checkpoint must carry whichever the module expects.
    """
    per_layer: list = [dict() for _ in range(num_layers)]
    top: dict = {}
    for key, value in raw.items():
        m = _BLOCK_RE.match(key)
        if m:
            idx = int(m.group(1))
            per_layer[idx][m.group(2)] = value
        else:
            top[key] = value

    def lin(d, prefix, alt=None):
        pre = prefix if f"{prefix}.weight" in d else alt
        if pre is None or f"{pre}.weight" not in d:
            raise KeyError(f"missing linear {prefix} (alt {alt})")
        p = {"w": _bf16(_t(d.pop(f"{pre}.weight")))}
        if f"{pre}.bias" in d:
            p["b"] = _bf16(d.pop(f"{pre}.bias"))
        return p

    def attn(d, prefix):
        out = {}
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            out[proj] = lin(d, f"{prefix}.{proj}")
        for nrm in ("q_norm", "k_norm"):
            out[nrm] = {"w": _bf16(d.pop(f"{prefix}.{nrm}.weight"))}
        return out

    def norm(d, prefix):
        return {"w": _bf16(d.pop(f"{prefix}.weight"))}

    def ff(d, prefix):
        return {
            "project_in": lin(d, f"{prefix}.project_in.proj"),
            "project_out": lin(d, f"{prefix}.project_out"),
        }

    def sst(d, key):
        return np.asarray(d.pop(key), np.float32)

    layers = []
    for i, d in enumerate(per_layer):
        blk = {
            "norm1": norm(d, "norm1"), "attn1": attn(d, "attn1"),
            "norm2": norm(d, "norm2"), "attn2": attn(d, "attn2"),
            "norm3": norm(d, "norm3"), "ff": ff(d, "ff"),
            "scale_shift_table": sst(d, "scale_shift_table"),
            "audio_norm1": norm(d, "audio_norm1"),
            "audio_attn1": attn(d, "audio_attn1"),
            "audio_norm2": norm(d, "audio_norm2"),
            "audio_attn2": attn(d, "audio_attn2"),
            "audio_norm3": norm(d, "audio_norm3"),
            "audio_ff": ff(d, "audio_ff"),
            "audio_scale_shift_table": sst(d, "audio_scale_shift_table"),
            "audio_to_video_norm": norm(d, "audio_to_video_norm"),
            "audio_to_video_attn": attn(d, "audio_to_video_attn"),
            "video_to_audio_norm": norm(d, "video_to_audio_norm"),
            "video_to_audio_attn": attn(d, "video_to_audio_attn"),
            "scale_shift_table_a2v_ca_video":
                sst(d, "scale_shift_table_a2v_ca_video"),
            "scale_shift_table_a2v_ca_audio":
                sst(d, "scale_shift_table_a2v_ca_audio"),
        }
        if d:
            raise KeyError(f"unconsumed AV block-{i} keys: {sorted(d)[:5]}")
        layers.append(blk)

    import jax

    def adaln(d, prefix, alt=None):
        pre = prefix if f"{prefix}.emb.linear_1.weight" in d else (alt or prefix)
        return {
            "emb": {
                "linear_1": lin(d, f"{pre}.emb.linear_1"),
                "linear_2": lin(d, f"{pre}.emb.linear_2"),
            },
            "linear": lin(d, f"{pre}.linear"),
        }

    params = {
        "blocks": jax.tree.map(lambda *xs: np.stack(xs), *layers),
        "patchify_proj": lin(top, "patchify_proj"),
        "adaln_single": adaln(top, "adaln_single"),
        "caption_projection": {
            "linear_1": lin(top, "caption_projection.linear_1"),
            "linear_2": lin(top, "caption_projection.linear_2"),
        },
        "proj_out": lin(top, "proj_out"),
        "scale_shift_table": np.asarray(top.pop("scale_shift_table"),
                                        np.float32),
        "audio_patchify_proj": lin(top, "audio_patchify_proj",
                                   alt="audio_proj_in"),
        "audio_adaln_single": adaln(top, "audio_adaln_single",
                                    alt="audio_time_embed"),
        "audio_caption_projection": {
            "linear_1": lin(top, "audio_caption_projection.linear_1"),
            "linear_2": lin(top, "audio_caption_projection.linear_2"),
        },
        "audio_proj_out": lin(top, "audio_proj_out"),
        "audio_scale_shift_table": np.asarray(
            top.pop("audio_scale_shift_table"), np.float32),
        "av_ca_video_scale_shift_adaln_single": adaln(
            top, "av_ca_video_scale_shift_adaln_single"),
        "av_ca_a2v_gate_adaln_single": adaln(
            top, "av_ca_a2v_gate_adaln_single"),
        "av_ca_audio_scale_shift_adaln_single": adaln(
            top, "av_ca_audio_scale_shift_adaln_single"),
        "av_ca_v2a_gate_adaln_single": adaln(
            top, "av_ca_v2a_gate_adaln_single"),
    }
    _check_consumed(top, "top-level AV transformer", strict)
    return params


def load_av_transformer_params(tensors: Tensors, num_layers: int,
                               strict: bool = True) -> dict:
    """Unified-file tensors -> dual AV DiT pytree."""
    diffusion = "model.diffusion_model."
    raw: Tensors = {}
    for key, value in tensors.items():
        if key.endswith(".weight_scale") or key.endswith(".input_scale"):
            continue
        k = key
        if k.startswith(diffusion):
            k = k[len(diffusion):]
        if k.startswith("video_embeddings_connector.") or \
                k.startswith("audio_embeddings_connector.") or \
                k.startswith("text_embedding_projection.") or \
                k.startswith("vae.") or "per_channel_statistics" in k or \
                k.startswith("vocoder"):
            continue
        mapped = map_transformer_key(k, include_audio=True)
        if mapped is not None:
            raw[mapped] = value
    return assemble_av_transformer_params(raw, num_layers, strict=strict)


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def map_vae_decoder_key(key: str) -> Optional[str]:
    """Diffusers 3-up-block decoder layout -> flat 7-block canonical keys
    (reference: ModelDownloader.swift:808-899)."""
    if key.startswith("encoder."):
        return None
    if "per_channel_statistics" in key:
        base = key.split(".")[-1]
        if base == "mean-of-means":
            return "mean_of_means"
        if base == "std-of-means":
            return "std_of_means"
        return None
    if key == "latents_mean":
        return "mean_of_means"
    if key == "latents_std":
        return "std_of_means"

    k = key
    if k.startswith("decoder."):
        k = k[len("decoder."):]

    if k.startswith("mid_block."):
        k = "up_blocks_0." + k[len("mid_block."):]
    else:
        for i in range(3):
            up_pre = f"up_blocks.{i}.upsamplers.0."
            res_pre = f"up_blocks.{i}.resnets."
            if k.startswith(up_pre):
                k = f"up_blocks_{2 * i + 1}." + k[len(up_pre):]
                break
            if k.startswith(res_pre):
                k = f"up_blocks_{2 * i + 2}.resnets." + k[len(res_pre):]
                break
    for i in range(7):  # legacy unified format up_blocks.{i}.
        pre = f"up_blocks.{i}."
        if k.startswith(pre):
            k = f"up_blocks_{i}." + k[len(pre):]
            break
    k = k.replace(".resnets.", ".res_blocks.")
    return k


def _conv(d: dict, prefix: str):
    """CausalConv3dFull: safetensors nest the inner conv as `.conv.`"""
    p = {"w": _bf16(_conv3d_t(d.pop(f"{prefix}.conv.weight")))}
    b = d.pop(f"{prefix}.conv.bias", None)
    if b is not None:
        p["b"] = _bf16(b)
    return p


def _time_embedder(d: dict, prefix: str):
    out = {"timestep_embedder": {}}
    for lin in ("linear_1", "linear_2"):
        w = d.pop(f"{prefix}.timestep_embedder.{lin}.weight")
        p = {"w": np.asarray(_t(w), np.float32)}
        b = d.pop(f"{prefix}.timestep_embedder.{lin}.bias", None)
        if b is not None:
            p["b"] = np.asarray(b, np.float32)
        else:
            p["b"] = np.zeros((p["w"].shape[1],), np.float32)
        out["timestep_embedder"][lin] = p
    return out


def load_vae_decoder_params(tensors: Tensors, strict: bool = True) -> dict:
    raw: Tensors = {}
    for key, value in tensors.items():
        mapped = map_vae_decoder_key(key)
        if mapped is not None:
            raw[mapped] = value

    params: dict = {}
    params["conv_in"] = _conv(raw, "conv_in")
    params["conv_out"] = _conv(raw, "conv_out")
    for gi in (0, 2, 4, 6):
        prefix = f"up_blocks_{gi}"
        blocks = []
        j = 0
        while f"{prefix}.res_blocks.{j}.conv1.conv.weight" in raw:
            blk = {
                "conv1": _conv(raw, f"{prefix}.res_blocks.{j}.conv1"),
                "conv2": _conv(raw, f"{prefix}.res_blocks.{j}.conv2"),
                "scale_shift_table": np.asarray(
                    raw.pop(f"{prefix}.res_blocks.{j}.scale_shift_table"),
                    np.float32,
                ),
            }
            blocks.append(blk)
            j += 1
        group = {"res_blocks": blocks}
        if f"{prefix}.time_embedder.timestep_embedder.linear_1.weight" in raw:
            group["time_embedder"] = _time_embedder(raw, f"{prefix}.time_embedder")
        params[prefix] = group
    for ui in (1, 3, 5):
        # upsampler conv nests twice: up_blocks_{ui}.conv (module) .conv (inner)
        params[f"up_blocks_{ui}"] = {"conv": _conv(raw, f"up_blocks_{ui}.conv")}
    if "last_time_embedder.timestep_embedder.linear_1.weight" in raw:
        params["last_time_embedder"] = _time_embedder(raw, "last_time_embedder")
    params["last_scale_shift_table"] = np.asarray(
        raw.pop("last_scale_shift_table"), np.float32
    )
    params["mean_of_means"] = np.asarray(
        np.squeeze(raw.pop("mean_of_means")), np.float32
    )
    params["std_of_means"] = np.asarray(
        np.squeeze(raw.pop("std_of_means")), np.float32
    )
    raw.pop("timestep_scale_multiplier", None)  # config constant (1000)
    _check_consumed(raw, "VAE decoder", strict)
    return params


# ---------------------------------------------------------------------------
# VAE encoder
# ---------------------------------------------------------------------------


def load_vae_encoder_params(tensors: Tensors, strict: bool = True) -> dict:
    """encoder.* keys -> models/vae.py encoder pytree
    (reference: ModelDownloader.swift:1222-1330)."""
    raw: Tensors = {}
    for key, value in tensors.items():
        if not key.startswith("encoder."):
            continue
        raw[key[len("encoder."):]] = value

    def enc_conv(d, prefix):
        return _conv(d, prefix)

    params: dict = {
        "conv_in": enc_conv(raw, "conv_in"),
        "conv_out": enc_conv(raw, "conv_out"),
        "down_blocks": [],
    }
    for i in range(4):
        resnets = []
        j = 0
        while f"down_blocks.{i}.resnets.{j}.conv1.conv.weight" in raw:
            resnets.append({
                "conv1": enc_conv(raw, f"down_blocks.{i}.resnets.{j}.conv1"),
                "conv2": enc_conv(raw, f"down_blocks.{i}.resnets.{j}.conv2"),
            })
            j += 1
        params["down_blocks"].append({
            "resnets": resnets,
            "downsamplers": {
                "conv": enc_conv(raw, f"down_blocks.{i}.downsamplers.0.conv")
            },
        })
    mid = []
    j = 0
    while f"mid_block.resnets.{j}.conv1.conv.weight" in raw:
        mid.append({
            "conv1": enc_conv(raw, f"mid_block.resnets.{j}.conv1"),
            "conv2": enc_conv(raw, f"mid_block.resnets.{j}.conv2"),
        })
        j += 1
    params["mid_block"] = {"resnets": mid}
    _check_consumed(raw, "VAE encoder", strict)
    return params


# ---------------------------------------------------------------------------
# Text encoder (feature extractor + connectors)
# ---------------------------------------------------------------------------


def _connector_internal(key: str) -> str:
    """(reference: ModelDownloader.swift:952-961)"""
    k = key
    k = k.replace("transformer_blocks.", "transformer_1d_blocks.")
    k = k.replace(".norm_q.", ".q_norm.")
    k = k.replace(".norm_k.", ".k_norm.")
    k = k.replace(".to_out.0.", ".to_out.")
    k = k.replace(".ff.net.0.proj.", ".ff.project_in.proj.")
    k = k.replace(".ff.net.2.", ".ff.project_out.")
    return k


def map_text_encoder_key(key: str) -> Optional[str]:
    """Standalone connector format 1 OR unified format 2 -> canonical
    (reference: ModelDownloader.swift:912-967)."""
    if key.startswith("text_proj_in."):
        return key.replace("text_proj_in.", "feature_extractor.aggregate_embed.")
    if key.startswith("video_connector."):
        return _connector_internal(
            key.replace("video_connector.", "embeddings_connector."))
    if key.startswith("audio_connector."):
        return _connector_internal(
            key.replace("audio_connector.", "audio_embeddings_connector."))
    if key.startswith("text_embedding_projection."):
        return key.replace("text_embedding_projection.", "feature_extractor.")
    if key.startswith("video_embeddings_connector."):
        return _connector_internal(
            key.replace("video_embeddings_connector.", "embeddings_connector."))
    if key.startswith("audio_embeddings_connector."):
        return _connector_internal(key)
    return None


def _assemble_connector(raw: Tensors, prefix: str) -> Optional[dict]:
    if f"{prefix}.learnable_registers" not in raw:
        return None
    blocks = []
    i = 0
    while f"{prefix}.transformer_1d_blocks.{i}.attn1.to_q.weight" in raw:
        pre = f"{prefix}.transformer_1d_blocks.{i}"
        attn = {}
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            attn[proj] = {"w": _bf16(_t(raw.pop(f"{pre}.attn1.{proj}.weight")))}
            b = raw.pop(f"{pre}.attn1.{proj}.bias", None)
            if b is not None:
                attn[proj]["b"] = _bf16(b)
        for nrm in ("q_norm", "k_norm"):
            attn[nrm] = {"w": _bf16(raw.pop(f"{pre}.attn1.{nrm}.weight"))}
        ff = {}
        for src, dst in (("project_in.proj", "project_in"),
                         ("project_out", "project_out")):
            ff[dst] = {"w": _bf16(_t(raw.pop(f"{pre}.ff.{src}.weight")))}
            b = raw.pop(f"{pre}.ff.{src}.bias", None)
            if b is not None:
                ff[dst]["b"] = _bf16(b)
        blocks.append({"attn1": attn, "ff": ff})
        i += 1
    return {
        "transformer_1d_blocks": blocks,
        "learnable_registers": _bf16(raw.pop(f"{prefix}.learnable_registers")),
    }


def load_text_encoder_params(tensors: Tensors, strict: bool = True) -> dict:
    raw: Tensors = {}
    for key, value in tensors.items():
        mapped = map_text_encoder_key(key)
        if mapped is not None:
            raw[mapped] = value

    params: dict = {
        "feature_extractor": {
            "aggregate_embed": {
                "w": _bf16(_t(raw.pop("feature_extractor.aggregate_embed.weight")))
            }
        }
    }
    video = _assemble_connector(raw, "embeddings_connector")
    if video is None:
        from ltx_jax.core.errors import WeightLoadingFailedError

        raise WeightLoadingFailedError("missing video connector weights")
    params["embeddings_connector"] = video
    audio = _assemble_connector(raw, "audio_embeddings_connector")
    if audio is not None:
        params["audio_embeddings_connector"] = audio
    _check_consumed(raw, "text encoder", strict)
    return params


# ---------------------------------------------------------------------------
# Gemma-3
# ---------------------------------------------------------------------------


def _maybe_dequant_mlx_4bit(tensors: Tensors, key: str,
                            group_size: int = 64, bits: int = 4):
    """MLX-quantized weights ship as {key}.weight (packed uint32),
    {key}.scales, {key}.biases; w[o, i] = q * scale + bias with 32/bits
    nibbles per uint32, little-endian (matches mlx.core.quantize).
    Consumes (pops) the three source keys."""
    packed = tensors.pop(f"{key}.weight")
    scales = tensors.pop(f"{key}.scales").astype(np.float32)
    biases = tensors.pop(f"{key}.biases").astype(np.float32)
    per_word = 32 // bits
    o, iw = packed.shape
    q = np.zeros((o, iw * per_word), np.float32)
    p = packed.astype(np.uint32)
    mask = (1 << bits) - 1
    for n in range(per_word):
        q[:, n::per_word] = ((p >> (n * bits)) & mask).astype(np.float32)
    d_in = q.shape[1]
    qg = q.reshape(o, d_in // group_size, group_size)
    w = qg * scales[:, :, None] + biases[:, :, None]
    return w.reshape(o, d_in)


def _repack_mlx_4bit(tensors: Tensors, key: str, bits: int = 4):
    """MLX-quantized (out, in) weight -> our int4 linear pytree, EXACTLY
    (same grouping transposed; no dequant round-trip, zero extra error).

    MLX: w[o,i] = q * scales[o, i//g] + biases[o, i//g], q packed
    little-endian in uint32. Ours: w[i,o] = q * scale[i//g, o] + bias[i//g, o],
    two nibbles per uint8 along the input axis.
    """
    packed = tensors.pop(f"{key}.weight").astype(np.uint32)
    scales = tensors.pop(f"{key}.scales")
    biases = tensors.pop(f"{key}.biases")
    per_word = 32 // bits
    o, iw = packed.shape
    q = np.zeros((o, iw * per_word), np.uint8)
    mask = (1 << bits) - 1
    for n in range(per_word):
        q[:, n::per_word] = ((packed >> (n * bits)) & mask).astype(np.uint8)
    from ltx_jax.kernels.quantization import pack_int4

    qt = _t(q)  # (in, out)
    return {
        "w_q4": np.asarray(pack_int4(qt)),
        "scale": np.asarray(_t(np.ascontiguousarray(scales)), np.float32),
        "bias": np.asarray(_t(np.ascontiguousarray(biases)), np.float32),
    }


def load_gemma_params(tensors: Tensors, num_layers: int,
                      quant_group_size: int = 64, quant_bits: int = 4,
                      keep_quantized: bool = True,
                      strict: bool = True, mode: str = "int4",
                      embed_int8: bool = False) -> dict:
    """HF/MLX Gemma-3 weights -> models/gemma3.py stacked pytree.

    Sanitize rules (reference: Gemma3Model.swift:347-370): strip
    `language_model.` VLM prefix, drop `lm_head`, f32 -> bf16. MLX 4-bit QAT
    weights (``.scales`` present) REPACK losslessly into our int4 layout by
    default — Gemma-3-12B bf16 is ~24 GB, so the model stays quantized at
    runtime (the reference likewise runs it 4-bit, LTXPipeline.swift:246). Embeddings dequantize to bf16 (gather
    needs a dense table; ~2 GB).

    mode="w8a8": linears requantize to per-output-channel int8 (W8A8) for
    the s8 x s8 decode path at 2x int4's memory (~11.5 GB). Numerics:
    the int4-QAT values plus at most one int8 step of per-channel noise.
    mode="bf16" dequantizes fully (multi-chip TP only). keep_quantized=False
    is the legacy spelling of mode="bf16".
    """
    if not keep_quantized and mode == "int4":
        mode = "bf16"
    src: Tensors = {}
    has_lm_prefix = any(k.startswith("language_model.") for k in tensors)
    for k, v in tensors.items():
        if has_lm_prefix:
            if not k.startswith("language_model."):
                continue
            k = k[len("language_model."):]
        if k.startswith("lm_head"):
            continue
        src[k] = v

    def dense(prefix: str):
        from ltx_jax.kernels.quantization import requant_int8_channel_np

        if f"{prefix}.scales" in src:
            if mode == "int4":
                return _repack_mlx_4bit(src, prefix, quant_bits)
            if mode == "w8a8":
                # lossless repack then fused dequant->per-channel-int8
                # (native single pass) — bit-identical to dequantizing the
                # dense f32 tree first (the repack preserves every value;
                # tests/test_native.py), without materializing it.
                qp = _repack_mlx_4bit(src, prefix, quant_bits)
                return requant_int8_channel_np(qp)
            w = _maybe_dequant_mlx_4bit(src, prefix, quant_group_size,
                                        quant_bits)
        else:
            w = src.pop(f"{prefix}.weight")
        if mode == "w8a8":
            return requant_int8_channel_np(_t(w))
        return {"w": _bf16(_t(w))}

    def norm(prefix: str):
        return {"w": _bf16(src.pop(f"{prefix}.weight"))}

    layers = []
    for i in range(num_layers):
        p = f"model.layers.{i}"
        layers.append({
            "q_proj": dense(f"{p}.self_attn.q_proj"),
            "k_proj": dense(f"{p}.self_attn.k_proj"),
            "v_proj": dense(f"{p}.self_attn.v_proj"),
            "o_proj": dense(f"{p}.self_attn.o_proj"),
            "q_norm": norm(f"{p}.self_attn.q_norm"),
            "k_norm": norm(f"{p}.self_attn.k_norm"),
            "gate_proj": dense(f"{p}.mlp.gate_proj"),
            "up_proj": dense(f"{p}.mlp.up_proj"),
            "down_proj": dense(f"{p}.mlp.down_proj"),
            "input_layernorm": norm(f"{p}.input_layernorm"),
            "post_attention_layernorm": norm(f"{p}.post_attention_layernorm"),
            "pre_feedforward_layernorm": norm(f"{p}.pre_feedforward_layernorm"),
            "post_feedforward_layernorm": norm(f"{p}.post_feedforward_layernorm"),
        })

    import jax

    if "model.embed_tokens.scales" in src:
        emb = _maybe_dequant_mlx_4bit(src, "model.embed_tokens",
                                      quant_group_size, quant_bits)
    else:
        emb = src.pop("model.embed_tokens.weight")
    if embed_int8:
        # int8 table with per-ROW (per-token) scales, replacing the 2 GB
        # bf16 table (~1 GB freed; the QAT source embedding is 4-bit, so
        # the int8 grid is strictly finer). Gather dequants per row;
        # the tied lm_head runs the s8 x s8 dot (gemma3._lm_head).
        # One-time f32 cast is slow on ml_dtypes bf16 — the quantized
        # cache (weights/qcache.py) makes it a first-load-only cost.
        embf = np.asarray(emb, np.float32)
        sr = np.abs(embf).max(axis=1) / 127.0
        sr = np.where(sr == 0, 1.0, sr).astype(np.float32)
        w8r = np.clip(np.rint(embf / sr[:, None]), -127, 127).astype(np.int8)
        embed_leaf = {"w8r": w8r, "sr": sr}
    else:
        embed_leaf = {"w": _bf16(emb)}
    params = {
        "embed_tokens": embed_leaf,
        "layers": jax.tree.map(lambda *xs: np.stack(xs), *layers),
        "norm": norm("model.norm"),
    }
    # NOTE w8a8 keeps the bf16 embedding matmul: an extra int8 tied
    # lm_head would cost 1 GB on top of w8a8's ~12.8 GB.
    _check_consumed(src, "Gemma", strict)
    return params


# ---------------------------------------------------------------------------
# Unified file splitting
# ---------------------------------------------------------------------------


def split_unified(tensors: Tensors, include_audio: bool = False):
    """Classify unified-file keys into (transformer, vae, connector) buckets
    (reference: ModelDownloader.swift:1343-1399). Returns raw sub-dicts with
    the prefixes the component loaders expect."""
    diffusion = "model.diffusion_model."
    vid_conn = diffusion + "video_embeddings_connector."
    aud_conn = diffusion + "audio_embeddings_connector."
    proj = diffusion + "text_embedding_projection."

    transformer: Tensors = {}
    vae: Tensors = {}
    connector: Tensors = {}
    for key, value in tensors.items():
        if key.endswith(".weight_scale") or key.endswith(".input_scale"):
            continue
        if not include_audio and ("audio" in key or key.startswith("vocoder")
                                  or "av_ca_" in key):
            continue
        if key.startswith(vid_conn):
            connector["video_embeddings_connector." + key[len(vid_conn):]] = value
        elif include_audio and key.startswith(aud_conn):
            connector["audio_embeddings_connector." + key[len(aud_conn):]] = value
        elif key.startswith(proj):
            connector["text_embedding_projection." + key[len(proj):]] = value
        elif key.startswith("text_embedding_projection."):
            connector[key] = value
        elif key.startswith(diffusion):
            transformer[key[len(diffusion):]] = value
        elif key.startswith("vae."):
            vae[key[len("vae."):]] = value
        elif "per_channel_statistics" in key:
            vae[key] = value
    return transformer, vae, connector
