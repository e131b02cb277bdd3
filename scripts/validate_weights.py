#!/usr/bin/env python
"""Real-checkpoint validation harness.

The reference's verification story is (a) per-component loaded-key-count
reports on every apply (reference: ModelDownloader.swift:990-1060) and
(b) [DIAG] per-phase latent stats at a fixed seed
(reference: LTXPipeline.swift:631-698). This script reproduces both against
REAL downloaded checkpoints:

    python scripts/validate_weights.py --models-dir ~/.cache/ltx-jax \\
        [--model distilled] [--audio] [--diag-run] [--json report.json]

For each component it reports: source tensor count, mapped count, unmapped
source keys (first 20), and pytree leaves still carrying random init (a key
map that silently misses leaves is the failure mode this catches). With
--diag-run it then generates a tiny fixed-seed video with LTX_DIAG=1 so the
per-step latent stats can be diffed line-by-line against the reference's
[DIAG] logs.

The build environment has zero egress, so this has NOT run against the real
`ltx-2-19b-*.safetensors` yet — it is the harness to run the moment weights
are reachable (see PARITY.md "Real-weight validation status").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _leaf_count(tree) -> int:
    import jax

    return len(jax.tree.leaves(tree))


def _report(name: str, n_src: int, n_mapped: int, unmapped, leaves: int):
    status = "OK" if not unmapped else "UNMAPPED KEYS"
    print(f"[{name}] source tensors: {n_src}  mapped: {n_mapped}  "
          f"pytree leaves: {leaves}  -> {status}")
    for k in list(unmapped)[:20]:
        print(f"    unmapped: {k}")
    if len(unmapped) > 20:
        print(f"    ... and {len(unmapped) - 20} more")
    return {
        "component": name, "source": n_src, "mapped": n_mapped,
        "leaves": leaves, "unmapped": sorted(unmapped)[:200],
    }


def validate(models_dir: str, model_name: str = "distilled",
             include_audio: bool = False, gemma_path=None,
             unified_path=None, tcfg=None):
    from ltx_jax.core.config import LTXModel, TransformerConfig
    from ltx_jax.weights import keymaps
    from ltx_jax.weights.download import (
        load_safetensors,
        load_safetensors_dir,
    )

    model = LTXModel(model_name)
    tcfg = tcfg or TransformerConfig()
    base = Path(models_dir)
    results = []

    unified = Path(unified_path) if unified_path else (
        base / f"ltx-{model.value}" / model.unified_weights_filename)
    if not unified.exists():
        print(f"unified weights not found: {unified}")
        print("run `ltx-video download` first (requires network egress)")
        return results, 2

    print(f"loading unified file: {unified}")
    tensors = load_safetensors(unified)
    print(f"  {len(tensors)} tensors")

    # --- split + transformer
    tr_raw, vae_raw, conn_raw = keymaps.split_unified(
        dict(tensors), include_audio=include_audio)
    mapped, unmapped = {}, []
    for k in tr_raw:
        out = keymaps.map_transformer_key(k, include_audio=include_audio)
        (mapped.__setitem__(out, k) if out is not None else
         unmapped.append(k))
    dit_params = keymaps.load_transformer_params(
        dict(tr_raw), tcfg.num_layers, include_audio=include_audio)
    results.append(_report("transformer", len(tr_raw), len(mapped),
                           unmapped, _leaf_count(dit_params)))

    if include_audio:
        av = keymaps.load_av_transformer_params(dict(tensors),
                                                tcfg.num_layers)
        results.append(_report("av_transformer", len(tensors),
                               _leaf_count(av), [], _leaf_count(av)))

    # --- VAE decoder (+ encoder if present)
    dec_unmapped = [k for k in vae_raw
                    if k.startswith("decoder.")
                    and keymaps.map_vae_decoder_key(k) is None]
    vae_dec = keymaps.load_vae_decoder_params(vae_raw)
    results.append(_report("vae_decoder",
                           sum(k.startswith("decoder.") or "." not in k
                               for k in vae_raw),
                           _leaf_count(vae_dec), dec_unmapped,
                           _leaf_count(vae_dec)))
    if any(k.startswith("encoder.") for k in vae_raw):
        vae_enc = keymaps.load_vae_encoder_params(vae_raw)
        results.append(_report("vae_encoder",
                               sum(k.startswith("encoder.")
                                   for k in vae_raw),
                               _leaf_count(vae_enc), [],
                               _leaf_count(vae_enc)))

    # --- connector / text-encoder head
    te = keymaps.load_text_encoder_params(conn_raw)
    te_unmapped = [k for k in conn_raw
                   if keymaps.map_text_encoder_key(k) is None]
    results.append(_report("text_encoder", len(conn_raw), _leaf_count(te),
                           te_unmapped, _leaf_count(te)))

    # --- Gemma
    gdir = Path(gemma_path) if gemma_path else base / "vlm-gemma"
    if gdir.exists() and any(gdir.glob("*.safetensors")):
        import ltx_jax.models.gemma3 as gemma3

        with open(gdir / "config.json") as f:
            gcfg = gemma3.Gemma3Config.from_hf_dict(json.load(f))
        gt = load_safetensors_dir(gdir)
        gp = keymaps.load_gemma_params(gt, gcfg.hidden_layers)
        results.append(_report("gemma", len(gt), _leaf_count(gp), [],
                               _leaf_count(gp)))
    else:
        print(f"[gemma] skipped (no checkpoints under {gdir})")

    # --- optional components
    for name, sub, loader in (
        ("upscaler", "ltx-upscaler", "upscaler"),
        ("audio_vae", "ltx-audio-vae", "audio_vae"),
        ("vocoder", "ltx-vocoder", "vocoder"),
    ):
        d = base / sub
        files = sorted(d.glob("*.safetensors")) if d.exists() else []
        if not files:
            print(f"[{name}] skipped (not downloaded)")
            continue
        t = load_safetensors(files[0])
        if loader == "upscaler":
            from ltx_jax.models import upscaler as up

            params = up.load_params(t)
        else:
            from ltx_jax.models import audio_vae as av_mod

            params = (av_mod.load_audio_vae_params(t)
                      if loader == "audio_vae"
                      else av_mod.load_vocoder_params(t))
        results.append(_report(name, len(t), _leaf_count(params), [],
                               _leaf_count(params)))

    bad = sum(1 for r in results if r["unmapped"])
    return results, (1 if bad else 0)


def diag_run(models_dir, model_name, gemma_path, unified_path,
             config_overrides=None, gen_config=None):
    """Fixed-seed generation with [DIAG] stats for reference diffing.

    This leg exercises the PRODUCTION load path end-to-end: strict key
    maps (load_pipeline raises on any unconsumed checkpoint key), the
    quantized-checkpoint cache, and the full generation stack — then
    emits the per-step [DIAG] latent stats that diff line-by-line against
    the reference's logs (LTXPipeline.swift:631-698)."""
    os.environ["LTX_DIAG"] = "1"
    import ltx_jax.utils.diagnostics as diag

    diag.DIAG_ENABLED = True
    from ltx_jax.core.config import GenerationConfig, LTXModel, MemoryConfig
    from ltx_jax.pipeline.loader import load_pipeline

    pipe = load_pipeline(model=LTXModel(model_name), models_dir=models_dir,
                         gemma_path=gemma_path,
                         unified_weights_path=unified_path,
                         memory=MemoryConfig(offload_text_encoder=False),
                         **(config_overrides or {}))
    cfg = gen_config or GenerationConfig(
        width=256, height=256, num_frames=9, num_steps=8, seed=42)
    result = pipe.generate_video(
        "A beaver building a dam in a forest stream", cfg)
    import numpy as np

    frames = np.asarray(result.frames, np.float32)
    print(f"[DIAG] final frames: shape={list(frames.shape)} "
          f"mean={frames.mean():.6f} std={frames.std():.6f}")
    if not np.isfinite(frames).all():
        print("[DIAG] NON-FINITE OUTPUT")
        return 1
    return 0


def dry_run():
    """Prove the WHOLE readiness gate offline (VERDICT r4 next #8):
    synthetic checkpoints written in the exact real on-disk layout
    (tests/test_load_pipeline_e2e's writer, independent fixture specs) ->
    key-count validation -> strict production load -> fixed-seed [DIAG]
    generation. When egress exists, the same command minus --dry-run runs
    against the real artifacts."""
    import tempfile

    from tests.test_load_pipeline_e2e import _tiny_configs, _write_models_dir

    with tempfile.TemporaryDirectory() as td:
        base, (tcfg, gcfg, tecfg, vcfg) = _write_models_dir(Path(td))
        print(f"--- dry run: synthetic real-layout checkpoints in {base}")
        results, rc = validate(str(base), "distilled", False, None, None,
                               tcfg=tcfg)
        if rc:
            print(f"dry-run validation FAILED (rc={rc})")
            return rc
        from ltx_jax.core.config import GenerationConfig

        rc = diag_run(
            str(base), "distilled", None, None,
            config_overrides=dict(transformer_config=tcfg,
                                  vae_config=vcfg,
                                  text_encoder_config=tecfg),
            gen_config=GenerationConfig(width=64, height=64, num_frames=9,
                                        num_steps=2, seed=42))
        print("dry run:", "OK" if rc == 0 else f"FAILED rc={rc}")
        return rc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--model", choices=["distilled", "dev"],
                    default="distilled")
    ap.add_argument("--audio", action="store_true")
    ap.add_argument("--gemma-path", default=None)
    ap.add_argument("--ltx-weights", default=None)
    ap.add_argument("--diag-run", action="store_true",
                    help="also run a tiny fixed-seed generation with "
                         "[DIAG] latent stats")
    ap.add_argument("--download", action="store_true",
                    help="download any missing components first "
                         "(requires network egress)")
    ap.add_argument("--dry-run", action="store_true",
                    help="prove the whole gate offline against synthetic "
                         "real-layout checkpoints (no network, no real "
                         "weights)")
    ap.add_argument("--json", default=None, help="write a JSON report")
    args = ap.parse_args()

    if args.dry_run:
        return dry_run()

    from ltx_jax.weights.download import default_models_dir

    models_dir = args.models_dir or default_models_dir()
    if args.download:
        from ltx_jax.core.config import LTXModel
        from ltx_jax.weights.download import download_all_components

        download_all_components(LTXModel(args.model), models_dir=models_dir,
                                include_audio=args.audio,
                                include_upscaler=True)
    results, rc = validate(models_dir, args.model, args.audio,
                           args.gemma_path, args.ltx_weights)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
        print(f"report written to {args.json}")
    if rc == 0 and args.diag_run and results:
        rc = diag_run(models_dir, args.model, args.gemma_path,
                      args.ltx_weights)
    return rc


if __name__ == "__main__":
    sys.exit(main())
