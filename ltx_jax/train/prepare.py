"""Training-data preparation: video clips + captions -> latent shards.

Closes the training loop's input side (docs/TRAINING.md step 1): each clip
is decoded, resized, VAE-encoded on device, normalized with the decoder's
channel stats (exactly the latent space the denoiser trains in —
LTXPipeline.encode_image's formula, reference: LTXPipeline.swift:1902-1932),
patchified to (T, C) token rows; captions run through the full Gemma ->
feature-extractor -> connector stack in batched groups
(pipe.encode_prompts — each component stages at most once per group, not
once per clip). Rows accumulate into `write_shard` files that
LatentShardDataset streams at step time, so training never touches the VAE
or text encoder again.

Driven by `ltx-video prepare-data` (io/cli.py) or directly:

    items = [("clip0.mp4", "a red fox running"), ...]
    prepare_dataset(pipe, items, "shards/", width=768, height=512,
                    num_frames=25)
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

import numpy as np

log = logging.getLogger("ltx_jax")


def encode_clip(pipe, video_path, width: int, height: int,
                num_frames: int) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """One clip -> ((T, C) f32 normalized-latent tokens, (f, h, w) grid)."""
    import jax.numpy as jnp

    from ltx_jax.io.video import load_video
    from ltx_jax.models import vae
    from ltx_jax.ops.latents import patchify

    pixels = load_video(video_path, width, height, num_frames)
    pipe._on_device("vae_encoder_params", "vae_decoder_params")
    latent = vae.encoder_forward_jit(
        pipe.vae_encoder_params, jnp.asarray(pixels), pipe.vcfg)
    mean = pipe.vae_decoder_params["mean_of_means"].astype(jnp.float32)
    std = pipe.vae_decoder_params["std_of_means"].astype(jnp.float32)
    latent = ((latent.astype(jnp.float32) - mean.reshape(1, -1, 1, 1, 1))
              / std.reshape(1, -1, 1, 1, 1))
    _, c, f, h, w = latent.shape
    tokens = np.asarray(patchify(latent))[0]  # (T, C) host
    return tokens, (f, h, w)


def prepare_dataset(
    pipe,
    items: Sequence[Tuple[str, str]],
    out_dir,
    width: int,
    height: int,
    num_frames: int,
    rows_per_shard: int = 8,
    skip_errors: bool = False,
    text_group: int = 8,
    text_batch: int = 4,
) -> List[str]:
    """Encode (video_path, caption) pairs into latent shards under out_dir.

    Two passes, ordered for device residency: pass 1 VAE-encodes every clip
    (encoder resident once, per-clip failure isolation under skip_errors);
    pass 2 runs the surviving captions through `pipe.encode_prompts` in
    groups of `text_group`, so under phase_staging the Gemma tower uploads
    once per GROUP instead of once per clip (encode_prompt's per-call
    staging cycle re-uploads 12.8 GB w8a8 Gemma every time — raise
    text_group for fewer uploads at ~0.4 GB host RAM per caption in the
    group; with a co-resident quant mode like int4 the grouping only sets
    the compiled batch cadence). `text_batch` captions share each compiled
    tower/connector program.

    Returns the shard paths written. All rows share one latent grid (fixed
    width/height/num_frames) and the text encoder's padded length, so any
    subset batches at step time. skip_errors logs-and-continues on a bad
    clip instead of aborting the run (a long prep job should survive one
    corrupt file); the failed paths are reported at the end either way.
    """
    from ltx_jax.train.data import write_shard

    if (num_frames - 1) % 8 != 0:
        raise ValueError(f"num_frames must be 8n+1, got {num_frames}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    text_group = max(1, int(text_group))

    grid = None
    failed: List[str] = []
    survivors: List[Tuple[np.ndarray, str]] = []  # (tokens, caption)

    # Pass 1: clips -> latent token rows (VAE encoder placed once).
    for video_path, caption in items:
        try:
            tokens, g = encode_clip(pipe, video_path, width, height,
                                    num_frames)
        except Exception as e:  # noqa: BLE001 — per-clip isolation
            if not skip_errors:
                raise
            log.warning("prepare-data: skipping %s (%s)", video_path, e)
            failed.append(str(video_path))
            continue
        if grid is None:
            grid = g
        elif g != grid:
            raise ValueError(f"{video_path}: grid {g} != {grid} "
                             "(all clips must share width/height/frames)")
        survivors.append((tokens.astype(np.float32), caption))

    # Pass 2: captions in groups -> context rows; shards flush as filled.
    tok_rows: List[np.ndarray] = []
    ctx_rows: List[np.ndarray] = []
    mask_rows: List[np.ndarray] = []
    shards: List[str] = []

    def flush():
        if not tok_rows:
            return
        path = out / f"shard{len(shards):05d}.npz"
        write_shard(path, np.stack(tok_rows), np.stack(ctx_rows), grid,
                    mask=np.stack(mask_rows))
        shards.append(str(path))
        log.info("prepare-data: wrote %s (%d rows)", path, len(tok_rows))
        tok_rows.clear()
        ctx_rows.clear()
        mask_rows.clear()

    for s in range(0, len(survivors), text_group):
        group = survivors[s:s + text_group]
        encs = pipe.encode_prompts([cap for _tok, cap in group],
                                   batch=text_batch)
        for (tokens, _cap), enc in zip(group, encs):
            tok_rows.append(tokens)
            ctx_rows.append(np.asarray(enc["video"], np.float32)[0])
            mask_rows.append(np.asarray(enc["mask"]).astype(np.int64)[0])
            if len(tok_rows) >= rows_per_shard:
                flush()
    flush()
    if failed:
        log.warning("prepare-data: %d clip(s) failed: %s", len(failed),
                    ", ".join(failed[:8]))
    if not shards:
        raise RuntimeError("prepare-data produced no shards")
    return shards


def read_manifest(path) -> List[Tuple[str, str]]:
    """JSONL manifest ({"video": ..., "caption": ...} per line) -> items.
    Relative video paths resolve against the manifest's directory."""
    base = Path(path).resolve().parent
    items = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "video" not in rec or "caption" not in rec:
                raise ValueError(f"{path}:{ln}: need 'video' and 'caption'")
            vp = Path(rec["video"])
            if not vp.is_absolute():
                vp = base / vp
            items.append((str(vp), str(rec["caption"])))
    if not items:
        raise ValueError(f"empty manifest {path}")
    return items


def scan_videos(directory) -> List[Tuple[str, str]]:
    """Directory of clips with sidecar captions: x.mp4 + x.txt."""
    root = Path(directory)
    items = []
    for vp in sorted(root.glob("*.mp4")):
        cap = vp.with_suffix(".txt")
        if not cap.exists():
            raise FileNotFoundError(f"no caption sidecar {cap}")
        items.append((str(vp), cap.read_text().strip()))
    if not items:
        raise ValueError(f"no .mp4 files under {directory}")
    return items


def add_prepare_arguments(ap) -> None:
    ap.add_argument("source",
                    help="JSONL manifest ({'video','caption'} per line) or "
                         "a directory of .mp4 clips with .txt sidecars")
    ap.add_argument("--out", required=True, help="shard output directory")
    ap.add_argument("-w", "--width", type=int, default=768)
    ap.add_argument("-H", "--height", type=int, default=512)
    ap.add_argument("-f", "--frames", type=int, default=25)
    ap.add_argument("--rows-per-shard", type=int, default=8)
    ap.add_argument("--text-group", type=int, default=8,
                    help="captions encoded per text-encoder staging cycle "
                         "(higher = fewer Gemma uploads, ~0.4 GB host RAM "
                         "per caption while staged)")
    ap.add_argument("--text-batch", type=int, default=4,
                    help="captions per compiled tower/connector program")
    ap.add_argument("--skip-errors", action="store_true",
                    help="log-and-continue on undecodable clips")
    ap.add_argument("--gemma-quant", choices=["int4", "w8a8", "bf16"],
                    default="w8a8")
    ap.add_argument("--memory", choices=["disabled", "light", "moderate",
                                         "aggressive"], default="moderate")
    ap.add_argument("--gemma-path", default=None)
    ap.add_argument("--ltx-weights", default=None)
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--hf-token", default=None)


def run(args) -> int:
    from ltx_jax.core.config import LTXModel, MemoryConfig
    from ltx_jax.pipeline.loader import load_pipeline

    src = Path(args.source)
    items = (scan_videos(src) if src.is_dir() else read_manifest(src))
    log.info("prepare-data: %d clips -> %s (%dx%d, %d frames)",
             len(items), args.out, args.width, args.height, args.frames)

    pipe = load_pipeline(
        model=LTXModel.DISTILLED,
        models_dir=args.models_dir,
        hf_token=args.hf_token,
        gemma_path=args.gemma_path,
        unified_weights_path=args.ltx_weights,
        memory=MemoryConfig.preset(args.memory),
        gemma_quant=args.gemma_quant,
    )
    shards = prepare_dataset(
        pipe, items, args.out, args.width, args.height, args.frames,
        rows_per_shard=args.rows_per_shard, skip_errors=args.skip_errors,
        text_group=args.text_group, text_batch=args.text_batch)
    print(f"PREPARE DATA OK: {len(items)} clips -> {len(shards)} shards "
          f"in {args.out}", file=sys.stdout)
    return 0
