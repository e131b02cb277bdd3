"""Training data pipeline — latent shards on disk -> device-ready batches.

Fine-tuning separates preprocessing from training: videos VAE-encode
and captions text-encode ONCE (offline, any machine), and the training job
streams the resulting latent shards. A shard is one .npz holding:

    tokens   (N, T, C) float16/32 — patchified clean video latents
    context  (N, S, caption_channels) — text-encoder embeddings
    mask     (N, S) int — optional attention mask (1 = real token)
    grid     (3,) int — the (frames, height, width) latent grid all rows
             of the shard share (fixed T keeps ONE compiled train step)

The loader is host-side numpy (shards mmap via np.load) with a seeded
shuffle over (shard, row) pairs each epoch; `prefetch_to_device` overlaps
the next batch's host->device upload with the current step's compute —
the same overlap discipline the inference tiling paths use
(models/vae.py decode double-buffering).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

REQUIRED_KEYS = ("tokens", "context", "grid")


@dataclasses.dataclass(frozen=True)
class Batch:
    tokens: np.ndarray    # (B, T, C)
    context: np.ndarray   # (B, S, caption_channels)
    mask: Optional[np.ndarray]  # (B, S) or None
    grid: Tuple[int, int, int]


def write_shard(path, tokens, context, grid, mask=None) -> None:
    """Write one training shard (the format `LatentShardDataset` reads)."""
    arrs = {"tokens": np.asarray(tokens),
            "context": np.asarray(context),
            "grid": np.asarray(grid, np.int64)}
    if mask is not None:
        arrs["mask"] = np.asarray(mask)
    f, h, w = arrs["grid"]
    if arrs["tokens"].shape[1] != f * h * w:
        raise ValueError(
            f"tokens T={arrs['tokens'].shape[1]} != grid {f}x{h}x{w}")
    with open(path, "wb") as fh:
        np.savez(fh, **arrs)


class LatentShardDataset:
    """Shuffled infinite batch iterator over a directory of .npz shards.

    All shards must share one latent grid (one compiled step); rows shuffle
    ACROSS shards each epoch with a seeded PRNG, so runs are reproducible
    and `state()`/restore makes mid-epoch resume exact.
    """

    def __init__(self, directory, batch_size: int, seed: int = 0,
                 dtype=np.float32):
        self.paths: Sequence[Path] = sorted(
            Path(directory).glob("*.npz"))
        if not self.paths:
            raise FileNotFoundError(f"no .npz shards under {directory}")
        self.batch_size = batch_size
        self.dtype = dtype
        self._index = []           # (shard_idx, row_idx)
        self._grid = None
        self._has_mask = True
        for si, p in enumerate(self.paths):
            with np.load(p) as z:
                for k in REQUIRED_KEYS:
                    if k not in z.files:
                        raise KeyError(f"shard {p} missing {k!r}")
                grid = tuple(int(g) for g in z["grid"])
                if self._grid is None:
                    self._grid = grid
                elif grid != self._grid:
                    raise ValueError(
                        f"shard {p} grid {grid} != {self._grid} — one "
                        "dataset = one latent grid (one compiled step)")
                self._has_mask &= "mask" in z.files
                n = z["tokens"].shape[0]
            self._index.extend((si, ri) for ri in range(n))
        if len(self._index) < batch_size:
            raise ValueError(
                f"{len(self._index)} rows < batch_size {batch_size}")
        self._rng = np.random.default_rng(seed)
        self._order = None
        self._pos = 0
        self._epoch = 0

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self._grid

    @property
    def num_rows(self) -> int:
        return len(self._index)

    def state(self) -> dict:
        """PRNG + position, for exact resume alongside the train ckpt."""
        return {"rng": self._rng.bit_generator.state,
                "pos": self._pos, "epoch": self._epoch,
                "order": None if self._order is None
                else self._order.copy()}

    def restore(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]
        self._pos = state["pos"]
        self._epoch = state["epoch"]
        self._order = state["order"]

    def _reshuffle(self):
        self._order = self._rng.permutation(len(self._index))
        self._pos = 0
        self._epoch += 1

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if self._order is None or self._pos + self.batch_size > len(
                self._order):
            self._reshuffle()  # drop the ragged tail (static batch shape)
        picks = [self._index[i] for i in
                 self._order[self._pos:self._pos + self.batch_size]]
        self._pos += self.batch_size

        toks, ctxs, masks = [], [], []
        by_shard = {}
        for si, ri in picks:
            by_shard.setdefault(si, []).append(ri)
        for si, rows in by_shard.items():
            with np.load(self.paths[si]) as z:
                t, c = z["tokens"], z["context"]
                m = z["mask"] if self._has_mask else None
                for ri in rows:
                    toks.append(t[ri])
                    ctxs.append(c[ri])
                    if m is not None:
                        masks.append(m[ri])
        return Batch(
            tokens=np.stack(toks).astype(self.dtype),
            context=np.stack(ctxs).astype(self.dtype),
            mask=np.stack(masks) if masks else None,
            grid=self._grid,
        )


def prefetch_to_device(batches: Iterator[Batch], depth: int = 2,
                       sharding=None):
    """Yield device-resident (tokens, context, bias) with `depth` uploads
    in flight — host->device transfer overlaps the running train step
    (dispatches are async; a transfer only blocks when consumed).
    """
    import collections

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ltx_jax.ops.attention import prepare_additive_mask

    # multi-host: each process holds only its rows; stitch them into one
    # global batch-sharded array (sharding must be a NamedSharding whose
    # spec puts the batch axis on a mesh axis)
    multi = sharding is not None and jax.process_count() > 1

    def _put(x):
        if multi:
            gshape = (x.shape[0] * jax.process_count(), *x.shape[1:])
            return jax.make_array_from_process_local_data(sharding, x,
                                                          gshape)
        return jax.device_put(x, sharding)

    def put(b: Batch):
        tokens = _put(b.tokens)
        context = _put(b.context)
        bias = None
        if b.mask is not None:
            if multi:
                # build the additive bias HOST-side: eager jnp ops on
                # process-local slices of a global batch are not portable
                m = np.asarray(b.mask)
                if np.issubdtype(m.dtype, np.floating):
                    bias = _put(m)
                else:
                    bias = _put(((1 - m.astype(np.float32)) * -10000.0)
                                .reshape(m.shape[0], 1, 1, m.shape[-1]))
            else:
                bias = prepare_additive_mask(jnp.asarray(b.mask))
        return tokens, context, bias

    queue = collections.deque()
    for b in batches:
        queue.append(put(b))
        if len(queue) > depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
