"""Observability: [DIAG] stat logging, profiler traces, denoise resume.

The reference's numerical-parity methodology is [DIAG] mean/std/first-5
logging at every phase (SURVEY.md §4; reference:
LTXPipeline.swift:631-698,959-986) — the tool its own correctness was
validated with. `diag_stats` reproduces that format so our latents can be
diffed line-by-line against reference logs once real weights are loaded.

`profile_trace` wraps jax.profiler for TensorBoard-viewable traces (the
answer to the reference's `--profile` timers, LTXVideo.swift:255-297).

`DenoiseCheckpoint` persists the latent every N steps so long 241-frame runs
are resumable — the recovery story SURVEY.md §5.3 calls out as an
improvement the reference lacks (its only recovery is re-running the seed).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import pickle
import tempfile
from pathlib import Path
from typing import Optional

import jax
import numpy as np

log = logging.getLogger("ltx_jax")

DIAG_ENABLED = os.environ.get("LTX_DIAG", "0") == "1"


def diag_stats(name: str, array, first_n: int = 5) -> Optional[str]:
    """Log '[DIAG] name: mean=... std=... first5=[...]' like the reference.

    Forces a host transfer — only call when LTX_DIAG=1 (or force=True via
    direct use); never inside jit.
    """
    if not DIAG_ENABLED:
        return None
    arr = np.asarray(array, np.float32)
    flat = arr.reshape(-1)
    msg = (f"[DIAG] {name}: shape={list(arr.shape)} mean={flat.mean():.6f} "
           f"std={flat.std():.6f} first{first_n}="
           f"{[round(float(v), 6) for v in flat[:first_n]]}")
    log.info(msg)
    return msg


def device_sync(array) -> None:
    """Block until `array` (any pytree) is computed; host arrays return at
    once. Pipeline phase timings end here, so they measure the device work
    and not just its enqueue."""
    jax.block_until_ready(array)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """jax.profiler trace context: view with TensorBoard's profile plugin.
    log_dir defaults to ltx_jax_trace under the temporary directory."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "ltx_jax_trace")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)


@dataclasses.dataclass
class DenoiseCheckpoint:
    """Persist/resume the denoise loop's latent state.

    Latents are a few MB; saving every N steps makes multi-minute 241-frame
    runs resumable after interruption. State includes the step index, seed
    and sigma schedule so a resume is exact (same compiled step, same keys).
    """

    path: str
    every_n_steps: int = 2

    def save(self, step: int, latent, velocity, sigmas, seed: int,
             extra: Optional[dict] = None) -> None:
        if self.every_n_steps <= 0 or (step + 1) % self.every_n_steps:
            return
        state = {
            "step": step,
            "latent": np.asarray(latent),
            "velocity": np.asarray(velocity),
            "sigmas": np.asarray(sigmas),
            "seed": seed,
            "extra": extra or {},
        }
        tmp = self.path + ".tmp"
        Path(tmp).parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, self.path)  # atomic
        log.debug("denoise checkpoint saved at step %d -> %s", step, self.path)

    def load(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            state = pickle.load(f)
        log.info("resuming denoise from step %d (%s)", state["step"] + 1,
                 self.path)
        return state

    def clear(self) -> None:
        Path(self.path).unlink(missing_ok=True)
