"""High-level generation pipeline: prompt -> video (T2V / I2V / two-stage).

JAX re-design of the reference `LTXPipeline` actor
(reference: Sources/LTXVideo/Pipeline/LTXPipeline.swift). The reference's
phase choreography (load Gemma -> encode -> unload -> denoise -> unload ->
VAE decode) exists to fit Apple unified memory; here phases are explicit
methods on a plain params-holder class, text-encoder params can be dropped
after encoding (`offload_text_encoder`), latent buffers are donated into the
jitted step, and the denoise loop compiles once.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ltx_jax.core.errors import (
    InvalidConfigurationError,
    ModelNotLoadedError,
    TextEncodingFailedError,
)
from ltx_jax.core.config import (
    DEFAULT_NEGATIVE_PROMPT,
    GenerationConfig,
    MemoryConfig,
    TransformerConfig,
)
from ltx_jax.models import dit, gemma3, text_encoder, vae
from ltx_jax.ops import schedule
from ltx_jax.ops.latents import VideoLatentShape, generate_noise
from ltx_jax.utils.diagnostics import device_sync
from ltx_jax.pipeline.denoise import (
    GuidanceSpec,
    build_guidance_context,
    make_denoise_step,
    run_denoise_loop,
)

log = logging.getLogger("ltx_jax")


@dataclasses.dataclass
class GenerationTimings:
    """Per-phase timings (reference: LTXVideo.swift:255-297)."""

    enhancement: float = 0.0
    text_encoding: float = 0.0
    denoise_steps: list = dataclasses.field(default_factory=list)
    vae_decode: float = 0.0
    total: float = 0.0
    # denoise-step compile overlapped with enhancement (0 = not warmed)
    warm_compile: float = 0.0

    def report(self) -> str:
        lines = [
            f"Prompt enhancement: {self.enhancement:.2f}s"
            + (f" (denoise compile overlapped: {self.warm_compile:.1f}s)"
               if self.warm_compile else ""),
            f"Text encoding: {self.text_encoding:.2f}s",
            f"Denoise: {sum(self.denoise_steps):.2f}s "
            f"({len(self.denoise_steps)} steps, "
            f"avg {np.mean(self.denoise_steps) if self.denoise_steps else 0:.2f}s)",
            f"VAE decode: {self.vae_decode:.2f}s",
            f"Total: {self.total:.2f}s",
        ]
        return "\n".join(lines)


@dataclasses.dataclass
class VideoGenerationResult:
    frames: jax.Array  # (F, H, W, 3) in [0, 1]
    timings: GenerationTimings
    seed: int
    audio: Optional[jax.Array] = None  # (2, samples) in [-1, 1] @ 24kHz


class _WarmCompiles:
    """Handle for background AOT compiles (LTXPipeline._start_warm_compile).

    Each added program lowers AND compiles in its own daemon thread —
    compiles run concurrently with each other and with executing device
    programs — so an entry point can join each program right before the
    phase that needs it while later phases' compiles keep overlapping
    earlier phases' execution. Compile failures
    only log (the program then compiles inline at first use, the status
    quo). With no threads added (warming gated off) every join is a no-op,
    so call sites need no conditionals."""

    def __init__(self, timings=None):
        self._threads = {}
        self._t0 = time.time()
        self._timings = timings

    def add(self, name, thunk):
        import threading

        def _run():
            t0 = time.time()
            try:
                thunk().compile()
                log.info("%s warm compile: %.1f s", name, time.time() - t0)
            except Exception as e:  # pragma: no cover - backend-dependent
                log.info("%s warm compile skipped (%s)", name, e)

        th = threading.Thread(target=_run, daemon=True)
        th.start()
        self._threads[name] = th

    def join(self, *names):
        """Block until the named compiles land (all of them when no names
        given); unknown/already-joined names no-op."""
        joined = False
        for n in (names or list(self._threads)):
            th = self._threads.pop(n, None)
            if th is not None:
                th.join()
                joined = True
        if joined and self._timings is not None:
            # elapsed since the warm started = the window compiles had to
            # overlap enhancement/earlier phases (grows with later joins)
            self._timings.warm_compile = time.time() - self._t0

    __call__ = join  # back-compat: generate_video's join_warm() idiom


class LTXPipeline:
    """Holds model params + configs; drives generation phases.

    For production use, params come from ltx_jax.weights loaders; for tests,
    `LTXPipeline.random_tiny()` builds a structurally-identical small model.
    """

    def __init__(
        self,
        transformer_params,
        transformer_config: TransformerConfig,
        vae_decoder_params,
        vae_config: vae.VAEConfig,
        gemma_params=None,
        gemma_config: Optional[gemma3.Gemma3Config] = None,
        text_encoder_params=None,
        text_encoder_config: Optional[text_encoder.TextEncoderConfig] = None,
        tokenizer=None,
        vae_encoder_params=None,
        upscaler_params=None,
        upscaler_config=None,
        av_transformer_params=None,
        audio_vae_params=None,
        audio_vae_config=None,
        vocoder_params=None,
        vocoder_config=None,
        memory: MemoryConfig = MemoryConfig(),
        is_distilled: bool = True,
        sdpa_impl: str = "auto",
        vision_params=None,
        vision_config=None,
    ):
        self.transformer_params = transformer_params
        self.tcfg = transformer_config
        self.vae_decoder_params = vae_decoder_params
        self.vcfg = vae_config
        self.gemma_params = gemma_params
        self.gcfg = gemma_config
        self.text_encoder_params = text_encoder_params
        self.tecfg = text_encoder_config
        self.tokenizer = tokenizer
        self.vae_encoder_params = vae_encoder_params
        self.upscaler_params = upscaler_params
        self.upscaler_config = upscaler_config
        self.av_transformer_params = av_transformer_params
        self.audio_vae_params = audio_vae_params
        self.audio_vae_config = audio_vae_config
        self.vocoder_params = vocoder_params
        self.vocoder_config = vocoder_config
        self.memory = memory
        self.is_distilled = is_distilled
        self.sdpa_impl = sdpa_impl
        self.vision_params = vision_params
        self.vision_config = vision_config
        self.mesh = None
        self.pp_mesh = None           # ("data", "pipe") mesh — shard_pp()
        self.pp_microbatches = None
        # host originals for phase staging (utils/staging.py): filled lazily
        # by _on_device when a component arrives as a host (numpy) tree
        self._host_store = {}

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    @classmethod
    def random_tiny(cls, seed: int = 0, include_audio: bool = False):
        """Structurally-faithful tiny pipeline for tests/benchmarks."""
        tcfg = TransformerConfig().tiny()
        vcfg = dataclasses.replace(
            vae.VAEConfig().tiny(), latent_channels=tcfg.in_channels
        )
        gcfg = gemma3.Gemma3Config().tiny()
        tecfg = dataclasses.replace(
            text_encoder.TextEncoderConfig().tiny(),
            hidden_dim=gcfg.hidden_size,
            num_gemma_layers=gcfg.hidden_layers + 1,
            connector_heads=4,
            connector_head_dim=gcfg.hidden_size // 4,
        )
        # DiT caption channels must match connector output
        tcfg = dataclasses.replace(tcfg, caption_channels=tecfg.inner_dim)
        from ltx_jax.models import upscaler as upscaler_mod

        ucfg = dataclasses.replace(
            upscaler_mod.UpscalerConfig().tiny(), in_channels=tcfg.in_channels
        )
        ks = jax.random.split(jax.random.key(seed), 9)
        av_extras = {}
        if include_audio:
            from ltx_jax.models import audio_vae as av_mod
            from ltx_jax.models import dit_av

            avcfg = av_mod.AudioVAEConfig().tiny()
            voccfg = av_mod.VocoderConfig().tiny()
            av_extras = dict(
                av_transformer_params=dit_av.init_params(ks[6], tcfg,
                                                         jnp.bfloat16),
                audio_vae_params=av_mod.init_audio_vae_params(ks[7], avcfg),
                audio_vae_config=avcfg,
                vocoder_params=av_mod.init_vocoder_params(ks[8], voccfg),
                vocoder_config=voccfg,
            )
        return cls(
            upscaler_params=upscaler_mod.init_params(ks[5], ucfg),
            upscaler_config=ucfg,
            **av_extras,
            transformer_params=dit.init_params(ks[0], tcfg, jnp.bfloat16),
            transformer_config=tcfg,
            vae_decoder_params=vae.init_decoder_params(ks[1], vcfg),
            vae_config=vcfg,
            gemma_params=gemma3.init_params(ks[2], gcfg, jnp.bfloat16),
            gemma_config=gcfg,
            text_encoder_params=text_encoder.init_params(
                ks[3], tecfg, jnp.bfloat16, include_audio=include_audio
            ),
            text_encoder_config=tecfg,
            vae_encoder_params=vae.init_encoder_params(ks[4], vcfg),
        )

    # ------------------------------------------------------------------
    # Phase staging (host <-> device placement)
    # ------------------------------------------------------------------

    _TP_SHARDED = ("transformer_params", "av_transformer_params",
                   "gemma_params")

    def _on_device(self, *names):
        """Place host (numpy) component trees into device memory — sharded
        over the mesh when one is attached, plain device_put otherwise.
        No-op for components already on device; the host original is kept
        in _host_store so phase_staging can release HBM without readbacks."""
        from ltx_jax.utils import staging

        for name in names:
            tree = getattr(self, name, None)
            if tree is None or not staging.is_host_tree(tree):
                continue
            self._host_store.setdefault(name, tree)
            if self.pp_mesh is not None:
                from ltx_jax.parallel import pipeline as pp_mod
                from ltx_jax.parallel import sharding as shard_mod

                if name in ("transformer_params", "av_transformer_params"):
                    placed = pp_mod.shard_pp_params(tree, self.pp_mesh)
                else:
                    placed = shard_mod.replicate(tree, self.pp_mesh)
            elif self.mesh is not None:
                from ltx_jax.parallel import sharding as shard_mod

                if name == "gemma_params":
                    # vocab-sharded embeddings on top of layer TP: decode is
                    # weight-DMA bound and the tied embed/lm_head table is
                    # the largest single tensor (parallel/sharding.py)
                    placed = shard_mod.shard_gemma_params(tree, self.mesh)
                elif name in self._TP_SHARDED:
                    placed = shard_mod.shard_transformer_params(tree, self.mesh)
                else:
                    placed = shard_mod.replicate(tree, self.mesh)
            else:
                placed = staging.to_device(tree)
            setattr(self, name, placed)

    def _release_to_host(self, *names):
        """Drop a component's device copy (phase_staging only): restore the
        stored host original; XLA frees the HBM when the refs die."""
        if not self.memory.phase_staging:
            return
        for name in names:
            if name in self._host_store:
                setattr(self, name, self._host_store[name])

    # ------------------------------------------------------------------
    # Parallelism
    # ------------------------------------------------------------------

    def shard(self, mesh):
        """Place every loaded component on a (data, model) mesh.

        Transformers (video DiT, AV dual, Gemma) get megatron TP over the
        "model" axis (works for bf16 AND int4/int8-quantized leaves);
        everything else replicates. Guidance rows already batch on the
        leading axis and ride the data axis via GSPMD propagation. New
        capability — the reference is single-device by design
        (SURVEY.md §2.9).
        """
        from ltx_jax.parallel import sharding as shard_mod
        from ltx_jax.utils import staging

        if self.pp_mesh is not None:
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(
                "shard() and shard_pp() are mutually exclusive")
        self.mesh = mesh
        # Host (numpy) trees are left in place: _on_device shards them when
        # their phase starts (phase_staging choreography); device trees
        # re-place eagerly.
        if not staging.is_host_tree(self.transformer_params):
            self.transformer_params = shard_mod.shard_transformer_params(
                self.transformer_params, mesh)
        tree = self.av_transformer_params
        if tree is not None and not staging.is_host_tree(tree):
            self.av_transformer_params = shard_mod.shard_transformer_params(
                tree, mesh)
        tree = self.gemma_params
        if tree is not None and not staging.is_host_tree(tree):
            self.gemma_params = shard_mod.shard_gemma_params(tree, mesh)
        for name in ("vae_decoder_params", "vae_encoder_params",
                     "upscaler_params", "text_encoder_params",
                     "audio_vae_params", "vocoder_params"):
            tree = getattr(self, name)
            if tree is not None and not staging.is_host_tree(tree):
                setattr(self, name, shard_mod.replicate(tree, mesh))
        return self

    def shard_pp(self, mesh, n_microbatches=None):
        """Pipeline-parallel placement over a ("data", "pipe") mesh
        (parallel/pipeline.py): the video DiT's and the dual AV
        transformer's stacked block axes shard across the pipe stages;
        every other component replicates; the denoise steps run the GPipe
        schedule with guidance rows as microbatches. TP (`shard`) is the
        default on one host's cards — PP is for exhausted model axes or
        slower links (docs/ARCHITECTURE.md). Mutually exclusive with
        shard()."""
        from ltx_jax.core.errors import InvalidConfigurationError
        from ltx_jax.parallel import pipeline as pp_mod
        from ltx_jax.parallel import sharding as shard_mod
        from ltx_jax.utils import staging

        if self.mesh is not None:
            raise InvalidConfigurationError(
                "shard() and shard_pp() are mutually exclusive")
        self.pp_mesh = mesh
        self.pp_microbatches = n_microbatches
        for name in ("transformer_params", "av_transformer_params"):
            tree = getattr(self, name)
            if tree is not None and not staging.is_host_tree(tree):
                setattr(self, name, pp_mod.shard_pp_params(tree, mesh))
        for name in ("vae_decoder_params", "vae_encoder_params",
                     "upscaler_params", "text_encoder_params",
                     "gemma_params", "audio_vae_params", "vocoder_params"):
            tree = getattr(self, name)
            if tree is not None and not staging.is_host_tree(tree):
                setattr(self, name, shard_mod.replicate(tree, mesh))
        return self

    # ------------------------------------------------------------------
    # Text encoding phase
    # ------------------------------------------------------------------

    def tokenize(self, prompt: str):
        """Left-pad to max_length with pad_id 0; over-long prompts keep the
        LAST max_length tokens — `encoded.suffix(maxLength)`
        (reference: LTXPipeline.swift:3254-3278). BOS insertion is the
        tokenizer.json post-processor's job (Gemma adds BOS=2)."""
        max_len = self.tecfg.max_length
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(prompt).ids
        else:
            # test fallback: bytes as tokens
            ids = [(b % (self.gcfg.vocab_size - 2)) + 2
                   for b in prompt.encode()]
        ids = ids[-max_len:]
        pad = max_len - len(ids)
        input_ids = np.full((1, max_len), 0, np.int32)
        mask = np.zeros((1, max_len), np.int32)
        input_ids[0, pad:] = ids
        mask[0, pad:] = 1
        return jnp.asarray(input_ids), jnp.asarray(mask)

    def encode_prompt(self, prompt: str):
        """prompt -> (embeddings (1, S, D), mask (1, S)[, audio]).

        With phase_staging the two halves are STAGED: the Gemma tower runs
        with only gemma_params resident, its (49, 1, S, D) hidden states
        (~0.4 GB) stay on device, gemma_params release to host, and only
        then does the connector come up, so W8A8 Gemma (12.8 GB) and the
        connector (~2.2 GB) never co-reside.
        """
        if self.gemma_params is None:
            raise ModelNotLoadedError("text encoder (Gemma)")
        ids, mask = self.tokenize(prompt)
        if self.memory.phase_staging:
            self._on_device("gemma_params")
            hidden = gemma3.forward_hidden_states_jit(
                self.gemma_params, ids, mask, self.gcfg
            )
            device_sync(hidden)  # real sync: see utils.diagnostics docstring
            self._release_to_host("gemma_params")
            self._on_device("text_encoder_params")
        else:
            self._on_device("gemma_params", "text_encoder_params")
            hidden = gemma3.forward_hidden_states_jit(
                self.gemma_params, ids, mask, self.gcfg
            )
        out = text_encoder.encode_from_hidden_states_jit(
            self.text_encoder_params, hidden, mask, self.tecfg
        )
        return out

    def encode_prompts(self, prompts, batch: Optional[int] = None,
                       stage: Optional[bool] = None):
        """Encode MANY prompts with each text-encoder component staged at
        most ONCE per call (encode_prompt runs a full staging cycle per
        prompt — re-uploading the 12.8 GB w8a8 Gemma tower every time, which
        is prohibitive for data-prep jobs that encode hundreds of captions).

        Chunks of `batch` prompts share one compiled tower/connector program
        (B rows ride the same weight reads); the
        tail chunk pads by repeating its last row so every chunk compiles to
        the same shape, and the padded rows are sliced off.

        stage=None follows memory.phase_staging. When staged, each chunk's
        (49, B, S, D) Gemma hidden states hop to HOST between the two phases
        so the tower and connector never co-reside (~0.4 GB host RAM per
        prompt at S=1024 — call in groups if len(prompts) is large).
        stage=False keeps both resident and streams chunk->chunk. batch=None
        sizes chunks from the device's memory (_encode_batch).

        Returns one dict per prompt — {"video": (1, S, D), "mask": (1, S)
        [, "audio"]} — as HOST numpy arrays.
        """
        if self.gemma_params is None:
            raise ModelNotLoadedError("text encoder (Gemma)")
        prompts = list(prompts)
        if not prompts:
            return []
        if stage is None:
            stage = self.memory.phase_staging
        if batch is None:
            batch = self._encode_batch()
        batch = max(1, int(batch))
        ids_rows = []
        mask_rows = []
        for p in prompts:
            i, m = self.tokenize(p)
            ids_rows.append(np.asarray(i)[0])
            mask_rows.append(np.asarray(m)[0])
        chunks = []  # (ids (B, S), mask (B, S), n_real)
        for s in range(0, len(prompts), batch):
            ids = ids_rows[s:s + batch]
            msk = mask_rows[s:s + batch]
            n = len(ids)
            if n < batch and len(prompts) > batch:
                # pad the tail to the chunk shape already compiled (repeat
                # the last row — all-zero masks would break the extractor's
                # masked norm); outputs beyond n are dropped
                ids = ids + [ids[-1]] * (batch - n)
                msk = msk + [msk[-1]] * (batch - n)
            chunks.append((np.stack(ids), np.stack(msk), n))

        hidden_host = []
        if stage:
            self._on_device("gemma_params")
            for ids, msk, _n in chunks:
                h = gemma3.forward_hidden_states_jit(
                    self.gemma_params, jnp.asarray(ids), jnp.asarray(msk),
                    self.gcfg)
                hidden_host.append(np.asarray(h))  # host hop (real sync)
            self._release_to_host("gemma_params")
            self._on_device("text_encoder_params")
        else:
            self._on_device("gemma_params", "text_encoder_params")

        results = []
        for ci, (ids, msk, n) in enumerate(chunks):
            if stage:
                h = jnp.asarray(hidden_host[ci])
                hidden_host[ci] = None  # free as we go
            else:
                h = gemma3.forward_hidden_states_jit(
                    self.gemma_params, jnp.asarray(ids), jnp.asarray(msk),
                    self.gcfg)
            out = text_encoder.encode_from_hidden_states_jit(
                self.text_encoder_params, h, jnp.asarray(msk), self.tecfg)
            video = np.asarray(out["video"])
            omask = np.asarray(out["mask"])
            audio = np.asarray(out["audio"]) if "audio" in out else None
            for r in range(n):
                d = {"video": video[r:r + 1], "mask": omask[r:r + 1]}
                if audio is not None:
                    d["audio"] = audio[r:r + 1]
                results.append(d)
        return results

    def _encode_batch(self) -> int:
        """encode_prompts' default chunk: 4 rows, or as many as fit where
        the device's memory holds fewer (layers + 1, B, S, D) bf16 hidden
        stacks (twice, for the tower's working copies) beside the resident
        Gemma weights."""
        from ltx_jax.utils.device_memory import (
            batch_rows_that_fit, device_memory_gb, tree_gb,
        )

        budget = device_memory_gb()
        if budget is None:
            return 4
        per_row = ((self.gcfg.hidden_layers + 1) * self.tecfg.max_length
                   * self.gcfg.hidden_size * 2 * 2 / 1e9)
        return batch_rows_that_fit(budget, tree_gb(self.gemma_params),
                                   per_row, 4)

    def offload_text_encoder(self):
        """Drop Gemma + connector params' device copies (the equivalent of
        the reference's unload-after-encode, LTXPipeline.swift:726-731).
        With phase_staging the host originals survive, so later generations
        re-place them; otherwise the params are gone for good."""
        if self.memory.phase_staging:
            self._release_to_host("gemma_params", "text_encoder_params",
                                  "vision_params")
        else:
            self.gemma_params = None
            self.text_encoder_params = None

    def _maybe_enhance(self, prompt: str, config: GenerationConfig,
                       is_i2v: bool, timings: GenerationTimings = None) -> str:
        """Prompt enhancement, applied on EVERY generation path like the
        reference (e.g. LTXPipeline.swift:1525-1531, :2466-2470)."""
        if not config.enhance_prompt:
            return prompt
        if self.gemma_params is None or self.tokenizer is None:
            log.warning("enhance_prompt requested but the text encoder is "
                        "not loaded; using the raw prompt")
            return prompt
        self._on_device("gemma_params", "vision_params")
        from ltx_jax.pipeline.enhance import enhance_prompt

        t0 = time.time()
        enhanced = enhance_prompt(
            self.gemma_params, self.gcfg, self.tokenizer, prompt,
            is_i2v=is_i2v, image_path=config.image_path,
            vision_params=self.vision_params,
            vision_config=self.vision_config,
            spec_k=config.enhancement_spec_k,
            mesh=self.mesh,  # TP decode: per-token weight DMA splits ~8x
        )
        if timings is not None:
            timings.enhancement = time.time() - t0
        log.info("Enhanced prompt: %s", enhanced)
        return enhanced

    def _abs_param_tree(self, tree, replicated: bool = False,
                        specs_fn=None):
        """ShapeDtypeStruct tree for AOT lowering. On a mesh the structs
        carry the SAME NamedShardings the real call's committed params have
        (live device arrays' .sharding when already placed; otherwise the
        spec walker / replication the upcoming _on_device will apply) —
        bare structs drop the shardings and warm a program never hit."""
        mesh = self.mesh or self.pp_mesh
        if mesh is None:
            return jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ltx_jax.utils import staging

        if not staging.is_host_tree(tree):
            # already placed: mirror the live shardings exactly
            return jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(
                    a.shape, a.dtype, sharding=getattr(a, "sharding", None)),
                tree)
        if replicated or specs_fn is None:
            return jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(
                    a.shape, a.dtype, sharding=NamedSharding(mesh, P())),
                tree)
        specs = specs_fn(tree)
        return jax.tree.map(
            lambda a, s: jax.ShapeDtypeStruct(
                a.shape, a.dtype, sharding=NamedSharding(mesh, s)),
            tree, specs)

    def _transformer_specs_fn(self):
        """The spec walker _on_device will apply to transformer_params."""
        if self.pp_mesh is not None:
            from ltx_jax.parallel.pipeline import pp_param_specs

            return pp_param_specs
        from ltx_jax.parallel.sharding import transformer_param_specs

        return transformer_param_specs

    def _warm_context_structs(self, guidance):
        """Abstract (context, bias) for warm lowering. On a mesh the real
        context/bias are COMMITTED replicated arrays (encode_prompt runs
        with replicated text-encoder params), so the abstract values must
        carry the same sharding annotation."""
        g = guidance.num_rows
        # 1024 = the production Gemma context; pipelines assembled without
        # a text-encoder config (probe fixtures, injected embeddings)
        # still warm the right program shape
        s = self.tecfg.max_length if self.tecfg is not None else 1024
        repl = None
        mesh = self.mesh or self.pp_mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            repl = NamedSharding(mesh, PartitionSpec())
        abs_ctx = jax.ShapeDtypeStruct((g, s, self.tcfg.caption_channels),
                                       jnp.bfloat16, sharding=repl)
        abs_bias = jax.ShapeDtypeStruct((g, 1, 1, s), jnp.float32,
                                        sharding=repl)
        return abs_ctx, abs_bias

    def _warm_cond(self, config: GenerationConfig, shape,
                   cond_frames=None, cond_frame_idx=None):
        """Conditioning pieces for a warm step lowering: the concrete
        (1, T) mask + a ZEROS stand-in conditioned latent (the step's
        compiled program depends only on its shape — the real latent is a
        call-time jit argument) + the injection scale."""
        if cond_frame_idx is not None:
            cm = self._conditioning_mask(shape, frame_idx=cond_frame_idx)
            k = int(np.asarray(cond_frame_idx).size)
        elif cond_frames is not None:
            cm = self._conditioning_mask(shape, frames=cond_frames)
            k = int(cond_frames)
        else:
            return None, None, 0.0
        ics = config.image_cond_noise_scale
        cond = None
        if ics > 0:
            cond = np.zeros((1, self.tcfg.in_channels, k, shape.height,
                             shape.width), np.float32)
        return cm, cond, ics

    def _warm_lowering(self, config: GenerationConfig, guidance,
                       width=None, height=None,
                       cond_frames=None, cond_frame_idx=None):
        """Lower the video denoise step for the upcoming shapes from
        abstract inputs only — no params touch the device (enhancement owns
        the HBM under phase staging). tests/test_pipeline.py asserts this
        lowering is IDENTICAL to the one the real denoise phase traces —
        single-chip AND mesh (sharding-annotated abstract values).

        width/height override config's (two-stage stage 1 runs half-res);
        cond_frames / cond_frame_idx warm the CONDITIONED step variants
        (I2V / extension / chain segments / keyframes — these trace a
        different program than plain T2V)."""
        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, height or config.height,
            width or config.width, channels=self.tcfg.in_channels,
        )
        abs_ctx, abs_bias = self._warm_context_structs(guidance)
        abs_params = self._abs_param_tree(
            self.transformer_params, specs_fn=self._transformer_specs_fn())
        cm, cond, ics = self._warm_cond(config, shape, cond_frames,
                                        cond_frame_idx)
        step = make_denoise_step(
            abs_params, self.tcfg, guidance, shape,
            abs_ctx, abs_bias,
            conditioning_mask=cm, conditioned_latent=cond,
            image_cond_noise_scale=(ics if cm is not None
                                    else config.image_cond_noise_scale),
            cond_frames=(cond_frames or 1), cond_frame_idx=cond_frame_idx,
            fps=config.fps, sdpa_impl=self.sdpa_impl,
            remat=self.memory.remat_blocks,
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )
        abs_latent = jax.ShapeDtypeStruct(shape.shape, jnp.float32)
        # run_denoise_loop passes python floats -> WEAK f32 scalars; a
        # strong-typed sigma would lower a different (never-hit) program
        abs_sigma = jax.ShapeDtypeStruct((), jnp.float32, weak_type=True)
        abs_key = jax.ShapeDtypeStruct((), jax.random.key(0).dtype)
        abs_pe = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), step._pe)
        args = [abs_params, abs_ctx, abs_bias, abs_pe,
                abs_latent, abs_sigma, abs_sigma, abs_latent,
                jax.ShapeDtypeStruct((), jnp.bool_), abs_key]
        if cond is not None:
            args.append(jax.ShapeDtypeStruct(cond.shape, jnp.float32))
        return step._jit.lower(*args)

    def _warm_av_lowering(self, config: GenerationConfig, guidance,
                          width=None, height=None, cond_frames=None,
                          cond_frame_idx=None, audio_cond_frames: int = 0,
                          video_euler: str = "scheduler"):
        """Lower the dual AV denoise step abstractly (the AV twin of
        _warm_lowering; VERDICT r4 #1 — AV/flagship runs previously paid
        their step compiles serially after enhancement)."""
        from ltx_jax.models import dit_av
        from ltx_jax.pipeline.denoise import make_av_denoise_step

        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, height or config.height,
            width or config.width, channels=self.tcfg.in_channels,
        )
        audio_frames = dit_av.audio_frame_count(
            config.num_frames / config.fps)
        abs_ctx, abs_bias = self._warm_context_structs(guidance)
        abs_params = self._abs_param_tree(
            self.av_transformer_params,
            specs_fn=self._transformer_specs_fn())
        cm, cond, ics = self._warm_cond(config, shape, cond_frames,
                                        cond_frame_idx)
        a_cond = None
        if (audio_cond_frames > 0 and cond is not None):
            # audio injection rides the same ics>0 gate as the video cond
            a_cond = np.zeros((1, audio_cond_frames,
                               self.tcfg.audio_in_channels), np.float32)
        step = make_av_denoise_step(
            abs_params, self.tcfg, guidance, shape, audio_frames,
            abs_ctx, abs_ctx, abs_bias,
            conditioning_mask=cm, conditioned_latent=cond,
            image_cond_noise_scale=(ics if cm is not None
                                    else config.image_cond_noise_scale),
            cond_frames=(cond_frames or 1), cond_frame_idx=cond_frame_idx,
            audio_cond_frames=audio_cond_frames,
            audio_conditioned_latent=a_cond,
            fps=config.fps,
            sdpa_impl=self.sdpa_impl, remat=self.memory.remat_blocks,
            video_euler=video_euler,
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )
        abs_video = jax.ShapeDtypeStruct(shape.shape, jnp.float32)
        abs_audio = jax.ShapeDtypeStruct(
            (1, audio_frames, self.tcfg.audio_in_channels), jnp.float32)
        abs_sigma = jax.ShapeDtypeStruct((), jnp.float32, weak_type=True)
        abs_key = jax.ShapeDtypeStruct((), jax.random.key(0).dtype)
        abs_ropes = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), step._ropes)
        args = [abs_params, abs_ctx, abs_ctx, abs_bias, abs_ropes,
                abs_video, abs_audio, abs_sigma, abs_sigma, abs_key]
        if cond is not None:
            args.append(jax.ShapeDtypeStruct(cond.shape, jnp.float32))
            if a_cond is not None:
                args.append(jax.ShapeDtypeStruct(a_cond.shape,
                                                 jnp.float32))
        return step._jit.lower(*args)

    def _warm_upscaler_lowering(self, config: GenerationConfig):
        """Lower the 2x latent-upscale program for stage-1 -> stage-2
        handoff (its compile measured ~60 s at the flagship shape)."""
        from ltx_jax.models.upscaler import (UpscalerConfig,
            upsample_latents_jit)

        s1 = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height // 2, config.width // 2,
            channels=self.tcfg.in_channels)
        abs_params = self._abs_param_tree(self.upscaler_params,
                                          replicated=True)
        mean = self.vae_decoder_params["mean_of_means"]
        std = self.vae_decoder_params["std_of_means"]
        ucfg = self.upscaler_config or UpscalerConfig(
            in_channels=self.tcfg.in_channels)
        # mean/std mirror the REAL call's placement: host numpy under
        # phase staging (uncommitted -> no annotation), committed
        # replicated device leaves otherwise on a mesh
        def _abs_leaf(a):
            sh = getattr(a, "sharding", None)
            if (self.mesh or self.pp_mesh) is not None and sh is not None:
                return jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=sh)
            return jax.ShapeDtypeStruct(a.shape, a.dtype)

        return upsample_latents_jit.lower(
            abs_params, jax.ShapeDtypeStruct(s1.shape, jnp.float32),
            _abs_leaf(mean), _abs_leaf(std), ucfg)

    def _warm_vae_lowering(self, config: GenerationConfig):
        """Lower the VAE decoder program for the decode shape the upcoming
        generation will hit (the same `_decoder_exec` cache key + argument
        structs `_decode_frames` produces), from abstract inputs only.
        Mirrors decode_video's tiling dispatch: untiled full-latent f32
        program when no tiling applies, else the main repeated tile with
        the on-device uint8 transfer. tests/test_pipeline.py asserts this
        lowering is IDENTICAL to the one the real decode phase traces."""
        from ltx_jax.models import vae as vae_mod

        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.vcfg.latent_channels,
        )
        dt = jnp.asarray([], self.vae_decoder_params["conv_in"]["w"].dtype
                         ).dtype
        ts = 0.05 if self.vcfg.timestep_conditioning else None
        tile = self.memory.vae_tile_size
        if tile <= 0 or shape.frames <= tile:
            tile_f, to_uint8 = shape.frames, False
        else:
            tile_f = tile
            to_uint8 = ("yuv420" if self.memory.decode_transfer == "yuv420"
                        else True)  # mirror _decode_frames' selection
        abs_params = self._abs_param_tree(self.vae_decoder_params,
                                          replicated=True)
        abs_tile = jax.ShapeDtypeStruct(
            (1, self.vcfg.latent_channels, tile_f, shape.height, shape.width),
            dt)
        abs_key = None
        if ts is not None:
            abs_key = jax.ShapeDtypeStruct((), jax.random.key(0).dtype)
        return vae_mod._decoder_exec(self.vcfg, ts, to_uint8).lower(
            abs_params, abs_tile, abs_key)

    def _vae_warm_applies(self, config: GenerationConfig) -> bool:
        """The VAE warm is skipped only when the mesh decode will route
        through decode_video_sharded (a shard_map program with its own
        dispatch — warming the tiled executable would compile a program
        that is never hit)."""
        if self.mesh is not None and self.mesh.shape.get("model", 1) > 1:
            lat_f = VideoLatentShape.from_pixels(
                1, config.num_frames, config.height, config.width,
                channels=self.vcfg.latent_channels).frames
            if lat_f >= self.mesh.shape["model"]:
                return False
        return True

    def _should_warm(self, config: GenerationConfig) -> bool:
        """Warm compiles overlap the prompt-enhancement generate loop; when
        enhancement won't run there is nothing device-side to hide them
        behind (and the test suite's tiny pipelines would pay every compile
        twice), so warming is gated on enhancement actually running."""
        return (config.enhance_prompt and self.gemma_params is not None
                and self.tokenizer is not None)

    def _start_warm_compile(self, config: GenerationConfig, guidance,
                            timings=None, plan=None):
        """AOT-compile the executables the upcoming generation will hit in
        background threads, so the compiles overlap the prompt-enhancement
        generate loop instead of serializing after it. Compiles proceed
        concurrently with executing programs AND with each other. Mesh runs
        warm too: the abstract params carry the real call's NamedShardings
        (_abs_param_tree), so the lowered program is the one GSPMD traces.

        plan: list of (name, thunk) where thunk() returns a jax Lowered —
        each entry point passes the programs its phases will trace (stage-1
        /stage-2 steps, upscaler, VAE, AV/chain variants). Default plan =
        generate_video's pair (T2V denoise step + VAE decoder).

        Returns a _WarmCompiles handle: `warm.join("name")` blocks until
        that program's compile lands (call right before the phase that uses
        it — later programs keep compiling during earlier phases);
        `warm.join()` joins everything. Failures only log — a failed
        warm-up just means the compile happens inline later (status quo).
        """
        if plan is None:
            plan = [("denoise",
                     lambda: self._warm_lowering(config, guidance))]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
        warm = _WarmCompiles(timings)
        for name, thunk in plan:
            warm.add(name, thunk)
        return warm

    def _encode_image_at(self, image_path: str, width: int, height: int):
        """Load + VAE-encode the conditioning image at a target resolution,
        in-pipeline like the reference (LTXPipeline.swift:2456,2651-2663)."""
        from ltx_jax.io.video import load_image

        pixels = load_image(image_path, width, height)
        return self.encode_image(pixels)

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def _decode_frames(self, latent, key, timings):
        """Shared VAE decode phase. With a mesh attached (pipe.shard), the
        frame axis decodes CONCURRENTLY across devices via
        vae.decode_video_sharded (halo-exchange shard_map); otherwise the
        sequential host tiling loop."""
        # all denoising is done by the time frames decode: free the DiT's
        # HBM before the conv stack's activations (phase_staging only)
        self._release_to_host("transformer_params", "av_transformer_params")
        self._on_device("vae_decoder_params")
        t0 = time.time()
        # decode in the decoder's own precision (bf16 at real scale — the
        # f32 denoise latent would otherwise promote the whole conv stack
        # to f32, doubling decode HBM for no visible gain; the decoder's
        # stat-sensitive steps run f32 internally regardless)
        latent = latent.astype(self.vae_decoder_params["conv_in"]["w"].dtype)
        ts = 0.05 if self.vcfg.timestep_conditioning else None
        mesh = self.mesh
        nkey = key if ts is not None else None
        if mesh is not None and mesh.shape["model"] > 1 \
                and latent.shape[2] >= mesh.shape["model"]:
            frames = vae.decode_video_sharded(
                self.vae_decoder_params, latent, self.vcfg, mesh,
                timestep=ts, noise_key=nkey,
                tile_overlap=max(self.memory.vae_tile_overlap, 1),
                transfer_uint8=("yuv420"
                                if self.memory.decode_transfer == "yuv420"
                                else True))
        else:
            # tiled decodes pull each tile as uint8 RGB (4x fewer
            # device->host bytes) or yuv420 planes (8x; the MP4 encoder's
            # own chroma subsample moved before the wire) per
            # memory.decode_transfer
            transfer = False
            if self.memory.vae_tile_size > 0:
                transfer = ("yuv420"
                            if self.memory.decode_transfer == "yuv420"
                            else True)
            frames = vae.decode_video(
                self.vae_decoder_params, latent, self.vcfg, timestep=ts,
                noise_key=nkey,
                tile_size=self.memory.vae_tile_size,
                tile_overlap=self.memory.vae_tile_overlap,
                transfer_uint8=transfer)
        device_sync(frames)
        timings.vae_decode = time.time() - t0
        return frames

    def generate_video(
        self,
        prompt: str,
        config: GenerationConfig,
        on_progress=None,
        image_latent=None,
        precomputed_embeddings=None,
        initial_noise=None,
        checkpoint=None,
    ) -> VideoGenerationResult:
        """T2V single-stage (reference: LTXPipeline.swift:586-1040), or I2V
        when `image_latent` (1, 128, 1, H', W') normalized latent is given.

        Parity-injection hooks (the reference's own validation methodology,
        SURVEY.md §4, generalized to noise):
          precomputed_embeddings: {"video": (1,S,D), "mask": (1,S),
            optionally "neg_video"/"neg_mask"} — bypass the text encoder and
            feed reference-produced embeddings to isolate the transformer.
          initial_noise: (1, C, F', H', W') float32 — bypass jax PRNG so
            per-step latents can be diffed against reference [DIAG] logs
            (MLX Philox != JAX threefry; injection is the only exact path).
          checkpoint: utils.diagnostics.DenoiseCheckpoint for resumable runs.
        """
        config.validate()
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())

        guidance = GuidanceSpec.from_config(config)

        # --- I2V: encode the conditioning image in-pipeline
        # (reference: LTXPipeline.swift:1902-1932); an injected image_latent
        # (parity hook) takes precedence.
        is_i2v = image_latent is not None or config.image_path is not None
        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(
                config.image_path, config.width, config.height)

        # --- prompt enhancement (reference: LTXPipeline.swift:2862-2971),
        # overlapped with the denoise-step compile for the upcoming shapes
        # (the 20 s enhancement loop runs device-side; the remote compile
        # proceeds concurrently on the host/compile-server)
        warm = _WarmCompiles()
        if self._should_warm(config) and precomputed_embeddings is None:
            # I2V warms the CONDITIONED step variant (round 5 — r4 warmed
            # T2V only); mesh runs warm with sharding-annotated abstract
            # values (round 4)
            cf = 1 if is_i2v else None
            plan = [("denoise", lambda: self._warm_lowering(
                config, guidance, cond_frames=cf))]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)
        prompt = self._maybe_enhance(prompt, config, is_i2v=is_i2v,
                                     timings=timings)

        # --- text encoding phase
        t0 = time.time()
        if precomputed_embeddings is not None:
            pos = {"video": jnp.asarray(precomputed_embeddings["video"]),
                   "mask": jnp.asarray(precomputed_embeddings["mask"])}
            neg = None
            if guidance.use_cfg:
                neg = {"video": jnp.asarray(precomputed_embeddings["neg_video"]),
                       "mask": jnp.asarray(precomputed_embeddings["neg_mask"])}
        else:
            pos = self.encode_prompt(prompt)
            neg = None
            if guidance.use_cfg:
                neg = self.encode_prompt(
                    config.negative_prompt or DEFAULT_NEGATIVE_PROMPT
                )
        timings.text_encoding = time.time() - t0
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()

        context, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None,
        )

        # --- latent init
        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels,
        )
        key = jax.random.key(seed)
        key, nkey = jax.random.split(key)
        sigmas = self._sigmas(config, shape)
        if initial_noise is not None:
            latent = jnp.asarray(initial_noise, jnp.float32) * float(sigmas[0])
        else:
            latent = generate_noise(nkey, shape) * float(sigmas[0])

        conditioning_mask = None
        if image_latent is not None:
            # frame 0 = clean conditioned latent; mask marks frame-0 tokens
            latent = latent.at[:, :, :1].set(image_latent.astype(latent.dtype))
            tokens_per_frame = shape.height * shape.width
            cm = np.zeros((1, shape.token_count), np.float32)
            cm[:, :tokens_per_frame] = 1.0
            conditioning_mask = cm

        # --- denoise phase (one compiled step)
        warm.join("denoise")  # VAE compile keeps overlapping the denoise
        self._on_device("transformer_params")
        step_fn = make_denoise_step(
            self.transformer_params, self.tcfg, guidance, shape,
            context, bias,
            conditioning_mask=conditioning_mask,
            conditioned_latent=image_latent,
            image_cond_noise_scale=config.image_cond_noise_scale,
            fps=config.fps,
            sdpa_impl=self.sdpa_impl,
            remat=self.memory.remat_blocks,
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )

        def on_step(i, n, sigma):
            timings.denoise_steps.append(time.time() - on_step.t0)
            on_step.t0 = time.time()
            if on_progress:
                on_progress(i, n, sigma)

        on_step.t0 = time.time()
        key, dkey = jax.random.split(key)
        latent = run_denoise_loop(step_fn, latent, sigmas, key=dkey,
                                  on_step=on_step, checkpoint=checkpoint,
                                  seed=seed)
        # drop the step closure BEFORE decode: it holds the device param
        # tree, and _release_to_host only swaps the attribute — a retained
        # closure would keep the transformer's HBM alive under the VAE
        # conv stack (measured RESOURCE_EXHAUSTED on the AV paths)
        del step_fn

        # --- VAE decode phase
        warm.join()
        key, vkey = jax.random.split(key)
        frames = self._decode_frames(latent, vkey, timings)

        frames = frames[: config.num_frames]
        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings, seed=seed)

    def generate_videos(self, prompts, config: GenerationConfig,
                        seeds=None) -> list:
        """B prompts through ONE compiled batched denoise program (serving
        throughput path; no reference analog — the Swift pipeline is
        strictly one generation at a time).

        The denoise step is compute-bound at production token counts, but
        small-to-mid shapes leave tensor-core headroom and every step's
        weight streaming is shared across the batch — queued jobs with identical
        (shape, guidance, steps) stack on the batch axis exactly like
        enhance rows do (serve/jobs.py drains compatible T2V jobs
        together). Per-job isolation: each prompt keeps its own seed,
        noise, context rows, and decode; per-sample numerics match the
        B=1 path (tests/test_serve_batch.py).

        seeds: optional per-prompt seeds (default config.seed, config.seed+1,
        ...). T2V only. Returns a list of VideoGenerationResult.
        """
        from ltx_jax.pipeline.denoise import build_guidance_context_batched

        config.validate()
        if config.image_path is not None:
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(
                "generate_videos is T2V-only: image conditioning is "
                "per-job state — route I2V requests through "
                "generate_video (serve's batch key already keeps them "
                "solo)")
        b = len(prompts)
        if b == 0:
            return []
        total_start = time.time()
        if seeds is None:
            base = config.seed if config.seed is not None else int(time.time())
            seeds = [base + i for i in range(b)]
        if len(seeds) != b:
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(
                f"{len(seeds)} seeds for {b} prompts")
        guidance = GuidanceSpec.from_config(config)

        if config.enhance_prompt and self.gemma_params is not None:
            from ltx_jax.pipeline.enhance import enhance_prompts

            self._on_device("gemma_params")
            prompts = enhance_prompts(
                self.gemma_params, self.gcfg, self.tokenizer, list(prompts),
                spec_k=config.enhancement_spec_k, mesh=self.mesh)

        # --- batched text encoding: positives AND the shared negative ride
        # ONE staged Gemma/connector pass (a separate encode_prompt for the
        # negative would re-stage the 12.8 GB tower per batch)
        t0 = time.time()
        to_encode = list(prompts)
        if guidance.use_cfg:
            to_encode.append(config.negative_prompt
                             or DEFAULT_NEGATIVE_PROMPT)
        rows = self.encode_prompts(to_encode)
        pos_rows = rows[:b]
        pos_v = jnp.concatenate([r["video"] for r in pos_rows], axis=0)
        pos_m = jnp.concatenate([r["mask"] for r in pos_rows], axis=0)
        neg_v = neg_m = None
        if guidance.use_cfg:
            neg = rows[b]
            neg_v = jnp.tile(jnp.asarray(neg["video"]), (b, 1, 1))
            neg_m = jnp.tile(jnp.asarray(neg["mask"]), (b, 1))
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        context, bias = build_guidance_context_batched(
            guidance, pos_v, pos_m, neg_v, neg_m)

        # --- per-prompt noise on the shared shape
        shape = VideoLatentShape.from_pixels(
            b, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels,
        )
        one = dataclasses.replace(shape, batch=1)
        sigmas = self._sigmas(config, shape)
        # EXACTLY the B=1 key derivation per sample (generate_video:
        # key->nkey, then dkey, then vkey) so each row's noise and decode
        # match a solo run of the same seed
        keys = []
        for s in seeds:
            k = jax.random.key(s)
            k, nkey = jax.random.split(k)
            k, dkey = jax.random.split(k)
            k, vkey = jax.random.split(k)
            keys.append((nkey, dkey, vkey))
        latent = jnp.concatenate(
            [generate_noise(k[0], one) for k in keys], axis=0
        ) * float(sigmas[0])

        timings = GenerationTimings()
        timings.text_encoding = time.time() - t0
        self._on_device("transformer_params")
        step_fn = make_denoise_step(
            self.transformer_params, self.tcfg, guidance, shape,
            context, bias, fps=config.fps, sdpa_impl=self.sdpa_impl,
            remat=self.memory.remat_blocks,
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )

        def on_step(i, n, sigma):
            timings.denoise_steps.append(time.time() - on_step.t0)
            on_step.t0 = time.time()

        on_step.t0 = time.time()
        # one shared denoise key stream: per-sample noise isolation comes
        # from the initial latents; the step's own key draws are only used
        # on the I2V re-noise path (not taken here)
        latent = run_denoise_loop(step_fn, latent, sigmas,
                                  key=keys[0][1], on_step=on_step)
        del step_fn  # free the DiT's HBM before the B decodes

        results = []
        for i in range(b):
            t_i = GenerationTimings()
            t_i.text_encoding = timings.text_encoding / b
            t_i.denoise_steps = [d / b for d in timings.denoise_steps]
            frames = self._decode_frames(latent[i: i + 1], keys[i][2], t_i)
            t_i.total = time.time() - total_start
            results.append(VideoGenerationResult(
                frames=frames[: config.num_frames], timings=t_i,
                seed=seeds[i]))
        return results

    def generate_video_from_video(
        self,
        prompt: str,
        config: GenerationConfig,
        video_path: Optional[str] = None,
        video_frames=None,
        strength: float = 0.6,
        on_progress=None,
    ) -> VideoGenerationResult:
        """VIDEO-to-video: restyle/redirect an input clip under a new
        prompt (no reference analog — the Swift pipeline conditions on a
        single image only; this is the SDEdit-style partial-noising
        counterpart, reusing the exact flow-matching forward the scheduler
        defines: x_k = (1-sigma_k) x_0 + sigma_k noise).

        strength in (0, 1]: the fraction of the schedule re-run. 1.0 =
        full noise (identical to generate_video with the same seed —
        sigma_0 is 1.0 on both schedules, tested); small values keep the
        input clip's structure and only repaint details.

        video_path: any readable clip (frames evenly resampled to
        config.num_frames and LANCZOS-resized, io/video.load_video);
        video_frames: alternatively a preloaded (1, 3, F, H, W) array in
        [-1, 1] with F == config.num_frames.
        """
        config.validate()
        if not 0.0 < strength <= 1.0:
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(
                f"v2v strength must be in (0, 1], got {strength}")
        if (video_path is None) == (video_frames is None):
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(
                "pass exactly one of video_path / video_frames")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        guidance = GuidanceSpec.from_config(config)

        if video_frames is None:
            from ltx_jax.io.video import load_video

            video_frames = load_video(video_path, config.width,
                                      config.height, config.num_frames)
        video_frames = jnp.asarray(video_frames)
        if video_frames.shape != (1, 3, config.num_frames, config.height,
                                  config.width):
            from ltx_jax.core.errors import InvalidConfigurationError

            raise InvalidConfigurationError(
                f"video_frames {video_frames.shape} != (1, 3, "
                f"{config.num_frames}, {config.height}, {config.width})")

        # v2v denoises the plain T2V step program (partial schedule only)
        warm = _WarmCompiles()
        if self._should_warm(config):
            plan = [("denoise",
                     lambda: self._warm_lowering(config, guidance))]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)
        prompt = self._maybe_enhance(prompt, config, is_i2v=False,
                                     timings=timings)

        t0 = time.time()
        pos = self.encode_prompt(prompt)
        neg = None
        if guidance.use_cfg:
            neg = self.encode_prompt(
                config.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
        timings.text_encoding = time.time() - t0
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        context, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None,
        )

        # --- encode the input clip, then flow-match-noise it to sigma_k
        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels,
        )
        src_latent = self.encode_video(video_frames).astype(jnp.float32)
        sig_full = self._sigmas(config, shape)
        n_steps = len(sig_full) - 1
        k = min(max(int(round((1.0 - strength) * n_steps)), 0), n_steps - 1)
        sigmas = sig_full[k:]

        # EXACTLY generate_video's key derivation, so strength=1.0 (k=0,
        # sigma_0=1.0 -> pure noise) reproduces the T2V output bit-for-bit
        key = jax.random.key(seed)
        key, nkey = jax.random.split(key)
        noise = generate_noise(nkey, shape)
        latent = schedule.add_noise(src_latent, noise, float(sigmas[0]))

        key, dkey = jax.random.split(key)
        warm.join("denoise")
        latent = self._denoise(latent, sigmas, shape, guidance, context,
                               bias, None, 0.0, config.fps, dkey, timings,
                               on_progress)

        warm.join()
        key, vkey = jax.random.split(key)
        frames = self._decode_frames(latent, vkey, timings)
        frames = frames[: config.num_frames]
        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=seed)

    def encode_video(self, pixels):
        """(1, 3, F, H, W) in [-1, 1] -> normalized latent (the multi-frame
        twin of encode_image; the causal encoder handles any 8k+1 frame
        count)."""
        return self.encode_image(pixels)

    def generate_video_extension(
        self,
        prompt: str,
        config: GenerationConfig,
        video_path: Optional[str] = None,
        video_frames=None,
        cond_frames: int = 9,
        on_progress=None,
    ) -> VideoGenerationResult:
        """EXTEND a clip: condition on its last cond_frames pixel frames
        and generate the continuation (no reference analog — the Swift
        pipeline conditions on a single image only; this is the
        multi-frame generalization of I2V: the conditioned latent frames
        get per-token timestep 0, per-step clean-source noise injection,
        and are frozen through Euler — pipeline/denoise.py cond_frames).

        The output video STARTS with the conditioned frames (re-encoded
        through the VAE) and continues for config.num_frames total — to
        join with the source clip, trim the first cond_frames frames of
        the result or crossfade over them.

        cond_frames: pixel frames taken from the input's TAIL; must be
        8k+1 (the causal VAE's frame alignment) and < config.num_frames.
        cond_frames=1 with a one-frame clip is exactly I2V (same key
        derivation as generate_video — tested bit-for-bit).

        video_path: any readable clip (its last cond_frames frames are
        used, LANCZOS-resized); video_frames: alternatively a preloaded
        (1, 3, cond_frames, H, W) array in [-1, 1].
        """
        config.validate()
        if cond_frames < 1 or (cond_frames - 1) % 8 != 0:
            raise InvalidConfigurationError(
                f"cond_frames must be 8k+1, got {cond_frames}")
        if cond_frames >= config.num_frames:
            raise InvalidConfigurationError(
                f"cond_frames {cond_frames} must be < num_frames "
                f"{config.num_frames}")
        if (video_path is None) == (video_frames is None):
            raise InvalidConfigurationError(
                "pass exactly one of video_path / video_frames")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        guidance = GuidanceSpec.from_config(config)

        if video_frames is None:
            from ltx_jax.io.video import load_video

            video_frames = load_video(video_path, config.width,
                                      config.height, cond_frames,
                                      sample="tail")
        video_frames = jnp.asarray(video_frames)
        if video_frames.shape != (1, 3, cond_frames, config.height,
                                  config.width):
            raise InvalidConfigurationError(
                f"video_frames {video_frames.shape} != (1, 3, "
                f"{cond_frames}, {config.height}, {config.width})")

        # the extension step's program depends on k_lat (conditioning mask
        # + frozen-frame split) — warm exactly that variant
        warm = _WarmCompiles()
        if self._should_warm(config):
            k_warm = (cond_frames - 1) // 8 + 1
            plan = [("denoise", lambda: self._warm_lowering(
                config, guidance, cond_frames=k_warm))]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)
        prompt = self._maybe_enhance(prompt, config, is_i2v=False,
                                     timings=timings)

        t0 = time.time()
        pos = self.encode_prompt(prompt)
        neg = None
        if guidance.use_cfg:
            neg = self.encode_prompt(
                config.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
        timings.text_encoding = time.time() - t0
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        context, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None,
        )

        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels,
        )
        cond_latent = self.encode_video(video_frames).astype(jnp.float32)
        k_lat = cond_latent.shape[2]  # (cond_frames - 1) // 8 + 1

        # EXACTLY generate_video's key derivation (so cond_frames=1
        # reproduces I2V bit-for-bit; tests/test_extend.py)
        key = jax.random.key(seed)
        key, nkey = jax.random.split(key)
        sigmas = self._sigmas(config, shape)
        latent = generate_noise(nkey, shape) * float(sigmas[0])
        latent = latent.at[:, :, :k_lat].set(cond_latent.astype(latent.dtype))
        cm = self._conditioning_mask(shape, frames=k_lat)

        key, dkey = jax.random.split(key)
        warm.join("denoise")
        latent = self._denoise(latent, sigmas, shape, guidance, context,
                               bias, cm, config.image_cond_noise_scale,
                               config.fps, dkey, timings, on_progress,
                               conditioned_latent=cond_latent,
                               cond_frames=k_lat)

        warm.join()
        key, vkey = jax.random.split(key)
        frames = self._decode_frames(latent, vkey, timings)
        frames = frames[: config.num_frames]
        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=seed)

    def _encode_keyframe_sources(self, keyframes, config: GenerationConfig):
        """Resolve keyframe (pixel_frame_idx, source) pairs into a stacked
        conditioned latent + sorted latent-frame indices (shared by
        generate_video_keyframes and the chain's per-segment anchors)."""
        lat_idx: list = []
        lats = []
        for pix_idx, src in sorted(keyframes, key=lambda kv: int(kv[0])):
            pix_idx = int(pix_idx)
            if pix_idx % 8 != 0:
                raise InvalidConfigurationError(
                    f"keyframe index {pix_idx} must be a multiple of 8 "
                    "(latent-frame alignment: latent k sits at pixel 8k)")
            if not 0 <= pix_idx < config.num_frames:
                raise InvalidConfigurationError(
                    f"keyframe index {pix_idx} outside "
                    f"[0, {config.num_frames})")
            k = pix_idx // 8
            if k in lat_idx:
                raise InvalidConfigurationError(
                    f"duplicate keyframe at latent index {k}")
            if isinstance(src, str):
                lat = self._encode_image_at(src, config.width,
                                            config.height)
            else:
                src = jnp.asarray(src)
                if src.ndim != 5 or src.shape[2] != 1:
                    raise InvalidConfigurationError(
                        f"keyframe source shape {tuple(src.shape)} is "
                        "neither pixels (1, 3, 1, H, W) nor a latent "
                        "(1, C, 1, h, w)")
                if src.shape[1] == 3:
                    lat = self.encode_image(src)
                elif src.shape[1] == self.tcfg.in_channels:
                    lat = src
                else:
                    raise InvalidConfigurationError(
                        f"keyframe source has {src.shape[1]} channels; "
                        f"expected 3 (pixels) or {self.tcfg.in_channels} "
                        "(latent)")
            lat_idx.append(k)
            lats.append(lat.astype(jnp.float32))
        return (jnp.concatenate(lats, axis=2),
                np.asarray(lat_idx, np.int64))

    def generate_video_keyframes(
        self,
        prompt: str,
        config: GenerationConfig,
        keyframes,
        on_progress=None,
        audio: bool = False,
        audio_gain: float = 1.0,
    ) -> VideoGenerationResult:
        """Condition at ARBITRARY frame positions (keyframe interpolation /
        anchoring): keyframes = [(pixel_frame_idx, source), ...] — e.g.
        [(0, "first.png"), (112, "last.png")] generates the in-between
        motion. No reference analog (the Swift pipeline conditions on
        frame 0 only, LTXPipeline.swift:1902-1932); this matches the
        upstream LTX-Video Python pipeline's conditioning items,
        restricted to single-frame anchors.

        source: an image path (loaded + LANCZOS-resized), a pixel array
        (1, 3, 1, H, W) in [-1, 1], or a pre-encoded normalized latent
        (1, C, 1, h, w). pixel_frame_idx must be a multiple of 8 (the
        causal VAE's temporal stride); each image encodes standalone
        through the causal first-frame path and anchors latent index
        idx // 8 — its latent frames get per-token timestep 0, per-step
        clean-source noise injection, and carry through Euler
        (pipeline/denoise.py cond_frame_idx).

        keyframes=[(0, latent)] reproduces
        generate_video(image_latent=latent) bit-for-bit (same key
        derivation, same noise draw shapes — tests/test_keyframes.py).

        audio=True runs the dual AV transformer instead (round 5 — the AV
        twin: anchors condition VIDEO frames at arbitrary positions while
        a matching soundtrack generates via cross-modal attention;
        generate_video_with_audio's exact key derivation, so
        keyframes=[(0, lat)] reproduces AV I2V bit-for-bit).
        """
        config.validate()
        if not keyframes:
            raise InvalidConfigurationError("keyframes must be non-empty")
        if audio:
            if self.av_transformer_params is None:
                raise ModelNotLoadedError("AV transformer")
            if self.audio_vae_params is None:
                raise ModelNotLoadedError("audio VAE")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        guidance = GuidanceSpec.from_config(config)
        if audio:
            # STG is not defined for the AV path (matches
            # generate_video_with_audio)
            guidance = dataclasses.replace(guidance, stg_scale=0.0)

        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels,
        )
        cond_latent, cond_idx = self._encode_keyframe_sources(keyframes,
                                                              config)

        # keyframe indices are STATIC in the step program — warm exactly
        # this anchor layout
        warm = _WarmCompiles()
        if self._should_warm(config):
            if audio:
                plan = [("denoise_av", lambda: self._warm_av_lowering(
                    config, guidance, cond_frame_idx=cond_idx))]
            else:
                plan = [("denoise", lambda: self._warm_lowering(
                    config, guidance, cond_frame_idx=cond_idx))]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)
        prompt = self._maybe_enhance(prompt, config, is_i2v=True,
                                     timings=timings)

        t0 = time.time()
        pos = self.encode_prompt(prompt)
        if audio and "audio" not in pos:
            raise TextEncodingFailedError(
                "text encoder lacks the audio connector")
        neg = None
        if guidance.use_cfg:
            neg = self.encode_prompt(
                config.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
        timings.text_encoding = time.time() - t0
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()

        sigmas = self._sigmas(config, shape)
        cm = self._conditioning_mask(shape, frame_idx=cond_idx)

        if audio:
            # the AV twin: EXACTLY generate_video_with_audio's key
            # derivation (so keyframes=[(0, lat)] == AV I2V bit-for-bit)
            from ltx_jax.models import audio_vae as audio_vae_mod
            from ltx_jax.models import dit_av
            from ltx_jax.pipeline.denoise import (
                make_av_denoise_step,
                run_av_denoise_loop,
            )

            v_ctx, bias = build_guidance_context(
                guidance, pos["video"], pos["mask"],
                neg["video"] if neg else None,
                neg["mask"] if neg else None)
            a_ctx, _ = build_guidance_context(
                guidance, pos["audio"], pos["mask"],
                neg["audio"] if neg else None,
                neg["mask"] if neg else None)
            audio_frames = dit_av.audio_frame_count(
                config.num_frames / config.fps)
            mel_latent_bins = self.tcfg.audio_in_channels // 8

            key = jax.random.key(seed)
            key, vkey, akey, dkey = jax.random.split(key, 4)
            video_latent = generate_noise(vkey, shape) * float(sigmas[0])
            audio_raw = jax.random.normal(
                akey, (1, 8, audio_frames, mel_latent_bins), jnp.float32)
            audio_packed = dit_av.pack_audio_latents(audio_raw) \
                * float(sigmas[0])
            video_latent = video_latent.at[:, :, cond_idx].set(
                cond_latent.astype(video_latent.dtype))

            warm.join("denoise_av")
            self._on_device("av_transformer_params")
            step_fn = make_av_denoise_step(
                self.av_transformer_params, self.tcfg, guidance, shape,
                audio_frames, v_ctx, a_ctx, bias,
                conditioning_mask=cm, conditioned_latent=cond_latent,
                image_cond_noise_scale=config.image_cond_noise_scale,
                cond_frame_idx=cond_idx, fps=config.fps,
                sdpa_impl=self.sdpa_impl, remat=self.memory.remat_blocks,
                pp_mesh=self.pp_mesh,
                pp_microbatches=self.pp_microbatches,
            )

            def on_step(i, n, sigma):
                timings.denoise_steps.append(time.time() - on_step.t0)
                on_step.t0 = time.time()
                if on_progress:
                    on_progress(i, n, sigma)

            on_step.t0 = time.time()
            video_latent, audio_packed = run_av_denoise_loop(
                step_fn, video_latent, audio_packed, sigmas, key=dkey,
                on_step=on_step)
            del step_fn  # closure holds the AV params' HBM — free it

            warm.join()
            key, dvkey = jax.random.split(key)
            frames = self._decode_frames(video_latent, dvkey, timings)
            frames = frames[: config.num_frames]

            audio_latents = dit_av.unpack_audio_latents(
                audio_packed, channels=8, mel=mel_latent_bins)
            self._on_device("audio_vae_params", "vocoder_params")
            waveform = audio_vae_mod.decode_audio_jit(
                self.audio_vae_params, self.vocoder_params, audio_latents,
                self.audio_vae_config or audio_vae_mod.AudioVAEConfig(),
                self.vocoder_config or audio_vae_mod.VocoderConfig())
            if audio_gain != 1.0:
                waveform = jnp.clip(waveform * audio_gain, -1.0, 1.0)
            timings.total = time.time() - total_start
            return VideoGenerationResult(frames=frames, timings=timings,
                                         seed=seed, audio=waveform[0])

        context, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None,
        )

        # EXACTLY generate_video's key derivation (so keyframes=[(0, lat)]
        # reproduces I2V bit-for-bit)
        key = jax.random.key(seed)
        key, nkey = jax.random.split(key)
        latent = generate_noise(nkey, shape) * float(sigmas[0])
        latent = latent.at[:, :, cond_idx].set(
            cond_latent.astype(latent.dtype))

        key, dkey = jax.random.split(key)
        warm.join("denoise")
        latent = self._denoise(latent, sigmas, shape, guidance, context,
                               bias, cm, config.image_cond_noise_scale,
                               config.fps, dkey, timings, on_progress,
                               conditioned_latent=cond_latent,
                               cond_frame_idx=cond_idx)

        warm.join()
        key, vkey = jax.random.split(key)
        frames = self._decode_frames(latent, vkey, timings)
        frames = frames[: config.num_frames]
        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=seed)

    def generate_video_chain(
        self,
        prompt: str,
        config: GenerationConfig,
        segments: int,
        cond_frames: int = 9,
        prompts=None,
        on_progress=None,
        precomputed_embeddings=None,
        anchors=None,
        tail_renorm: float = 0.0,
    ) -> VideoGenerationResult:
        """CHAINED long-video generation: autoregressively extend past the
        single-clip token budget by conditioning each segment on the
        previous segment's tail — IN LATENT SPACE (no reference analog;
        the Swift pipeline generates one clip per call,
        LTXPipeline.swift:586-1040).

        Two deliberate departures from naive generate->export->extend
        chaining:
          * the tail carries as the previous segment's DENOISED latent
            directly — no decode->re-encode round trip, so no VAE
            reconstruction drift accumulating across segments (the
            denoised latent lives in the same normalized latent space
            the conditioning path expects);
          * ALL segments denoise first, THEN all segments decode — under
            phase_staging this stages the DiT onto the chip once for the
            whole chain instead of ping-ponging DiT<->VAE HBM per
            segment, and every segment reuses the ONE compiled extension
            step program (identical shapes/masks by construction).

        Segment i's seed is seed+i with generate_video's exact key
        derivation, so segment 0 — and therefore the first num_frames
        output frames — reproduces generate_video(prompt, config)
        bit-for-bit (tests/test_chain.py). Later segments run the
        extension conditioning (pipeline/denoise.py cond_frames): the
        carried tail's latent frames get per-token timestep 0, per-step
        clean-source noise injection, and are frozen through Euler.

        segments: total clips to generate (>= 1). cond_frames: pixel
        frames of overlap carried between segments; must be 8k+1 and
        < config.num_frames. Each segment after the first contributes
        num_frames - cond_frames new frames (its first cond_frames
        frames re-render the carried tail and are trimmed), so the
        result has num_frames + (segments-1)*(num_frames - cond_frames)
        frames. prompts: optional per-segment prompt list (len ==
        segments) for evolving scene direction; default: `prompt` for
        every segment. precomputed_embeddings: the generate_video
        parity-injection hook ({"video", "mask"[, "neg_video",
        "neg_mask"]}) — bypasses the text encoder for EVERY segment
        (prompts then must be uniform/None).

        anchors: optional {segment_index: [(pixel_frame_idx, source),
        ...]} — per-segment KEYFRAME anchors (round 5, the anti-drift
        tool: pin mid-chain segments to reference images so latent-carry
        autoregression cannot wander). Sources/index rules match
        generate_video_keyframes; indices are per-segment-local. For
        segments > 0 the anchor's latent index must be >= the carried
        tail's k_lat frames (the tail already conditions those), and the
        segment denoises through the cond_frame_idx path (tail indices +
        anchor indices), tracing its OWN step program (anchor layouts are
        static). anchors={0: kfs} with segments=1 reproduces
        generate_video_keyframes(prompt, config, kfs) bit-for-bit.

        tail_renorm in [0, 1]: opt-in drift mitigation (round 5) — AdaIN
        each carried tail's per-channel mean/std toward SEGMENT 0's tail
        stats before it conditions the next segment (factor = blend
        strength; 0 = off, exactly the r4 behavior). Latent-carry
        autoregression can drift statistically over many segments (each
        segment renders from a tail the model itself produced);
        re-anchoring the carried statistics to the first segment bounds
        the excursion without touching content structure.
        """
        config.validate()
        segments = int(segments)
        if segments < 1:
            raise InvalidConfigurationError(
                f"segments must be >= 1, got {segments}")
        if cond_frames < 1 or (cond_frames - 1) % 8 != 0:
            raise InvalidConfigurationError(
                f"cond_frames must be 8k+1, got {cond_frames}")
        if segments > 1 and cond_frames >= config.num_frames:
            raise InvalidConfigurationError(
                f"cond_frames {cond_frames} must be < num_frames "
                f"{config.num_frames}")
        if prompts is not None and len(prompts) != segments:
            raise InvalidConfigurationError(
                f"{len(prompts)} prompts for {segments} segments")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        guidance = GuidanceSpec.from_config(config)
        seg_prompts = list(prompts) if prompts is not None \
            else [prompt] * segments

        # --- per-segment keyframe anchors: encode sources once, validate
        # against the carried tail's frames
        k_lat_w = (cond_frames - 1) // 8 + 1
        anchor_enc = self._encode_chain_anchors(anchors, segments, k_lat_w,
                                                config)

        # warm EVERY chain program (segment-0, the shared extension step,
        # each anchored segment's own layout) and the decoder while
        # enhancement runs
        warm = _WarmCompiles()
        if self._should_warm(config) and precomputed_embeddings is None:
            if 0 in anchor_enc:
                idx0 = anchor_enc[0][1]
                plan = [("denoise", lambda: self._warm_lowering(
                    config, guidance, cond_frame_idx=idx0))]
            else:
                plan = [("denoise",
                         lambda: self._warm_lowering(config, guidance))]
            if any(i not in anchor_enc for i in range(1, segments)):
                plan.append(("denoise_ext", lambda: self._warm_lowering(
                    config, guidance, cond_frames=k_lat_w)))
            for si in sorted(anchor_enc):
                if si > 0:
                    aidx = np.concatenate([np.arange(k_lat_w),
                                           anchor_enc[si][1]])
                    plan.append((f"denoise_anchor_{si}",
                                 lambda aidx=aidx: self._warm_lowering(
                                     config, guidance,
                                     cond_frame_idx=aidx)))
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)

        # --- text encoding: enhance + encode each UNIQUE prompt once
        if precomputed_embeddings is not None:
            if prompts is not None and len(set(seg_prompts)) > 1:
                raise InvalidConfigurationError(
                    "precomputed_embeddings carries ONE embedding set; "
                    "per-segment prompts cannot vary with it")
            pe_ = precomputed_embeddings
            pos = {"video": jnp.asarray(pe_["video"]),
                   "mask": jnp.asarray(pe_["mask"])}
            neg = None
            if guidance.use_cfg:
                neg = {"video": jnp.asarray(pe_["neg_video"]),
                       "mask": jnp.asarray(pe_["neg_mask"])}
            encoded = {p: pos for p in seg_prompts}
        else:
            encoded, neg = self._encode_chain_prompts(
                seg_prompts, config, guidance, timings)
        contexts = []
        for p in seg_prompts:
            pos = encoded[p]
            contexts.append(build_guidance_context(
                guidance, pos["video"], pos["mask"],
                neg["video"] if neg else None,
                neg["mask"] if neg else None))

        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels,
        )
        k_lat = (cond_frames - 1) // 8 + 1
        sigmas = self._sigmas(config, shape)
        n_steps = len(sigmas) - 1
        cm = self._conditioning_mask(shape, frames=k_lat)

        # --- phase 1: denoise every segment, carrying the tail latent.
        # Segments >= 1 share ONE compiled extension-step program: context
        # and the conditioned latent are call-time jit ARGUMENTS of the
        # step (step._jit), so new prompts/tails never recompile — only
        # the first extension segment pays the trace.
        latents = []
        vkeys = []
        tail = None
        ext_step = None
        for i in range(segments):
            # EXACTLY generate_video's derivation at seed+i (segment 0 is
            # bit-identical to generate_video; tests/test_chain.py)
            key = jax.random.key(seed + i)
            key, nkey = jax.random.split(key)
            latent = generate_noise(nkey, shape) * float(sigmas[0])
            context, bias = contexts[i]

            def on_seg_step(s, n, sigma, _i=i):
                if on_progress:
                    on_progress(_i * n_steps + s, segments * n_steps,
                                sigma)

            key, dkey = jax.random.split(key)
            seg_anchor = anchor_enc.get(i)
            if i == 0:
                warm.join("denoise")
                if seg_anchor is not None:
                    # anchored first segment == generate_video_keyframes'
                    # exact ops order (set anchors -> cond_frame_idx step)
                    a_lat, a_idx = seg_anchor
                    latent = latent.at[:, :, a_idx].set(
                        a_lat.astype(latent.dtype))
                    acm = self._conditioning_mask(shape, frame_idx=a_idx)
                    latent = self._denoise(
                        latent, sigmas, shape, guidance, context, bias,
                        acm, config.image_cond_noise_scale, config.fps,
                        dkey, timings, on_seg_step,
                        conditioned_latent=a_lat, cond_frame_idx=a_idx)
                else:
                    latent = self._denoise(latent, sigmas, shape, guidance,
                                           context, bias, None, 0.0,
                                           config.fps, dkey, timings,
                                           on_seg_step)
            elif seg_anchor is not None:
                # anchored continuation: the carried tail AND the anchor
                # frames condition via cond_frame_idx (its own compiled
                # program — anchor layouts are static)
                a_lat, a_idx = seg_anchor
                latent = latent.at[:, :, :k_lat].set(
                    tail.astype(latent.dtype))
                latent = latent.at[:, :, a_idx].set(
                    a_lat.astype(latent.dtype))
                idx = np.concatenate([np.arange(k_lat), a_idx])
                c_lat = jnp.concatenate([tail, a_lat], axis=2)
                acm = self._conditioning_mask(shape, frame_idx=idx)
                warm.join(f"denoise_anchor_{i}")
                latent = self._denoise(
                    latent, sigmas, shape, guidance, context, bias,
                    acm, config.image_cond_noise_scale, config.fps,
                    dkey, timings, on_seg_step,
                    conditioned_latent=c_lat, cond_frame_idx=idx)
            else:
                latent = latent.at[:, :, :k_lat].set(
                    tail.astype(latent.dtype))
                self._on_device("transformer_params")
                if ext_step is None:
                    warm.join("denoise_ext")
                    ext_step = make_denoise_step(
                        self.transformer_params, self.tcfg, guidance,
                        shape, context, bias,
                        conditioning_mask=cm,
                        conditioned_latent=tail,
                        image_cond_noise_scale=(
                            config.image_cond_noise_scale),
                        cond_frames=k_lat, fps=config.fps,
                        sdpa_impl=self.sdpa_impl,
                        remat=self.memory.remat_blocks,
                        pp_mesh=self.pp_mesh,
                        pp_microbatches=self.pp_microbatches,
                    )
                    seg_step = ext_step
                else:
                    # rebind (context, bias, tail) on the SAME jitted
                    # program (injection-off traces drop the cond arg)
                    _jit, _pe = ext_step._jit, ext_step._pe
                    cond_arg = ((tail,)
                                if config.image_cond_noise_scale > 0
                                else ())

                    def seg_step(lat, s0, s1, pv, hp, k,
                                 _c=context, _b=bias, _cl=cond_arg):
                        return _jit(self.transformer_params, _c, _b,
                                    _pe, lat, s0, s1, pv, hp, k, *_cl)

                def on_step(s, n, sigma, _cb=on_seg_step):
                    timings.denoise_steps.append(time.time() - on_step.t0)
                    on_step.t0 = time.time()
                    _cb(s, n, sigma)

                on_step.t0 = time.time()
                latent = run_denoise_loop(seg_step, latent, sigmas,
                                          key=dkey, on_step=on_step)
            tail = latent[:, :, -k_lat:].astype(jnp.float32)
            if i == 0:
                tail0 = tail  # segment-0 tail = the renorm reference
            elif tail_renorm > 0:
                from ltx_jax.ops.latents import adain_filter_latent

                tail = adain_filter_latent(tail, tail0,
                                           factor=float(tail_renorm))
            latents.append(latent)
            key, vkey = jax.random.split(key)
            vkeys.append(vkey)

        # --- phase 2: decode every segment, trim the carried overlap
        # (drop the step closures first — they hold the DiT's device
        # params, which _release_to_host alone cannot free)
        ext_step = seg_step = None
        warm.join()
        parts = []
        for i, (latent, vkey) in enumerate(zip(latents, vkeys)):
            frames = self._decode_frames(latent, vkey, timings)
            frames = np.asarray(frames[: config.num_frames])
            parts.append(frames if i == 0 else frames[cond_frames:])
        frames = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=0)
        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=seed)

    def generate_video_chain_with_audio(
        self,
        prompt: str,
        config: GenerationConfig,
        segments: int,
        cond_frames: int = 9,
        prompts=None,
        audio_gain: float = 1.0,
        on_progress=None,
        audio_cond: bool = False,
        anchors=None,
    ) -> VideoGenerationResult:
        """CHAINED long video WITH a generated soundtrack: the AV twin of
        generate_video_chain — each segment runs the dual AV transformer
        (generate_video_with_audio's exact per-segment derivation at
        seed+i, so segments=1 reproduces it bit-for-bit), the VIDEO tail
        carries in latent space, and per-segment waveforms stitch with a
        linear crossfade over the trimmed overlap window.

        audio_cond=False (default): each segment's audio is generated
        fresh (coherent with its own video via cross-modal attention, but
        not continued from the previous segment's waveform); the
        crossfade masks the seam.

        audio_cond=True (round 5 experiment, VERDICT r4 missing #5):
        ALSO carry the previous segment's AUDIO tail latents through the
        AV step's audio conditioning (per-token audio timestep 0 +
        clean-source injection + carry — the exact audio analog of the
        video cond_frames path; pipeline/denoise.py audio_cond_frames).
        The overlap window then re-renders near-identical audio on both
        sides of the seam, so the crossfade blends matching content.
        CAVEAT: the underlying model was not explicitly trained for
        audio conditioning; real-checkpoint listening validation is
        pending. Crossfade-only stays the default.

        Segments >= 1 share ONE compiled AV extension-step program
        (context/tail rebind via step._jit/_ropes as call-time jit args).

        anchors: per-segment keyframe anchors, same semantics as
        generate_video_chain's (round 5 — the AV cond_frame_idx path):
        anchored segments condition on the carried tail PLUS the anchor
        frames and trace their own step program (static anchor layouts).
        """
        from ltx_jax.models import audio_vae as audio_vae_mod
        from ltx_jax.models import dit_av
        from ltx_jax.pipeline.denoise import (
            make_av_denoise_step,
            run_av_denoise_loop,
        )

        config.validate()
        if self.av_transformer_params is None:
            raise ModelNotLoadedError("AV transformer")
        if self.audio_vae_params is None:
            raise ModelNotLoadedError("audio VAE")
        segments = int(segments)
        if segments < 1:
            raise InvalidConfigurationError(
                f"segments must be >= 1, got {segments}")
        if cond_frames < 1 or (cond_frames - 1) % 8 != 0:
            raise InvalidConfigurationError(
                f"cond_frames must be 8k+1, got {cond_frames}")
        if segments > 1 and cond_frames >= config.num_frames:
            raise InvalidConfigurationError(
                f"cond_frames {cond_frames} must be < num_frames "
                f"{config.num_frames}")
        if prompts is not None and len(prompts) != segments:
            raise InvalidConfigurationError(
                f"{len(prompts)} prompts for {segments} segments")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        guidance = dataclasses.replace(
            GuidanceSpec.from_config(config), stg_scale=0.0)
        seg_prompts = list(prompts) if prompts is not None \
            else [prompt] * segments

        # --- per-segment anchors: encode + validate BEFORE the text
        # phases (an invalid anchor must not fail after minutes of
        # device work; same ordering as the video chain)
        k_lat_w = (cond_frames - 1) // 8 + 1
        af_w = dit_av.audio_frame_count(config.num_frames / config.fps)
        k_a_w = (max(1, int(round(af_w * cond_frames
                                  / config.num_frames)))
                 if audio_cond else 0)
        if audio_cond and k_a_w >= af_w:
            raise InvalidConfigurationError(
                f"audio overlap {k_a_w} >= audio_frames {af_w} "
                "(cond_frames too close to num_frames for audio_cond)")
        anchor_enc = self._encode_chain_anchors(anchors, segments,
                                                k_lat_w, config)

        # warm EVERY AV chain program (segment-0, the shared extension
        # step when some continuation is unanchored, each anchored
        # segment's own layout) and the decoder while enhancement runs
        warm = _WarmCompiles()
        if self._should_warm(config):
            if 0 in anchor_enc:
                idx0 = anchor_enc[0][1]
                plan = [("denoise_av", lambda: self._warm_av_lowering(
                    config, guidance, cond_frame_idx=idx0))]
            else:
                plan = [("denoise_av",
                         lambda: self._warm_av_lowering(config, guidance))]
            if any(i not in anchor_enc for i in range(1, segments)):
                plan.append(("denoise_av_ext",
                             lambda: self._warm_av_lowering(
                                 config, guidance, cond_frames=k_lat_w,
                                 audio_cond_frames=k_a_w)))
            for si in sorted(anchor_enc):
                if si > 0:
                    aidx = np.concatenate([np.arange(k_lat_w),
                                           anchor_enc[si][1]])
                    plan.append((f"denoise_av_anchor_{si}",
                                 lambda aidx=aidx:
                                 self._warm_av_lowering(
                                     config, guidance,
                                     cond_frame_idx=aidx,
                                     audio_cond_frames=k_a_w)))
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)

        # --- text encoding: enhance + encode each UNIQUE prompt once
        # (batched — one staging cycle — when prompts vary per segment)
        encoded, neg = self._encode_chain_prompts(
            seg_prompts, config, guidance, timings, need_audio=True)
        contexts = []
        for p in seg_prompts:
            pos = encoded[p]
            v_ctx, bias = build_guidance_context(
                guidance, pos["video"], pos["mask"],
                neg["video"] if neg else None,
                neg["mask"] if neg else None)
            a_ctx, _ = build_guidance_context(
                guidance, pos["audio"], pos["mask"],
                neg["audio"] if neg else None,
                neg["mask"] if neg else None)
            contexts.append((v_ctx, a_ctx, bias))

        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels)
        duration = config.num_frames / config.fps
        audio_frames = dit_av.audio_frame_count(duration)
        mel_latent_bins = self.tcfg.audio_in_channels // 8
        k_lat = k_lat_w
        sigmas = self._sigmas(config, shape)
        n_steps = len(sigmas) - 1
        cm = self._conditioning_mask(shape, frames=k_lat)
        # audio latent frames covering the trimmed overlap window (the
        # crossfade's own k; audio latents run at ~25/s) — computed with
        # the anchors before the text phases
        k_a = k_a_w

        # --- phase 1: AV denoise every segment, carrying the video tail
        self._on_device("av_transformer_params")
        seg_latents = []
        dvkeys = []
        tail = None
        audio_tail = None
        base_step = None
        ext_step = None
        for i in range(segments):
            # EXACTLY generate_video_with_audio's derivation at seed+i
            key = jax.random.key(seed + i)
            v_ctx, a_ctx, bias = contexts[i]
            key, vkey, akey, dkey = jax.random.split(key, 4)
            video_latent = generate_noise(vkey, shape) * float(sigmas[0])
            audio_raw = jax.random.normal(
                akey, (1, 8, audio_frames, mel_latent_bins), jnp.float32)
            audio_packed = dit_av.pack_audio_latents(audio_raw) \
                * float(sigmas[0])

            seg_anchor = anchor_enc.get(i)
            if seg_anchor is not None:
                # anchored AV segment: carried tail (i > 0) + anchors
                # condition via cond_frame_idx; its OWN step program
                # (static anchor layout, warmed per layout), audio
                # conditioning unchanged
                warm.join("denoise_av" if i == 0
                          else f"denoise_av_anchor_{i}")
                a_lat, a_idx = seg_anchor
                if i == 0:
                    fidx, c_lat = a_idx, a_lat
                else:
                    video_latent = video_latent.at[:, :, :k_lat].set(
                        tail.astype(video_latent.dtype))
                    if audio_cond:
                        audio_packed = audio_packed.at[:, :k_a].set(
                            audio_tail.astype(audio_packed.dtype))
                    fidx = np.concatenate([np.arange(k_lat), a_idx])
                    c_lat = jnp.concatenate([tail, a_lat], axis=2)
                video_latent = video_latent.at[:, :, a_idx].set(
                    a_lat.astype(video_latent.dtype))
                acm = self._conditioning_mask(shape, frame_idx=fidx)
                seg_k_a = k_a if (i > 0 and audio_cond) else 0
                seg_step = make_av_denoise_step(
                    self.av_transformer_params, self.tcfg, guidance,
                    shape, audio_frames, v_ctx, a_ctx, bias,
                    conditioning_mask=acm, conditioned_latent=c_lat,
                    image_cond_noise_scale=config.image_cond_noise_scale,
                    cond_frame_idx=fidx,
                    audio_cond_frames=seg_k_a,
                    audio_conditioned_latent=(
                        audio_tail if seg_k_a
                        and config.image_cond_noise_scale > 0 else None),
                    fps=config.fps, sdpa_impl=self.sdpa_impl,
                    remat=self.memory.remat_blocks,
                    pp_mesh=self.pp_mesh,
                    pp_microbatches=self.pp_microbatches)
            elif i == 0:
                if base_step is None:
                    warm.join("denoise_av")
                    base_step = make_av_denoise_step(
                        self.av_transformer_params, self.tcfg, guidance,
                        shape, audio_frames, v_ctx, a_ctx, bias,
                        fps=config.fps, sdpa_impl=self.sdpa_impl,
                        remat=self.memory.remat_blocks,
                        pp_mesh=self.pp_mesh,
                        pp_microbatches=self.pp_microbatches)
                seg_step = base_step
            else:
                video_latent = video_latent.at[:, :, :k_lat].set(
                    tail.astype(video_latent.dtype))
                if audio_cond:
                    audio_packed = audio_packed.at[:, :k_a].set(
                        audio_tail.astype(audio_packed.dtype))
                if ext_step is None:
                    warm.join("denoise_av_ext")
                    ext_step = make_av_denoise_step(
                        self.av_transformer_params, self.tcfg, guidance,
                        shape, audio_frames, v_ctx, a_ctx, bias,
                        conditioning_mask=cm, conditioned_latent=tail,
                        image_cond_noise_scale=(
                            config.image_cond_noise_scale),
                        cond_frames=k_lat,
                        audio_cond_frames=k_a,
                        audio_conditioned_latent=(
                            audio_tail if audio_cond
                            and config.image_cond_noise_scale > 0
                            else None),
                        fps=config.fps,
                        sdpa_impl=self.sdpa_impl,
                        remat=self.memory.remat_blocks,
                        pp_mesh=self.pp_mesh,
                        pp_microbatches=self.pp_microbatches)
                    seg_step = ext_step
                else:
                    # rebind on the SAME jitted program (injection-off
                    # traces drop the cond args; audio tail rides the
                    # second cond slot when injection is on)
                    _jit, _ropes = ext_step._jit, ext_step._ropes
                    cond_arg = ()
                    if config.image_cond_noise_scale > 0:
                        cond_arg = (tail,)
                        if audio_cond:
                            cond_arg = (tail, audio_tail)

                    def seg_step(vl, ap, s0, s1, k, _v=v_ctx, _a=a_ctx,
                                 _b=bias, _cl=cond_arg):
                        return _jit(self.av_transformer_params, _v, _a,
                                    _b, _ropes, vl, ap, s0, s1, k, *_cl)

            def on_step(s, n, sigma, _i=i):
                timings.denoise_steps.append(time.time() - on_step.t0)
                on_step.t0 = time.time()
                if on_progress:
                    on_progress(_i * n_steps + s, segments * n_steps,
                                sigma)

            on_step.t0 = time.time()
            video_latent, audio_packed = run_av_denoise_loop(
                seg_step, video_latent, audio_packed, sigmas, key=dkey,
                on_step=on_step)
            tail = video_latent[:, :, -k_lat:].astype(jnp.float32)
            if audio_cond:
                audio_tail = audio_packed[:, -k_a:].astype(jnp.float32)
            seg_latents.append((video_latent, audio_packed))
            key, dvkey = jax.random.split(key)
            dvkeys.append(dvkey)

        # --- phase 2: decode + stitch (video trims the overlap; audio
        # crossfades over the same window); step closures drop first —
        # they hold the AV transformer's device params
        base_step = ext_step = seg_step = None
        warm.join()
        parts = []
        waves = []
        for i, ((video_latent, audio_packed), dvkey) in enumerate(
                zip(seg_latents, dvkeys)):
            frames = self._decode_frames(video_latent, dvkey, timings)
            frames = np.asarray(frames[: config.num_frames])
            parts.append(frames if i == 0 else frames[cond_frames:])

            audio_latents = dit_av.unpack_audio_latents(
                audio_packed, channels=8, mel=mel_latent_bins)
            self._on_device("audio_vae_params", "vocoder_params")
            waveform = audio_vae_mod.decode_audio_jit(
                self.audio_vae_params, self.vocoder_params, audio_latents,
                self.audio_vae_config or audio_vae_mod.AudioVAEConfig(),
                self.vocoder_config or audio_vae_mod.VocoderConfig())
            if audio_gain != 1.0:
                waveform = jnp.clip(waveform * audio_gain, -1.0, 1.0)
            waves.append(np.asarray(waveform[0], np.float32))

        frames = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=0)
        audio = waves[0]
        for w in waves[1:]:
            s = w.shape[-1]
            k = int(round(s * cond_frames / config.num_frames))
            k = min(k, audio.shape[-1], s)
            if k > 0:
                ramp = np.linspace(0.0, 1.0, k, endpoint=False,
                                   dtype=np.float32)
                blended = audio[..., -k:] * (1.0 - ramp) + w[..., :k] * ramp
                audio = np.concatenate(
                    [audio[..., :-k], blended, w[..., k:]], axis=-1)
            else:
                audio = np.concatenate([audio, w], axis=-1)
        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=seed, audio=audio)

    def _encode_chain_anchors(self, anchors, segments: int, k_lat: int,
                              config: GenerationConfig):
        """Validate + encode a chain's per-segment keyframe anchors
        ({segment: [(pix_idx, src), ...]}; shared by the video and AV
        chains). Segment > 0 anchors must sit past the carried tail's
        k_lat latent frames."""
        anchor_enc = {}
        if anchors:
            for si, kfs in anchors.items():
                si = int(si)
                if not 0 <= si < segments:
                    raise InvalidConfigurationError(
                        f"anchor segment {si} outside [0, {segments})")
                a_lat, a_idx = self._encode_keyframe_sources(kfs, config)
                if si > 0 and int(a_idx[0]) < k_lat:
                    raise InvalidConfigurationError(
                        f"segment {si} anchor at latent frame "
                        f"{int(a_idx[0])} overlaps the carried tail "
                        f"(first {k_lat} latent frames)")
                anchor_enc[si] = (a_lat, a_idx)
        return anchor_enc

    def _encode_chain_prompts(self, seg_prompts, config, guidance, timings,
                              need_audio: bool = False):
        """Enhance + encode a chain's per-segment prompts.

        ONE unique prompt (the common case): exactly the unchained entry
        points' sequence — _maybe_enhance, then encode_prompt for the
        positive and (under CFG) the negative — so a uniform-prompt chain's
        segment 0 stays bit-for-bit identical to generate_video
        (tests/test_chain.py pins this).

        MULTIPLE unique prompts: the batched path — enhance_prompts (all
        prompts share one compiled batched-decode program) and ONE
        encode_prompts call covering every unique prompt AND the negative
        (one Gemma/connector staging cycle total). The per-prompt
        encode_prompt loop this replaces re-staged the 12.8 GB w8a8 tower
        once per unique prompt under phase_staging (advisor r4), exactly
        the pattern generate_videos already avoids.

        Returns ({prompt: {"video", "mask"[, "audio"]}}, neg_or_None).
        """
        unique = list(dict.fromkeys(seg_prompts))
        if len(unique) == 1:
            ep = self._maybe_enhance(unique[0], config, is_i2v=False,
                                     timings=timings)
            t0 = time.time()
            encoded = {unique[0]: self.encode_prompt(ep)}
            neg = None
            if guidance.use_cfg:
                neg = self.encode_prompt(
                    config.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
            timings.text_encoding = time.time() - t0
        else:
            enhanced = list(unique)
            if config.enhance_prompt:
                if self.gemma_params is None or self.tokenizer is None:
                    log.warning("enhance_prompt requested but the text "
                                "encoder is not loaded; using raw prompts")
                else:
                    from ltx_jax.pipeline.enhance import enhance_prompts

                    self._on_device("gemma_params")
                    t0 = time.time()
                    # max_batch=4 bounds the KV cache at ~1.6 GB — safe
                    # alongside every Gemma quant mode's resident weights
                    enhanced = enhance_prompts(
                        self.gemma_params, self.gcfg, self.tokenizer,
                        unique, spec_k=config.enhancement_spec_k,
                        max_batch=4, mesh=self.mesh)
                    timings.enhancement = time.time() - t0
            import gc

            gc.collect()  # free the enhancement KV/prefill buffers before
            # the tower pass (its hidden stacks are sized from the memory
            # left beside the weights, _encode_batch)
            t0 = time.time()
            to_encode = list(enhanced)
            if guidance.use_cfg:
                to_encode.append(config.negative_prompt
                                 or DEFAULT_NEGATIVE_PROMPT)
            # encode_prompts auto-caps the chunk rows by quant mode; the
            # chunks stream inside ONE staging cycle either way, so the
            # 12.8 GB re-upload saving is untouched
            rows = self.encode_prompts(to_encode)
            encoded = {p: rows[i] for i, p in enumerate(unique)}
            neg = rows[len(unique)] if guidance.use_cfg else None
            timings.text_encoding = time.time() - t0
        if need_audio:
            rows_to_check = list(encoded.values())
            if neg is not None:
                rows_to_check.append(neg)  # the CFG negative row too
            for out in rows_to_check:
                if "audio" not in out:
                    raise TextEncodingFailedError(
                        "text encoder lacks the audio connector")
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        return encoded, neg

    def _denoise(self, latent, sigmas, shape, guidance, context, bias,
                 conditioning_mask, cond_noise_scale, fps, key, timings,
                 on_progress, conditioned_latent=None, cond_frames=1,
                 cond_frame_idx=None):
        """Shared compiled-step denoise (reference: LTXPipeline.swift:2191)."""
        self._on_device("transformer_params")
        step_fn = make_denoise_step(
            self.transformer_params, self.tcfg, guidance, shape,
            context, bias,
            conditioning_mask=conditioning_mask,
            conditioned_latent=conditioned_latent,
            image_cond_noise_scale=cond_noise_scale,
            cond_frames=cond_frames,
            cond_frame_idx=cond_frame_idx,
            fps=fps,
            sdpa_impl=self.sdpa_impl,
            remat=self.memory.remat_blocks,
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )

        def on_step(i, n, sigma):
            timings.denoise_steps.append(time.time() - on_step.t0)
            on_step.t0 = time.time()
            if on_progress:
                on_progress(i, n, sigma)

        on_step.t0 = time.time()
        return run_denoise_loop(step_fn, latent, sigmas, key=key,
                                on_step=on_step)

    def _sigmas(self, config: GenerationConfig, shape) -> np.ndarray:
        """Sigma schedule for a single-stage run; honors a Turbo-LoRA
        sigma override (config.sigmas_override,
        lora.fuse.LoRASchedulerOverrides) with a terminal 0.0 appended."""
        if config.sigmas_override is not None:
            s = np.asarray(config.sigmas_override, np.float32)
            if s[-1] != 0.0:
                s = np.concatenate([s, [0.0]]).astype(np.float32)
            return s
        return schedule.get_sigmas(
            config.num_steps, distilled=self.is_distilled,
            token_count=shape.token_count,
        )

    def _conditioning_mask(self, shape, frames: int = 1,
                           frame_idx=None) -> np.ndarray:
        """(1, T) mask, 1 on the conditioned latent frames' tokens
        (patchify is row-major (F, H, W): frame f's tokens are the
        contiguous block [f*h*w, (f+1)*h*w)). frames: the first `frames`
        frames (I2V/extension); frame_idx: arbitrary positions
        (keyframes)."""
        tokens_per_frame = shape.height * shape.width
        cm = np.zeros((1, shape.token_count), np.float32)
        if frame_idx is not None:
            for f in np.asarray(frame_idx).reshape(-1):
                cm[:, f * tokens_per_frame: (f + 1) * tokens_per_frame] = 1.0
        else:
            cm[:, : frames * tokens_per_frame] = 1.0
        return cm

    def generate_video_two_stage(
        self,
        prompt: str,
        config: GenerationConfig,
        on_progress=None,
        image_latent=None,
        full_res_image_latent=None,
    ) -> VideoGenerationResult:
        """Half-res denoise -> 2x latent upscale (+AdaIN) -> 3-step refine
        (reference: LTXPipeline.swift:2420-2740).

        I2V: set config.image_path and the image is encoded IN-pipeline at
        half resolution for stage 1 and re-encoded at full resolution for
        stage 2 (reference: LTXPipeline.swift:2456-2461, 2651-2663). The
        image_latent / full_res_image_latent arguments are parity-injection
        hooks that bypass the internal encodes when given.
        """
        from ltx_jax.models.upscaler import (UpscalerConfig,
            upsample_latents_jit)
        from ltx_jax.ops.latents import adain_filter_latent

        config.validate()
        if self.upscaler_params is None:
            raise ModelNotLoadedError("spatial upscaler")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        key = jax.random.key(seed)

        guidance = GuidanceSpec.from_config(config)

        # --- I2V: encode at HALF resolution for stage 1
        is_i2v = (config.image_path is not None or image_latent is not None
                  or full_res_image_latent is not None)
        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(
                config.image_path, config.width // 2, config.height // 2)

        # --- prompt enhancement (all paths enhance, like the reference:
        # LTXPipeline.swift:2466-2470), overlapped with BOTH stages' step
        # compiles + the upscaler + the VAE decoder (round 5 — r4 warmed
        # generate_video only; the flagship-class serial compile bill on
        # this path is ~100 s)
        g2 = dataclasses.replace(guidance, use_cfg=False)
        warm = _WarmCompiles()
        if self._should_warm(config):
            cf = 1 if is_i2v else None
            plan = [
                ("denoise_s1", lambda: self._warm_lowering(
                    config, guidance, width=config.width // 2,
                    height=config.height // 2, cond_frames=cf)),
                ("upscaler",
                 lambda: self._warm_upscaler_lowering(config)),
                ("denoise_s2", lambda: self._warm_lowering(
                    config, g2, cond_frames=cf)),
            ]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)
        prompt = self._maybe_enhance(prompt, config, is_i2v=is_i2v,
                                     timings=timings)

        # --- text encoding
        t0 = time.time()
        pos = self.encode_prompt(prompt)
        neg = None
        if guidance.use_cfg:
            neg = self.encode_prompt(
                config.negative_prompt or DEFAULT_NEGATIVE_PROMPT
            )
        timings.text_encoding = time.time() - t0
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        context, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None,
        )

        # === STAGE 1: half resolution ===
        warm.join("denoise_s1")  # later compiles overlap stage 1
        s1_shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height // 2, config.width // 2,
            channels=self.tcfg.in_channels,
        )
        if config.num_steps <= 8 and config.cfg_scale <= 1.0:
            s1_sigmas = schedule.get_sigmas(
                config.num_steps, distilled=True,
                token_count=s1_shape.token_count)
        else:
            s1_sigmas = schedule.get_sigmas(
                config.num_steps, distilled=False,
                token_count=s1_shape.token_count)

        key, nkey, dkey = jax.random.split(key, 3)
        latent = generate_noise(nkey, s1_shape) * float(s1_sigmas[0])
        s1_cond_mask = None
        if image_latent is not None:
            latent = latent.at[:, :, :1].set(image_latent.astype(latent.dtype))
            s1_cond_mask = self._conditioning_mask(s1_shape)

        latent = self._denoise(
            latent, s1_sigmas, s1_shape, guidance, context, bias,
            s1_cond_mask, config.image_cond_noise_scale, config.fps, dkey,
            timings, on_progress, conditioned_latent=image_latent,
        )
        stage1_output = latent

        # === UPSCALE 2x + AdaIN toward stage-1 stats ===
        warm.join("upscaler")
        self._on_device("upscaler_params")
        mean = self.vae_decoder_params["mean_of_means"]
        std = self.vae_decoder_params["std_of_means"]
        ucfg = self.upscaler_config or UpscalerConfig(
            in_channels=self.tcfg.in_channels)
        latent = upsample_latents_jit(self.upscaler_params, latent, mean,
                                      std, ucfg)
        latent = adain_filter_latent(latent, stage1_output)

        # === STAGE 2: full resolution, 3 steps, never CFG ===
        s2_shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels,
        )
        s2_sigmas = schedule.STAGE_2_SIGMAS
        key, nkey2, dkey2 = jax.random.split(key, 3)
        noise = generate_noise(nkey2, s2_shape)
        noise_scale = float(s2_sigmas[0])  # 0.909375
        latent = noise_scale * noise + (1.0 - noise_scale) * latent

        # I2V stage 2: re-encode the image at FULL resolution and re-apply
        # frame-0 conditioning (reference: LTXPipeline.swift:2651-2663)
        if full_res_image_latent is None and config.image_path is not None:
            full_res_image_latent = self._encode_image_at(
                config.image_path, config.width, config.height)
        s2_cond_mask = None
        if full_res_image_latent is not None:
            latent = latent.at[:, :, :1].set(
                full_res_image_latent.astype(latent.dtype))
            s2_cond_mask = self._conditioning_mask(s2_shape)

        warm.join("denoise_s2")
        context2, bias2 = build_guidance_context(
            g2, pos["video"], pos["mask"])
        latent = self._denoise(
            latent, s2_sigmas, s2_shape, g2, context2, bias2,
            s2_cond_mask, config.image_cond_noise_scale, config.fps, dkey2,
            timings, on_progress, conditioned_latent=full_res_image_latent,
        )

        # --- decode
        warm.join()
        key, vkey = jax.random.split(key)
        frames = self._decode_frames(latent, vkey, timings)
        frames = frames[: config.num_frames]
        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings, seed=seed)

    def generate_video_with_audio(
        self,
        prompt: str,
        config: GenerationConfig,
        on_progress=None,
        image_latent=None,
        audio_gain: float = 1.0,
        video_path: Optional[str] = None,
        video_frames=None,
        cond_frames: int = 9,
    ) -> VideoGenerationResult:
        """Joint video+audio generation via the dual AV transformer
        (reference: LTXPipeline.swift:1108-1450). Audio duration matches the
        video (num_frames / fps); audio latent frames = round(dur * 25).

        video_path / video_frames: EXTEND a clip with a soundtrack — the
        AV twin of generate_video_extension (no reference analog):
        condition on the input's last cond_frames pixel frames (8k+1,
        encoded to latent frames that get per-token timestep 0, per-step
        clean-source injection, and carry through Euler — the AV denoise
        step's cond_frames path). Mutually exclusive with image
        conditioning (image_latent / config.image_path); cond_frames=1
        with a one-frame clip is the I2V-with-audio path.
        """
        from ltx_jax.models import audio_vae as audio_vae_mod
        from ltx_jax.models import dit_av
        from ltx_jax.pipeline.denoise import (
            make_av_denoise_step,
            run_av_denoise_loop,
        )

        config.validate()
        if self.av_transformer_params is None:
            raise ModelNotLoadedError("AV transformer")
        if self.audio_vae_params is None:
            raise ModelNotLoadedError("audio VAE")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        key = jax.random.key(seed)

        guidance = dataclasses.replace(
            GuidanceSpec.from_config(config), stg_scale=0.0
        )

        # --- I2V: encode the conditioning image in-pipeline
        is_i2v = image_latent is not None or config.image_path is not None
        ext = video_path is not None or video_frames is not None
        if ext and is_i2v:
            raise InvalidConfigurationError(
                "clip-tail conditioning (video_path/video_frames) is "
                "mutually exclusive with image conditioning")
        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(
                config.image_path, config.width, config.height)

        # --- extension: encode the clip tail (the AV twin of
        # generate_video_extension's conditioning)
        cond_latent = None
        k_lat = 1
        if ext:
            if cond_frames < 1 or (cond_frames - 1) % 8 != 0:
                raise InvalidConfigurationError(
                    f"cond_frames must be 8k+1, got {cond_frames}")
            if cond_frames >= config.num_frames:
                raise InvalidConfigurationError(
                    f"cond_frames {cond_frames} must be < num_frames "
                    f"{config.num_frames}")
            if (video_path is None) == (video_frames is None):
                raise InvalidConfigurationError(
                    "pass exactly one of video_path / video_frames")
            if video_frames is None:
                from ltx_jax.io.video import load_video

                video_frames = load_video(video_path, config.width,
                                          config.height, cond_frames,
                                          sample="tail")
            video_frames = jnp.asarray(video_frames)
            if video_frames.shape != (1, 3, cond_frames, config.height,
                                      config.width):
                raise InvalidConfigurationError(
                    f"video_frames {video_frames.shape} != (1, 3, "
                    f"{cond_frames}, {config.height}, {config.width})")
            cond_latent = self.encode_video(video_frames) \
                .astype(jnp.float32)
            k_lat = cond_latent.shape[2]

        # --- prompt enhancement (reference: LTXPipeline.swift:1525-1531),
        # overlapped with the AV step + decoder compiles (round 5)
        warm = _WarmCompiles()
        if self._should_warm(config):
            cf = 1 if is_i2v else (k_lat if ext else None)
            plan = [("denoise_av", lambda: self._warm_av_lowering(
                config, guidance, cond_frames=cf))]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)
        prompt = self._maybe_enhance(prompt, config, is_i2v=is_i2v,
                                     timings=timings)

        # --- text encoding (video + audio connectors)
        t0 = time.time()
        pos = self.encode_prompt(prompt)
        if "audio" not in pos:
            raise TextEncodingFailedError(
                "text encoder lacks the audio connector")
        neg = None
        if guidance.use_cfg:
            neg = self.encode_prompt(
                config.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
        timings.text_encoding = time.time() - t0
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()

        v_ctx, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None)
        a_ctx, _ = build_guidance_context(
            guidance, pos["audio"], pos["mask"],
            neg["audio"] if neg else None, neg["mask"] if neg else None)

        # --- latents: video noise first, then audio (reference RNG order)
        shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels)
        duration = config.num_frames / config.fps
        audio_frames = dit_av.audio_frame_count(duration)

        sigmas = self._sigmas(config, shape)

        key, vkey, akey, dkey = jax.random.split(key, 4)
        video_latent = generate_noise(vkey, shape) * float(sigmas[0])
        mel_latent_bins = self.tcfg.audio_in_channels // 8
        audio_raw = jax.random.normal(
            akey, (1, 8, audio_frames, mel_latent_bins), jnp.float32)
        audio_packed = dit_av.pack_audio_latents(audio_raw) * float(sigmas[0])

        conditioning_mask = None
        if image_latent is not None:
            video_latent = video_latent.at[:, :, :1].set(
                image_latent.astype(video_latent.dtype))
            conditioning_mask = self._conditioning_mask(shape)
        elif cond_latent is not None:
            video_latent = video_latent.at[:, :, :k_lat].set(
                cond_latent.astype(video_latent.dtype))
            conditioning_mask = self._conditioning_mask(shape,
                                                        frames=k_lat)

        warm.join("denoise_av")
        self._on_device("av_transformer_params")
        step_fn = make_av_denoise_step(
            self.av_transformer_params, self.tcfg, guidance, shape,
            audio_frames, v_ctx, a_ctx, bias,
            conditioning_mask=conditioning_mask,
            conditioned_latent=(image_latent if image_latent is not None
                                else cond_latent),
            image_cond_noise_scale=config.image_cond_noise_scale,
            cond_frames=(1 if image_latent is not None else k_lat),
            fps=config.fps, sdpa_impl=self.sdpa_impl,
            remat=self.memory.remat_blocks,
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )

        def on_step(i, n, sigma):
            timings.denoise_steps.append(time.time() - on_step.t0)
            on_step.t0 = time.time()
            if on_progress:
                on_progress(i, n, sigma)

        on_step.t0 = time.time()
        video_latent, audio_packed = run_av_denoise_loop(
            step_fn, video_latent, audio_packed, sigmas, key=dkey,
            on_step=on_step)
        del step_fn  # closure holds the AV params' HBM — free pre-decode

        # --- decode video
        warm.join()
        key, dvkey = jax.random.split(key)
        frames = self._decode_frames(video_latent, dvkey, timings)
        frames = frames[: config.num_frames]

        # --- decode audio
        audio_latents = dit_av.unpack_audio_latents(
            audio_packed, channels=8, mel=mel_latent_bins)
        self._on_device("audio_vae_params", "vocoder_params")
        waveform = audio_vae_mod.decode_audio_jit(
            self.audio_vae_params, self.vocoder_params, audio_latents,
            self.audio_vae_config or audio_vae_mod.AudioVAEConfig(),
            self.vocoder_config or audio_vae_mod.VocoderConfig())
        if audio_gain != 1.0:
            waveform = jnp.clip(waveform * audio_gain, -1.0, 1.0)

        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=seed, audio=waveform[0])

    def generate_video_with_audio_two_stage(
        self,
        prompt: str,
        config: GenerationConfig,
        on_progress=None,
        audio_gain: float = 1.0,
    ) -> VideoGenerationResult:
        """Two-stage joint video+audio: half-res dual denoise -> 2x video
        upscale (+AdaIN) -> 3-step full-res dual refine -> decode both.

        Reference: LTXPipeline.swift:1485-1860 (the flagship 241-frame
        1024x640 BASELINE config runs through this path). Reference
        semantics kept: stage 1 always uses the DISTILLED schedule; no CFG
        on either stage (one transformer pass per step); stage-2 video
        steps with PLAIN Euler x += dt*v (not the scheduler round-trip);
        audio is re-noised alongside video between stages but is never
        upscaled; I2V re-encodes the image per stage (half then full res).
        """
        from ltx_jax.models import audio_vae as audio_vae_mod
        from ltx_jax.models import dit_av
        from ltx_jax.models.upscaler import (UpscalerConfig,
            upsample_latents_jit)
        from ltx_jax.ops.latents import adain_filter_latent
        from ltx_jax.pipeline.denoise import (
            make_av_denoise_step,
            run_av_denoise_loop,
        )

        config.validate()
        if self.av_transformer_params is None:
            raise ModelNotLoadedError("AV transformer")
        if self.audio_vae_params is None:
            raise ModelNotLoadedError("audio VAE")
        if self.upscaler_params is None:
            raise ModelNotLoadedError("spatial upscaler")
        total_start = time.time()
        timings = GenerationTimings()
        seed = config.seed if config.seed is not None else int(time.time())
        key = jax.random.key(seed)

        # no CFG / STG on this path (reference runs one pass per step)
        guidance = dataclasses.replace(
            GuidanceSpec.from_config(config, use_cfg=False), stg_scale=0.0)

        # --- I2V: encode at HALF resolution for stage 1
        # (reference: LTXPipeline.swift:1516-1521)
        is_i2v = config.image_path is not None
        half_res_image_latent = None
        if is_i2v:
            half_res_image_latent = self._encode_image_at(
                config.image_path, config.width // 2, config.height // 2)

        # --- prompt enhancement (reference: LTXPipeline.swift:1525-1531),
        # overlapped with BOTH AV stage compiles + the upscaler + the VAE
        # decoder (round 5 — the flagship 241f@1024x640 run previously
        # paid ~150 s of these compiles serially after enhancement)
        warm = _WarmCompiles()
        if self._should_warm(config):
            cf = 1 if is_i2v else None
            plan = [
                ("denoise_s1", lambda: self._warm_av_lowering(
                    config, guidance, width=config.width // 2,
                    height=config.height // 2, cond_frames=cf)),
                ("upscaler",
                 lambda: self._warm_upscaler_lowering(config)),
                ("denoise_s2", lambda: self._warm_av_lowering(
                    config, guidance, cond_frames=cf,
                    video_euler="plain")),
            ]
            if self._vae_warm_applies(config):
                plan.append(("vae",
                             lambda: self._warm_vae_lowering(config)))
            warm = self._start_warm_compile(config, guidance, timings, plan)
        prompt = self._maybe_enhance(prompt, config, is_i2v=is_i2v,
                                     timings=timings)

        # --- text encoding (video + audio connectors)
        t0 = time.time()
        pos = self.encode_prompt(prompt)
        if "audio" not in pos:
            raise TextEncodingFailedError(
                "text encoder lacks the audio connector")
        timings.text_encoding = time.time() - t0
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()

        v_ctx, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"])
        a_ctx, _ = build_guidance_context(
            guidance, pos["audio"], pos["mask"])

        # --- shapes + noise (video noise drawn before audio, reference
        # RNG order: LTXPipeline.swift:1575-1586)
        s1_shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height // 2, config.width // 2,
            channels=self.tcfg.in_channels)
        duration = config.num_frames / config.fps
        audio_frames = dit_av.audio_frame_count(duration)

        # stage 1 is ALWAYS the distilled schedule
        # (reference: LTXPipeline.swift:1589-1595)
        s1_sigmas = schedule.get_sigmas(
            config.num_steps, distilled=True, token_count=s1_shape.token_count)

        key, vkey, akey, dkey = jax.random.split(key, 4)
        video_latent = generate_noise(vkey, s1_shape) * float(s1_sigmas[0])
        mel_latent_bins = self.tcfg.audio_in_channels // 8
        audio_raw = jax.random.normal(
            akey, (1, 8, audio_frames, mel_latent_bins), jnp.float32)
        audio_packed = dit_av.pack_audio_latents(audio_raw) * float(s1_sigmas[0])

        s1_cond_mask = None
        if half_res_image_latent is not None:
            video_latent = video_latent.at[:, :, :1].set(
                half_res_image_latent.astype(video_latent.dtype))
            s1_cond_mask = self._conditioning_mask(s1_shape)

        def on_step(i, n, sigma):
            timings.denoise_steps.append(time.time() - on_step.t0)
            on_step.t0 = time.time()
            if on_progress:
                on_progress(i, n, sigma)

        # === STAGE 1: half-resolution dual denoise ===
        warm.join("denoise_s1")  # later compiles overlap stage 1
        self._on_device("av_transformer_params")
        step_fn = make_av_denoise_step(
            self.av_transformer_params, self.tcfg, guidance, s1_shape,
            audio_frames, v_ctx, a_ctx, bias,
            conditioning_mask=s1_cond_mask,
            conditioned_latent=half_res_image_latent,
            image_cond_noise_scale=config.image_cond_noise_scale,
            fps=config.fps, sdpa_impl=self.sdpa_impl,
            remat=self.memory.remat_blocks,
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )
        on_step.t0 = time.time()
        video_latent, audio_packed = run_av_denoise_loop(
            step_fn, video_latent, audio_packed, s1_sigmas, key=dkey,
            on_step=on_step)
        stage1_output = video_latent

        # === UPSCALE video 2x (audio unchanged) + AdaIN toward stage 1 ===
        # (reference: LTXPipeline.swift:1692-1721)
        warm.join("upscaler")
        self._on_device("upscaler_params")
        mean = self.vae_decoder_params["mean_of_means"]
        std = self.vae_decoder_params["std_of_means"]
        ucfg = self.upscaler_config or UpscalerConfig(
            in_channels=self.tcfg.in_channels)
        video_latent = upsample_latents_jit(
            self.upscaler_params, video_latent, mean, std, ucfg)
        video_latent = adain_filter_latent(video_latent, stage1_output)

        # === STAGE 2: full-resolution dual refine ===
        s2_shape = VideoLatentShape.from_pixels(
            1, config.num_frames, config.height, config.width,
            channels=self.tcfg.in_channels)
        s2_sigmas = schedule.STAGE_2_SIGMAS
        noise_scale = float(s2_sigmas[0])  # 0.909375

        # re-noise video then audio (reference: LTXPipeline.swift:1737-1744)
        key, nkey2, akey2, dkey2 = jax.random.split(key, 4)
        video_noise = generate_noise(nkey2, s2_shape)
        video_latent = (noise_scale * video_noise
                        + (1.0 - noise_scale) * video_latent)
        audio_renoise = jax.random.normal(
            akey2, audio_packed.shape, jnp.float32)
        audio_packed = (noise_scale * audio_renoise
                        + (1.0 - noise_scale) * audio_packed.astype(jnp.float32))

        # I2V stage 2: re-encode at FULL resolution
        # (reference: LTXPipeline.swift:1747-1762)
        s2_cond_mask = None
        full_res_image_latent = None
        if is_i2v:
            full_res_image_latent = self._encode_image_at(
                config.image_path, config.width, config.height)
            video_latent = video_latent.at[:, :, :1].set(
                full_res_image_latent.astype(video_latent.dtype))
            s2_cond_mask = self._conditioning_mask(s2_shape)

        warm.join("denoise_s2")
        step_fn2 = make_av_denoise_step(
            self.av_transformer_params, self.tcfg, guidance, s2_shape,
            audio_frames, v_ctx, a_ctx, bias,
            conditioning_mask=s2_cond_mask,
            conditioned_latent=full_res_image_latent,
            image_cond_noise_scale=config.image_cond_noise_scale,
            fps=config.fps, sdpa_impl=self.sdpa_impl,
            remat=self.memory.remat_blocks,
            video_euler="plain",  # reference: LTXPipeline.swift:1800-1816
            pp_mesh=self.pp_mesh, pp_microbatches=self.pp_microbatches,
        )
        on_step.t0 = time.time()
        video_latent, audio_packed = run_av_denoise_loop(
            step_fn2, video_latent, audio_packed, s2_sigmas, key=dkey2,
            on_step=on_step)
        # free the AV params' HBM before the conv stack: BOTH step
        # closures hold the device tree (_release_to_host only swaps the
        # attribute; measured RESOURCE_EXHAUSTED at 97f@768x512 int4)
        del step_fn, step_fn2

        # --- decode video
        warm.join()
        key, dvkey = jax.random.split(key)
        frames = self._decode_frames(video_latent, dvkey, timings)
        frames = frames[: config.num_frames]

        # --- decode audio
        audio_latents = dit_av.unpack_audio_latents(
            audio_packed, channels=8, mel=mel_latent_bins)
        self._on_device("audio_vae_params", "vocoder_params")
        waveform = audio_vae_mod.decode_audio_jit(
            self.audio_vae_params, self.vocoder_params, audio_latents,
            self.audio_vae_config or audio_vae_mod.AudioVAEConfig(),
            self.vocoder_config or audio_vae_mod.VocoderConfig())
        if audio_gain != 1.0:
            waveform = jnp.clip(waveform * audio_gain, -1.0, 1.0)

        timings.total = time.time() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=seed, audio=waveform[0])

    def encode_image(self, pixels):
        """(1, 3, 1, H, W) in [-1, 1] -> normalized latent for I2V
        conditioning (VAE stats normalization,
        reference: LTXPipeline.swift:1902-1932)."""
        if self.vae_encoder_params is None:
            raise ModelNotLoadedError("VAE encoder")
        self._on_device("vae_encoder_params", "vae_decoder_params")
        latent = vae.encoder_forward_jit(self.vae_encoder_params, pixels,
                                         self.vcfg)
        mean = self.vae_decoder_params["mean_of_means"].astype(jnp.float32)
        std = self.vae_decoder_params["std_of_means"].astype(jnp.float32)
        return ((latent.astype(jnp.float32)
                 - mean.reshape(1, -1, 1, 1, 1)) / std.reshape(1, -1, 1, 1, 1))
