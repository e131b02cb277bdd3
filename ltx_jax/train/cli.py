"""LoRA fine-tune driver: latent shards -> adapter safetensors.

The training loop behind both `ltx-video train` (io/cli.py) and
`scripts/train_lora.py`. Closes the loop around ltx_jax.train on one chip
(multi-chip: shard params with parallel/sharding before init_train_state —
the dp+tp step is dryrun-validated):

    dataset (train/data.py shards) -> QLoRA/LoRA flow-matching steps
    -> periodic bit-exact checkpoints (+ dataset cursor) -> adapter
    exported in the ComfyUI LoRA schema (consumable by fuse_lora_file /
    --lora at inference).

Weights: --weights UNIFIED.safetensors loads the real video DiT via the
same key maps the pipeline uses; --random-init {tiny,full} smoke-runs
without checkpoints (zero-egress environments). Guide: docs/TRAINING.md.
"""

import os
import sys
import time


def add_train_arguments(ap) -> None:
    """Register the trainer's flags on an argparse parser/subparser."""
    ap.add_argument("--data", required=True, help="shard directory")
    ap.add_argument("--out", required=True, help="adapter .safetensors path")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat-segments", type=int, default=0,
                    help="segmented (sqrt) remat over the 48-block scan: "
                         "peak residuals S + 48/S activations instead of "
                         "48 (one-chip long-sequence/bigger-batch headroom)")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA decay (0 = off); exports the EMA adapter")
    ap.add_argument("--quant", choices=("none", "w8a8", "int4"),
                    default="w8a8", help="frozen-base quantization")
    ap.add_argument("--weights", default=None,
                    help="unified checkpoint (.safetensors)")
    ap.add_argument("--random-init", choices=("tiny", "full"), default=None,
                    help="random base instead of --weights (smoke runs)")
    ap.add_argument("--compute", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--ckpt", default=None, help="checkpoint .npz path")
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="dp+tp train over a device mesh (params via the "
                         "inference partition specs, batch on the data "
                         "axis); --batch is PER PROCESS")
    ap.add_argument("--sdpa", choices=("auto", "xla", "pallas", "ring"),
                    default="auto",
                    help="attention backend for the loss: auto = cuDNN "
                         "flash attention on a GPU for long sequences, "
                         "else xla; pallas = this repository's FA-2 "
                         "fwd+bwd kernels; ring = SEQUENCE-PARALLEL over "
                         "the mesh model axis (differentiable ring "
                         "attention; requires --mesh)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-host jax.distributed coordinator")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)


def _build_base_params(args, cfg, jnp):
    if args.random_init:
        return _dit_init_random(args, cfg, jnp)
    if not args.weights:
        raise SystemExit("pass --weights UNIFIED.safetensors or "
                         "--random-init {tiny,full}")
    from ltx_jax.weights import keymaps
    from ltx_jax.weights.download import load_safetensors

    tensors = load_safetensors(args.weights)
    tr_raw, _, _ = keymaps.split_unified(tensors)
    del tensors
    return keymaps.load_transformer_params(tr_raw, cfg.num_layers)


def _dit_init_random(args, cfg, jnp):
    import jax

    from ltx_jax.models import dit

    dtype = jnp.float32 if args.compute == "f32" else jnp.bfloat16
    return dit.init_params(jax.random.key(args.seed), cfg, dtype)


def run(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ltx_jax.core.config import TransformerConfig
    from ltx_jax.kernels.quantization import quantize_transformer_params
    from ltx_jax.ops import rope as rope_ops
    from ltx_jax.train import (
        TrainConfig, add_lora, ema_init, make_ema_update, make_train_step,
        save_lora,
    )
    from ltx_jax.train.checkpoint import (
        load_train_checkpoint, save_train_checkpoint,
    )
    from ltx_jax.train.data import LatentShardDataset, prefetch_to_device
    from ltx_jax.train.step import combine_params, init_train_state

    def log(msg):
        print(f"[train_lora] {msg}", file=sys.stderr, flush=True)

    mesh = None
    if getattr(args, "coordinator", None) or getattr(args, "num_processes",
                                                     None):
        from ltx_jax.parallel.runtime import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    if getattr(args, "mesh", None):
        from ltx_jax.parallel.sharding import make_mesh

        d, m = (int(x) for x in args.mesh.split(","))
        mesh = make_mesh(data=d, model=m)
        log(f"mesh: ({d},{m}) over {d * m} devices, "
            f"{jax.process_count()} process(es)")

    cfg = TransformerConfig()
    if args.random_init == "tiny":
        cfg = cfg.tiny()

    # multi-host: decorrelate each process's row sampling (the global batch
    # = per-process --batch x process_count, stitched in prefetch_to_device)
    ds_seed = args.seed + jax.process_index() * 100003
    ds = LatentShardDataset(args.data, args.batch, seed=ds_seed)
    f, h, w = ds.grid
    if ds.batch_size * (f * h * w) * cfg.in_channels == 0:
        raise SystemExit("empty dataset")
    log(f"dataset: {ds.num_rows} rows, grid {ds.grid}, batch {args.batch}")

    params = _build_base_params(args, cfg, jnp)
    if args.quant != "none" and not args.random_init == "tiny":
        bits = 8 if args.quant == "w8a8" else 4
        params = quantize_transformer_params(
            params, bits=bits, w8a8=(args.quant == "w8a8"))
        log(f"frozen base quantized: {args.quant}")
    params = add_lora(params, jax.random.key(args.seed + 1),
                      rank=args.rank, alpha=args.alpha)

    cos, sin = rope_ops.video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
    rope = (jnp.asarray(cos), jnp.asarray(sin))

    sdpa = getattr(args, "sdpa", "xla")
    if sdpa == "ring":
        if mesh is None:
            raise SystemExit("--sdpa ring needs --mesh (the token axis "
                             "shards over the mesh model axis)")
        from ltx_jax.ops.attention import set_sequence_parallel

        set_sequence_parallel(mesh)
        log("sequence-parallel attention: token axis over the model axis")
    tc = TrainConfig(
        learning_rate=args.lr, warmup_steps=args.warmup, lora_only=True,
        accum_steps=args.accum,
        remat_segments=getattr(args, "remat_segments", 0),
        sdpa_impl=sdpa,
        compute_dtype=jnp.float32 if args.compute == "f32" else jnp.bfloat16,
    )
    batch_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from ltx_jax.parallel.sharding import dit_param_specs

        specs = dit_param_specs(params)
        params = jax.tree.map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
            params, specs)
        batch_sharding = NamedSharding(mesh, PartitionSpec("data"))
        log("params sharded (tp over heads/FFN; LoRA leaves outer dims)")

    trainable, frozen, opt_state = init_train_state(params, tc)
    step = make_train_step(cfg, tc, donate=True)
    ema = ema_init(trainable) if args.ema > 0 else None
    ema_upd = make_ema_update(args.ema) if args.ema > 0 else None

    # dataset cursor is per process (multi-host: each process samples its
    # own decorrelated rows, so each saves/restores its own RNG state)
    dstate_path = (args.ckpt + f".data.{jax.process_index()}.npy"
                   if args.ckpt else None)

    start = 0
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        trainable, opt_state, start = load_train_checkpoint(
            args.ckpt, trainable, opt_state)
        if mesh is not None:
            # load_train_checkpoint rebuilds host/replicated arrays; re-apply
            # the train-state shardings so the first post-resume step doesn't
            # run (and hold HBM) with replicated placement. The opt_state
            # sharding template comes from tx.init on the re-sharded
            # trainable (mu/nu inherit the leaf shardings; adapter-sized, so
            # the extra init is cheap).
            from jax.sharding import NamedSharding

            from ltx_jax.parallel.sharding import dit_param_specs
            from ltx_jax.train.step import make_optimizer

            t_specs = dit_param_specs(trainable)
            trainable = jax.tree.map(
                lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
                trainable, t_specs)
            fresh_opt = make_optimizer(tc).init(trainable)
            opt_state = jax.tree.map(
                lambda old, new: jax.device_put(
                    np.asarray(old), new.sharding)
                if isinstance(new, jax.Array) and new.ndim > 0 else old,
                opt_state, fresh_opt)
        # legacy single-file cursor (pre-round-4 checkpoints) as fallback
        legacy = args.ckpt + ".data.npy"
        cursor = dstate_path if os.path.exists(dstate_path) else legacy
        if os.path.exists(cursor):
            ds.restore(np.load(cursor, allow_pickle=True).item())
        log(f"resumed from {args.ckpt} at step {start}")

    key = jax.random.key(args.seed + 2)
    t0 = time.time()
    it = prefetch_to_device(iter(ds), depth=2, sharding=batch_sharding)
    for i in range(start, args.steps):
        tokens, context, bias = next(it)
        key, sub = jax.random.split(key)
        trainable, opt_state, aux = step(
            trainable, frozen, opt_state, tokens, context, rope, sub,
            context_bias=bias)
        if ema is not None:
            ema = ema_upd(ema, trainable)
        if (i + 1) % args.log_every == 0 or i == start:
            loss = float(aux["loss"])  # readback = sync
            if not np.isfinite(loss):
                raise SystemExit(f"non-finite loss at step {i + 1}")
            log(f"step {i + 1}/{args.steps} loss={loss:.4f} "
                f"gnorm={float(aux['grad_norm']):.3f} "
                f"({(time.time() - t0) / max(1, i + 1 - start):.2f} s/step)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            # train state: process 0 only (all processes hold identical
            # gathered values; concurrent writers would race on shared
            # storage). Dataset cursor: per process (decorrelated sampling).
            host_t, host_o = _host_tree(trainable), _host_tree(opt_state)
            if jax.process_index() == 0:
                save_train_checkpoint(args.ckpt, host_t, host_o, i + 1)
            _atomic_np_save(dstate_path, ds.state())
            log(f"checkpoint @ step {i + 1} -> {args.ckpt}")

    export_tree = combine_params(
        _host_tree(ema if ema is not None else trainable), frozen)
    if jax.process_index() == 0:
        n = save_lora(export_tree, args.out)
        log(f"exported {'EMA ' if ema is not None else ''}adapter: "
            f"{n} tensors -> {args.out}")
    print(f"TRAIN LORA OK: {args.steps - start} steps, adapter {args.out}")
    return 0


def _atomic_np_save(path, obj):
    """np.save via pid-unique tmp + os.replace (np.save appends .npy to a
    bare prefix, so write the tmp with an explicit .npy suffix)."""
    import numpy as np

    tmp = f"{path}.tmp.{os.getpid()}.npy"
    try:
        np.save(tmp, obj, allow_pickle=True)  # noqa: allow rng state
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _host_tree(tree):
    """Sharded train state -> host numpy (every leaf fully addressable).

    Single-process (incl. single-host meshes) this is the identity — the
    savers call np.asarray themselves. Multi-host it all-gathers each leaf
    so process 0 can write the checkpoint/adapter.
    """
    import jax

    if jax.process_count() == 1:
        return tree
    from jax.experimental import multihost_utils

    return jax.tree.map(
        lambda x: multihost_utils.process_allgather(x, tiled=True)
        if isinstance(x, jax.Array) else x, tree)
