"""Training subsystem: flow-matching loss, LoRA adapters, STE gradients,
jitted train step (full + LoRA-only/QLoRA), dp+tp sharded step.

The reference is inference-only (SURVEY.md) — this is beyond-parity
capability; the tests pin that training reuses the inference machinery
exactly (same dit_forward, same sharding specs, same quantized kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ltx_jax.core.config import TransformerConfig
from ltx_jax.kernels import quantization as q
from ltx_jax.models import dit
from ltx_jax.ops import rope as rope_ops
from ltx_jax.parallel import sharding as sh
from ltx_jax.train import (
    TrainConfig, add_lora, flow_match_loss, lora_param_mask, make_train_step,
    merge_lora, sample_sigmas, strip_lora,
)
from ltx_jax.train.step import (
    combine_params, init_train_state, partition_trainable,
)

CFG = TransformerConfig().tiny()  # 2 layers, 4 heads x 32 = 128 inner


def _batch(key, b=2, f=2, h=2, w=3, s=16):
    t = f * h * w
    ks = jax.random.split(key, 2)
    tokens = jax.random.normal(ks[0], (b, t, CFG.in_channels), jnp.float32)
    context = jax.random.normal(ks[1], (b, s, CFG.caption_channels),
                                jnp.float32)
    cos, sin = rope_ops.video_rope(f, h, w, CFG.inner_dim, CFG.num_heads)
    return tokens, context, (jnp.asarray(cos), jnp.asarray(sin))


# ---------------------------------------------------------------- STE grads


def test_int8_ste_grad_matches_dequantized_dense():
    """d/dx of the W8A8 matmul == g @ W_deq^T (activation round treated as
    identity; frozen int weights get zero cotangents)."""
    key = jax.random.key(0)
    kx, kw = jax.random.split(key)
    x = jax.random.normal(kx, (4, 64), jnp.float32)
    w = jax.random.normal(kw, (64, 32), jnp.float32) * 0.1
    leaf = q.requant_int8_channel_np(np.asarray(w))
    leaf = {k: jnp.asarray(v) for k, v in leaf.items()}

    g = jax.grad(lambda xx: jnp.sum(q.int8_matmul(leaf, xx) ** 2))(x)
    w_deq = leaf["w8"].astype(jnp.float32) * leaf["sw"]
    # cotangent of sum(out^2) is 2*out; out itself uses quantized activations
    out = q.int8_matmul(leaf, x)
    g_ref = (2.0 * out) @ w_deq.T
    # backward runs in bf16 — compare loosely
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=0.05, atol=0.05)


def test_int4_ste_grad_matches_dequantized_dense():
    """d/dx of the int4 linear == g @ dequant(W)^T."""
    key = jax.random.key(1)
    kx, kw = jax.random.split(key)
    k, n = 512, 256
    x = jax.random.normal(kx, (8, k), jnp.bfloat16)
    w = jax.random.normal(kw, (k, n), jnp.float32) * 0.1
    qp = {k2: jnp.asarray(v)
          for k2, v in q._quantize_weight_np(np.asarray(w), 4, 64).items()}

    def f(xx):
        return jnp.sum(q.linear_any(qp, xx).astype(jnp.float32))

    g = jax.grad(f)(x)
    w_deq = q.dequantize_weight(qp, jnp.bfloat16)
    g_ref = jnp.ones((8, n), jnp.bfloat16) @ w_deq.T
    np.testing.assert_allclose(np.asarray(g, np.float32),
                               np.asarray(g_ref, np.float32),
                               rtol=0.05, atol=0.05)


def test_linear_any_lora_grads_flow():
    """Gradients reach the LoRA leaves through a quantized base."""
    key = jax.random.key(2)
    kx, kw, kl = jax.random.split(key, 3)
    x = jax.random.normal(kx, (4, 64), jnp.float32)
    w = jax.random.normal(kw, (64, 32), jnp.float32) * 0.1
    leaf = {k: jnp.asarray(v)
            for k, v in q.requant_int8_channel_np(np.asarray(w)).items()}
    leaf["lora_a"] = jax.random.normal(kl, (64, 4), jnp.float32) * 0.1
    leaf["lora_b"] = jnp.zeros((4, 32), jnp.float32)
    leaf["lora_s"] = jnp.asarray(1.0)

    def loss(ab):
        p = dict(leaf, lora_a=ab[0], lora_b=ab[1])
        return jnp.sum(q.linear_any(p, x) ** 2)

    ga, gb = jax.grad(loss)((leaf["lora_a"], leaf["lora_b"]))
    # lora_b is zero so d/d lora_a is zero — but d/d lora_b is NOT
    assert float(jnp.abs(gb).max()) > 0.0
    assert np.isfinite(np.asarray(ga)).all()


# ---------------------------------------------------------------- LoRA tree


def test_add_lora_zero_init_is_identity():
    """With lora_b = 0 the adapted model equals the base model exactly."""
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    tokens, context, rope = _batch(jax.random.key(1))
    ts = jnp.full((2,), 0.5, jnp.float32)
    base = dit.dit_forward(params, tokens, context, ts, rope, CFG)

    lp = add_lora(params, jax.random.key(3), rank=4)
    out = dit.dit_forward(lp, tokens, context, ts, rope, CFG)
    np.testing.assert_allclose(np.asarray(out), np.asarray(base), atol=1e-6)

    # strip recovers the base tree leaf-for-leaf
    stripped = strip_lora(lp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), stripped, params)


def test_add_lora_targets_stacked_blocks():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    blk = lp["blocks"]
    a = blk["attn1"]["to_q"]["lora_a"]
    assert a.shape == (CFG.num_layers, CFG.inner_dim, 4)
    assert blk["ff"]["project_in"]["lora_b"].shape[0] == CFG.num_layers
    mask = lora_param_mask(lp)
    n_lora = sum(jax.tree.leaves(jax.tree.map(int, mask)))
    assert n_lora > 0


def test_merge_lora_matches_side_path():
    """merge_lora(W + s*A@B) forward == side-path forward (f32 base)."""
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    # give lora_b real values so the adapter is active
    lp = jax.tree.map(lambda p: p, lp)

    def bump(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = bump(v)
            elif k == "lora_b":
                out[k] = jax.random.normal(
                    jax.random.key(hash(k) % 2**31), v.shape,
                    jnp.float32) * 0.02
            else:
                out[k] = v
        return out

    lp = bump(lp)
    tokens, context, rope = _batch(jax.random.key(1))
    ts = jnp.full((2,), 0.5, jnp.float32)
    side = dit.dit_forward(lp, tokens, context, ts, rope, CFG)
    merged = merge_lora(lp)
    # merged tree must carry no LoRA leaves
    assert not any("lora" in k for k in jax.tree_util.tree_flatten_with_path(
        merged)[0].__str__())
    fused = dit.dit_forward(merged, tokens, context, ts, rope, CFG)
    assert not np.allclose(np.asarray(side), np.asarray(
        dit.dit_forward(params, tokens, context, ts, rope, CFG)))
    np.testing.assert_allclose(np.asarray(fused), np.asarray(side),
                               atol=5e-4)


def test_export_roundtrip_through_fusion(tmp_path):
    """save_lora -> the INFERENCE fuse path (parse_lora/map_lora_key/
    fuse_lora_file) -> fused forward == side-path forward."""
    from ltx_jax.lora import fuse
    from ltx_jax.train.export import lora_state_dict, save_lora

    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)

    def bump(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = bump(v)
            elif k == "lora_b":
                out[k] = jax.random.normal(
                    jax.random.key(hash(k) % 2**31), v.shape,
                    jnp.float32) * 0.02
            else:
                out[k] = v
        return out

    lp = bump(lp)
    sd = lora_state_dict(lp)
    # one (down, up, alpha) triple per targeted linear per layer
    n_targets = len({k.rsplit(".lora", 1)[0].rsplit(".alpha", 1)[0]
                     for k in sd})
    # q,k,v,out in attn1 AND attn2 + ff in/out = 10 linears per block
    assert n_targets == CFG.num_layers * 10
    path = tmp_path / "adapter.safetensors"
    n = save_lora(lp, path)
    assert n == len(sd)

    fused = fuse.fuse_lora_file(params, path)
    tokens, context, rope = _batch(jax.random.key(1))
    ts = jnp.full((2,), 0.5, jnp.float32)
    side = dit.dit_forward(lp, tokens, context, ts, rope, CFG)
    out = dit.dit_forward(fused, tokens, context, ts, rope, CFG)
    assert not np.allclose(np.asarray(out), np.asarray(
        dit.dit_forward(params, tokens, context, ts, rope, CFG)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(side), atol=5e-4)


# ------------------------------------------------------------- train steps


def test_sample_sigmas_ranges():
    for scheme in ("uniform", "logit_normal"):
        s = sample_sigmas(jax.random.key(0), 512, scheme)
        a = np.asarray(s)
        assert (a > 0).all() and (a < 1).all()
    with pytest.raises(ValueError):
        sample_sigmas(jax.random.key(0), 4, "nope")


def test_full_finetune_loss_decreases():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    tokens, context, rope = _batch(jax.random.key(1))
    tc = TrainConfig(learning_rate=3e-4, remat=False,
                     compute_dtype=jnp.float32)
    trainable, frozen, opt_state = init_train_state(params, tc)
    step = make_train_step(CFG, tc, donate=False)

    losses = []
    for i in range(8):
        trainable, opt_state, aux = step(
            trainable, frozen, opt_state, tokens, context, rope,
            jax.random.key(100 + (i % 2)))  # 2 fixed (sigma, noise) draws
        losses.append(float(aux["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert float(aux["grad_norm"]) > 0.0


def test_lora_only_trains_adapters_freezes_base():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    tokens, context, rope = _batch(jax.random.key(1))
    tc = TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                     compute_dtype=jnp.float32)
    trainable, frozen, opt_state = init_train_state(lp, tc)

    # trainable tree contains ONLY lora leaves
    for path, leaf in jax.tree_util.tree_leaves_with_path(trainable):
        assert "lora" in jax.tree_util.keystr(path)

    step = make_train_step(CFG, tc, donate=False)
    l0 = None
    for i in range(6):
        trainable, opt_state, aux = step(
            trainable, frozen, opt_state, tokens, context, rope,
            jax.random.key(100 + (i % 2)))
        if l0 is None:
            l0 = float(aux["loss"])
    assert float(aux["loss"]) < l0

    # base weights unchanged; adapters moved
    full = combine_params(trainable, frozen)
    np.testing.assert_array_equal(
        np.asarray(full["blocks"]["attn1"]["to_q"]["w"]),
        np.asarray(lp["blocks"]["attn1"]["to_q"]["w"]))
    assert float(jnp.abs(
        full["blocks"]["attn1"]["to_q"]["lora_b"]).max()) > 0.0


def test_qlora_over_w8a8_base(monkeypatch):
    """LoRA training over a frozen W8A8-quantized base (QLoRA): the step
    runs through the int8 STE, the int base never changes, loss drops."""
    # tiny linears sit below the real size gate — force quantization
    monkeypatch.setattr(q, "_MIN_QUANT_SIZE", 1)
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    qp = q.quantize_transformer_params(params, bits=8, w8a8=True)
    assert "w8" in qp["blocks"]["attn1"]["to_q"]
    lp = add_lora(qp, jax.random.key(3), rank=4)
    tokens, context, rope = _batch(jax.random.key(1))
    tc = TrainConfig(learning_rate=1e-3, lora_only=True, remat=False,
                     compute_dtype=jnp.float32)
    trainable, frozen, opt_state = init_train_state(lp, tc)
    step = make_train_step(CFG, tc, donate=False)

    l0 = None
    for i in range(6):
        trainable, opt_state, aux = step(
            trainable, frozen, opt_state, tokens, context, rope,
            jax.random.key(100 + (i % 2)))
        if l0 is None:
            l0 = float(aux["loss"])
    assert np.isfinite(float(aux["loss"]))
    assert float(aux["loss"]) < l0
    full = combine_params(trainable, frozen)
    np.testing.assert_array_equal(
        np.asarray(full["blocks"]["attn1"]["to_q"]["w8"]),
        np.asarray(lp["blocks"]["attn1"]["to_q"]["w8"]))


def test_av_lora_train_step():
    """Joint AV flow-matching LoRA step: adapters land in all 6 attentions
    + both FFNs, loss decreases, base frozen."""
    from ltx_jax.models import dit_av
    from ltx_jax.train import make_av_train_step

    params = dit_av.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    blk = lp["blocks"]
    for leaf in ("attn1", "audio_attn1", "audio_to_video_attn",
                 "video_to_audio_attn"):
        assert "lora_a" in blk[leaf]["to_q"], leaf
    assert "lora_a" in blk["audio_ff"]["project_in"]

    b, f, h, w, ta, s = 1, 2, 2, 3, 5, 8
    video = jax.random.normal(jax.random.key(1),
                              (b, f * h * w, CFG.in_channels), jnp.float32)
    audio = jax.random.normal(jax.random.key(2),
                              (b, ta, CFG.audio_in_channels), jnp.float32)
    ctx = jax.random.normal(jax.random.key(4),
                            (b, s, CFG.caption_channels), jnp.float32)
    ropes = dit_av.prepare_av_ropes(CFG, f, h, w, ta)

    tc = TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                     compute_dtype=jnp.float32)
    trainable, frozen, opt_state = init_train_state(lp, tc)
    step = make_av_train_step(CFG, tc, donate=False)
    l0 = None
    for i in range(6):
        trainable, opt_state, aux = step(
            trainable, frozen, opt_state, video, audio, ctx, ctx, ropes,
            jax.random.key(100 + (i % 2)))
        if l0 is None:
            l0 = float(aux["loss"])
    assert np.isfinite(float(aux["loss"]))
    assert float(aux["loss"]) < l0
    assert float(aux["loss_audio"]) > 0.0 and float(aux["loss_video"]) > 0.0
    full = combine_params(trainable, frozen)
    np.testing.assert_array_equal(
        np.asarray(full["blocks"]["audio_attn1"]["to_q"]["w"]),
        np.asarray(lp["blocks"]["audio_attn1"]["to_q"]["w"]))
    assert float(jnp.abs(
        full["blocks"]["audio_attn1"]["to_q"]["lora_b"]).max()) > 0.0


def test_partition_roundtrip():
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    tc = TrainConfig(lora_only=True)
    trainable, frozen = partition_trainable(lp, tc)
    back = combine_params(trainable, frozen)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, lp)


def test_grad_accumulation_updates_every_k():
    """accum_steps=2: params move only on every 2nd call; the applied
    update equals one step on the mean of the accumulated grads."""
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    tokens, context, rope = _batch(jax.random.key(1))
    tc = TrainConfig(learning_rate=1e-3, lora_only=True, remat=False,
                     compute_dtype=jnp.float32, accum_steps=2)
    trainable, frozen, opt_state = init_train_state(lp, tc)
    step = make_train_step(CFG, tc, donate=False)

    probe = lambda t: np.asarray(t["blocks"]["attn1"]["to_q"]["lora_b"])
    before = probe(trainable)
    trainable, opt_state, _ = step(trainable, frozen, opt_state, tokens,
                                   context, rope, jax.random.key(100))
    np.testing.assert_array_equal(probe(trainable), before)  # micro-step 1
    trainable, opt_state, aux = step(trainable, frozen, opt_state, tokens,
                                     context, rope, jax.random.key(101))
    assert float(np.abs(probe(trainable) - before).max()) > 0  # applied
    assert np.isfinite(float(aux["loss"]))


def test_ema_tracks_trainable():
    from ltx_jax.train import ema_init, make_ema_update

    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    tc = TrainConfig(lora_only=True)
    trainable, _ = partition_trainable(lp, tc)
    ema = ema_init(trainable)
    jax.tree.map(lambda e, p: np.testing.assert_array_equal(
        np.asarray(e), np.asarray(p)), ema, trainable)

    moved = jax.tree.map(lambda p: p + 1.0, trainable)
    upd = make_ema_update(decay=0.9)
    ema = upd(ema, moved)
    # ema = 0.9 * p + 0.1 * (p + 1) = p + 0.1
    jax.tree.map(lambda e, p: np.testing.assert_allclose(
        np.asarray(e), np.asarray(p) + 0.1, atol=1e-6), ema, trainable)


def test_checkpoint_resume_exact(tmp_path):
    """save -> load -> continue == uninterrupted training (same keys)."""
    from ltx_jax.train import load_train_checkpoint, save_train_checkpoint

    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    tokens, context, rope = _batch(jax.random.key(1))
    tc = TrainConfig(learning_rate=1e-3, lora_only=True, remat=False,
                     compute_dtype=jnp.float32)
    step = make_train_step(CFG, tc, donate=False)

    def run(trainable, opt_state, frozen, start, n):
        for i in range(start, start + n):
            trainable, opt_state, _ = step(
                trainable, frozen, opt_state, tokens, context, rope,
                jax.random.key(100 + i))
        return trainable, opt_state

    trainable, frozen, opt_state = init_train_state(lp, tc)
    t2, o2 = run(trainable, opt_state, frozen, 0, 2)
    path = tmp_path / "ckpt.npz"
    save_train_checkpoint(path, t2, o2, step=2)

    # uninterrupted: 4 steps straight
    t_ref, o_ref = run(trainable, opt_state, frozen, 0, 4)
    # resumed: fresh templates, load, 2 more steps
    t_new, _, o_new = init_train_state(lp, tc)
    t_res, o_res, start = load_train_checkpoint(path, t_new, o_new)
    assert start == 2
    t_res, o_res = run(t_res, o_res, frozen, 2, 2)

    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), t_res, t_ref)

    # structure mismatch raises
    bad, _, bad_o = init_train_state(
        add_lora(params, jax.random.key(3), rank=8), tc)
    with pytest.raises((KeyError, ValueError)):
        load_train_checkpoint(path, bad, bad_o)


# -------------------------------------------------------------- data + e2e


def _write_shards(root, n_shards=2, rows=5, grid=(2, 2, 3), s=16):
    from ltx_jax.train.data import write_shard

    rng = np.random.default_rng(0)
    t = grid[0] * grid[1] * grid[2]
    for i in range(n_shards):
        write_shard(
            root / f"shard{i}.npz",
            rng.standard_normal((rows, t, CFG.in_channels)).astype(
                np.float32),
            rng.standard_normal((rows, s, CFG.caption_channels)).astype(
                np.float32),
            grid,
            mask=np.ones((rows, s), np.int64),
        )


def test_dataset_shuffles_and_resumes(tmp_path):
    from ltx_jax.train.data import LatentShardDataset

    _write_shards(tmp_path)
    ds = LatentShardDataset(tmp_path, batch_size=4, seed=7)
    assert ds.num_rows == 10 and ds.grid == (2, 2, 3)
    b1 = next(ds)
    assert b1.tokens.shape == (4, 12, CFG.in_channels)
    assert b1.mask.shape == (4, 16)
    state = ds.state()
    b2 = next(ds)

    ds2 = LatentShardDataset(tmp_path, batch_size=4, seed=7)
    next(ds2)
    ds2.restore(state)
    b2r = next(ds2)
    np.testing.assert_array_equal(b2.tokens, b2r.tokens)

    # different seed -> different order
    ds3 = LatentShardDataset(tmp_path, batch_size=4, seed=8)
    assert not np.array_equal(next(ds3).tokens, b1.tokens)


def test_dataset_rejects_mixed_grids(tmp_path):
    from ltx_jax.train.data import LatentShardDataset, write_shard

    _write_shards(tmp_path, n_shards=1)
    write_shard(tmp_path / "bad.npz",
                np.zeros((2, 8, CFG.in_channels), np.float32),
                np.zeros((2, 16, CFG.caption_channels), np.float32),
                (2, 2, 2))
    with pytest.raises(ValueError):
        LatentShardDataset(tmp_path, batch_size=2)


def test_train_lora_script_e2e(tmp_path):
    """scripts/train_lora.py: shards -> steps -> exported adapter that the
    inference fusion path loads."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_lora", "scripts/train_lora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    data_dir = tmp_path / "shards"
    data_dir.mkdir()
    _write_shards(data_dir)
    out = tmp_path / "adapter.safetensors"
    ckpt = tmp_path / "run.npz"
    mod.main([
        "--data", str(data_dir), "--out", str(out), "--steps", "4",
        "--batch", "2", "--rank", "4", "--random-init", "tiny",
        "--compute", "f32", "--quant", "none", "--ckpt", str(ckpt),
        "--ckpt-every", "2", "--log-every", "2", "--ema", "0.9",
    ])
    assert out.exists() and ckpt.exists()

    from ltx_jax.lora import fuse
    layers = fuse.parse_lora(
        __import__("ltx_jax.weights.download",
                   fromlist=["load_safetensors"]).load_safetensors(out))
    assert len(layers) == CFG.num_layers * 10
    # resume path: 2 more steps from the checkpoint
    mod.main([
        "--data", str(data_dir), "--out", str(out), "--steps", "6",
        "--batch", "2", "--rank", "4", "--random-init", "tiny",
        "--compute", "f32", "--quant", "none", "--ckpt", str(ckpt),
        "--resume", "--log-every", "2",
    ])


# ---------------------------------------------------------------- dp + tp


def test_train_step_dp_tp_mesh():
    """Full train step under a 2x4 (data, model) mesh: params shard with the
    INFERENCE partition specs (incl. LoRA leaves), batch rides data."""
    mesh = sh.make_mesh(data=2, model=4)
    params = dit.init_params(jax.random.key(0), CFG, dtype=jnp.float32)
    lp = add_lora(params, jax.random.key(3), rank=4)
    specs = sh.dit_param_specs(lp)
    shd = jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), lp, specs)

    tokens, context, rope = _batch(jax.random.key(1), b=4)
    dsh = NamedSharding(mesh, P("data"))
    tokens = jax.device_put(tokens, dsh)
    context = jax.device_put(context, dsh)

    tc = TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                     compute_dtype=jnp.float32)
    trainable, frozen, opt_state = init_train_state(shd, tc)
    step = make_train_step(CFG, tc, donate=False)
    trainable, opt_state, aux = step(
        trainable, frozen, opt_state, tokens, context, rope,
        jax.random.key(7))
    assert np.isfinite(float(aux["loss"]))

    # sharded step == single-device step (same key, same batch)
    t2, f2, o2 = init_train_state(lp, tc)
    t2, o2, aux2 = make_train_step(CFG, tc, donate=False)(
        t2, f2, o2, tokens, context, rope, jax.random.key(7))
    np.testing.assert_allclose(float(aux["loss"]), float(aux2["loss"]),
                               rtol=1e-4)


def test_train_lora_cli_mesh_e2e(tmp_path):
    """`--mesh 2,4` trains dp+tp end-to-end through the CLI: params shard
    with the inference specs, the batch rides the data axis, and the
    exported adapter still loads through the inference fusion path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_lora", "scripts/train_lora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    data_dir = tmp_path / "shards"
    data_dir.mkdir()
    _write_shards(data_dir)
    out = tmp_path / "adapter_mesh.safetensors"
    mod.main([
        "--data", str(data_dir), "--out", str(out), "--steps", "3",
        "--batch", "2", "--rank", "4", "--random-init", "tiny",
        "--compute", "f32", "--quant", "none", "--log-every", "1",
        "--mesh", "2,4",
    ])
    assert out.exists()
    from ltx_jax.lora import fuse
    from ltx_jax.weights.download import load_safetensors
    layers = fuse.parse_lora(load_safetensors(out))
    assert len(layers) == CFG.num_layers * 10


def test_segmented_remat_matches_per_block():
    """remat_segments groups the scan without changing math: forward AND
    LoRA grads must match per-block remat exactly (same op order)."""
    import jax.numpy as jnp

    from ltx_jax.models import dit
    from ltx_jax.ops import rope as rope_ops
    from ltx_jax.train import TrainConfig, add_lora
    from ltx_jax.train.flow_match import flow_match_loss

    cfg = CFG  # tiny, num_layers=2
    params = add_lora(dit.init_params(jax.random.key(0), cfg, jnp.float32),
                      jax.random.key(1), rank=4)
    f, h, w = 2, 4, 4
    tokens = jax.random.normal(jax.random.key(2),
                               (1, f * h * w, cfg.in_channels), jnp.float32)
    ctx = jax.random.normal(jax.random.key(3),
                            (1, 8, cfg.caption_channels), jnp.float32)
    cos, sin = rope_ops.video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
    rope = (jnp.asarray(cos), jnp.asarray(sin))

    def loss(p, segs):
        out, _aux = flow_match_loss(p, tokens, ctx, rope, jax.random.key(4),
                                    cfg, remat=(segs == 0),
                                    remat_segments=segs,
                                    compute_dtype=jnp.float32)
        return out

    base, gbase = jax.value_and_grad(loss)(params, 0)
    seg, gseg = jax.value_and_grad(loss)(params, 2)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(seg))
    for a, b in zip(jax.tree.leaves(gbase), jax.tree.leaves(gseg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_segmented_remat_av_matches():
    import jax.numpy as jnp

    from ltx_jax.models import dit_av
    from ltx_jax.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(seed=0, include_audio=True)
    cfg = pipe.tcfg
    b, tv, ta = 1, 16, 5
    v = jax.random.normal(jax.random.key(0), (b, tv, cfg.in_channels),
                          jnp.float32)
    a = jax.random.normal(jax.random.key(1),
                          (b, ta, cfg.audio_in_channels), jnp.float32)
    ctx = jnp.ones((b, 8, cfg.caption_channels), jnp.float32)
    ropes = dit_av.prepare_av_ropes(cfg, 2, 2, 4, ta, fps=24.0)
    sv = jnp.full((b,), 0.7, jnp.float32)

    vp, ap_ = dit_av.dit_av_forward(
        pipe.av_transformer_params, v, a, ctx, ctx, sv, sv, ropes, cfg,
        remat=True)
    vs, as_ = dit_av.dit_av_forward(
        pipe.av_transformer_params, v, a, ctx, ctx, sv, sv, ropes, cfg,
        remat_segments=2)
    np.testing.assert_array_equal(np.asarray(vp), np.asarray(vs))
    np.testing.assert_array_equal(np.asarray(ap_), np.asarray(as_))


def test_segmented_remat_invalid_segments():
    import jax.numpy as jnp
    import pytest as _pytest

    from ltx_jax.models import dit
    from ltx_jax.ops import rope as rope_ops

    cfg = CFG
    params = dit.init_params(jax.random.key(0), cfg, jnp.float32)
    cos, sin = rope_ops.video_rope(2, 4, 4, cfg.inner_dim, cfg.num_heads)
    x = jnp.zeros((1, 32, cfg.in_channels), jnp.float32)
    ctx = jnp.zeros((1, 8, cfg.caption_channels), jnp.float32)
    with _pytest.raises(ValueError, match="divide"):
        dit.dit_forward(params, x, ctx, jnp.full((1,), 0.5),
                        (jnp.asarray(cos), jnp.asarray(sin)), cfg,
                        remat_segments=7)


def test_train_step_sp_ring_matches_xla():
    """SEQUENCE-PARALLEL training (VERDICT r3 #2): the flow-match step with
    sdpa_impl='ring' — self-attention sharded over the token axis via the
    differentiable ring (parallel/ring_attention.py custom VJP) — matches
    the plain XLA step. Completes SURVEY §5.7 for training: long-sequence
    steps can shard T across the mesh instead of rematerializing (T, T)
    logits."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ltx_jax.ops.attention import set_sequence_parallel

    mesh = sh.make_mesh(data=1, model=8)
    params = add_lora(dit.init_params(jax.random.key(0), CFG, jnp.float32),
                      jax.random.key(3), rank=4)
    tokens, context, rope = _batch(jax.random.key(1), b=2, f=2, h=2, w=4)

    tc_ref = TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                         compute_dtype=jnp.float32, sdpa_impl="xla")
    t0, f0, o0 = init_train_state(params, tc_ref)
    _, _, aux_ref = make_train_step(CFG, tc_ref, donate=False)(
        t0, f0, o0, tokens, context, rope, jax.random.key(7))

    set_sequence_parallel(mesh)
    try:
        tc = TrainConfig(learning_rate=1e-3, lora_only=True, remat=True,
                         compute_dtype=jnp.float32, sdpa_impl="ring")
        t1, f1, o1 = init_train_state(params, tc)
        t1, o1, aux = make_train_step(CFG, tc, donate=False)(
            t1, f1, o1, tokens, context, rope, jax.random.key(7))
    finally:
        set_sequence_parallel(None)
    np.testing.assert_allclose(float(aux["loss"]), float(aux_ref["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(
        float(aux["grad_norm"]), float(aux_ref["grad_norm"]), rtol=1e-3)
