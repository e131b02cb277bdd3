"""Training-data preparation: clips + captions -> latent shards -> a train
step runs on the produced shards (the full data-side loop)."""

import json

import numpy as np
import pytest

from ltx_jax.io.video import export_video, load_video


def _synthetic_clip(path, frames=9, h=40, w=48, seed=0):
    rng = np.random.default_rng(seed)
    # smooth low-frequency content (codec-friendly; random noise would
    # stress H.264 and distort the value-roundtrip check)
    t = np.linspace(0, 1, frames)[:, None, None, None]
    y = np.linspace(0, 1, h)[None, :, None, None]
    x = np.linspace(0, 1, w)[None, None, :, None]
    c = np.linspace(0, 1, 3)[None, None, None, :]
    vid = 0.5 + 0.45 * np.sin(2 * np.pi * (t + y + x + c))
    vid += rng.normal(0, 0.01, vid.shape)
    export_video(np.clip(vid, 0, 1), str(path), fps=8.0)
    return vid


def test_load_video_roundtrip(tmp_path):
    p = tmp_path / "clip.mp4"
    vid = _synthetic_clip(p, frames=9)
    out = load_video(p, 48, 40, 9)
    assert out.shape == (1, 3, 9, 40, 48) and out.dtype == np.float32
    assert out.min() >= -1.0 and out.max() <= 1.0
    # codec-lossy but content-preserving
    ref = (vid * 2 - 1).transpose(3, 0, 1, 2)[None]
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.95


def test_load_video_resamples_frames(tmp_path):
    p = tmp_path / "clip.mp4"
    _synthetic_clip(p, frames=17)
    out = load_video(p, 32, 32, 9)  # 17 -> evenly sampled 9
    assert out.shape == (1, 3, 9, 32, 32)


@pytest.fixture(scope="module")
def tiny_pipe():
    from ltx_jax.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(seed=0)

    def fake_tokenize(prompt):
        import jax.numpy as jnp

        n = max(1, min(len(prompt) % 7 + 3, 8))
        ids = np.zeros((1, 8), np.int32)
        ids[0, -n:] = (np.frombuffer(prompt.encode()[:n].ljust(n, b"x"),
                                     np.uint8).astype(np.int32)
                       % pipe.gcfg.vocab_size)
        mask = np.zeros((1, 8), np.int32)
        mask[0, -n:] = 1
        return jnp.asarray(ids), jnp.asarray(mask)

    pipe.tokenize = fake_tokenize
    return pipe


def test_prepare_dataset_to_train_step(tmp_path, tiny_pipe):
    from ltx_jax.train.data import LatentShardDataset
    from ltx_jax.train.prepare import prepare_dataset

    clips = tmp_path / "clips"
    clips.mkdir()
    items = []
    for i in range(3):
        p = clips / f"c{i}.mp4"
        _synthetic_clip(p, frames=9, h=64, w=64, seed=i)
        items.append((str(p), f"clip number {i} of a moving gradient"))

    shards = prepare_dataset(tiny_pipe, items, tmp_path / "shards",
                             width=64, height=64, num_frames=9,
                             rows_per_shard=2)
    assert len(shards) == 2  # 2 + 1 rows

    from ltx_jax.train.data import prefetch_to_device

    ds = LatentShardDataset(tmp_path / "shards", batch_size=2, seed=0)
    assert ds.num_rows == 3
    f, h, w = ds.grid
    assert f == (9 - 1) // 8 + 1
    tokens, context, bias = next(prefetch_to_device(iter(ds)))
    assert tokens.shape[1] == f * h * w
    assert tokens.shape[2] == tiny_pipe.tcfg.in_channels
    assert np.isfinite(np.asarray(tokens)).all()

    # the produced shards drive a real train step
    import jax
    import jax.numpy as jnp

    from ltx_jax.ops import rope as rope_ops
    from ltx_jax.train import TrainConfig, add_lora, make_train_step
    from ltx_jax.train.step import init_train_state

    params = add_lora(tiny_pipe.transformer_params, jax.random.key(1),
                      rank=2)
    tc = TrainConfig(learning_rate=1e-4, lora_only=True,
                     compute_dtype=jnp.float32)
    trainable, frozen, opt_state = init_train_state(params, tc)
    step = make_train_step(tiny_pipe.tcfg, tc)
    cos, sin = rope_ops.video_rope(f, h, w, tiny_pipe.tcfg.inner_dim,
                                   tiny_pipe.tcfg.num_heads)
    _, _, aux = step(trainable, frozen, opt_state, tokens, context,
                     (jnp.asarray(cos), jnp.asarray(sin)),
                     jax.random.key(2), context_bias=bias)
    assert np.isfinite(float(aux["loss"]))


def test_prepare_dataset_grid_mismatch_raises(tmp_path, tiny_pipe):
    from ltx_jax.train.prepare import prepare_dataset

    p = tmp_path / "c.mp4"
    _synthetic_clip(p, frames=9, h=64, w=64)
    with pytest.raises(ValueError, match="8n\\+1"):
        prepare_dataset(tiny_pipe, [(str(p), "x")], tmp_path / "s",
                        width=64, height=64, num_frames=10)


def test_prepare_dataset_skip_errors(tmp_path, tiny_pipe):
    from ltx_jax.train.prepare import prepare_dataset

    good = tmp_path / "good.mp4"
    _synthetic_clip(good, frames=9, h=64, w=64)
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")

    with pytest.raises(Exception):
        prepare_dataset(tiny_pipe, [(str(bad), "x"), (str(good), "y")],
                        tmp_path / "s1", 64, 64, 9)
    shards = prepare_dataset(
        tiny_pipe, [(str(bad), "x"), (str(good), "y")], tmp_path / "s2",
        64, 64, 9, skip_errors=True)
    assert len(shards) == 1


def test_manifest_and_sidecar_scan(tmp_path):
    from ltx_jax.train.prepare import read_manifest, scan_videos

    (tmp_path / "a.mp4").write_bytes(b"x")
    (tmp_path / "a.txt").write_text("caption a\n")
    items = scan_videos(tmp_path)
    assert items == [(str(tmp_path / "a.mp4"), "caption a")]

    man = tmp_path / "m.jsonl"
    man.write_text(json.dumps({"video": "a.mp4", "caption": "c"}) + "\n\n")
    items = read_manifest(man)
    assert items == [(str(tmp_path / "a.mp4"), "c")]

    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty manifest"):
        read_manifest(empty)


def test_cli_prepare_data_parses():
    from ltx_jax.io.cli import build_parser

    args = build_parser().parse_args(
        ["prepare-data", "manifest.jsonl", "--out", "shards", "-w", "256",
         "-H", "192", "-f", "9", "--rows-per-shard", "4", "--skip-errors"])
    assert args.command == "prepare-data"
    assert args.out == "shards" and args.frames == 9 and args.skip_errors
