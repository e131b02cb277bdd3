"""Batched generation jobs (VERDICT r3 #6): B same-config T2V prompts
stack on the denoise batch axis — pipeline.generate_videos parity with
per-sample generate_video, and JobQueue coalescing with per-job isolation.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

from ltx_jax.core.config import GenerationConfig
from ltx_jax.pipeline.generate import LTXPipeline
from ltx_jax.serve.jobs import DONE, FAILED, JobQueue


def _cfg(**kw):
    d = dict(width=64, height=64, num_frames=9, num_steps=2, seed=42)
    d.update(kw)
    return GenerationConfig(**d)


@pytest.fixture(scope="module")
def pipe():
    p = LTXPipeline.random_tiny(seed=0)
    p.memory = dataclasses.replace(p.memory, offload_text_encoder=False)
    return p


def test_generate_videos_matches_per_sample(pipe):
    """Each batched row must reproduce a SOLO run of the same (prompt,
    seed) — noise, context rows, decode all isolated per sample."""
    prompts = ["a red fox", "a blue whale"]
    seeds = [11, 12]
    solo = [pipe.generate_video(p, _cfg(seed=s))
            for p, s in zip(prompts, seeds)]
    batched = pipe.generate_videos(prompts, _cfg(), seeds=seeds)
    assert len(batched) == 2
    for s, b in zip(solo, batched):
        assert b.seed == s.seed
        got, want = np.asarray(b.frames), np.asarray(s.frames)
        # bf16 matmuls tile differently at B=2 vs B=1 -> low-bit reduction
        # noise compounds over 8 denoise steps (measured max ~6e-3)
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0,
                                   err_msg="batched row diverged")
        assert np.abs(got - want).mean() < 1e-3


def test_generate_videos_cfg_guided(pipe):
    """CFG rows (B-major layout) — guided combine stays per-sample."""
    cfg = _cfg(cfg_scale=4.0)
    prompts = ["a red fox", "a blue whale"]
    solo = [pipe.generate_video(p, dataclasses.replace(cfg, seed=s))
            for p, s in zip(prompts, (5, 6))]
    batched = pipe.generate_videos(prompts, cfg, seeds=[5, 6])
    for s, b in zip(solo, batched):
        got, want = np.asarray(b.frames), np.asarray(s.frames)
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
        assert np.abs(got - want).mean() < 1e-3


def _gated_queue(run_batch, max_batch):
    """Queue whose worker can be parked on a gate job (the gate blocks
    inside run_one — no queue lock held — so submits keep flowing and the
    pending jobs pile up for the coalescing scan)."""
    calls = []
    gate = {"open": False}

    def run_one(job):
        while job.request.get("gate") and not gate["open"]:
            time.sleep(0.005)
        calls.append(("one", [job.request["p"]]))
        return {"v": job.request["p"]}

    q = JobQueue(run_one, run_batch=run_batch, max_batch=max_batch,
                 batch_key=lambda j: j.request.get("k"))
    return q, gate, calls


def test_jobqueue_coalesces_same_key():
    """Same-key pending jobs drain as ONE run_batch call; different keys
    stay solo; per-job results land on the right job."""
    def run_batch(batch):
        ps = [j.request["p"] for j in batch]
        calls.append(("batch", ps))
        return [{"v": p} for p in ps]

    q, gate, calls = _gated_queue(run_batch, max_batch=3)
    try:
        ids = [q.submit("t2v", {"p": "hold", "gate": True})]  # k=None: solo
        ids += [q.submit("t2v", {"p": f"a{i}", "k": "A"}) for i in range(4)]
        ids.append(q.submit("t2v", {"p": "b0", "k": "B"}))
        gate["open"] = True
        recs = [q.wait(i, timeout=30) for i in ids]
    finally:
        q.close()
    assert all(r["state"] == DONE for r in recs)
    assert [r["result"]["v"] for r in recs] == ["hold", "a0", "a1", "a2",
                                                "a3", "b0"]
    # a0+a1+a2 coalesce (max_batch=3); a3 drains next and picks up no
    # peers; b0 has a different key
    assert ("batch", ["a0", "a1", "a2"]) in calls
    assert ("batch", ["a3"]) not in calls  # lone batchable -> run_one path
    assert ("one", ["a3"]) in calls and ("one", ["b0"]) in calls


def test_jobqueue_batch_failure_isolated():
    """A failing batch fails exactly its own jobs; later jobs still run."""
    def run_batch(batch):
        raise RuntimeError("boom")

    q, gate, calls = _gated_queue(run_batch, max_batch=4)
    try:
        hold = q.submit("t2v", {"p": "hold", "gate": True})
        a = q.submit("t2v", {"p": "a", "k": "A"})
        b = q.submit("t2v", {"p": "b", "k": "A"})
        c = q.submit("t2v", {"p": "c"})  # k=None: solo, after the failure
        gate["open"] = True
        rh, ra, rb, rc = (q.wait(i, timeout=30) for i in (hold, a, b, c))
    finally:
        q.close()
    assert rh["state"] == DONE
    assert ra["state"] == FAILED and "boom" in ra["error"]
    assert rb["state"] == FAILED
    assert rc["state"] == DONE


def test_generate_videos_rejects_i2v(pipe):
    from ltx_jax.core.errors import InvalidConfigurationError

    with pytest.raises(InvalidConfigurationError):
        pipe.generate_videos(["a fox"], _cfg(image_path="/tmp/x.png"))


def test_enhance_prompts_strict_rejects_images_without_vision():
    """image_paths without the vision tower must fail loudly under strict
    (a silent text-only fallback would ship image-blind enhancements)."""
    from ltx_jax.core.errors import InvalidConfigurationError
    from ltx_jax.pipeline.enhance import enhance_prompts

    with pytest.raises(InvalidConfigurationError):
        enhance_prompts(None, None, None, ["a fox"],
                        image_paths=["x.png"], strict=True)


def test_serve_v2v_job_http(pipe, tmp_path):
    """kind=v2v over real HTTP: clip in, restyled MP4 out; out-of-fence
    video_path rejected at submit (400)."""
    import json
    import urllib.error
    import urllib.request

    from ltx_jax.io.video import export_video
    from ltx_jax.serve.app import build_app
    from ltx_jax.serve.server import serve_forever_threaded

    clip = np.random.default_rng(2).uniform(size=(9, 64, 64, 3)) \
        .astype(np.float32)
    root = tmp_path / "media"
    root.mkdir()
    export_video(clip, str(root / "in.mp4"))

    app = build_app(pipe, output_dir=str(tmp_path / "out"), port=0,
                    image_root=str(root))
    serve_forever_threaded(app.server)
    host, port = app.server.server_address[:2]
    base = f"http://{host}:{port}"

    def post(body):
        req = urllib.request.Request(
            base + "/v1/generate", json.dumps(body).encode(),
            {"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req).read())

    try:
        body = {"kind": "v2v", "prompt": "a fox", "video_path": "in.mp4",
                "strength": 0.5, "width": 64, "height": 64,
                "num_frames": 9, "num_steps": 2, "seed": 4}
        job_id = post(body)["job_id"]
        rec = app.jobs.wait(job_id, timeout=600)
        assert rec["state"] == "done", rec
        import os

        assert os.path.getsize(rec["result"]["output"]) > 0

        with pytest.raises(urllib.error.HTTPError) as ei:
            post({**body, "video_path": "../../etc/passwd"})
        assert ei.value.code == 400
    finally:
        app.close()


def test_serve_extend_job_http(pipe, tmp_path):
    """kind=extend over real HTTP: clip tail conditioned, continuation MP4
    out; bad cond_frames and out-of-fence video_path rejected at submit."""
    import json
    import os
    import urllib.error
    import urllib.request

    from ltx_jax.io.video import export_video
    from ltx_jax.serve.app import build_app
    from ltx_jax.serve.server import serve_forever_threaded

    clip = np.random.default_rng(3).uniform(size=(24, 64, 64, 3)) \
        .astype(np.float32)
    root = tmp_path / "media"
    root.mkdir()
    export_video(clip, str(root / "in.mp4"))

    app = build_app(pipe, output_dir=str(tmp_path / "out"), port=0,
                    image_root=str(root))
    serve_forever_threaded(app.server)
    host, port = app.server.server_address[:2]
    base = f"http://{host}:{port}"

    def post(body):
        req = urllib.request.Request(
            base + "/v1/generate", json.dumps(body).encode(),
            {"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req).read())

    try:
        body = {"kind": "extend", "prompt": "the story continues",
                "video_path": "in.mp4", "cond_frames": 9, "width": 64,
                "height": 64, "num_frames": 17, "num_steps": 2, "seed": 4}
        job_id = post(body)["job_id"]
        rec = app.jobs.wait(job_id, timeout=600)
        assert rec["state"] == "done", rec
        assert os.path.getsize(rec["result"]["output"]) > 0

        with pytest.raises(urllib.error.HTTPError) as ei:
            post({**body, "cond_frames": 8})  # not 8k+1 -> 400 at the door
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({**body, "cond_frames": 17})  # >= num_frames
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({**body, "video_path": "../../etc/passwd"})
        assert ei.value.code == 400
    finally:
        app.close()
