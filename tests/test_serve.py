"""Serving subsystem: micro-batcher, job queue, HTTP front-end.

The device-facing callables are injected fakes (the batching/queueing/HTTP
logic is device-independent); one test drives the REAL tiny pipeline
through build_app end-to-end (HTTP request -> job -> MP4 on disk).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from ltx_jax.serve.batcher import MicroBatcher
from ltx_jax.serve.jobs import JobQueue
from ltx_jax.serve.server import (
    enhance_group_key,
    make_server,
    serve_forever_threaded,
)


# ---------------------------------------------------------------------------
# MicroBatcher
# ---------------------------------------------------------------------------


def test_batcher_coalesces_concurrent_submissions():
    sizes = []

    def run(batch):
        sizes.append(len(batch))
        time.sleep(0.02)  # simulate device time so later submits queue up
        return [p * 2 for p in batch]

    b = MicroBatcher(run, max_batch=8, batch_window_s=0.25)
    futs = [b.submit(i) for i in range(6)]
    assert [f.result(timeout=10) for f in futs] == [0, 2, 4, 6, 8, 10]
    b.close()
    # the 0.25 s window comfortably covers six immediate submits: they must
    # NOT run as six single-row batches
    assert len(sizes) <= 2 and sum(sizes) == 6
    st = b.stats()
    assert st["requests_done"] == 6 and st["requests_failed"] == 0


def test_batcher_respects_max_batch():
    sizes = []

    def run(batch):
        sizes.append(len(batch))
        return batch

    b = MicroBatcher(run, max_batch=3, batch_window_s=0.1)
    futs = b.submit_many(list(range(7)))
    assert [f.result(timeout=10) for f in futs] == list(range(7))
    b.close()
    assert max(sizes) <= 3 and sum(sizes) == 7


def test_batcher_groups_by_key():
    batches = []

    def run(batch):
        batches.append(list(batch))
        return [p["v"] for p in batch]

    b = MicroBatcher(run, max_batch=8, batch_window_s=0.15,
                     group_key=lambda p: p["k"])
    payloads = [{"k": "a", "v": 1}, {"k": "b", "v": 2},
                {"k": "a", "v": 3}, {"k": "b", "v": 4}]
    futs = b.submit_many(payloads)
    assert [f.result(timeout=10) for f in futs] == [1, 2, 3, 4]
    b.close()
    for batch in batches:
        assert len({p["k"] for p in batch}) == 1  # never mixed
    assert sum(len(bt) for bt in batches) == 4


def test_batcher_error_fails_only_its_batch():
    def run(batch):
        if any(p == "bad" for p in batch):
            raise RuntimeError("device OOM")
        return batch

    # group bad/good separately so they can't share a batch
    b = MicroBatcher(run, max_batch=4, batch_window_s=0.05,
                     group_key=lambda p: p)
    bad = b.submit("bad")
    good = b.submit("good")
    with pytest.raises(RuntimeError, match="device OOM"):
        bad.result(timeout=10)
    assert good.result(timeout=10) == "good"
    b.close()
    st = b.stats()
    assert st["requests_failed"] == 1 and st["requests_done"] == 1


def test_batcher_result_count_mismatch_is_an_error():
    b = MicroBatcher(lambda batch: batch[:-1], max_batch=4,
                     batch_window_s=0.05)
    futs = b.submit_many([1, 2])
    for f in futs:
        with pytest.raises(RuntimeError, match="results"):
            f.result(timeout=10)
    b.close()


def test_batcher_rejects_after_close():
    b = MicroBatcher(lambda batch: batch, max_batch=2)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(1)


# ---------------------------------------------------------------------------
# JobQueue
# ---------------------------------------------------------------------------


def test_jobqueue_lifecycle_and_failure():
    def run(job):
        if job.request.get("boom"):
            raise ValueError("bad request payload")
        return {"echo": job.request["x"]}

    q = JobQueue(run)
    ok = q.submit("t2v", {"x": 7})
    bad = q.submit("t2v", {"x": 0, "boom": True})
    d_ok = q.wait(ok, timeout=10)
    d_bad = q.wait(bad, timeout=10)
    q.close()
    assert d_ok["state"] == "done" and d_ok["result"] == {"echo": 7}
    assert d_ok["started_at"] >= d_ok["submitted_at"]
    assert d_ok["finished_at"] >= d_ok["started_at"]
    assert d_bad["state"] == "failed"
    assert "bad request payload" in d_bad["error"]
    # FIFO order preserved in the record list (newest first)
    jobs = q.list_jobs()
    assert [j["job_id"] for j in jobs] == [bad, ok]


def test_jobqueue_cancel_pending_but_not_running():
    release = threading.Event()
    started = threading.Event()

    def run(job):
        started.set()
        release.wait(10)
        return {}

    q = JobQueue(run)
    first = q.submit("t2v", {})
    assert started.wait(10)
    second = q.submit("t2v", {})
    assert q.cancel(second) is True  # pending -> cancellable
    assert q.cancel(first) is False  # running -> not
    release.set()
    d1 = q.wait(first, timeout=10)
    q.close()
    assert d1["state"] == "done"
    assert q.get(second)["state"] == "cancelled"
    assert q.get("nonexistent") is None


def test_jobqueue_shares_device_lock_with_batcher():
    """Enhance batches and generation jobs never overlap on the chip."""
    lock = threading.Lock()
    active = []

    def enter(tag):
        active.append(tag)
        assert len(active) == 1, f"device overlap: {active}"
        time.sleep(0.01)
        active.remove(tag)

    b = MicroBatcher(lambda batch: (enter("enhance"), batch)[1],
                     max_batch=4, batch_window_s=0, device_lock=lock)
    q = JobQueue(lambda job: (enter("job"), {})[1], device_lock=lock)
    futs = b.submit_many(list(range(4)))
    ids = [q.submit("t2v", {}) for _ in range(4)]
    for f in futs:
        f.result(timeout=10)
    for i in ids:
        q.wait(i, timeout=10)
    b.close()
    q.close()


# ---------------------------------------------------------------------------
# HTTP server (fake device callables)
# ---------------------------------------------------------------------------


@pytest.fixture()
def http_app():
    batcher = MicroBatcher(
        lambda batch: [p["prompt"].upper() for p in batch],
        max_batch=4, batch_window_s=0.05, group_key=enhance_group_key,
        name="enhance")

    def run_job(job):
        if job.request.get("boom"):
            raise RuntimeError("synthetic failure")
        return {"output": f"/tmp/{job.job_id}.mp4"}

    jobs = JobQueue(run_job)
    srv = make_server(jobs, batcher=batcher,
                      info_fn=lambda: {"model": "tiny"},
                      validate_fn=lambda body: body.get("invalid") and
                      "synthetic validation error",
                      port=0)
    serve_forever_threaded(srv)
    base = "http://%s:%d" % srv.server_address[:2]
    yield base
    srv.shutdown()
    srv.server_close()
    batcher.close()
    jobs.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, obj=None, raw=None, method="POST"):
    data = raw if raw is not None else json.dumps(obj or {}).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_health_models_stats(http_app):
    assert _get(http_app + "/healthz") == (200, {"status": "ok"})
    assert _get(http_app + "/v1/models") == (200, {"model": "tiny"})
    code, stats = _get(http_app + "/v1/stats")
    assert code == 200 and "enhance" in stats and "jobs" in stats
    assert _get(http_app + "/nope")[0] == 404


def test_http_enhance_roundtrip(http_app):
    code, out = _post(http_app + "/v1/enhance",
                      {"prompts": ["a cat", "a dog"]})
    assert code == 200 and out == {"prompts": ["A CAT", "A DOG"]}
    # validation
    assert _post(http_app + "/v1/enhance", {"prompts": []})[0] == 400
    assert _post(http_app + "/v1/enhance", {"prompts": [3]})[0] == 400
    assert _post(http_app + "/v1/enhance", raw=b"{nope")[0] == 400
    assert _post(http_app + "/v1/enhance", raw=b"[1,2]")[0] == 400


def test_http_concurrent_enhance_coalesces(http_app):
    """Two concurrent HTTP clients land in ONE compiled batch."""
    results = {}

    def call(name):
        results[name] = _post(http_app + "/v1/enhance",
                              {"prompts": [name]})

    threads = [threading.Thread(target=call, args=(n,))
               for n in ("alpha", "beta", "gamma")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in ("alpha", "beta", "gamma"):
        assert results[n] == (200, {"prompts": [n.upper()]})
    _, stats = _get(http_app + "/v1/stats")
    sizes = stats["enhance"]["recent_batch_sizes"]
    assert sum(sizes) == 3 and len(sizes) <= 2  # coalesced, not 3 singles


def test_http_generate_job_lifecycle(http_app):
    code, out = _post(http_app + "/v1/generate", {"prompt": "hello"})
    assert code == 202 and "job_id" in out
    jid = out["job_id"]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        code, job = _get(http_app + f"/v1/jobs/{jid}")
        assert code == 200
        if job["state"] not in ("pending", "running"):
            break
        time.sleep(0.01)
    assert job["state"] == "done"
    assert job["result"]["output"].endswith(f"{jid}.mp4")
    # failure surfaces in the record, not as a 500
    _, out2 = _post(http_app + "/v1/generate",
                    {"prompt": "x", "boom": True})
    jid2 = out2["job_id"]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        _, job2 = _get(http_app + f"/v1/jobs/{jid2}")
        if job2["state"] not in ("pending", "running"):
            break
        time.sleep(0.01)
    assert job2["state"] == "failed" and "synthetic failure" in job2["error"]
    # listing + 404 + cancel-done conflict
    code, lst = _get(http_app + "/v1/jobs")
    assert code == 200 and {j["job_id"] for j in lst["jobs"]} >= {jid, jid2}
    assert _get(http_app + "/v1/jobs/zzz")[0] == 404
    assert _post(http_app + f"/v1/jobs/{jid}", method="DELETE")[0] == 409


def test_http_generate_validation(http_app):
    assert _post(http_app + "/v1/generate", {})[0] == 400
    assert _post(http_app + "/v1/generate",
                 {"prompt": "x", "kind": "zzz"})[0] == 400
    code, out = _post(http_app + "/v1/generate",
                      {"prompt": "x", "invalid": True})
    assert code == 400 and "synthetic validation error" in out["error"]


# ---------------------------------------------------------------------------
# build_app with the REAL tiny pipeline
# ---------------------------------------------------------------------------


def test_build_app_tiny_pipeline_end_to_end(tmp_path):
    import dataclasses

    from ltx_jax.pipeline.generate import LTXPipeline
    from ltx_jax.serve.app import build_app, request_to_config

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.memory = dataclasses.replace(pipe.memory,
                                      offload_text_encoder=False)
    app = build_app(pipe, output_dir=str(tmp_path), port=0)
    serve_forever_threaded(app.server)
    base = "http://%s:%d" % app.server.server_address[:2]
    try:
        # tiny pipeline has no tokenizer -> enhancement is not loaded
        assert _post(base + "/v1/enhance", {"prompts": ["x"]})[0] == 503
        # invalid config rejected at submit time (width not /32)
        code, out = _post(base + "/v1/generate",
                          {"prompt": "x", "width": 65})
        assert code == 400 and "divisible by 32" in out["error"]
        # real generation through the HTTP surface
        code, out = _post(base + "/v1/generate",
                          {"prompt": "a cat plays piano", "width": 64,
                           "height": 64, "num_frames": 9, "seed": 7})
        assert code == 202
        job = app.jobs.wait(out["job_id"], timeout=300)
        assert job["state"] == "done", job.get("error")
        assert job["result"]["frames"] == 9
        assert job["result"]["width"] == 64
        out_path = job["result"]["output"]
        assert out_path.startswith(str(tmp_path))
        import os

        assert os.path.getsize(out_path) > 0
    finally:
        app.close()


def test_request_to_config_kinds():
    from ltx_jax.core.errors import LTXError
    from ltx_jax.serve.app import request_to_config

    cfg = request_to_config({"prompt": "x", "kind": "two_stage",
                             "width": 128, "height": 128, "num_frames": 9})
    assert cfg.two_stage is True
    with pytest.raises(ValueError, match="image_path"):
        request_to_config({"prompt": "x", "kind": "i2v"})
    with pytest.raises((LTXError, ValueError)):
        request_to_config({"prompt": "x", "num_frames": 10})


def test_http_enhance_param_validation(http_app):
    """Malformed sampling params 400 at the door instead of failing the
    coalesced batch on the worker thread."""
    ok = {"prompts": ["a"]}
    assert _post(http_app + "/v1/enhance",
                 {**ok, "max_tokens": "512"})[0] == 400
    assert _post(http_app + "/v1/enhance", {**ok, "max_tokens": 0})[0] == 400
    assert _post(http_app + "/v1/enhance",
                 {**ok, "max_tokens": 10**6})[0] == 400
    assert _post(http_app + "/v1/enhance",
                 {**ok, "temperature": -1})[0] == 400
    assert _post(http_app + "/v1/enhance",
                 {**ok, "temperature": "hot"})[0] == 400
    assert _post(http_app + "/v1/enhance", {**ok, "seed": -1})[0] == 400
    assert _post(http_app + "/v1/enhance", {**ok, "i2v": "yes"})[0] == 400
    # in-bounds values still pass
    code, out = _post(http_app + "/v1/enhance",
                      {**ok, "max_tokens": 64, "temperature": 1.0,
                       "seed": 7, "i2v": True})
    assert code == 200 and out == {"prompts": ["A"]}


def test_http_request_size_limits(http_app):
    from ltx_jax.serve.server import MAX_PROMPTS_PER_REQUEST

    too_many = {"prompts": ["p"] * (MAX_PROMPTS_PER_REQUEST + 1)}
    assert _post(http_app + "/v1/enhance", too_many)[0] == 400
    # oversize bodies are rejected WITHOUT being read; depending on timing
    # the client sees the 413 or a connection reset mid-send — both mean
    # the server never buffered the 9 MB
    big = b'{"prompts": ["' + b"x" * (9 << 20) + b'"]}'
    try:
        code, _ = _post(http_app + "/v1/enhance", raw=big)
        assert code == 413
    except (urllib.error.URLError, ConnectionError):
        pass


def test_request_to_config_image_root_fence(tmp_path):
    from ltx_jax.serve.app import request_to_config

    root = tmp_path / "images"
    root.mkdir()
    (root / "ok.png").write_bytes(b"x")
    # relative path resolves under the root
    cfg = request_to_config({"prompt": "x", "kind": "i2v",
                             "image_path": "ok.png"}, image_root=root)
    assert cfg.image_path == str((root / "ok.png").resolve())
    # escapes are rejected: absolute outside, and ../ traversal
    for bad in ["/etc/hostname", "../outside.png",
                str(tmp_path / "outside.png")]:
        with pytest.raises(ValueError, match="image-root"):
            request_to_config({"prompt": "x", "kind": "i2v",
                               "image_path": bad}, image_root=root)
    # no fence -> any path accepted (trusted local default)
    cfg = request_to_config({"prompt": "x", "kind": "i2v",
                             "image_path": "/anywhere/i.png"})
    assert cfg.image_path == "/anywhere/i.png"


def test_export_config_from_request():
    from ltx_jax.serve.app import export_config_from_request

    cfg = export_config_from_request({}, fps=24.0)
    assert (cfg.codec, cfg.quality, cfg.fps) == ("h264", 0.8, 24.0)
    cfg = export_config_from_request(
        {"codec": "hevc", "export_quality": 0.95}, fps=12.0)
    assert (cfg.codec, cfg.quality) == ("hevc", 0.95)
    import pytest as _pytest
    with _pytest.raises(ValueError, match="unknown codec"):
        export_config_from_request({"codec": "vp9"}, fps=24.0)


def test_serve_warmup_precompiles_configured_shapes(tmp_path):
    """--warmup (round 5): build_app pre-compiles the T2V denoise + VAE
    programs for each configured WxHxF BEFORE the server accepts jobs —
    every shape's _start_warm_compile must run and be JOINED by the time
    build_app returns (first-job latency == steady-state)."""
    import dataclasses

    from ltx_jax.pipeline.generate import LTXPipeline, _WarmCompiles
    from ltx_jax.serve.app import build_app

    pipe = LTXPipeline.random_tiny(seed=0)
    pipe.memory = dataclasses.replace(pipe.memory,
                                      offload_text_encoder=False)
    seen = []

    class SpyWarm(_WarmCompiles):
        def __init__(self):
            super().__init__()
            self.joined = False

        def join(self, *names):
            self.joined = True
            super().join(*names)

    def spy(config, guidance, timings=None, plan=None):
        handle = SpyWarm()
        seen.append(((config.width, config.height, config.num_frames),
                     ([n for n, _ in plan] if plan is not None
                      else ["denoise", "vae"]), handle))
        if plan is None:
            # run the REAL default plan so the compile machinery executes
            handle.add("denoise",
                       lambda: pipe._warm_lowering(config, guidance))
            handle.add("vae", lambda: pipe._warm_vae_lowering(config))
        else:
            for name, thunk in plan:
                handle.add(name, thunk)
        return handle

    pipe._start_warm_compile = spy
    app = build_app(pipe, output_dir=str(tmp_path), port=0,
                    warmup_shapes=[(64, 64, 9), (128, 64, 9),
                                   (128, 128, 9, "two_stage")])
    try:
        assert [(s, p) for s, p, _ in seen] == [
            ((64, 64, 9), ["denoise", "vae"]),
            ((128, 64, 9), ["denoise", "vae"]),
            ((128, 128, 9),
             ["denoise_s1", "upscaler", "denoise_s2", "vae"]),
        ]
        assert all(h.joined for _, _, h in seen)
    finally:
        app.close()
