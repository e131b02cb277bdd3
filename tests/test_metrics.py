"""serve/metrics.py: Prometheus-exposition primitives + end-to-end scrape
through the HTTP server (beyond parity — reference has no serving/metrics)."""

import json
import time
import urllib.error
import urllib.request

import pytest

from ltx_jax.serve.batcher import MicroBatcher
from ltx_jax.serve.jobs import JobQueue
from ltx_jax.serve.metrics import (
    Counter, Gauge, Histogram, Registry, ServeMetrics,
)
from ltx_jax.serve.server import (
    enhance_group_key, make_server, serve_forever_threaded,
)


def test_counter_labels_and_render():
    c = Counter("t_total", "help", ("route", "code"))
    c.inc(route="/a", code="200")
    c.inc(2, route="/a", code="200")
    c.inc(route="/b", code="500")
    assert c.value(route="/a", code="200") == 3
    lines = list(c.render())
    assert 't_total{route="/a",code="200"} 3' in lines
    assert 't_total{route="/b",code="500"} 1' in lines


def test_histogram_cumulative_buckets():
    h = Histogram("t_seconds", "help", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    lines = list(h.render())
    assert 't_seconds_bucket{le="0.1"} 1' in lines
    assert 't_seconds_bucket{le="1"} 3' in lines
    assert 't_seconds_bucket{le="10"} 4' in lines
    assert 't_seconds_bucket{le="+Inf"} 5' in lines
    assert "t_seconds_count 5" in lines
    count, total = h.summary()
    assert count == 5 and total == pytest.approx(56.05)


def test_histogram_labelled_series_are_independent():
    h = Histogram("t", "help", ("kind",), buckets=(1.0,))
    h.observe(0.5, kind="a")
    h.observe(2.0, kind="b")
    assert h.summary(kind="a") == (1, 0.5)
    assert h.summary(kind="b") == (1, 2.0)


def test_gauge_callback_and_failure_isolation():
    g = Gauge("g", "help", fn=lambda: 7)
    assert list(g.render()) == ["g 7"]
    bad = Gauge("bad", "help", fn=lambda: 1 / 0)
    assert list(bad.render()) == ["bad NaN"]  # scrape never raises


def test_registry_render_has_help_and_type():
    r = Registry()
    c = r.register(Counter("x_total", "counts x"))
    c.inc()
    text = r.render()
    assert "# HELP x_total counts x" in text
    assert "# TYPE x_total counter" in text
    assert "x_total 1" in text


def test_servemetrics_hooks():
    m = ServeMetrics()
    m.on_batch(0.2, 4, True)
    m.on_batch(0.3, 2, False)
    m.on_job("t2v", "done", 12.0)
    assert m.enhance_rows_total.value(outcome="done") == 4
    assert m.enhance_rows_total.value(outcome="failed") == 2
    assert m.enhance_batch_seconds.summary() == (2, pytest.approx(0.5))
    assert m.job_seconds.summary(kind="t2v", state="done") == (
        1, pytest.approx(12.0))


# --- end-to-end scrape through the HTTP server ---


def _get_text(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def metrics_app():
    metrics = ServeMetrics()
    batcher = MicroBatcher(
        lambda batch: [p["prompt"].upper() for p in batch],
        max_batch=4, batch_window_s=0.0, group_key=enhance_group_key,
        name="enhance", on_batch=metrics.on_batch)
    jobs = JobQueue(lambda job: {"output": "x.mp4"}, on_job=metrics.on_job)
    srv = make_server(jobs, batcher=batcher, port=0, metrics=metrics)
    serve_forever_threaded(srv)
    base = "http://%s:%d" % srv.server_address[:2]
    yield base, jobs
    srv.shutdown()
    srv.server_close()
    batcher.close()
    jobs.close()


def test_metrics_endpoint_scrape(metrics_app):
    base, jobs = metrics_app
    code, out = _post(base + "/v1/enhance", {"prompts": ["hello"]})
    assert code == 200 and out["prompts"] == ["HELLO"]
    code, out = _post(base + "/v1/generate", {"prompt": "p"})
    assert code == 202
    jobs.wait(out["job_id"], timeout=30)
    # bounded wait: the on_job hook fires on the worker thread just after
    # the state transition wait() observes
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        status, text = _get_text(base + "/metrics")
        if "ltx_job_seconds_count" in text:
            break
        time.sleep(0.02)
    assert status == 200
    assert 'ltx_http_requests_total{route="/v1/enhance",method="POST",' \
           'code="200"} 1' in text
    assert "ltx_enhance_batch_seconds_count 1" in text
    assert 'ltx_enhance_rows_total{outcome="done"} 1' in text
    assert 'ltx_job_seconds_count{kind="t2v",state="done"} 1' in text
    assert "ltx_jobs_queued 0" in text
    assert "ltx_enhance_pending 0" in text
    assert "ltx_http_request_seconds_bucket" in text
    # alias route + bounded label cardinality for per-job paths
    status2, _ = _get_text(base + "/v1/metrics")
    assert status2 == 200
    _get_text(base + "/v1/jobs")  # list ok
    _post(base + "/v1/enhance", {"prompts": ["x"], "max_tokens": -1})  # 400
    _, text = _get_text(base + "/metrics")
    assert 'code="400"} 1' in text
    assert '/v1/jobs/{id}' not in text  # no per-id series yet
    buckets = [ln for ln in text.splitlines()
               if ln.startswith("ltx_http_request_seconds_bucket")
               and 'le="+Inf"' in ln and '/v1/enhance' in ln]
    assert buckets and all(int(ln.rsplit(" ", 1)[1]) >= 1 for ln in buckets)


def test_route_label_closed_set():
    """Label cardinality is bounded by a CLOSED route set: job ids collapse
    to one template and arbitrary (scanned-404) paths collapse to "other"."""
    from ltx_jax.serve.server import _route_label

    assert _route_label("/v1/jobs/abc-123") == "/v1/jobs/{id}"
    assert _route_label("/v1/enhance?verbose=1") == "/v1/enhance"
    assert _route_label("/healthz") == "/healthz"
    for probe in ("/admin", "/.env", "/etc/passwd", "/v2/whatever",
                  "/v1/enhance/extra"):
        assert _route_label(probe) == "other", probe
