"""The port's serving telemetry (``telemetry/``) and fault points
(``utils/faults.py``) held against the JAX package's on the CPU: the
Prometheus text of the same registry content (exactly), snapshot records,
quantiles, structured records, request ids, spans and the flight-recorder
dump, the SLO window under a fake clock, the WSGI middleware and
``/metrics``, the counters of the same request sequence through both
single-model apps, the fault-spec grammar and each fault action; and that
no module of the port (nor ``chip_smoke.py``) imports JAX or the JAX
package.
"""

import io
import json
import logging
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.serving import app as jax_app
from sagemaker_xgboost_container_tpu.serving import lifecycle as jax_lifecycle
from sagemaker_xgboost_container_tpu.telemetry import REGISTRY as JAX_REGISTRY
from sagemaker_xgboost_container_tpu.telemetry import correlation as jax_correlation
from sagemaker_xgboost_container_tpu.telemetry import emit as jax_emit
from sagemaker_xgboost_container_tpu.telemetry import prometheus as jax_prometheus
from sagemaker_xgboost_container_tpu.telemetry import registry as jax_registry
from sagemaker_xgboost_container_tpu.telemetry import slo as jax_slo
from sagemaker_xgboost_container_tpu.telemetry import tracing as jax_tracing
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu_torch.serving import app, lifecycle
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY
from sagemaker_xgboost_container_tpu_torch.telemetry import (
    correlation,
    emit,
    prometheus,
    registry,
    slo,
    tracing,
    wsgi,
)
from sagemaker_xgboost_container_tpu_torch.utils import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No lifecycle installed, faults disarmed, tracing and SLO state reset,
    in both packages, before and after each test."""
    monkeypatch.setenv("GRAFT_PREDICT_WARMUP", "0")
    for mod in (lifecycle, jax_lifecycle):
        mod.uninstall()
    for mod in (faults, jax_faults):
        mod.reset()
    for mod in (tracing, jax_tracing, slo, jax_slo):
        mod._reset_for_tests()
    yield
    for mod in (lifecycle, jax_lifecycle):
        mod.uninstall()
    for mod in (faults, jax_faults):
        mod.reset()
    for mod in (tracing, jax_tracing, slo, jax_slo):
        mod._reset_for_tests()


# -------------------------------------------------------- registry + text

def _fill(reg_mod, seed):
    """A registry of each package filled by the same random operations:
    counters, gauges (NaN, infinities, floats, integers) and histograms
    (default, power-of-two and custom buckets), labels needing escapes."""
    reg = reg_mod.MetricsRegistry()
    rng = np.random.RandomState(seed)
    labels = [{}, {"route": "/ping", "code": "2xx"}, {"batcher": 'we"ird\\name\nx'},
              {"stage": "decode"}, {"z": "1", "a": "2"}]
    for i in range(60):
        lab = labels[rng.randint(len(labels))]
        kind = rng.randint(3)
        name = "m{}_{}".format(["c", "g", "h"][kind], rng.randint(3))
        help_text = "help of {}\nline two \\ slash".format(name) if rng.rand() < 0.7 else ""
        if kind == 0:
            reg.counter(name, help_text, lab).inc(float(rng.choice([1, 2.5, 0.1, 1e-7])))
        elif kind == 1:
            reg.gauge(name, help_text, lab).set(
                float(rng.choice([np.nan, np.inf, -np.inf, 3.0, -0.25, 1e20, 7.125])))
        else:
            buckets = [None, reg_mod.POW2_BUCKETS, (0.5, 0.1, 2.0)][rng.randint(3)]
            h = reg.histogram(name + ("p" if buckets else ""), help_text, lab, buckets)
            for v in rng.exponential(0.5, size=rng.randint(1, 8)):
                h.observe(float(v))
    return reg


@pytest.mark.parametrize("seed", range(8))
def test_exposition_equals_jax_for_the_same_content(seed):
    ours = _fill(registry, seed)
    ref = _fill(jax_registry, seed)
    text = prometheus.render_text(ours)
    assert text == jax_prometheus.render_text(ref)
    assert text.endswith("\n") and "# TYPE" in text
    assert prometheus.CONTENT_TYPE == jax_prometheus.CONTENT_TYPE


@pytest.mark.parametrize("seed", range(4))
def test_snapshot_fields_equal_jax(seed):
    ours = emit.snapshot_fields(_fill(registry, seed))
    ref = jax_emit.snapshot_fields(_fill(jax_registry, seed))
    assert sorted(ours) == sorted(ref)
    for key in ours:
        a, b = ours[key], ref[key]
        assert (a == b) or (math.isnan(a) and math.isnan(b)), key


@pytest.mark.parametrize("q", [0.0, 0.05, 0.5, 0.95, 0.99, 1.0])
def test_quantiles_equal_jax(q):
    values = list(np.random.RandomState(3).lognormal(-4, 1.5, size=500))
    assert registry.percentile(values, q) == jax_registry.percentile(values, q)
    ours = registry.Histogram("h")
    ref = jax_registry.Histogram("h")
    for v in values:
        ours.observe(v)
        ref.observe(v)
    assert ours.quantile(q) == ref.quantile(q)
    assert ours.snapshot() == ref.snapshot()


def test_registry_identity_kinds_and_retirement():
    reg = registry.MetricsRegistry()
    assert reg.counter("x", labels={"a": "1"}) is reg.counter("x", labels={"a": "1"})
    with pytest.raises(ValueError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.counter("y").inc(-1)
    for model in ("m1", "m2"):
        reg.counter("batcher_requests_total", labels={"batcher": model}).inc()
        reg.gauge("batcher_queue_depth", labels={"batcher": model}).set(1)
    assert reg.remove_matching("batcher", "m1") == 2
    text = prometheus.render_text(reg)
    assert 'batcher="m1"' not in text and 'batcher="m2"' in text


def test_emit_metric_line_equals_jax(capsys, monkeypatch):
    fields = {"state": "ready", "prev": None, "n": 3, "ratio": 0.5, "obj": object}
    ours = emit.emit_metric("serving.lifecycle", **fields)
    ref = jax_emit.emit_metric("serving.lifecycle", **fields)
    assert ours == ref and "\t" not in ours
    assert capsys.readouterr().out.splitlines() == [ours, ref]
    monkeypatch.setenv(emit.STRUCTURED_METRICS_ENV, "false")
    assert emit.emit_metric("serving.lifecycle", state="x") is None
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("environ", [
    {"HTTP_X_REQUEST_ID": "abc-123.XY_z"},
    {"HTTP_X_REQUEST_ID": "bad id\nwith<script>" + "x" * 80},
    {"HTTP_X_AMZN_SAGEMAKER_CUSTOM_ATTRIBUTES": "foo=1, trace_id=t-9 ,request_id=r1"},
    {"HTTP_X_AMZN_SAGEMAKER_CUSTOM_ATTRIBUTES": "Request_ID=Q7"},
    {"HTTP_X_REQUEST_ID": "\n\t", "HTTP_X_AMZN_SAGEMAKER_CUSTOM_ATTRIBUTES": "trace_id=fb"},
])
def test_request_id_extraction_equals_jax(environ):
    assert correlation.extract_request_id(environ) == jax_correlation.extract_request_id(environ)


def test_request_id_generated_and_log_filter():
    rid = correlation.extract_request_id({})
    assert len(rid) == 32 and int(rid, 16) >= 0
    record = logging.LogRecord("x", logging.INFO, __file__, 1, "hello", None, None)
    filt = correlation.RequestIdFilter()
    filt.filter(record)
    assert record.request_id == "-" and record.msg == "hello"
    correlation.set_request_id("r-1")
    try:
        filt.filter(record)
        filt.filter(record)  # idempotent across handlers
    finally:
        correlation.clear_request_id()
    assert record.request_id == "r-1" and record.msg == "hello [rid=r-1]"


# ----------------------------------------------------------------- tracing

def _spans(mod):
    with mod.trace_span("http.request", attributes={"route": "/ping"}, trace_id="t1",
                        root=True):
        with mod.trace_span("batcher.queue", attributes={"rows": 3}):
            pass
        ctx = mod.current_context()
    mod.finish_span(mod.start_span("batcher.dispatch", parent=ctx))
    return mod.start_span("wedged", attributes={"rows": 7})


def _shape(doc):
    return [(e["name"], e["ph"], sorted(e["args"])) for e in doc["traceEvents"]
            if e["ph"] == "X"]


def test_flight_recorder_dump_like_jax(monkeypatch, tmp_path):
    """The same span sequence in both packages: the dumps hold the same
    spans, links and in-flight flags, and the tree's parent ids agree."""
    monkeypatch.setenv("SM_TRACE", "1")
    docs = []
    for mod, sub in ((tracing, "ours"), (jax_tracing, "ref")):
        monkeypatch.setenv("SM_TRACE_EXPORT_DIR", str(tmp_path / sub))
        wedged = _spans(mod)
        path = mod.dump_flight_recorder(reason="predict_stuck", exit_code=84)
        assert os.path.basename(path) == "flight-recorder-rank0.json"
        with open(path) as f:
            docs.append(json.load(f))
        mod.finish_span(wedged)
    ours, ref = docs
    assert _shape(ours) == _shape(ref)
    assert ours["otherData"]["abort_reason"] == "predict_stuck"
    assert ours["otherData"]["exit_code"] == 84 and ours["otherData"]["spans"] == 4
    events = {e["name"]: e for e in ours["traceEvents"] if e["ph"] == "X"}
    assert events["wedged"]["args"]["in_flight"] is True
    assert events["batcher.queue"]["args"]["parent_id"] == events["http.request"]["args"][
        "span_id"]
    assert events["batcher.dispatch"]["args"]["parent_id"] == events["http.request"]["args"][
        "span_id"]
    assert events["http.request"]["args"]["trace_id"] == "t1"


def test_tracing_off_records_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("SM_TRACE_EXPORT_DIR", str(tmp_path))
    assert not tracing.enabled()
    with tracing.trace_span("x") as span:
        assert span is None
    assert tracing.start_span("y") is None and tracing.current_context() is None
    assert tracing.dump_flight_recorder(reason="r") is None
    assert os.listdir(tmp_path) == []


def test_device_sync_is_a_span_every_nth_cuda_call(monkeypatch):
    """SM_TRACE_DEVICE_SYNC=2: every second predict on a CUDA device waits
    for the card in a device_sync span; a CPU device never does."""
    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    monkeypatch.setenv("SM_TRACE", "true")
    monkeypatch.setenv("SM_TRACE_DEVICE_SYNC", "2")
    for _ in range(4):
        tracing.device_sync(torch.device("cuda"))
        tracing.device_sync(torch.device("cpu"))
    assert calls == [torch.device("cuda")] * 2
    names = [s.name for s in tracing.snapshot_spans()]
    assert names == ["device_sync", "device_sync"]
    tracing._reset_for_tests()
    monkeypatch.delenv("SM_TRACE")
    tracing.device_sync(torch.device("cuda"))
    assert len(calls) == 2


# --------------------------------------------------------------------- SLO

def test_slo_window_equals_jax_under_a_fake_clock():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    ours = slo.SloWindow(50.0, window_s=10.0, registry=registry.MetricsRegistry(), clock=clock)
    ref = jax_slo.SloWindow(50.0, window_s=10.0, registry=jax_registry.MetricsRegistry(),
                            clock=clock)
    rng = np.random.RandomState(4)
    for step in range(120):
        now[0] += float(rng.exponential(0.2))
        ms = float(rng.choice([5.0, 30.0, 80.0, 200.0], p=[0.5, 0.3, 0.15, 0.05]))
        ours.observe_ms(ms)
        ref.observe_ms(ms)
        assert ours.degraded == ref.degraded, step
        assert ours.snapshot() == ref.snapshot(), step
    assert ours._m_violations.value == ref._m_violations.value > 0


def test_slo_window_is_off_without_its_knob(monkeypatch):
    assert slo.maybe_install() is None and slo.active_window() is None
    monkeypatch.setenv(slo.SLO_P95_ENV, "25")
    reg = registry.MetricsRegistry()
    window = slo.maybe_install(reg)
    assert window is slo.maybe_install(reg) and window.target_p95_ms == 25.0
    assert "serving_slo_burn_rate 0" in prometheus.render_text(reg)


# ---------------------------------------------------------------- /metrics

def _call(wsgi_app, path="/invocations", method="POST", body=b"", content_type="text/csv",
          headers=None):
    environ = {"PATH_INFO": path, "REQUEST_METHOD": method, "CONTENT_TYPE": content_type,
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    environ.update(headers or {})
    got = {}

    def start_response(status, hdrs, exc_info=None):
        got["status"] = int(status.split()[0])
        got["headers"] = dict(hdrs)

    result = wsgi_app(environ, start_response)
    out = b"".join(result)
    close = getattr(result, "close", None)
    if close is not None:
        close()
    return got["status"], got["headers"], out


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = rng.randn(400, D).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    forest = jax_booster.train({"objective": "binary:logistic", "max_depth": 3, "max_bin": 16},
                               JaxDataMatrix(X, y), 3)
    d = tmp_path_factory.mktemp("telemetry-model")
    forest.save_model(str(d / "xgboost-model"))
    return str(d)


def _csv(n, seed=1):
    X = np.random.RandomState(seed).randn(n, D)
    return "\n".join(",".join("%.6f" % v for v in row) for row in X).encode()


def test_metrics_route_is_gated(model_dir, monkeypatch):
    wsgi_app = app.make_app(app.ScoringService(model_dir, device="cpu"))
    assert _call(wsgi_app, "/metrics", "GET")[0] == 404
    assert _call(wsgi_app, "/ping", "GET")[0] == 200
    monkeypatch.setenv(wsgi.METRICS_ENDPOINT_ENV, "true")
    status, headers, body = _call(wsgi_app, "/metrics", "GET")
    assert status == 200 and headers["Content-Type"] == prometheus.CONTENT_TYPE
    assert "serving_requests_total" in body.decode()


def _counters(reg, prefixes=("serving_requests_total", "batcher_", "serving_shed_total")):
    """Counter values (and histogram counts) by series, time-free."""
    out = {}
    for name, kind, _help, series in reg.collect():
        if not name.startswith(prefixes):
            continue
        for metric in series:
            key = (name, tuple(sorted(metric.labels.items())))
            if kind == "histogram":
                out[key] = metric.count
            elif kind == "counter":
                out[key] = metric.value
    return out


def test_counters_equal_jax_after_the_same_requests(model_dir, monkeypatch):
    """The same request sequence through the JAX single-model app and the
    port's, each on its own process-wide registry (reset first): the same
    counter series with the same values, and the same request-id echo."""
    monkeypatch.setenv(wsgi.METRICS_ENDPOINT_ENV, "true")
    REGISTRY.reset()
    JAX_REGISTRY.reset()
    ours = app.make_app(app.ScoringService(model_dir, device="cpu"))
    ref = jax_app.make_app(jax_app.ScoringService(model_dir))
    requests = [
        dict(path="/ping", method="GET"),
        dict(body=_csv(1)), dict(body=_csv(5)), dict(body=_csv(40)), dict(body=_csv(100, 2)),
        dict(body=b""), dict(body=b"<x/>", content_type="application/xml"),
        dict(body=_csv(3), headers={"HTTP_ACCEPT": "text/html"}),
        dict(path="/execution-parameters", method="GET"), dict(path="/nope", method="GET"),
        dict(body=_csv(2), headers={"HTTP_X_REQUEST_ID": "client-7"}),
        dict(path="/metrics", method="GET"),
    ]
    for req in requests:
        a = _call(ours, **req)
        b = _call(ref, **req)
        assert a[0] == b[0], req
        if req.get("path") != "/metrics":
            assert ("X-Request-Id" in a[1]) == ("X-Request-Id" in b[1])
        if "headers" in req and "HTTP_X_REQUEST_ID" in req["headers"]:
            assert a[1]["X-Request-Id"] == b[1]["X-Request-Id"] == "client-7"
    got, want = _counters(REGISTRY), _counters(JAX_REGISTRY)
    assert got == want and got[("serving_requests_total",
                                (("code", "2xx"), ("route", "/invocations")))] == 6.0
    # the same families, the runtime gauges a scrape refreshes included
    ours_names = {n for n, *_ in REGISTRY.collect()}
    jax_names = {n for n, *_ in JAX_REGISTRY.collect()}
    assert {"device_live_bytes", "process_open_fds", "process_rss_bytes",
            "process_threads"} <= ours_names
    assert ours_names == jax_names


def test_app_exception_counts_5xx_and_releases_the_latch():
    lc = lifecycle.install(lifecycle.ServingLifecycle(registry=registry.MetricsRegistry()))
    reg = registry.MetricsRegistry()

    def broken(environ, start_response):
        raise RuntimeError("boom")

    wrapped = wsgi.instrument_wsgi(broken, registry=reg)
    with pytest.raises(RuntimeError):
        _call(wrapped, "/invocations")
    assert lc.inflight == 0
    assert reg.counter("serving_requests_total",
                       labels={"route": "/invocations", "code": "5xx"}).value == 1.0


@pytest.mark.parametrize("path,label", [
    ("/ping", "/ping"), ("/invocations", "/invocations"), ("/models/abc/invoke", "/models"),
    ("/models", "/models"), ("/../etc/passwd", "other"), ("/metricsx", "other")])
def test_route_labels_are_a_closed_set(path, label):
    from sagemaker_xgboost_container_tpu.telemetry import wsgi as jax_wsgi

    assert wsgi._route_label(path) == jax_wsgi._route_label(path) == label


def test_metrics_reporter_emits_snapshots_and_stops(capsys, monkeypatch):
    """SM_METRICS_EMIT_INTERVAL_S: one serving.snapshot record of the
    registry an interval, the JAX package's fields; off when unset."""
    from sagemaker_xgboost_container_tpu_torch.serving import server

    assert server.start_metrics_reporter() is None
    monkeypatch.setenv(server.METRICS_INTERVAL_ENV, "bad")
    assert server.start_metrics_reporter() is None
    reg = registry.MetricsRegistry()
    reg.counter("serving_requests_total", labels={"route": "/ping", "code": "2xx"}).inc(3)
    reg.histogram("serving_request_seconds", labels={"route": "/ping"}).observe(0.004)
    reporter = server.start_metrics_reporter(interval=0.05, registry=reg)
    deadline = time.monotonic() + 10
    while capsys.readouterr().out.count('"serving.snapshot"') < 1:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    reporter.stop()
    assert not reporter._thread.is_alive()
    capsys.readouterr()
    time.sleep(0.15)
    assert capsys.readouterr().out == ""
    line = emit.emit_metric("serving.snapshot", **emit.snapshot_fields(reg))
    record = json.loads(line)
    assert record["serving_requests_total{code=2xx,route=/ping}"] == 3.0
    assert record["serving_request_seconds{route=/ping}_count"] == 1


# ------------------------------------------------------------------ faults

@pytest.mark.parametrize("spec,hits", [
    ("p:error:boom", 4), ("p:error@2", 4), ("p:drop@3+", 5), ("a:sleep:0.01;p:error", 3),
    ("p:bogus, p:error@x, q:sleep:notanumber, p:error@2", 3), ("p:error@0,p:drop", 2),
    ("", 2), ("p:nan@2", 3)])
def test_fault_grammar_and_counts_equal_jax(spec, hits):
    outcomes = []
    for mod in (faults, jax_faults):
        mod.configure(spec)
        seen = []
        for _ in range(hits):
            try:
                seen.append(("ok", mod.fault_point("p"), mod.fault_point("a")))
            except OSError as e:
                seen.append((type(e).__name__, str(e)))
        outcomes.append((seen, mod.fault_counts()))
        mod.reset()
    assert outcomes[0] == outcomes[1]


def test_fault_spec_from_env(monkeypatch):
    monkeypatch.setenv(faults.FAULT_SPEC_ENV, "serving.decode:error:bad")
    faults.configure_from_env()
    with pytest.raises(OSError, match="bad"):
        faults.fault_point("serving.decode", content_type="text/csv")
    assert faults.fault_point("predict.dispatch") is None
    faults.reset()
    assert faults.fault_point("serving.decode") is None and faults.fault_counts() == {}


@pytest.mark.parametrize("action,expect", [
    ("exit:9", ("exit", 9)), ("exit", ("exit", 1)), ("sigterm:0", ("kill", signal.SIGTERM)),
    ("kill", ("kill", signal.SIGKILL))])
def test_process_fault_actions(monkeypatch, action, expect):
    """The actions that end or signal the process, with the exit and the
    signal faked: the same call in both packages."""
    seen = []
    for mod in (faults, jax_faults):
        monkeypatch.setattr(mod.os, "_exit", lambda code: seen.append(("exit", code)))
        monkeypatch.setattr(mod.os, "kill", lambda pid, sig: seen.append(("kill", sig)))
        mod.configure("batcher.dispatch:" + action)
        mod.fault_point("batcher.dispatch", requests=1)
    assert seen == [expect, expect]


# ----------------------------------------------------------- import hygiene

def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke.py, import with JAX and the
    JAX package blocked, and pull neither in."""
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "for name in ('jax', 'jaxlib', 'sagemaker_xgboost_container_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import sagemaker_xgboost_container_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'sagemaker_xgboost_container_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "assert 'sagemaker_xgboost_container_tpu_torch.serving.mme' in mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) > 40


# ------------------------------------------------------- the training planes
def test_metrics_render_refreshes_the_runtime_gauges(model_dir, monkeypatch):
    """``/metrics`` carries the four runtime gauge families of the JAX
    package, fresh at each scrape (RSS and fds > 0; the device bytes are 0
    on the CPU, where torch keeps no allocator tally)."""
    from sagemaker_xgboost_container_tpu_torch.telemetry import cluster

    monkeypatch.setenv(wsgi.METRICS_ENDPOINT_ENV, "true")
    wsgi_app = app.make_app(app.ScoringService(model_dir, device="cpu"))
    body = _call(wsgi_app, "/metrics", "GET")[2].decode()
    values = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            values[name] = float(value)
    assert values["process_rss_bytes"] > 0 and values["process_open_fds"] > 0
    assert values["process_threads"] >= 1 and values["device_live_bytes"] == 0
    from sagemaker_xgboost_container_tpu.telemetry import cluster as jax_cluster

    for name in ("process_rss_bytes", "process_open_fds", "process_threads",
                 "device_live_bytes"):
        assert "# HELP {} ".format(name) in body
    assert set(cluster.runtime_snapshot()) == set(jax_cluster.runtime_snapshot())


def test_runtime_gauge_help_strings_equal_jax():
    from sagemaker_xgboost_container_tpu.telemetry import cluster as jax_cluster
    from sagemaker_xgboost_container_tpu_torch.telemetry import cluster

    ours, ref = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    cluster.refresh_runtime_gauges(ours)
    jax_cluster.refresh_runtime_gauges(ref)
    assert [(n, k, h) for n, k, h, _ in ours.collect()] == \
        [(n, k, h) for n, k, h, _ in ref.collect()]


def test_kernel_builds_count_as_compiles(monkeypatch):
    from sagemaker_xgboost_container_tpu_torch.telemetry import cluster

    monkeypatch.setenv("SM_TRACE", "true")
    before = cluster.compile_stats()
    with tracing.trace_span("round"):
        cluster.note_build(1.5)
    after = cluster.compile_stats()
    assert after["count"] == before["count"] + 1
    assert after["seconds"] == pytest.approx(before["seconds"] + 1.5)
    (build,) = [s for s in tracing.snapshot_spans() if s.name == "xla.compile"]
    assert build.attributes == {"kind": "nvcc_build"} and build.dur_us == 1.5e6
    (root,) = [s for s in tracing.snapshot_spans() if s.name == "round"]
    assert build.parent_id == root.span_id


def test_round_state_snapshot_equals_jax():
    from sagemaker_xgboost_container_tpu.telemetry import cluster as jax_cluster
    from sagemaker_xgboost_container_tpu_torch.telemetry import cluster

    ours, ref = cluster.RoundState(maxlen=8), jax_cluster.RoundState(maxlen=8)
    assert ours.snapshot() == ref.snapshot()
    for rnd, seconds in enumerate(np.random.RandomState(3).rand(12)):
        ours.note_round(rnd, seconds)
        ref.note_round(rnd, seconds)
        assert ours.snapshot() == ref.snapshot()


def test_round_fields_and_spans_like_jax(capsys):
    from sagemaker_xgboost_container_tpu.telemetry import spans as jax_spans
    from sagemaker_xgboost_container_tpu_torch.telemetry import spans

    for mod in (emit, jax_emit):
        mod.set_round_fields(a=1, b="x")
        mod.set_round_fields(b=None)
    assert emit.get_round_fields() == jax_emit.get_round_fields() == {"a": 1}
    for mod in (emit, jax_emit):
        mod.set_round_fields(a=None)
    lines = []
    for mod in (spans, jax_spans):
        rec = mod.push_recorder()
        with mod.span("checkpoint"):
            pass
        with mod.span("ingest", emit=True):
            pass
        assert mod.active_recorder() is rec and set(rec.drain()) == {"checkpoint", "ingest"}
        mod.pop_recorder(rec)
        assert mod.active_recorder() is None
        lines.append(capsys.readouterr().out)
    shapes = [sorted(json.loads(line)) for line in lines]
    assert shapes[0] == shapes[1]


def test_phase_recorders_are_thread_local():
    import threading

    from sagemaker_xgboost_container_tpu_torch.telemetry import spans

    rec = spans.push_recorder()
    seen = {}

    def other():
        seen["active"] = spans.active_recorder()
        with spans.span("fold_work"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen["active"] is None
    assert rec.drain() == {}
    spans.pop_recorder(rec)


def test_export_traces_and_rank_like_jax(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("SM_TRACE", "1")
    docs = []
    for mod, sub in ((tracing, "ours"), (jax_tracing, "ref")):
        mod.set_rank(2)
        assert mod.get_rank() == 2
        with mod.trace_span("round"):
            mod.record_span("kernel", 0.25, attributes={"k": 1})
        path = mod.export_traces(default_dir=str(tmp_path / sub))
        assert os.path.basename(path) == "trace-rank2.json"
        docs.append(json.loads(open(path).read()))
        mod.set_rank(0)
    assert _shape(docs[0]) == _shape(docs[1])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if "training.trace_export" in line]
    assert [sorted(r) for r in records[:1]] == [sorted(r) for r in records[1:]]
    monkeypatch.delenv("SM_TRACE")
    tracing._reset_for_tests()
    assert tracing.export_traces(default_dir=str(tmp_path / "off")) is None
