"""The port's serving lifecycle (``serving/lifecycle.py``, the drain of
``serving/server.py``) held against the JAX package's on the CPU: state
transitions and the drain wait under a fake clock, per-stage request
deadlines through both apps of both packages, the in-flight latch, the
SIGTERM drain (in-flight answered, new work 503 + Retry-After, a wedged
drain exiting 83), and the predict watchdog (shed and recover, or exit 84).

Every test starts and ends with no lifecycle installed, faults disarmed
and tracing reset in both packages; exits are faked, never taken.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
from wsgiref.simple_server import make_server

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.serving import app as jax_app
from sagemaker_xgboost_container_tpu.serving import lifecycle as jax_lifecycle
from sagemaker_xgboost_container_tpu.serving import mme as jax_mme
from sagemaker_xgboost_container_tpu.telemetry import REGISTRY as JAX_REGISTRY
from sagemaker_xgboost_container_tpu.telemetry import registry as jax_registry
from sagemaker_xgboost_container_tpu.telemetry import tracing as jax_tracing
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu_torch.serving import app, lifecycle, mme, server
from sagemaker_xgboost_container_tpu_torch.serving.batcher import PredictBatcher
from sagemaker_xgboost_container_tpu_torch.serving.breaker import CircuitBreaker
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY, registry, tracing
from sagemaker_xgboost_container_tpu_torch.utils import faults

D = 4


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = rng.rand(300, D).astype(np.float32)
    y = (X @ rng.rand(D).astype(np.float32)).astype(np.float32)
    forest = jax_booster.train({"max_depth": 3, "objective": "reg:squarederror", "max_bin": 16},
                               JaxDataMatrix(X, y), 4)
    d = tmp_path_factory.mktemp("lifecycle-model")
    forest.save_model(str(d / "xgboost-model"))
    return str(d)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("GRAFT_PREDICT_WARMUP", "0")

    def reset():
        for mod in (lifecycle, jax_lifecycle):
            mod.uninstall()
            mod._reset_abort_for_tests()
        for mod in (faults, jax_faults):
            mod.reset()
        for mod in (tracing, jax_tracing):
            mod._reset_for_tests()

    reset()
    yield
    reset()


def _call(wsgi, method, path, body=b"", content_type="text/csv"):
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "CONTENT_LENGTH": str(len(body)),
               "CONTENT_TYPE": content_type, "wsgi.input": io.BytesIO(body)}
    captured = {}

    def start_response(status, headers, exc_info=None):
        captured["status"] = status
        captured["headers"] = headers

    result = wsgi(environ, start_response)
    out = b"".join(result)
    close = getattr(result, "close", None)
    if close is not None:
        close()  # the WSGI server does this after the write loop
    return (int(captured["status"].split()[0]), {k.lower(): v for k, v in captured["headers"]},
            out)


def _csv(n):
    return "\n".join(",".join("0.5" for _ in range(D)) for _ in range(n)).encode()


def _count(reg, name, **labels):
    for family, _kind, _help, series in reg.collect():
        if family == name:
            for metric in series:
                if metric.labels == labels:
                    return metric.value
    return 0.0


class _FakeBreaker:
    def __init__(self, degraded=False):
        self.degraded = degraded
        self.forced = []

    def force_open(self, reason="forced"):
        self.forced.append(reason)
        self.degraded = True

    def retry_after_s(self):
        return 5


# --------------------------------------------------------- state machine

def _script(mod, reg_mod):
    reg = reg_mod.MetricsRegistry()
    lc = mod.ServingLifecycle(registry=reg)
    breaker = _FakeBreaker()
    lc.note_breaker(breaker)
    seen = []

    def snap(label):
        seen.append((label, lc.state, lc.accepting, _count(reg, "serving_state")))

    snap("start")
    lc.mark_ready()
    snap("ready")
    breaker.degraded = True
    snap("degraded")
    breaker.degraded = False
    snap("recovered")
    seen.append(("drain", lc.begin_drain()))
    lc.mark_ready()  # a load finishing mid-drain never un-drains
    snap("draining")
    seen.append(("drain again", lc.begin_drain()))
    lc.mark_stopped()
    snap("stopped")
    return seen


def test_state_machine_equals_jax(capsys):
    ours = _script(lifecycle, registry)
    ours_out = capsys.readouterr().out
    ref = _script(jax_lifecycle, jax_registry)
    ref_out = capsys.readouterr().out
    assert ours == ref
    assert [s[1] for s in ours if len(s) == 4] == [
        "starting", "ready", "degraded", "ready", "draining", "stopped"]
    # one serving.lifecycle record per change, the same lines
    assert ours_out == ref_out and ours_out.count('"serving.lifecycle"') == 5


def test_knobs_resolve_once_and_malformed_action_sheds(monkeypatch):
    monkeypatch.setenv(lifecycle.REQUEST_DEADLINE_ENV, "2.5")
    monkeypatch.setenv(lifecycle.PREDICT_STUCK_ACTION_ENV, "explode")
    lc = lifecycle.ServingLifecycle(registry=registry.MetricsRegistry())
    ref = jax_lifecycle.ServingLifecycle(registry=jax_registry.MetricsRegistry())
    monkeypatch.setenv(lifecycle.REQUEST_DEADLINE_ENV, "0")
    assert lc.request_deadline_s == ref.request_deadline_s == 2.5
    assert lc.predict_stuck_action == ref.predict_stuck_action == "shed"
    assert lc.request_deadline().budget_s == 2.5
    assert lc.watchdog is None and lc.drain_timeout_s == 30.0 and lc.graceful_drain


def test_deadline_math_under_a_fake_clock():
    now = [100.0]
    clock = lambda: now[0]  # noqa: E731
    ours = lifecycle.RequestDeadline(1.0, clock=clock)
    ref = jax_lifecycle.RequestDeadline(1.0, clock=clock)
    for step in (0.25, 0.5, 0.25, 0.5):
        now[0] += step
        assert ours.remaining() == ref.remaining() and ours.expired() == ref.expired()
    before = _count(REGISTRY, "serving_deadline_exceeded_total", stage="encode")
    with pytest.raises(lifecycle.DeadlineExceeded) as e:
        ours.check("encode")
    assert isinstance(e.value, TimeoutError) and e.value.stage == "encode"
    assert _count(REGISTRY, "serving_deadline_exceeded_total", stage="encode") == before + 1
    lifecycle.note_deadline_exceeded("bogus", registry=registry.MetricsRegistry())


def test_wait_drained_under_a_fake_clock():
    """The clock jumps 100 s between its first and second read: a latch
    that never drops times out at once in both packages, without a real
    wait; one that drops from another thread drains."""
    for mod, reg_mod in ((lifecycle, registry), (jax_lifecycle, jax_registry)):
        reads = []

        def clock():
            reads.append(None)
            return 0.0 if len(reads) == 1 else 100.0

        lc = mod.ServingLifecycle(registry=reg_mod.MetricsRegistry(), clock=clock)
        lc.request_started()
        t = time.monotonic()
        assert lc.wait_drained(3.0) is False and len(reads) == 2
        assert time.monotonic() - t < 1.0
        assert lc.wait_drained(0.0) is False
        threading.Timer(0.05, lc.request_finished).start()
        assert lc.wait_drained(1e9) is True and lc.inflight == 0


# -------------------------------------------------------- deadlines per stage

STAGE_FAULTS = {"decode": "serving.decode:sleep:0.15", "predict": "predict.dispatch:sleep:0.15",
                "encode": "serving.encode:sleep:0.15"}


def _apps(kind, model_dir):
    """(port app, JAX app) of ``kind`` serving the model: the single-model
    apps, or the MMEs with the model loaded as "m"."""
    if kind == "single":
        return (app.make_app(app.ScoringService(model_dir, device="cpu")),
                jax_app.make_app(jax_app.ScoringService(model_dir)))
    ours = mme.make_mme_app(device="cpu")
    ref = jax_mme.make_mme_app()
    body = json.dumps({"model_name": "m", "url": model_dir}).encode()
    for wsgi in (ours, ref):
        assert _call(wsgi, "POST", "/models", body, "application/json")[0] == 200
    return ours, ref


@pytest.mark.parametrize("kind", ["single", "mme"])
@pytest.mark.parametrize("stage", ["decode", "predict", "encode"])
def test_deadline_expiry_per_stage_equals_jax(model_dir, monkeypatch, kind, stage):
    """SM_REQUEST_DEADLINE_S=0.05 and a 0.15 s stall in one stage: both
    packages answer 503 + Retry-After and count that stage once."""
    monkeypatch.setenv(lifecycle.REQUEST_DEADLINE_ENV, "0.05")
    ours, ref = _apps(kind, model_dir)
    path = "/invocations"
    results = []
    for mod, fmod, wsgi, reg in ((lifecycle, faults, ours, REGISTRY),
                                 (jax_lifecycle, jax_faults, ref, JAX_REGISTRY)):
        mod.install(mod.ServingLifecycle())
        mod.mark_ready()
        before = _count(reg, "serving_deadline_exceeded_total", stage=stage)
        fmod.configure(STAGE_FAULTS[stage])
        status, headers, _ = _call(wsgi, "POST", path, _csv(3))
        fmod.reset()
        results.append((status, int(headers.get("retry-after", 0)) >= 1,
                        _count(reg, "serving_deadline_exceeded_total", stage=stage) - before))
        # a request without a stall still answers 200
        assert _call(wsgi, "POST", path, _csv(3))[0] == 200
        mod.uninstall()
    assert results[0] == results[1] == (503, True, 1.0)


def test_queue_stage_expiry_in_the_batcher():
    """A budget gone before the enqueue, and one that runs out while the
    worker is busy, both expire in the `queue` stage."""
    gate = threading.Event()
    batcher = PredictBatcher(lambda x: (gate.wait(5), np.zeros(len(x)))[1],
                             registry=registry.MetricsRegistry(), name="q")
    try:
        now = [0.0]
        spent = lifecycle.RequestDeadline(1.0, clock=lambda: now[0])
        now[0] = 2.0
        with pytest.raises(lifecycle.DeadlineExceeded) as e:
            batcher.predict(np.zeros((100, D)), deadline=spent)
        assert e.value.stage == "queue" and batcher.stats()["requests"] == 0
        busy = threading.Thread(target=batcher.predict, args=(np.zeros((100, D)),))
        busy.start()
        time.sleep(0.2)  # the worker is inside predict_fn
        with pytest.raises(lifecycle.DeadlineExceeded) as e:
            batcher.predict(np.zeros((100, D)), deadline=lifecycle.RequestDeadline(0.1))
        assert e.value.stage == "queue" and batcher.stats()["timeouts"] == 1
    finally:
        gate.set()
        busy.join(10)
        assert batcher.close(10)


def test_no_deadline_knob_means_no_deadline(model_dir):
    lifecycle.install(lifecycle.ServingLifecycle())
    assert lifecycle.request_deadline() is None
    faults.configure("predict.dispatch:sleep:0.1")
    wsgi = app.make_app(app.ScoringService(model_dir, device="cpu"))
    assert _call(wsgi, "POST", "/invocations", _csv(2))[0] == 200


# -------------------------------------------------------------- the latch

def test_latch_counts_until_body_close_and_on_exceptions(model_dir):
    lc = lifecycle.install(lifecycle.ServingLifecycle(registry=registry.MetricsRegistry()))
    wsgi = app.make_app(app.ScoringService(model_dir, device="cpu"))
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/invocations", "CONTENT_TYPE": "text/csv",
               "CONTENT_LENGTH": "7", "wsgi.input": io.BytesIO(_csv(1))}
    result = wsgi(environ, lambda status, headers, exc_info=None: None)
    assert lc.inflight == 1  # the body is not written yet
    b"".join(result)
    result.close()
    assert lc.inflight == 0
    lc.begin_drain()
    # refused while draining: answered 503 and never latched
    status, headers, _ = _call(wsgi, "GET", "/ping")
    assert status == 503 and int(headers["retry-after"]) >= 1 and lc.inflight == 0
    assert _call(wsgi, "POST", "/invocations", _csv(1))[0] == 503


# ------------------------------------------------------------------ drain

def _serve(wsgi):
    httpd = make_server("127.0.0.1", 0, wsgi, server_class=server._ThreadedWSGIServer,
                        handler_class=server._QuietHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return "http://127.0.0.1:{}".format(httpd.server_port), httpd


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _http(url, data=None, timeout=30):
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "text/csv"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.mark.parametrize("kind", ["single", "mme"])
def test_drain_answers_inflight_refuses_new_then_stops(model_dir, kind):
    """4 requests in flight (a 1.5 s predict stall) when the drain starts:
    all 4 answer 200, /ping and new work answer 503 + Retry-After meanwhile,
    the listener closes and the state ends `stopped`."""
    lc = lifecycle.install(lifecycle.ServingLifecycle())
    wsgi = _apps(kind, model_dir)[0] if kind == "mme" else app.make_app(
        app.ScoringService(model_dir, device="cpu"))
    lifecycle.mark_ready()
    base, httpd = _serve(wsgi)
    path = "/invocations"
    assert _http(base + path, _csv(2))[0] == 200
    faults.configure("predict.dispatch:sleep:1.5")
    answers = []
    clients = [threading.Thread(target=lambda: answers.append(_http(base + path, _csv(2))))
               for _ in range(4)]
    for c in clients:
        c.start()
    deadline = time.monotonic() + 10
    while lc.inflight < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert lc.inflight == 4
    drainer = threading.Thread(target=lambda: answers.append(server.drain_and_shutdown(httpd,
                                                                                       lc)))
    drainer.start()
    _until(lambda: not lc.accepting)
    ping = _http(base + "/ping")
    new = _http(base + path, _csv(2))
    assert ping[0] == new[0] == 503 and int(ping[1]["Retry-After"]) >= 1
    assert lc.state == "draining"
    for c in clients:
        c.join(10)
    drainer.join(10)
    assert not drainer.is_alive() and httpd.stopped.is_set()
    assert sorted(a[0] for a in answers if isinstance(a, tuple)) == [200] * 4
    assert answers.count(True) == 1
    assert lc.state == "stopped" and lc.inflight == 0
    assert _count(REGISTRY, "serving_drain_seconds") > 0.3
    with pytest.raises(OSError):
        urllib.request.urlopen(base + "/ping", timeout=2)


def test_wedged_drain_exits_83_with_a_dump(model_dir, monkeypatch, tmp_path, capsys):
    """A request wedged past SM_DRAIN_TIMEOUT_S: one flight-recorder dump
    with the open request span, one serving.abort record, exit 83."""
    monkeypatch.setenv("SM_TRACE", "1")
    monkeypatch.setenv("SM_TRACE_EXPORT_DIR", str(tmp_path))
    monkeypatch.setenv(lifecycle.DRAIN_TIMEOUT_ENV, "0.3")
    exits = []
    monkeypatch.setattr(lifecycle, "_exit", exits.append)
    lc = lifecycle.install(lifecycle.ServingLifecycle())
    wsgi = app.make_app(app.ScoringService(model_dir, device="cpu"))
    base, httpd = _serve(wsgi)
    faults.configure("predict.dispatch:sleep:2")
    wedged = threading.Thread(target=_http, args=(base + "/invocations", _csv(1)))
    wedged.start()
    while lc.inflight < 1:
        time.sleep(0.01)
    assert server.drain_and_shutdown(httpd, lc) is False
    assert exits == [83]
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if '"serving.abort"' in line]
    assert len(records) == 1 and records[0]["reason"] == "drain_timeout"
    with open(records[0]["flight_recorder"]) as f:
        doc = json.load(f)
    assert doc["otherData"]["exit_code"] == 83
    assert any(e["name"] == "http.request" and e["args"].get("in_flight")
               for e in doc["traceEvents"] if e["ph"] == "X")
    wedged.join(10)
    httpd.stop()


def test_legacy_mode_skips_the_wait_but_stops(model_dir, monkeypatch):
    monkeypatch.setenv(lifecycle.GRACEFUL_DRAIN_ENV, "false")
    lc = lifecycle.install(lifecycle.ServingLifecycle())
    base, httpd = _serve(app.make_app(app.ScoringService(model_dir, device="cpu")))
    lc.request_started()  # a latch that never drops: no wait, no exit
    t = time.monotonic()
    assert server.drain_and_shutdown(httpd, lc) is True
    assert time.monotonic() - t < 5 and httpd.stopped.is_set() and lc.state == "stopped"


def test_sigterm_through_the_entrypoint_drains(model_dir, monkeypatch):
    """The entry point's SIGTERM handler on a real socket: the request in
    flight answers 200, a new one 503, and the server stops."""
    import logging
    import signal

    monkeypatch.setenv("SM_MODEL_DIR", model_dir)
    root = logging.getLogger()
    saved = (list(root.handlers), root.level, signal.getsignal(signal.SIGTERM),
             os.environ.get("OMP_NUM_THREADS"))
    httpd = server.serving_entrypoint(port=0, block=False, device="cpu")
    loop = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    try:
        base = "http://127.0.0.1:{}".format(httpd.server_port)
        assert _http(base + "/ping")[0] == 200
        faults.configure("predict.dispatch:sleep:1.5")
        inflight = []
        t = threading.Thread(target=lambda: inflight.append(_http(base + "/invocations",
                                                                  _csv(3))))
        t.start()
        while lifecycle.current().inflight < 1:
            time.sleep(0.01)
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        _until(lambda: not lifecycle.current().accepting)
        assert _http(base + "/invocations", _csv(3))[0] == 503
        t.join(10)
        assert inflight[0][0] == 200 and len(inflight[0][2].split(b"\n")) == 3
        assert httpd.stopped.wait(10)
        loop.join(10)
        assert not loop.is_alive() and lifecycle.current().state == "stopped"
    finally:
        signal.signal(signal.SIGTERM, saved[2])
        if not httpd.stopped.is_set():
            httpd.stop()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
        if saved[3] is None:
            os.environ.pop("OMP_NUM_THREADS", None)


# --------------------------------------------------------------- watchdog

class _FakeBatcher:
    def __init__(self):
        self.age = None

    def dispatch_age_s(self):
        return self.age

    def dispatch_info(self):
        return (2, 64)


def _watchdog_run(mod, action, exits):
    breaker, batcher = _FakeBreaker(), _FakeBatcher()
    dog = mod.PredictWatchdog(1.0, action=action, check_interval=60)
    dog.register("m", batcher, breaker)
    dog.stop()  # driven by hand below
    for age in (None, 0.5, 1.5, 2.5, None, 3.0):
        batcher.age = age
        dog.check_once()
    return breaker.forced, list(exits)


@pytest.mark.parametrize("action", ["shed", "abort"])
def test_watchdog_equals_jax(monkeypatch, capsys, action):
    """The same dispatch ages through both watchdogs: the breaker forced
    open on each stuck check, one serving.stuck record per episode, and
    with `abort` one exit 84."""
    got = []
    for mod in (lifecycle, jax_lifecycle):
        exits = []
        monkeypatch.setattr(mod, "_exit", exits.append)
        mod._reset_abort_for_tests()
        got.append(_watchdog_run(mod, action, exits))
        out = capsys.readouterr().out
        got.append(sorted(json.loads(line)["metric"] for line in out.splitlines()
                          if line.startswith("{")))
    assert got[0] == got[2] and got[1] == got[3]
    assert got[0][0] == ["predict_stuck"] * 3
    assert got[0][1] == ([84] if action == "abort" else [])
    stuck = got[1].count("serving.stuck")
    assert stuck == 2 and got[1].count("serving.abort") == (1 if action == "abort" else 0)


def test_watchdog_restarts_after_stop_and_gates_on_its_knob(monkeypatch):
    dog = lifecycle.PredictWatchdog(0.2, check_interval=0.05)
    dog.start()
    dog.stop()
    dog.start()
    assert dog._thread.is_alive()
    dog.stop()
    assert lifecycle.ServingLifecycle(registry=registry.MetricsRegistry()).watchdog is None
    monkeypatch.setenv(lifecycle.PREDICT_STUCK_ENV, "3")
    lc = lifecycle.ServingLifecycle(registry=registry.MetricsRegistry())
    assert lc.watchdog is not None and lc.watchdog.stuck_s == 3.0
    assert lc.watchdog.check_interval == 0.75


def test_batcher_times_its_dispatch_only_while_watched():
    """Without a watchdog a predict reads no clock for one: the dispatch
    age stays None mid-dispatch; registered with a watchdog, the dispatch
    shows its age and size; unregistered, it is untimed again."""
    seen = []

    def predict_fn(x):
        seen.append((batcher.dispatch_age_s(), batcher.dispatch_info()))
        return x[:, 0]

    batcher = PredictBatcher(predict_fn, registry=registry.MetricsRegistry())
    X = np.ones((2, D), np.float32)
    dog = lifecycle.PredictWatchdog(5.0, check_interval=60)
    try:
        batcher.predict(X)
        dog.register("b", batcher)
        batcher.predict(X)
        dog.unregister("b")
        batcher.predict(X)
    finally:
        dog.stop()
        batcher.close()
    assert seen[0] == (None, (0, 0)) and seen[2] == (None, (0, 0))
    assert seen[1][0] is not None and 0.0 <= seen[1][0] < 5.0 and seen[1][1] == (1, 2)
    assert batcher.dispatch_age_s() is None and not batcher.watched


@pytest.mark.parametrize("kind", ["single", "mme"])
def test_stuck_dispatch_sheds_then_recovers_like_jax(model_dir, monkeypatch, kind):
    """A batched dispatch wedged for 2 s (the `batcher.dispatch` fault)
    past SM_PREDICT_STUCK_S=0.3: /ping and new requests answer 503 +
    Retry-After while it is stuck, the wedged request still answers 200,
    and after the breaker's cooldown the endpoint answers 200 again; the
    same statuses from both packages."""
    monkeypatch.setenv(lifecycle.PREDICT_STUCK_ENV, "0.3")
    monkeypatch.setenv("SM_SHED_COOLDOWN_S", "0.4")
    statuses = []
    for mod, fmod in ((lifecycle, faults), (jax_lifecycle, jax_faults)):
        lc = mod.install(mod.ServingLifecycle())
        ours, ref = _apps(kind, model_dir)
        wsgi = ours if mod is lifecycle else ref
        mod.mark_ready()
        assert _call(wsgi, "POST", "/invocations", _csv(1))[0] == 200  # arms the batcher
        fmod.configure("batcher.dispatch:sleep:2@1")
        wedged = []
        t = threading.Thread(target=lambda: wedged.append(
            _call(wsgi, "POST", "/invocations", _csv(64))))
        t.start()
        # the watchdog sees the dispatch past 0.3 s and opens the breaker
        _until(lambda: _call(wsgi, "GET", "/ping")[0] == 503, timeout=1.9)
        ping = _call(wsgi, "GET", "/ping")
        shed = _call(wsgi, "POST", "/invocations", _csv(1))
        t.join(10)
        # the cooldown after the last forced open ends
        _until(lambda: _call(wsgi, "GET", "/ping")[0] == 200)
        after = (_call(wsgi, "GET", "/ping")[0], _call(wsgi, "POST", "/invocations", _csv(1))[0])
        statuses.append((ping[0], "retry-after" in ping[1], shed[0], "retry-after" in shed[1],
                         wedged[0][0], after, lc.state))
        fmod.reset()
        mod.uninstall()
    assert statuses[0] == statuses[1] == (503, True, 503, True, 200, (200, 200), "ready")


def test_abort_serving_first_caller_wins(monkeypatch, capsys):
    exits = []
    monkeypatch.setattr(lifecycle, "_exit", exits.append)
    lifecycle.abort_serving("drain_timeout", 83, inflight=1)
    lifecycle.abort_serving("predict_stuck", 84)
    assert exits == [83]
    assert capsys.readouterr().out.count('"serving.abort"') == 1


def test_breaker_force_open_equals_jax():
    from sagemaker_xgboost_container_tpu.serving import breaker as jax_breaker

    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    ours = CircuitBreaker(name="t", cooldown_s=2.0, clock=clock,
                          registry=registry.MetricsRegistry())
    ref = jax_breaker.CircuitBreaker(name="t", cooldown_s=2.0, clock=clock,
                                     registry=jax_registry.MetricsRegistry())
    for step in ("force", "allow", "degraded", "t+1", "force", "t+1.5", "allow", "t+1",
                 "degraded", "allow", "ok", "allow", "retry"):
        if step.startswith("t+"):
            now[0] += float(step[2:])
            continue
        call = {"force": lambda b: b.force_open("predict_stuck"), "allow": lambda b: b.allow(),
                "degraded": lambda b: b.degraded, "ok": lambda b: b.record_success(),
                "retry": lambda b: b.retry_after_s()}[step]
        assert call(ours) == call(ref), step
        assert ours.state == ref.state, step
    assert ours.shed == 2
