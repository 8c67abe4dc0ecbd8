"""The port's multi-model endpoint (``serving/mme.py``) and MMS handler
services (``serving/handler_service.py``) held against the JAX package's on
the CPU: one script of WSGI calls over the whole MMS REST surface (load,
list, describe, invoke, delete, LRU eviction, 400 / 404 / 405 / 409 / 413 /
415 / 406 / 500, queue full 503) through JAX ``make_mme_app`` and the
port's, comparing status codes, Content-Type and Retry-After headers and
predictions (within 1e-5); the handler pipelines on the same payloads; and
that an unloaded or evicted model leaves no thread, no device tensor and no
metric series behind.

The model files are written by the JAX package from a numpy seed (depth
<= 4, a few rounds); none is read from outside the test's temp dirs.
"""

import io
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.serving import handler_service as jax_handlers
from sagemaker_xgboost_container_tpu.serving import lifecycle as jax_lifecycle
from sagemaker_xgboost_container_tpu.serving import mme as jax_mme
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.serving import handler_service, lifecycle, mme
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY, prometheus
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.utils import faults

D = 6
TOL = 1e-5  # predictions of both packages on the same rows (f32 traversal)


def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D).astype(np.float32)
    X[rng.rand(n, D) < 0.05] = np.nan
    return X


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """{name: dir}: binary:logistic (depth 4, 5 rounds), reg:squarederror
    (depth 3, 4 rounds), multi:softprob with 3 classes (depth 3, 3 rounds),
    and a dir whose model file is not a model."""
    root = tmp_path_factory.mktemp("mme")
    X = _data(900, seed=0)
    z = np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) * np.nan_to_num(X[:, 2])
    specs = {
        "bin": ({"objective": "binary:logistic", "max_depth": 4, "max_bin": 32},
                (z > 0).astype(np.float32), 5),
        "reg": ({"objective": "reg:squarederror", "max_depth": 3, "max_bin": 32},
                z.astype(np.float32), 4),
        "multi": ({"objective": "multi:softprob", "num_class": 3, "max_depth": 3, "max_bin": 16},
                  np.digitize(z, [-0.5, 0.5]).astype(np.float32), 3),
    }
    out = {}
    for name, (params, y, rounds) in specs.items():
        forest = jax_booster.train(params, JaxDataMatrix(X, y), rounds)
        d = root / name
        d.mkdir()
        forest.save_model(str(d / "xgboost-model"))
        out[name] = str(d)
    bad = root / "corrupt"
    bad.mkdir()
    (bad / "xgboost-model").write_bytes(b"\x00not a model")
    out["corrupt"] = str(bad)
    return out


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("GRAFT_PREDICT_WARMUP", "0")
    for mod in (lifecycle, jax_lifecycle):
        mod.uninstall()
    for mod in (faults, jax_faults):
        mod.reset()
    yield
    for mod in (lifecycle, jax_lifecycle):
        mod.uninstall()
    for mod in (faults, jax_faults):
        mod.reset()


def _call(wsgi, method, path, body=b"", content_type="text/csv", accept=None, query=""):
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": query,
               "CONTENT_TYPE": content_type, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    if accept:
        environ["HTTP_ACCEPT"] = accept
    got = {}

    def start_response(status, headers, exc_info=None):
        got["status"] = int(status.split()[0])
        got["headers"] = dict(headers)

    result = wsgi(environ, start_response)
    out = b"".join(result)
    if hasattr(result, "close"):
        result.close()
    return got["status"], got["headers"], out


def _csv(X):
    return "\n".join(",".join("" if np.isnan(v) else repr(float(v)) for v in row)
                     for row in X).encode()


def _libsvm(X):
    return "\n".join(" ".join("{}:{!r}".format(j + 1, float(v)) for j, v in enumerate(row)
                              if not np.isnan(v)) for row in X).encode()


def _scores(body, accept):
    if accept == "application/json":
        return np.asarray([p["score"] for p in json.loads(body)["predictions"]], np.float64)
    rows = [r for r in body.decode().split("\n") if r]
    return np.asarray([[float(c) for c in r.split(",")] if "," in r else float(r)
                       for r in rows], np.float64)


def _load_body(name, url):
    return json.dumps({"model_name": name, "url": url}).encode()


def _same(ours, ref, req, where):
    """Both answers alike: status, Content-Type, Retry-After (present and
    >= 1), and the body: predictions within TOL, JSON documents equal,
    error texts aside."""
    assert ours[0] == ref[0], (where, ours, ref)
    assert ours[1]["Content-Type"] == ref[1]["Content-Type"], where
    assert ("Retry-After" in ours[1]) == ("Retry-After" in ref[1]), where
    if "Retry-After" in ours[1]:
        assert int(ours[1]["Retry-After"]) >= 1
    if ours[0] != 200:
        return
    if req[1].endswith("/invoke") or req[1] == "/invocations":
        accept = ours[1]["Content-Type"]
        a, b = _scores(ours[2], accept), _scores(ref[2], accept)
        assert a.shape == b.shape and np.all(np.isfinite(a)), where
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=where)
    else:
        assert json.loads(ours[2]) == json.loads(ref[2]), where


def _apps(monkeypatch, max_models):
    monkeypatch.setenv("SAGEMAKER_MAX_MODELS", str(max_models))
    ours = mme.make_mme_app(device="cpu")
    ref_manager = jax_mme.ModelManager()
    return ours, jax_mme.make_mme_app(ref_manager), ref_manager


def test_rest_surface_equals_jax(model_dirs, monkeypatch):
    """One script over the whole REST surface, LRU cap 2, through both
    endpoints."""
    ours, ref, _ = _apps(monkeypatch, 2)
    Xs = {n: _data(n, seed=10 + n) for n in (1, 10, 50)}
    wide = np.hstack([Xs[10], Xs[10], Xs[10]])
    invoke = "/models/{}/invoke".format
    script = [
        ("GET", "/ping", {}),
        ("GET", "/models", {}),
        ("POST", "/invocations", {"body": _csv(Xs[1])}),  # no model: 400
        ("POST", "/models", {"body": _load_body("bin", model_dirs["bin"]),
                             "content_type": "application/json"}),
        ("POST", "/models", {"body": _load_body("bin", model_dirs["bin"]),
                             "content_type": "application/json"}),  # 409
        ("POST", "/models", {"body": json.dumps({"model_name": "x"}).encode(),
                             "content_type": "application/json"}),  # 400
        ("POST", "/models", {"body": _load_body("x", model_dirs["bin"] + "-missing"),
                             "content_type": "application/json"}),  # 404
        ("POST", "/models", {"query": "model_name=reg&url=" + model_dirs["reg"]}),
        ("GET", "/models", {}),
        ("GET", "/models/bin", {}),
        ("GET", "/models/ghost", {}),
        ("POST", invoke("bin"), {"body": _csv(Xs[1]), "accept": "application/json"}),
        ("POST", invoke("bin"), {"body": _csv(Xs[50]), "accept": "text/csv"}),
        ("POST", invoke("bin"), {"body": _libsvm(Xs[10]), "content_type": "text/libsvm"}),
        ("GET", invoke("bin"), {}),  # 405
        ("POST", invoke("ghost"), {"body": _csv(Xs[1])}),  # 404
        ("POST", "/invocations", {"body": _csv(Xs[1])}),  # two models: 400
        ("POST", invoke("reg"), {}),  # empty: 204
        ("POST", invoke("reg"), {"body": b"<x/>", "content_type": "application/xml"}),  # 415
        ("POST", invoke("reg"), {"body": _csv(Xs[1]), "accept": "text/html"}),  # 406
        ("POST", invoke("reg"), {"body": _csv(wide)}),  # too many features: 400
        ("POST", invoke("reg"), {"body": _csv(Xs[50]), "accept": "application/json"}),
        # reg is the most recent now: loading a third model evicts bin
        ("POST", "/models", {"body": _load_body("multi", model_dirs["multi"]),
                             "content_type": "application/json"}),
        ("GET", "/models", {}),
        ("POST", invoke("bin"), {"body": _csv(Xs[1])}),  # evicted: 404
        ("POST", invoke("multi"), {"body": _csv(Xs[50]), "accept": "text/csv"}),
        ("POST", invoke("multi"), {"body": _libsvm(Xs[1]), "content_type": "text/libsvm",
                                   "accept": "application/json"}),
        ("DELETE", "/models/reg", {}),
        ("DELETE", "/models/reg", {}),  # 404
        ("POST", "/invocations", {"body": _csv(Xs[10])}),  # one model again: 200
        ("POST", "/models", {"body": _load_body("bad", model_dirs["corrupt"]),
                             "content_type": "application/json"}),  # 500
        ("GET", "/nope", {}),
        ("GET", "/models", {}),
    ]
    statuses = []
    for i, (method, path, kw) in enumerate(script):
        a = _call(ours, method, path, **kw)
        b = _call(ref, method, path, **kw)
        _same(a, b, (method, path), "{} {} {} (step {})".format(method, path, kw.get("query", ""),
                                                                 i))
        statuses.append(a[0])
    assert statuses == [200, 200, 400, 200, 409, 400, 404, 200, 200, 200, 404, 200, 200, 200,
                        405, 404, 400, 204, 415, 406, 400, 200, 200, 200, 404, 200, 200, 200,
                        404, 200, 500, 404, 200]
    listed = json.loads(_call(ours, "GET", "/models")[2])["models"]
    assert listed == [{"modelName": "multi", "modelUrl": model_dirs["multi"]}]


@pytest.mark.parametrize("name,rows", [("bin", 1), ("bin", 40), ("reg", 7), ("multi", 33)])
def test_invoke_matches_the_cpu_forest(model_dirs, name, rows):
    """The port's MME answers what the port's Forest predicts on the CPU
    for the same rows, csv and libsvm bodies alike."""
    wsgi = mme.make_mme_app(device="cpu")
    assert _call(wsgi, "POST", "/models", _load_body(name, model_dirs[name]),
                 "application/json")[0] == 200
    X = _data(rows, seed=rows)
    want = Forest.load_model(os.path.join(model_dirs[name], "xgboost-model"),
                             device="cpu").predict(X)
    for body, ctype in ((_csv(X), "text/csv"), (_libsvm(X), "text/libsvm")):
        status, headers, out = _call(wsgi, "POST", "/models/{}/invoke".format(name), body,
                                     ctype, "application/json")
        assert status == 200 and headers["Content-Type"] == "application/json"
        got = _scores(out, "application/json")
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _unload_all(wsgi.manager)


def test_payload_cap_and_hard_limit_equal_jax(model_dirs, monkeypatch):
    monkeypatch.setenv("SAGEMAKER_MAX_REQUEST_SIZE", str(64 * 1024**2))
    assert mme._max_request_size() == jax_mme._max_request_size() == 20 * 1024**2
    monkeypatch.delenv("SAGEMAKER_MAX_REQUEST_SIZE")
    monkeypatch.setenv("MAX_CONTENT_LENGTH", "2048")
    assert mme._max_request_size() == jax_mme._max_request_size() == 2048
    monkeypatch.setenv("SAGEMAKER_MAX_REQUEST_SIZE", "64")
    ours, ref, _ = _apps(monkeypatch, 0)
    for wsgi in (ours, ref):
        assert _call(wsgi, "POST", "/models", _load_body("bin", model_dirs["bin"]),
                     "application/json")[0] == 200
    body = _csv(_data(20, seed=3))
    a = _call(ours, "POST", "/models/bin/invoke", body)
    b = _call(ref, "POST", "/models/bin/invoke", body)
    _same(a, b, ("POST", "/models/bin/invoke"), "413")
    assert a[0] == 413
    small = b"0.1,0.2,0.3,0.4,0.5,0.6"
    assert _call(ours, "POST", "/models/bin/invoke", small)[0] == 200


def test_queue_full_answers_503_like_jax(model_dirs, monkeypatch):
    """SAGEMAKER_MODEL_JOB_QUEUE_SIZE=1 and the model's dispatch held: one
    request in the dispatch, one in the queue slot, the third 503 +
    Retry-After in both packages; the held two answer 200 once released."""
    monkeypatch.setenv("SAGEMAKER_MODEL_JOB_QUEUE_SIZE", "1")
    ours, ref, ref_manager = _apps(monkeypatch, 0)
    batchers = []
    for wsgi in (ours, ref):
        assert _call(wsgi, "POST", "/models", _load_body("bin", model_dirs["bin"]),
                     "application/json")[0] == 200
    batchers = [ours.manager.get("bin").batcher, ref_manager.get("bin")[3]]
    release = threading.Event()
    for batcher in batchers:
        inner = batcher.predict_fn
        batcher.predict_fn = lambda x, _f=inner: (release.wait(20), _f(x))[1]
    body = _csv(_data(40, seed=5))
    held, threads = [], []
    try:
        for wsgi in (ours, ref):
            for _ in range(2):  # the dispatch, then the queue slot
                t = threading.Thread(target=lambda w=wsgi: held.append(
                    _call(w, "POST", "/models/bin/invoke", body)[0]))
                t.start()
                threads.append(t)
                time.sleep(0.3)
        a = _call(ours, "POST", "/models/bin/invoke", body)
        b = _call(ref, "POST", "/models/bin/invoke", body)
        _same(a, b, ("POST", "/models/bin/invoke"), "queue full")
        assert a[0] == 503 and ours.manager.get("bin").batcher.stats()["rejected"] == 1
    finally:
        release.set()
        for t in threads:
            t.join(20)
    assert held == [200] * 4
    # the breaker saw one saturation event: /ping stays 200 (threshold 5)
    assert _call(ours, "GET", "/ping")[0] == _call(ref, "GET", "/ping")[0] == 200


def test_ping_and_invoke_refused_while_draining(model_dirs):
    ours = mme.make_mme_app(device="cpu")
    ref = jax_mme.make_mme_app()
    for mod, wsgi in ((lifecycle, ours), (jax_lifecycle, ref)):
        assert _call(wsgi, "POST", "/models", _load_body("bin", model_dirs["bin"]),
                     "application/json")[0] == 200
        lc = mod.install(mod.ServingLifecycle())
        lc.mark_ready()
        lc.begin_drain()
    for path, method in (("/ping", "GET"), ("/models/bin/invoke", "POST"),
                         ("/invocations", "POST")):
        body = _csv(_data(2, seed=6)) if method == "POST" else b""
        a, b = _call(ours, method, path, body), _call(ref, method, path, body)
        _same(a, b, (method, path), path)
        assert a[0] == 503
    lifecycle.uninstall()
    jax_lifecycle.uninstall()


def test_invoke_fault_points_equal_jax(model_dirs):
    """`predict.dispatch:error` answers 400 and `serving.decode:error` 415
    in both MMEs."""
    ours = mme.make_mme_app(device="cpu")
    ref = jax_mme.make_mme_app()
    for wsgi in (ours, ref):
        assert _call(wsgi, "POST", "/models", _load_body("bin", model_dirs["bin"]),
                     "application/json")[0] == 200
    body = _csv(_data(3, seed=7))
    for spec, want in (("predict.dispatch:error:boom", 400), ("serving.decode:error:bad", 415),
                       ("serving.encode:drop", 500)):
        got = []
        for fmod, wsgi in ((faults, ours), (jax_faults, ref)):
            fmod.configure(spec)
            got.append(_call(wsgi, "POST", "/models/bin/invoke", body)[0])
            fmod.reset()
        assert got == [want, want], spec


# ------------------------------------------------------ releasing a model

def _unload_all(manager):
    for entry in manager.list():
        manager.unload(entry["modelName"])


def _series(name):
    return 'batcher="{}"'.format(name) in prometheus.render_text(REGISTRY)


def test_unload_and_eviction_release_threads_tensors_and_series(model_dirs, monkeypatch):
    """Load, predict on the device path (stacked trees), unload or evict:
    the batcher and warmup threads end, the forest's device copies go, the
    batcher series go, and no thread started here is left."""
    monkeypatch.delenv("GRAFT_PREDICT_WARMUP")  # the port's warmup thread on
    manager = mme.ModelManager(max_models=1, device="cpu")
    baseline = set(threading.enumerate())
    X = _data(40, seed=8)  # above the host-path rows: the device path
    for cycle in range(4):
        manager.load("a", model_dirs["bin"])
        entry = manager.get("a")
        entry.batcher.predict(X)
        assert entry.model._stacked and _series("a")
        if cycle % 2:
            manager.unload("a")
        else:
            manager.load("b", model_dirs["reg"])  # evicts a
            manager.get("b").batcher.predict(X)
            manager.unload("b")
            assert not _series("b")
        assert not entry.batcher._thread.is_alive() and not entry.warmup.is_alive()
        assert entry.model._stacked == {} and not _series("a")
        assert set(threading.enumerate()) <= baseline
    assert manager.list() == []
    # a request holding the entry across the unload still answers, inline
    np.testing.assert_allclose(entry.batcher.predict(X),
                               entry.model.predict(X), rtol=0, atol=0)


def test_duplicate_load_keeps_the_loaded_model(model_dirs, monkeypatch):
    monkeypatch.delenv("GRAFT_PREDICT_WARMUP")  # the port's warmup thread on
    manager = mme.ModelManager(device="cpu")
    manager.load("a", model_dirs["bin"])
    manager.get("a").warmup.join(30)
    baseline = set(threading.enumerate())
    with pytest.raises(KeyError):
        manager.load("a", model_dirs["reg"])
    assert set(threading.enumerate()) <= baseline and _series("a")
    assert manager.get("a").model_dir == model_dirs["bin"]
    _unload_all(manager)
    assert not _series("a")


def test_churn_under_concurrent_invokes(model_dirs):
    """Loads, evictions and unloads racing 8 invoking threads, with a short
    switch interval: every answer is 200 or 404 and right, nothing hangs."""
    wsgi = mme.make_mme_app(mme.ModelManager(max_models=2, device="cpu"))
    X = _data(40, seed=9)
    body = _csv(X)
    want = Forest.load_model(os.path.join(model_dirs["bin"], "xgboost-model"),
                             device="cpu").predict(X)
    stop = threading.Event()
    seen, bad = [], []

    def client(i):
        while not stop.is_set():
            status, _, out = _call(wsgi, "POST", "/models/m{}/invoke".format(i % 3), body)
            seen.append(status)
            if status == 200 and np.abs(_scores(out, "text/csv") - want).max() > TOL:
                bad.append(out[:80])
            elif status not in (200, 404):
                bad.append(status)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for k in range(12):
            name = "m{}".format(k % 3)
            _call(wsgi, "POST", "/models", _load_body(name, model_dirs["bin"]),
                  "application/json")
            if k % 4 == 3:
                _call(wsgi, "DELETE", "/models/" + name)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not bad and 200 in seen
    _unload_all(wsgi.manager)


# --------------------------------------------------------- handler services

def _handlers(module_ours=None, module_ref=None):
    if module_ours is None:
        return handler_service.AlgorithmHandlerService(device="cpu"), \
            jax_handlers.AlgorithmHandlerService()
    return (handler_service.UserModuleHandlerService(module_ours, device="cpu"),
            jax_handlers.UserModuleHandlerService(module_ref))


@pytest.mark.parametrize("name", ["bin", "multi"])
@pytest.mark.parametrize("ctype", ["text/csv", "text/libsvm"])
@pytest.mark.parametrize("accept", ["application/json", "application/jsonlines", "text/csv"])
def test_algorithm_handler_equals_jax(model_dirs, name, ctype, accept):
    X = _data(12, seed=11)
    payload = _csv(X) if ctype == "text/csv" else _libsvm(X)
    ours, ref = _handlers()
    a_body, a_type = ours.handle(payload, ctype, accept, model_dirs[name])
    b_body, b_type = ref.handle(payload, ctype, accept, model_dirs[name])
    assert a_type == b_type == accept
    if accept == "application/jsonlines":
        a = [json.loads(line)["score"] for line in a_body.splitlines()]
        b = [json.loads(line)["score"] for line in b_body.splitlines()]
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    else:
        np.testing.assert_allclose(_scores(a_body.encode(), accept),
                                   _scores(b_body.encode(), accept), rtol=0, atol=TOL)


@pytest.mark.parametrize("case,status", [("content", 415), ("accept", 406), ("width", 400)])
def test_algorithm_handler_errors_equal_jax(model_dirs, case, status):
    X = _data(3, seed=12)
    payload, ctype, accept = _csv(X), "text/csv", "text/csv"
    if case == "content":
        ctype = "application/xml"
    elif case == "accept":
        accept = "text/html"
    else:
        payload = _csv(np.hstack([X, X]))
    codes = []
    for handler, error in zip(_handlers(), (handler_service.InferenceError,
                                            jax_handlers.InferenceError)):
        with pytest.raises(error) as e:
            handler.handle(payload, ctype, accept, model_dirs["bin"])
        codes.append(e.value.status)
    assert codes == [status, status]


def test_user_module_handler_equals_jax(model_dirs):
    """Script mode: model_fn is required; input_fn / predict_fn / output_fn
    / transform_fn override their defaults in both packages alike."""
    ours, ref = _handlers(types.SimpleNamespace(), types.SimpleNamespace())
    with pytest.raises(exc.UserError, match="model_fn implementation is required"):
        ours.handle(b"1", "text/csv", "text/csv", model_dirs["bin"])
    with pytest.raises(Exception, match="model_fn implementation is required"):
        ref.handle(b"1", "text/csv", "text/csv", model_dirs["bin"])

    def module(load):
        return types.SimpleNamespace(
            model_fn=lambda d: load(os.path.join(d, "xgboost-model")),
            predict_fn=lambda data, model: model.predict(data[0].features)[:, None] * 2.0,
            output_fn=lambda preds, accept: ",".join("%.6f" % p for p in np.ravel(preds)))

    from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest

    ours, ref = _handlers(module(lambda p: Forest.load_model(p, device="cpu")),
                          module(JaxForest.load_model))
    X = _data(6, seed=13)
    a = ours.handle(_csv(X), "text/csv", "text/csv", model_dirs["bin"])
    b = ref.handle(_csv(X), "text/csv", "text/csv", model_dirs["bin"])
    assert a[1] == b[1] == "text/csv"
    np.testing.assert_allclose(np.asarray(a[0].split(","), float),
                               np.asarray(b[0].split(","), float), rtol=0, atol=2 * TOL)
    transform = types.SimpleNamespace(
        model_fn=lambda d: "m", transform_fn=lambda m, p, c, a: ("{}:{}".format(m, len(p)), c))
    for handler in _handlers(transform, transform):
        assert handler.handle(b"abc", "text/csv", "text/csv", "unused") == ("m:3", "text/csv")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bin", "multi"])
def test_mme_on_cuda_matches_jax_and_releases_the_card(model_dirs, name):
    """The port's MME on the GPU against the JAX MME (host path 1 row,
    device path 100 and 2,000 rows), then an unload: the device memory is
    back where it was before the load."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py phase 12 serves the MME on the card")
    ours = mme.make_mme_app(device="cuda")
    ref = jax_mme.make_mme_app()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for wsgi in (ours, ref):
        assert _call(wsgi, "POST", "/models", _load_body(name, model_dirs[name]),
                     "application/json")[0] == 200
    for rows in (1, 100, 2000):
        body = _csv(_data(rows, seed=14 + rows))
        path = "/models/{}/invoke".format(name)
        a, b = _call(ours, "POST", path, body), _call(ref, "POST", path, body)
        _same(a, b, ("POST", path), "{} rows".format(rows))
        assert a[0] == 200
    assert torch.cuda.memory_allocated() > before
    assert _call(ours, "DELETE", "/models/" + name)[0] == 200
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
