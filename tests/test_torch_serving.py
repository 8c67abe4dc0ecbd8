"""The port's serve path (``sagemaker_xgboost_container_tpu_torch.serving``)
held against the JAX package's on the CPU: the WSGI apps called with the same
environ, the codecs, selectable inference, ensembles, script-mode hooks, the
batcher and breaker, model formats, and one real-socket server run.

The models are trained by the JAX package from a numpy seed and saved as
xgboost JSON, with a UBJSON copy written by the JAX package's encoder.
"""

import csv
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data import content_types as jax_content_types
from sagemaker_xgboost_container_tpu.data import record_pb2
from sagemaker_xgboost_container_tpu.data import recordio as jax_recordio
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import compat as jax_compat
from sagemaker_xgboost_container_tpu.serving import app as jax_app
from sagemaker_xgboost_container_tpu.serving import breaker as jax_breaker
from sagemaker_xgboost_container_tpu.serving import encoder as jax_encoder
from sagemaker_xgboost_container_tpu.serving import serve_utils as jax_serve_utils
from sagemaker_xgboost_container_tpu.utils import envconfig as jax_envconfig
from sagemaker_xgboost_container_tpu_torch.data import content_types, recordio
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import compat
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.serving import (app, breaker, encoder, lifecycle,
                                                            serve_utils, server)
from sagemaker_xgboost_container_tpu_torch.serving.batcher import JobQueueFull, PredictBatcher
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.utils import envconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
ACCEPTS = ["text/csv", "application/json", "application/jsonlines",
           "application/x-recordio-protobuf"]


def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D).astype(np.float32)
    logit = X[:, 0] * 0.8 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3]) - 0.2
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    return X, y


def _save(forest, model_dir, name="xgboost-model", ubjson=False):
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(str(model_dir), name)
    if ubjson:
        with open(path, "wb") as f:
            f.write(jax_compat.encode_ubjson(json.loads(forest.save_json())))
    else:
        forest.save_model(path)
    return str(model_dir)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Model dirs: binary:logistic (depth 4, 6 rounds, best_iteration 3) as
    JSON and as UBJSON; a two-file reg:squarederror ensemble."""
    saved = os.environ.get("GRAFT_PREDICT_WARMUP")
    # the JAX app's warmup compiles on a background thread; nothing here
    # needs it, and a compile still running at interpreter exit aborts
    os.environ["GRAFT_PREDICT_WARMUP"] = "0"
    X, y = _data(1500, seed=0)
    binary = jax_booster.train(
        {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32, "eta": 0.3},
        JaxDataMatrix(X, y), 6)
    binary.set_attr(best_iteration=3)
    root = tmp_path_factory.mktemp("models")
    dirs = {"json": _save(binary, root / "json"),
            "ubjson": _save(binary, root / "ubjson", ubjson=True)}
    for seed in (1, 2):
        Xr, _ = _data(600, seed=seed)
        yr = Xr[:, 0] * 2.0 + Xr[:, 1] - 0.5 * Xr[:, 2] ** 2
        reg = jax_booster.train({"objective": "reg:squarederror", "max_depth": 3, "max_bin": 32},
                                JaxDataMatrix(Xr, yr), 3 + seed)
        _save(reg, root / "ensemble", name="model-{}".format(seed), ubjson=seed == 2)
    dirs["ensemble"] = str(root / "ensemble")
    yield dirs
    if saved is None:
        os.environ.pop("GRAFT_PREDICT_WARMUP", None)
    else:
        os.environ["GRAFT_PREDICT_WARMUP"] = saved


@pytest.fixture(scope="module")
def apps(models):
    """(JAX app, port app) per model dir, the port's on the CPU."""
    out = {}
    for key, model_dir in models.items():
        out[key] = (jax_app.make_app(jax_app.ScoringService(model_dir)),
                    app.make_app(app.ScoringService(model_dir, device="cpu")))
    yield out
    for _, ours in out.values():
        if ours.service.warmup is not None:
            ours.service.warmup.join(30)


def _call(wsgi, body=b"", content_type="text/csv", accept=None, path="/invocations",
          method="POST", content_length=None):
    environ = {
        "PATH_INFO": path, "REQUEST_METHOD": method, "CONTENT_TYPE": content_type,
        "CONTENT_LENGTH": str(len(body) if content_length is None else content_length),
        "wsgi.input": io.BytesIO(body),
    }
    if accept is not None:
        environ["HTTP_ACCEPT"] = accept
    got = {}

    def start_response(status, headers, exc_info=None):
        got["status"] = int(status.split()[0])
        got["headers"] = dict(headers)

    out = b"".join(wsgi(environ, start_response))
    return got["status"], got["headers"], out


def _payload(X, kind):
    if kind == "csv":
        return "\n".join(",".join(repr(float(v)) for v in row) for row in X).encode(), "text/csv"
    if kind == "libsvm":
        lines = [" ".join("{}:{!r}".format(j + 1, float(v)) for j, v in enumerate(row)
                          if not np.isnan(v)) for row in X]
        return "\n".join(lines).encode(), "text/libsvm"
    return recordio.write_recordio_protobuf(X), "application/x-recordio-protobuf"


def _parse_cell(cell):
    cell = cell.strip()
    if cell.startswith("["):
        return json.loads(cell.replace("nan", "NaN"))
    return float(cell)


def _parse(body, accept):
    """A response body -> nested lists/dicts of floats."""
    if accept == "text/csv":
        return [[_parse_cell(c) for c in row] for row in csv.reader(body.decode().splitlines())]
    if accept == "application/json":
        return json.loads(body)
    if accept == "application/jsonlines":
        return [json.loads(line) for line in body.decode().splitlines()]
    out = []
    for payload in jax_recordio.iter_records(body):
        r = record_pb2.Record()
        r.ParseFromString(payload)
        out.append({name: {k: list(v.float32_tensor.values) for k, v in getattr(r, name).items()}
                    for name in ("features", "label")})
    return out


def _assert_close(a, b, tol, where="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_close(a[k], b[k], tol, "{}.{}".format(where, k))
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, tol, "{}[{}]".format(where, i))
    else:
        assert not isinstance(b, (list, dict)), where
        if np.isnan(a) or np.isnan(b):
            assert np.isnan(a) and np.isnan(b), where
        else:
            assert abs(a - b) <= tol, (where, a, b)


def _same_answer(jax_wsgi, port_wsgi, rows, tol=None, **kw):
    """Both apps answer alike: status, content type, and predictions within
    1e-6 (equal on the host path of payloads of at most 32 rows)."""
    a = _call(jax_wsgi, **kw)
    b = _call(port_wsgi, **kw)
    assert a[0] == b[0], (a, b)
    assert a[1]["Content-Type"] == b[1]["Content-Type"]
    if a[0] == 200:
        accept = b[1]["Content-Type"]
        _assert_close(_parse(a[2], accept), _parse(b[2], accept),
                      tol if tol is not None else (0.0 if rows <= 32 else 1e-6))
    return a, b


@pytest.mark.parametrize("model", ["json", "ubjson"])
@pytest.mark.parametrize("kind", ["csv", "libsvm", "recordio"])
@pytest.mark.parametrize("accept", ACCEPTS)
@pytest.mark.parametrize("rows", [1, 100])
def test_invocations_match_jax(apps, model, kind, accept, rows):
    X, _ = _data(rows, seed=5)
    X[np.random.RandomState(6).rand(*X.shape) < 0.1] = np.nan
    body, content_type = _payload(X, kind)
    a, _ = _same_answer(*apps[model], rows, body=body, content_type=content_type,
                        accept=accept)
    assert a[0] == 200


@pytest.mark.parametrize("keys", ["predicted_label,probability",
                                  "labels,probabilities,raw_score",
                                  "raw_scores, predicted_score"])
@pytest.mark.parametrize("kind", ["csv", "libsvm", "recordio"])
@pytest.mark.parametrize("accept", ACCEPTS)
@pytest.mark.parametrize("rows", [1, 100])
def test_selectable_inference_matches_jax(apps, monkeypatch, keys, kind, accept, rows):
    monkeypatch.setenv("SAGEMAKER_INFERENCE_OUTPUT", keys)
    X, _ = _data(rows, seed=7)
    body, content_type = _payload(X, kind)
    a, _ = _same_answer(*apps["json"], rows, body=body, content_type=content_type,
                        accept=accept)
    assert a[0] == 200


@pytest.mark.parametrize("case", ["empty", "bad_content_type", "bad_accept", "too_large",
                                  "too_wide", "libsvm_too_wide", "not_found", "ping",
                                  "execution_parameters", "default_accept", "batch_output"])
def test_status_codes_match_jax(apps, monkeypatch, case):
    X, _ = _data(3, seed=8)
    body, _ = _payload(X, "csv")
    kw = {"body": body}
    if case == "empty":
        kw["body"] = b""
    elif case == "bad_content_type":
        kw["content_type"] = "application/xml"
    elif case == "bad_accept":
        kw["accept"] = "text/html"
    elif case == "too_large":
        kw["content_length"] = 7 * 1024 * 1024
    elif case == "too_wide":
        kw["body"], _ = _payload(np.hstack([X, X[:, :2]]), "csv")
    elif case == "libsvm_too_wide":
        kw["body"], kw["content_type"] = b"1:0.5 12:1.0", "text/libsvm"
    elif case == "not_found":
        kw["path"] = "/nope"
    elif case == "ping":
        kw.update(path="/ping", method="GET")
    elif case == "execution_parameters":
        kw.update(path="/execution-parameters", method="GET")
    elif case == "default_accept":
        monkeypatch.setenv("SAGEMAKER_DEFAULT_INVOCATIONS_ACCEPT", "application/json")
        kw["accept"] = "*/*"
    elif case == "batch_output":
        monkeypatch.setenv("SAGEMAKER_BATCH", "true")
    jax_wsgi, port_wsgi = apps["json"]
    a, b = _call(jax_wsgi, **kw), _call(port_wsgi, **kw)
    want = {"empty": 204, "bad_content_type": 415, "bad_accept": 406, "too_large": 413,
            "too_wide": 400, "libsvm_too_wide": 400, "not_found": 404}.get(case, 200)
    assert a[0] == b[0] == want
    assert a[1]["Content-Type"] == b[1]["Content-Type"]
    if case in ("default_accept", "batch_output"):
        _assert_close(_parse(a[2], "application/json" if case == "default_accept"
                             else "text/csv"),
                      _parse(b[2], "application/json" if case == "default_accept"
                             else "text/csv"), 0.0)
    if case == "execution_parameters":
        assert json.loads(a[2]) == json.loads(b[2])


@pytest.mark.parametrize("ensemble", ["true", "false"])
@pytest.mark.parametrize("rows", [5, 60])
def test_ensemble_mean_matches_jax(models, monkeypatch, ensemble, rows):
    monkeypatch.setenv("SAGEMAKER_INFERENCE_ENSEMBLE", ensemble)
    jax_wsgi = jax_app.make_app(jax_app.ScoringService(models["ensemble"]))
    port_wsgi = app.make_app(app.ScoringService(models["ensemble"], device="cpu"))
    X, _ = _data(rows, seed=9)
    body, content_type = _payload(X, "csv")
    _same_answer(jax_wsgi, port_wsgi, rows, tol=1e-5, body=body, content_type=content_type,
                 accept="application/json")
    assert isinstance(port_wsgi.service.model, list) == (ensemble == "true")


class _Stub:
    """A model both packages' serve_utils.predict can drive."""

    def __init__(self, out):
        self.out = np.asarray(out, np.float32)
        self.num_feature = 3
        self.attributes = {"best_iteration": "1"}
        self.ranges = []

    def predict(self, features, iteration_range=None):
        self.ranges.append(iteration_range)
        return self.out[: features.shape[0]]


@pytest.mark.parametrize("objective", ["binary:hinge", "multi:softmax", "reg:squarederror"])
def test_ensemble_vote_and_mean_match_jax(objective):
    outs = [[1, 0, 2, 1], [1, 2, 2, 0], [0, 2, 1, 0]]
    dtest = DataMatrix(np.zeros((4, 3), np.float32))
    jdtest = JaxDataMatrix(np.zeros((4, 3), np.float32))
    ours = serve_utils.predict([_Stub(o) for o in outs], None, dtest, "text/csv", objective)
    stubs = [_Stub(o) for o in outs]
    ref = jax_serve_utils.predict(stubs, None, jdtest, "text/csv", objective)
    np.testing.assert_array_equal(ours, ref)
    assert stubs[0].ranges == [(0, 2)]


def _port_hooks():
    def model_fn(model_dir):
        return Forest.load_model(os.path.join(model_dir, "xgboost-model"), device="cpu")
    return model_fn


def _jax_hooks():
    from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest

    def model_fn(model_dir):
        return JaxForest.load_model(os.path.join(model_dir, "xgboost-model"))
    return model_fn


def _common_hooks(model_fn):
    def input_fn(payload, content_type):
        return np.asarray([[float(v) for v in line.split(",")]
                           for line in payload.decode().splitlines()], np.float32)

    def predict_fn(data, model):
        return model.predict(data)

    def output_fn(preds, accept):
        return json.dumps({"p": [float(p) for p in preds]}), "application/json"

    def transform_fn(model, payload, content_type, accept):
        preds = predict_fn(input_fn(payload, content_type), model)
        return ",".join("{:.6f}".format(p) for p in preds), "text/csv"

    return {"model_fn": model_fn, "input_fn": input_fn, "predict_fn": predict_fn,
            "output_fn": output_fn, "transform_fn": transform_fn}


@pytest.mark.parametrize("which", ["transform_fn", "model_fn/input_fn/predict_fn/output_fn"])
def test_script_mode_hooks_match_jax(models, which):
    jax_hooks, port_hooks = _common_hooks(_jax_hooks()), _common_hooks(_port_hooks())
    if which != "transform_fn":
        jax_hooks.pop("transform_fn")
        port_hooks.pop("transform_fn")
    jax_wsgi = jax_app.make_app(jax_app.ScoringService(models["json"]), hooks=jax_hooks)
    port_wsgi = app.make_app(app.ScoringService(models["json"], device="cpu"), hooks=port_hooks)
    X, _ = _data(40, seed=10)
    body, _ = _payload(X, "csv")
    a, b = _call(jax_wsgi, body=body), _call(port_wsgi, body=body)
    assert a[0] == b[0] == 200 and a[1]["Content-Type"] == b[1]["Content-Type"]
    if which == "transform_fn":
        np.testing.assert_allclose([float(v) for v in a[2].split(b",")],
                                   [float(v) for v in b[2].split(b",")], atol=2e-6)
    else:
        np.testing.assert_allclose(json.loads(a[2])["p"], json.loads(b[2])["p"], atol=1e-6)
    assert port_wsgi.service.model_format == "user"


def test_user_hooks_load_from_script(models, tmp_path, monkeypatch):
    script = tmp_path / "inference.py"
    script.write_text(
        "def transform_fn(model, payload, content_type, accept):\n"
        "    return b'rows=%d' % len(payload.splitlines()), 'text/plain'\n")
    monkeypatch.setenv("SAGEMAKER_PROGRAM", "inference.py")
    monkeypatch.setenv("SAGEMAKER_SUBMIT_DIRECTORY", str(tmp_path))
    monkeypatch.setenv("SM_MODEL_DIR", models["json"])
    hooks = server._load_user_hooks(models["json"])
    assert sorted(hooks) == ["transform_fn"]
    status, headers, body = _call(server.build_app(device="cpu"), body=b"1,2\n3,4")
    assert (status, headers["Content-Type"], body) == (200, "text/plain", b"rows=2")
    broken = tmp_path / "broken.py"
    broken.write_text("raise ImportError('nope')\n")
    monkeypatch.setenv("SAGEMAKER_PROGRAM", "broken.py")
    n_path = list(sys.path)
    with pytest.raises(ImportError):
        server._load_user_hooks(models["json"])
    assert sys.path == n_path


def test_multi_model_builds_the_mme_app(monkeypatch):
    monkeypatch.setenv("SAGEMAKER_MULTI_MODEL", "true")
    wsgi = server.build_app(device="cpu")
    assert _call(wsgi, path="/ping", method="GET")[0] == 200
    status, headers, body = _call(wsgi, path="/models", method="GET")
    assert status == 200 and headers["Content-Type"] == "application/json"
    assert json.loads(body) == {"models": []}


# ------------------------------------------------------------ model formats

@pytest.mark.parametrize("fmt", ["json", "ubjson"])
def test_load_model_any_format_matches_jax(models, fmt):
    path = os.path.join(models[fmt], "xgboost-model")
    ours, tag = compat.load_model_any_format(path, device="cpu")
    ref, ref_tag = jax_compat.load_model_any_format(path)
    assert tag == ref_tag == "xgb_format"
    assert ours.attributes == ref.attributes
    X, _ = _data(50, seed=11)
    for rng in (None, (0, 4), (2, 5)):
        np.testing.assert_allclose(ours.predict(X, iteration_range=rng),
                                   ref.predict(X, iteration_range=rng), atol=1e-6)


def test_ubjson_codec_matches_jax(models):
    with open(os.path.join(models["json"], "xgboost-model")) as f:
        doc = json.load(f)
    doc["extra"] = {"ints": [0, -1, 200, -40000, 2**31, -2**40], "none": None,
                    "flags": [True, False], "text": "naïve"}
    raw = jax_compat.encode_ubjson(doc)
    assert compat.encode_ubjson(doc) == raw
    assert compat.decode_ubjson(raw) == jax_compat.decode_ubjson(raw)
    # typed arrays of every numeric marker, and an unsized array
    typed = (b"{i\x01a[$l#i\x02\x00\x00\x00\x01\xff\xff\xff\xfe"
             b"i\x01b[$d#i\x01?\x80\x00\x00i\x01c[$U#i\x02\x01\x02"
             b"i\x01d[$M#i\x01" + (2**63).to_bytes(8, "big") + b"i\x01e[SU\x01xCy]}")
    assert compat.decode_ubjson(typed) == jax_compat.decode_ubjson(typed)


@pytest.mark.parametrize("fmt", ["config_offset", "binf", "pickle"])
def test_unported_formats_raise_user_error(models, tmp_path, fmt):
    """The formats the port once refused load as the JAX package loads
    them: a CONFIG-offset legacy buffer, a ``binf`` legacy binary file and a
    pickled Booster (its handle the JSON model) give the same format tag and
    trees, and both apps answer alike (host path exactly, 100 rows within
    1e-6)."""
    from chip_smoke import config_offset, legacy_binary, pickled_booster

    with open(os.path.join(models["json"], "xgboost-model")) as f:
        doc = f.read()
    model = jax_booster.Forest.load_json(doc)
    raw = {"config_offset": lambda: config_offset(legacy_binary(model, binf=False),
                                                  model.objective_name),
           "binf": lambda: legacy_binary(model),
           "pickle": lambda: pickled_booster(doc.encode())}[fmt]()
    (tmp_path / "xgboost-model").write_bytes(raw)
    path = str(tmp_path / "xgboost-model")
    ours, tag = compat.load_model_any_format(path, device="cpu")
    ref, ref_tag = jax_compat.load_model_any_format(path)
    assert tag == ref_tag == ("pkl_format" if fmt == "pickle" else "xgb_format")
    assert len(ours.trees) == len(ref.trees) == len(model.trees)
    assert ours.attributes == ref.attributes
    jax_wsgi = jax_app.make_app(jax_app.ScoringService(str(tmp_path)))
    port_wsgi = app.make_app(app.ScoringService(str(tmp_path), device="cpu"))
    assert _call(port_wsgi, path="/ping", method="GET")[0] == 200
    for rows in (3, 100):
        X, _ = _data(rows, seed=12)
        _same_answer(jax_wsgi, port_wsgi, rows, body=_payload(X, "csv")[0])


def test_bad_json_model_raises_and_answers_500(tmp_path):
    (tmp_path / "xgboost-model").write_bytes(b'{"learner": ')
    with pytest.raises(RuntimeError, match="cannot be loaded"):
        compat.load_model_any_format(str(tmp_path / "xgboost-model"), device="cpu")
    wsgi = app.make_app(app.ScoringService(str(tmp_path), device="cpu"))
    assert _call(wsgi, path="/ping", method="GET")[0] == 500
    assert _call(wsgi, body=b"1,2")[0] == 500


# ------------------------------------------------------------- the device

def test_service_raises_without_cuda_unless_cpu(models):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(exc.UserError, match="no CUDA device"):
        app.ScoringService(models["json"])
    with pytest.raises(exc.UserError, match="no CUDA device"):
        server.serving_entrypoint(port=0, block=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["csv", "libsvm", "recordio"])
def test_invocations_on_cuda_match_jax(models, kind):
    """The port's app on the GPU against the JAX app, on the host path (1
    row) and the device path (100 and 5000 rows)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py phase 7 serves on the card")
    jax_wsgi = jax_app.make_app(jax_app.ScoringService(models["json"]))
    port_wsgi = app.make_app(app.ScoringService(models["json"], device="cuda"))
    for rows in (1, 100, 5000):
        X, _ = _data(rows, seed=15)
        X[np.random.RandomState(16).rand(*X.shape) < 0.1] = np.nan
        body, content_type = _payload(X, kind)
        for accept in ACCEPTS:
            a, _ = _same_answer(jax_wsgi, port_wsgi, rows, body=body,
                                content_type=content_type, accept=accept)
            assert a[0] == 200


class _RaisingService:
    model = "loaded"
    model_dir = "unused"
    objective = "binary:logistic"
    num_class = ""

    def __init__(self, error):
        self.error = error
        self.calls = 0
        self.breaker = breaker.CircuitBreaker()

    def load_model(self):
        return "xgb_format"

    def predict(self, dtest, content_type):
        self.calls += 1
        raise self.error


@pytest.mark.parametrize("error,status", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), 500),
    (ValueError("Feature size of csv inference data 3 is not consistent"), 400),
    (JobQueueFull("job queue full (1 pending)"), 503),
    (TimeoutError("prediction timed out in the batch queue"), 503),
])
def test_predict_errors_map_to_status(error, status):
    service = _RaisingService(error)
    got, headers, _ = _call(app.make_app(service), body=b"1,2,3")
    assert got == status
    assert service.calls == 1  # never retried
    assert ("Retry-After" in headers) == (status == 503)


def test_job_queue_full_answers_503_with_retry_after(models, monkeypatch):
    monkeypatch.setenv("SAGEMAKER_MODEL_JOB_QUEUE_SIZE", "1")
    service = app.ScoringService(models["json"], device="cpu")
    wsgi = app.make_app(service)
    assert _call(wsgi, path="/ping", method="GET")[0] == 200
    service.warmup.join(30)
    release = threading.Event()
    model_predict = service.batcher.predict_fn
    service.batcher.predict_fn = lambda x: (release.wait(10), model_predict(x))[1]
    X, _ = _data(40, seed=12)
    body, _ = _payload(X, "csv")
    results = []
    fillers = [threading.Thread(target=lambda: results.append(_call(wsgi, body=body)))
               for _ in range(2)]
    try:
        for t in fillers:  # one in the worker's dispatch, one in the queue slot
            t.start()
            time.sleep(0.3)
        status, headers, _ = _call(wsgi, body=body)
        assert status == 503 and int(headers["Retry-After"]) >= 1
        assert service.batcher.stats()["rejected"] == 1
    finally:
        release.set()
        for t in fillers:
            t.join(30)
    assert [r[0] for r in results] == [200, 200]


# ------------------------------------------------------------------ batcher

def test_batcher_coalesced_results_equal_direct_predicts(models):
    forest = Forest.load_model(os.path.join(models["json"], "xgboost-model"), device="cpu")
    gate = threading.Event()

    def predict_fn(x):
        gate.wait(10)
        return forest.predict(x, iteration_range=(0, 4))

    batcher = PredictBatcher(predict_fn, max_wait_ms=20)
    n = 12
    inputs = [_data(3 + 7 * i, seed=20 + i)[0] for i in range(n)]
    results = [None] * n

    def issue(i):
        results[i] = batcher.predict(inputs[i], timeout=30)

    threads = [threading.Thread(target=issue, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    time.sleep(0.3)  # every request is waiting: inline, in dispatch or queued
    gate.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    for x, got in zip(inputs, results):
        np.testing.assert_allclose(got, forest.predict(x, iteration_range=(0, 4)), atol=1e-6)
    stats = batcher.stats()
    assert stats["requests"] == n
    assert stats["coalesced"] >= 2 and stats["dispatches"] + stats["inline"] < n


def test_batcher_error_reaches_every_caller():
    def boom(x):
        raise RuntimeError("CUDA error: device-side assert triggered")

    batcher = PredictBatcher(boom)
    with pytest.raises(RuntimeError, match="CUDA error"):
        batcher.predict(np.zeros((40, 2), np.float32), timeout=10)
    with pytest.raises(RuntimeError, match="CUDA error"):
        batcher.predict(np.zeros((2, 2), np.float32), timeout=10)


def test_batcher_queue_full_and_timeout():
    release = threading.Event()
    batcher = PredictBatcher(lambda x: (release.wait(10), x[:, 0])[1], max_queue=1)
    x = np.zeros((40, 2), np.float32)
    threads = [threading.Thread(target=lambda: batcher.predict(x, timeout=30))
               for _ in range(2)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.3)
        with pytest.raises(JobQueueFull):
            batcher.predict(x, timeout=10)
    finally:
        release.set()
        for t in threads:
            t.join(30)
    release.clear()
    with pytest.raises(TimeoutError):
        batcher.predict(x, timeout=0.2)
    release.set()
    assert batcher.stats()["timeouts"] == 1


# ------------------------------------------------------------------ breaker

def test_breaker_matches_jax_state_machine():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    ours = breaker.CircuitBreaker(threshold=2, cooldown_s=3.0, clock=clock)
    ref = jax_breaker.CircuitBreaker(name="torch-port-parity", threshold=2, cooldown_s=3.0,
                                     clock=clock)
    script = ["allow", "sat", "allow", "sat", "allow", "degraded", "retry", "t+1", "allow",
              "retry", "t+2.5", "degraded", "allow", "allow", "sat", "allow", "t+3",
              "allow", "ok", "allow", "degraded", "retry"]
    for step in script:
        if step.startswith("t+"):
            now[0] += float(step[2:])
            continue
        call = {"allow": lambda b: b.allow(), "sat": lambda b: b.record_saturation(),
                "ok": lambda b: b.record_success(), "degraded": lambda b: b.degraded,
                "retry": lambda b: b.retry_after_s()}[step]
        assert call(ours) == call(ref), step
        assert ours.state == ref.state, step
    assert ours.shed > 0


@pytest.mark.parametrize("env", [{}, {"SM_SHED_RETRY_AFTER_S": "2.2"},
                                 {"SM_SHED_COOLDOWN_S": "7"}, {"SM_SHED_COOLDOWN_S": "bad"}])
def test_retry_after_hint_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert breaker.retry_after_hint() == jax_breaker.retry_after_hint()


def test_load_shedding_off_never_sheds(monkeypatch):
    monkeypatch.setenv("SM_LOAD_SHEDDING", "false")
    b = breaker.CircuitBreaker(threshold=1)
    for _ in range(3):
        b.record_saturation()
    assert b.allow() and b.state == breaker.CLOSED


# ------------------------------------------------------- codecs and helpers

@pytest.mark.parametrize("body", [
    b"1,2,3\n4,,6", b"1\t2\t3", b"1;2;3\n4;5;6", b"1|2|3", b"1 2 3", b"1:2:3",
    b"1.0 ", b"1, 2, 3", b"7"])
def test_csv_decode_matches_jax(body):
    ours = encoder.csv_to_matrix(body)
    ref = jax_encoder.csv_to_matrix(body)
    np.testing.assert_array_equal(ours.features, ref.features)


@pytest.mark.parametrize("body", [b"1:0.5 3:2.0\n2:1.5", b"0:1 4:2\n1:3", b"\n", b"1:2 2:3 8:1"])
def test_libsvm_decode_matches_jax(body):
    np.testing.assert_array_equal(encoder.libsvm_to_matrix(body).features,
                                  jax_encoder.libsvm_to_matrix(body).features)


def test_parse_content_data_and_jsonlines_match_jax():
    for body, ct in ((b"1,2\n", "text/csv"), (b"1:1", "text/x-libsvm"),
                     (recordio.write_recordio_protobuf(np.ones((2, 3), np.float32)),
                      "application/x-recordio-protobuf; charset=x")):
        ours, ours_ct = serve_utils.parse_content_data(body, ct)
        ref, ref_ct = jax_serve_utils.parse_content_data(body, ct)
        np.testing.assert_array_equal(ours.features, ref.features)
        assert ours_ct == ref_ct
    for body, ct in ((b"", "application/xml"), (b"1,x", "text/csv"), (b"a:b", "libsvm"),
                     (b"\x00" * 12, "application/x-recordio-protobuf")):
        with pytest.raises(Exception) as ours:
            serve_utils.parse_content_data(body, ct)
        with pytest.raises(Exception) as ref:
            jax_serve_utils.parse_content_data(body, ct)
        assert type(ours.value).__name__ == type(ref.value).__name__
    doc = {"predictions": [{"a": 1}, {"b": [1.5, None]}]}
    assert encoder.json_to_jsonlines(doc) == jax_encoder.json_to_jsonlines(doc)
    assert encoder.json_to_jsonlines(json.dumps(doc)) == jax_encoder.json_to_jsonlines(doc)
    with pytest.raises(ValueError):
        encoder.json_to_jsonlines({"a": [], "b": []})


@pytest.mark.parametrize("value", [None, "csv", "text/csv", "TEXT/CSV; label_size=1",
                                   "text/csv;label_size=2", "libsvm", "text/x-libsvm",
                                   "application/x-parquet", "recordio-protobuf",
                                   "application/x-recordio-protobuf", "image/png"])
def test_content_types_match_jax(value):
    try:
        want = jax_content_types.get_content_type(value)
    except Exception as e:  # the JAX package's own UserError
        with pytest.raises(exc.UserError) as ours:
            content_types.get_content_type(value)
        assert str(ours.value) == str(e)
    else:
        assert content_types.get_content_type(value) == want


@pytest.mark.parametrize("raw", [None, "", "7", "-3", "1e9", "abc", "nan", "inf", "2.5",
                                 "true", "OFF", "maybe"])
def test_envconfig_matches_jax(monkeypatch, raw):
    if raw is not None:
        monkeypatch.setenv("TORCH_PORT_TEST_KNOB", raw)
    for fn, args in (("env_int", (5,)), ("env_int", (5, 0, 100)), ("env_float", (1.5,)),
                     ("env_float", (1.5, 0.1, 60.0)), ("env_bool", (True,))):
        assert getattr(envconfig, fn)("TORCH_PORT_TEST_KNOB", *args) == \
            getattr(jax_envconfig, fn)("TORCH_PORT_TEST_KNOB", *args), (fn, args)


@pytest.mark.parametrize("objective", sorted(serve_utils.VALID_OBJECTIVES))
def test_selected_predictions_match_jax(objective):
    rng = np.random.RandomState(13)
    if objective == "multi:softprob":
        raw = rng.dirichlet(np.ones(3), size=4).astype(np.float32)
    elif objective in ("multi:softmax", "binary:hinge"):
        raw = rng.randint(0, 3, 4).astype(np.float32)
    else:
        raw = rng.rand(4).astype(np.float32)
    keys = serve_utils.ALL_VALID_SELECT_KEYS
    ours = serve_utils.get_selected_predictions(raw, keys, objective, num_class="3")
    ref = jax_serve_utils.get_selected_predictions(raw, keys, objective, num_class="3")
    _assert_close(ours, ref, 0.0)
    for accept in ACCEPTS:
        a = serve_utils.encode_selected_predictions(ours, keys, accept)
        b = jax_serve_utils.encode_selected_predictions(ref, keys, accept)
        a = a.encode() if isinstance(a, str) else a
        b = b.encode() if isinstance(b, str) else b
        if accept == "application/x-recordio-protobuf":
            _assert_close(_parse(a, accept), _parse(b, accept), 0.0)
        else:
            assert a == b


def test_feature_checks_and_padding_match_jax(models):
    forest = Forest.load_model(os.path.join(models["json"], "xgboost-model"), device="cpu")
    for width in (D - 2, D - 1, D, D + 1, D + 2):
        x = np.ones((2, width), np.float32)
        for ct in ("csv", "libsvm", "recordio-protobuf", "parquet"):
            outcomes = []
            for mod, mat in ((serve_utils, DataMatrix(x)), (jax_serve_utils, JaxDataMatrix(x))):
                try:
                    mod._check_feature_count(forest, mat, ct)
                    outcomes.append(None)
                except ValueError as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1]
        np.testing.assert_array_equal(
            serve_utils.canonicalize_features(forest, DataMatrix(x)),
            jax_serve_utils.canonicalize_features(forest, JaxDataMatrix(x)))
    assert serve_utils.best_iteration_range(forest) == (0, 4)


# ---------------------------------------------------------- import hygiene

def test_serving_imports_without_protobuf_or_jax():
    code = (
        "import sys\n"
        "for name in ('google', 'google.protobuf', 'jax', 'jaxlib',"
        " 'sagemaker_xgboost_container_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from sagemaker_xgboost_container_tpu_torch.serving import app, server, serve_utils,"
        " batcher, breaker, encoder\n"
        "from sagemaker_xgboost_container_tpu_torch.data import recordio\n"
        "from sagemaker_xgboost_container_tpu_torch.models import compat\n"
        "x = np.arange(12, dtype=np.float32).reshape(3, 4)\n"
        "buf = recordio.write_recordio_protobuf(x, labels=np.ones(3))\n"
        "f, l = recordio.read_recordio_protobuf(buf)\n"
        "assert (f == x).all() and (l == 1).all()\n"
        "dtest, ct = serve_utils.parse_content_data(buf, 'application/x-recordio-protobuf')\n"
        "assert (dtest.features == x).all() and ct == 'recordio-protobuf'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'sagemaker_xgboost_container_tpu') or m.startswith('google.protobuf')]\n"
        "bad = [m for m in bad if sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ----------------------------------------------------------- real socket

def _http(url, data=None, headers=None, method="GET"):
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serving_entrypoint_real_socket(models, monkeypatch):
    import logging

    monkeypatch.setenv("SM_MODEL_DIR", models["json"])
    root = logging.getLogger()
    saved_logging = (list(root.handlers), root.level)
    saved_sigterm = signal.getsignal(signal.SIGTERM)
    saved_omp = os.environ.get("OMP_NUM_THREADS")
    httpd = server.serving_entrypoint(port=0, block=False, device="cpu")
    loop = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    try:
        base = "http://127.0.0.1:{}".format(httpd.server_port)
        assert _http(base + "/ping")[0] == 200
        assert os.environ["OMP_NUM_THREADS"]
        X, _ = _data(64, seed=14)
        body, ct = _payload(X, "csv")
        status, out = _http(base + "/invocations", body, {"Content-Type": ct,
                                                          "Accept": "application/json"},
                            method="POST")
        assert status == 200
        want = Forest.load_model(os.path.join(models["json"], "xgboost-model"),
                                 device="cpu").predict(X, iteration_range=(0, 4))
        np.testing.assert_allclose([p["score"] for p in json.loads(out)["predictions"]],
                                   want, atol=1e-6)
        # SIGTERM: the handler the entrypoint installed shuts the server down
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert httpd.stopped.wait(30)
        loop.join(30)
        assert not loop.is_alive()
        with pytest.raises(OSError):
            urllib.request.urlopen(base + "/ping", timeout=5)
    finally:
        signal.signal(signal.SIGTERM, saved_sigterm)
        if not httpd.stopped.is_set():
            httpd.stop()
        lifecycle.uninstall()  # the entrypoint installed one, now stopped
        root.handlers[:], _ = saved_logging[0], root.setLevel(saved_logging[1])
        if saved_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        warm = httpd.get_app().service.warmup
        if warm is not None:
            warm.join(30)


# ------------------------------------------------- every objective (predict)

OBJECTIVE_LABELS = {
    "reg:squaredlogerror": lambda z, r: np.exp(z * 0.3),
    "reg:pseudohubererror": lambda z, r: z,
    "reg:absoluteerror": lambda z, r: z,
    "binary:logitraw": lambda z, r: (z > 0).astype(np.float32),
    "binary:hinge": lambda z, r: (z > 0).astype(np.float32),
    "count:poisson": lambda z, r: np.floor(np.exp(z * 0.5)),
    "reg:gamma": lambda z, r: np.exp(z * 0.3),
    "reg:tweedie": lambda z, r: np.maximum(z, 0.0),
    "multi:softmax": lambda z, r: np.digitize(z, [-0.5, 0.5]),
    "multi:softprob": lambda z, r: np.digitize(z, [-0.5, 0.5]),
    "survival:aft": lambda z, r: np.exp(z * 0.3),
    "survival:cox": lambda z, r: np.exp(z * 0.3) * np.where(r.rand(len(z)) < 0.3, -1, 1),
    "rank:pairwise": lambda z, r: np.digitize(z, [-0.5, 0.5]),
    "rank:ndcg": lambda z, r: np.digitize(z, [-0.5, 0.5]),
    "rank:map": lambda z, r: (z > 0).astype(np.float32),
}


@pytest.fixture(scope="module")
def objective_apps(tmp_path_factory):
    """(JAX app, port app on the CPU) per objective, over a model the JAX
    package trained on the CPU (depth 3, 3 rounds; 3 classes for multi:*)."""
    saved = os.environ.get("GRAFT_PREDICT_WARMUP")
    os.environ["GRAFT_PREDICT_WARMUP"] = "0"
    root = tmp_path_factory.mktemp("objective_models")
    X, _ = _data(400, seed=20)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
    out = {}
    for objective, label in OBJECTIVE_LABELS.items():
        params = {"objective": objective, "max_depth": 3, "max_bin": 16, "eta": 0.3}
        if objective.startswith("multi:"):
            params["num_class"] = 3
        groups = np.full(20, 20) if objective.startswith("rank:") else None
        y = label(z, np.random.RandomState(21)).astype(np.float32)
        forest = jax_booster.train(params, JaxDataMatrix(X, y, groups=groups), 3)
        model_dir = _save(forest, root / objective.replace(":", "_"))
        out[objective] = (jax_app.make_app(jax_app.ScoringService(model_dir)),
                          app.make_app(app.ScoringService(model_dir, device="cpu")))
    yield out
    if saved is None:
        os.environ.pop("GRAFT_PREDICT_WARMUP", None)
    else:
        os.environ["GRAFT_PREDICT_WARMUP"] = saved


@pytest.mark.parametrize("objective", sorted(OBJECTIVE_LABELS))
@pytest.mark.parametrize("kind", ["csv", "libsvm", "recordio"])
@pytest.mark.parametrize("accept", ACCEPTS)
def test_every_objective_served_like_jax(objective_apps, objective, kind, accept):
    """Both apps answer alike for a model of each objective the reference
    registers: the host path (5 rows) and the device path (100 rows)."""
    jax_wsgi, port_wsgi = objective_apps[objective]
    for rows in (5, 100):
        X, _ = _data(rows, seed=22)
        X[np.random.RandomState(23).rand(*X.shape) < 0.1] = np.nan
        body, content_type = _payload(X, kind)
        a, _ = _same_answer(jax_wsgi, port_wsgi, rows, tol=1e-5, body=body,
                            content_type=content_type, accept=accept)
        assert a[0] == 200


@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_multiclass_margins_grouped_by_tree_info(objective_apps, objective):
    """Margins of a 3-class model: column c sums the trees of class c
    (``tree_info``), on the host path and the device path alike."""
    model = objective_apps[objective][1].service.model
    assert model.num_output_group == 3 and model.tree_info[:3] == [0, 1, 2]
    for rows in (7, 64):
        X, _ = _data(rows, seed=24)
        margin = model.predict(X, output_margin=True)
        assert margin.shape == (rows, 3)
        stacked, _ = model._stack(0, len(model.trees))
        from sagemaker_xgboost_container_tpu_torch.ops.predict import host_leaf_nodes
        node = host_leaf_nodes(stacked, X)
        leaf = stacked["leaf_value"][np.arange(len(model.trees))[None, :], node]
        info = np.asarray(model.tree_info)
        want = np.stack([leaf[:, info == c].sum(axis=1) for c in range(3)], axis=1) + 0.5
        np.testing.assert_allclose(margin, want, atol=1e-6)
        pred = model.predict(X)
        if objective == "multi:softprob":
            assert pred.shape == (rows, 3)
            np.testing.assert_allclose(pred.sum(axis=1), 1.0, atol=1e-6)
        else:
            np.testing.assert_array_equal(pred, np.argmax(margin, axis=1))


def _edited_model(models, tmp_path, kind):
    """The binary model as xgboost writes a dart model (the gbtree nested
    under "gbtree", with per-tree "weight_drop"), or with a categorical
    split at the root of its first tree."""
    with open(os.path.join(models["json"], "xgboost-model")) as f:
        doc = json.load(f)
    gb = doc["learner"]["gradient_booster"]
    if kind == "dart":
        doc["learner"]["gradient_booster"] = {
            "name": "dart", "gbtree": gb, "weight_drop": [0.9] * len(gb["model"]["trees"])}
    else:
        tree = gb["model"]["trees"][0]
        tree.update(categories=[1], categories_nodes=[0], categories_segments=[0],
                    categories_sizes=[1])
        tree["split_type"][0] = 1
    (tmp_path / "xgboost-model").write_text(json.dumps(doc))
    return str(tmp_path)


@pytest.mark.parametrize("booster", ["dart", "gblinear", "categorical"])
def test_unported_boosters_answer_ping_500(models, tmp_path, booster):
    """dart and gblinear models and a model with a categorical split, which
    the port once refused at load (/ping 500), answer as the JAX app
    does."""
    if booster != "gblinear":
        model_dir = _edited_model(models, tmp_path, booster)
    else:
        X, _ = _data(200, seed=25)
        forest = jax_booster.train({"booster": booster, "objective": "reg:squarederror",
                                    "max_depth": 3, "max_bin": 16}, JaxDataMatrix(X, X[:, 0]), 2)
        model_dir = _save(forest, tmp_path)
    jax_wsgi = jax_app.make_app(jax_app.ScoringService(model_dir))
    port_wsgi = app.make_app(app.ScoringService(model_dir, device="cpu"))
    assert _call(jax_wsgi, path="/ping", method="GET")[0] == 200
    assert _call(port_wsgi, path="/ping", method="GET")[0] == 200
    for rows in (3, 100):
        X, _ = _data(rows, seed=26)
        _same_answer(jax_wsgi, port_wsgi, rows, body=_payload(X, "csv")[0])
    if booster == "categorical":
        model = port_wsgi.service.model
        assert model.trees[0].has_categorical and "cat_split" in model._stack()[0]


@pytest.mark.parametrize("objective", sorted(OBJECTIVE_LABELS) + ["reg:linear"])
def test_objective_predict_side_matches_jax(objective):
    """base_margin, margin_to_prediction, validate_labels, default_metric and
    the output count of every registered objective, against the JAX one."""
    from sagemaker_xgboost_container_tpu.models import objectives as jax_objectives
    from sagemaker_xgboost_container_tpu_torch.models import objectives

    params = {"num_class": 3, "tweedie_variance_power": 1.3}
    ours = objectives.create_objective(objective, params)
    ref = jax_objectives.create_objective(objective, params)
    assert ours.name == ref.name and ours.default_metric == ref.default_metric
    assert ours.num_output_group == ref.num_output_group
    for base_score in (0.3, 0.5, 2.0):
        try:
            want = ref.base_margin(base_score)
        except Exception as e:
            with pytest.raises(exc.UserError, match=re.escape(str(e).split(": ", 1)[1])):
                ours.base_margin(base_score)
        else:
            assert ours.base_margin(base_score) == want
    rng = np.random.RandomState(27)
    margin = rng.randn(20, 3).astype(np.float32) if ours.num_output_group > 1 else \
        rng.randn(20).astype(np.float32)
    np.testing.assert_allclose(ours.margin_to_prediction(margin),
                               ref.margin_to_prediction(margin), rtol=1e-6)
    for labels in ([0.0, 1.0, 2.0], [-1.0, 0.5], [0.0, 0.5, 1.0], [3.0]):
        labels = np.asarray(labels, np.float32)

        def outcome(obj, error_type):
            try:
                obj.validate_labels(labels)
                return None
            except error_type as e:
                return str(e)

        assert outcome(ours, exc.UserError) == outcome(ref, Exception)
    trainable = objective in objectives.TRAINABLE
    if not trainable:
        with pytest.raises(exc.UserError, match=objective.replace("+", r"\+")):
            ours.grad_hess(None, None, None)
