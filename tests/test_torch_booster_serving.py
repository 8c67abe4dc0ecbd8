"""dart and gblinear model files served by the port's endpoints against the
JAX package's, on the CPU: the single-model app over every content type and
accept with selectable inference, and the multi-model endpoint's load,
invoke and unload. The models are trained by the JAX package from a numpy
seed; predictions agree exactly on the host path (at most 32 rows) and
within 1e-6 on the device path."""

import json
import os

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.serving import app as jax_app
from sagemaker_xgboost_container_tpu.serving import lifecycle as jax_lifecycle
from sagemaker_xgboost_container_tpu.serving import mme as jax_mme
from sagemaker_xgboost_container_tpu_torch.models.compat import load_model_any_format
from sagemaker_xgboost_container_tpu_torch.serving import app, lifecycle, mme
from test_torch_serving import ACCEPTS, _call, _data, _payload, _same_answer

MODELS = {
    "gblinear": ({"booster": "gblinear", "objective": "binary:logistic", "eta": 0.5}, 6),
    "gblinear_multi": ({"booster": "gblinear", "objective": "multi:softprob", "num_class": 3,
                        "eta": 0.5}, 4),
    "dart": ({"booster": "dart", "objective": "binary:logistic", "max_depth": 4,
              "max_bin": 32, "rate_drop": 0.3, "one_drop": 1, "seed": 3}, 6),
}


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    saved = os.environ.get("GRAFT_PREDICT_WARMUP")
    os.environ["GRAFT_PREDICT_WARMUP"] = "0"
    X, y = _data(1200, seed=0)
    root = tmp_path_factory.mktemp("boosters")
    dirs = {}
    for name, (params, rounds) in MODELS.items():
        labels = y
        if params.get("num_class"):
            labels = (y + (X[:, 4] > 0.5)).astype(np.float32)
        model = jax_booster.train(params, JaxDataMatrix(X, labels), rounds)
        d = root / name
        d.mkdir()
        model.save_model(str(d / "xgboost-model"))
        dirs[name] = str(d)
    yield dirs
    if saved is None:
        os.environ.pop("GRAFT_PREDICT_WARMUP", None)
    else:
        os.environ["GRAFT_PREDICT_WARMUP"] = saved


@pytest.fixture(scope="module")
def apps(model_dirs):
    return {name: (jax_app.make_app(jax_app.ScoringService(d)),
                   app.make_app(app.ScoringService(d, device="cpu")))
            for name, d in model_dirs.items()}


@pytest.mark.parametrize("model", sorted(MODELS))
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
    assert _call(apps[model][1], path="/ping", method="GET")[0] == 200


@pytest.mark.parametrize("model", ["gblinear", "dart"])
@pytest.mark.parametrize("keys", ["predicted_label,probability",
                                  "labels,probabilities,raw_score"])
@pytest.mark.parametrize("accept", ACCEPTS)
@pytest.mark.parametrize("rows", [1, 100])
def test_selectable_inference_matches_jax(apps, monkeypatch, model, keys, accept, rows):
    monkeypatch.setenv("SAGEMAKER_INFERENCE_OUTPUT", keys)
    X, _ = _data(rows, seed=7)
    body, content_type = _payload(X, "csv")
    a, _ = _same_answer(*apps[model], rows, body=body, content_type=content_type,
                        accept=accept)
    assert a[0] == 200


@pytest.fixture
def _clean_lifecycle():
    for mod in (lifecycle, jax_lifecycle):
        mod.uninstall()
    yield
    for mod in (lifecycle, jax_lifecycle):
        mod.uninstall()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_mme_loads_invokes_and_releases(model_dirs, model, _clean_lifecycle, monkeypatch):
    monkeypatch.setenv("GRAFT_PREDICT_WARMUP", "0")
    ours = mme.make_mme_app(device="cpu")
    ref = jax_mme.make_mme_app(jax_mme.ModelManager())
    load = json.dumps({"model_name": model, "url": model_dirs[model]}).encode()
    X, _ = _data(60, seed=9)
    body, _ctype = _payload(X, "csv")
    for wsgi in (ours, ref):
        assert _call(wsgi, body=load, content_type="application/json", path="/models")[0] == 200
    a = _call(ours, body=body, path="/models/{}/invoke".format(model), accept="text/csv")
    b = _call(ref, body=body, path="/models/{}/invoke".format(model), accept="text/csv")
    assert a[0] == b[0] == 200 and a[1]["Content-Type"] == b[1]["Content-Type"]

    def scores(raw):
        return np.asarray([[float(c) for c in row.split(",")]
                           for row in raw.decode().split("\n") if row])

    np.testing.assert_allclose(scores(a[2]), scores(b[2]), atol=1e-6)
    want, _fmt = load_model_any_format(os.path.join(model_dirs[model], "xgboost-model"),
                                       device="cpu")
    np.testing.assert_allclose(scores(a[2]).reshape(want.predict(X).shape), want.predict(X),
                               atol=1e-6)
    entry = ours.manager._models[model]
    assert type(entry.model).__name__ == ("LinearModel" if "gblinear" in model else "Forest")
    for wsgi in (ours, ref):
        assert _call(wsgi, path="/models/{}".format(model), method="DELETE")[0] == 200
    cached = entry.model._dev if "gblinear" in model else entry.model._stacked
    assert not cached


@pytest.mark.cuda
def test_linear_model_predicts_on_cuda_like_the_cpu(model_dirs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path = os.path.join(model_dirs["gblinear_multi"], "xgboost-model")
    gpu, _ = load_model_any_format(path, device="cuda")
    cpu, _ = load_model_any_format(path, device="cpu")
    X, _ = _data(500, seed=3)
    np.testing.assert_allclose(gpu.predict(X), cpu.predict(X), atol=1e-6)
