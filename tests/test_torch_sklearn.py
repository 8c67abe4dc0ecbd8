"""The port's sklearn-style estimators (``sagemaker_xgboost_container_tpu_torch
.sklearn``) against the JAX package's on the same numpy-seeded data, on the
CPU: predictions within 1e-5, scores and normalized importances within
1e-6, ``clone`` and ``cross_val_score`` composing as they do with JAX's,
and the module importing and training without sklearn."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu import sklearn as jax_sklearn
from sagemaker_xgboost_container_tpu_torch import sklearn as port_sklearn
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
PARAMS = {"n_estimators": 4, "max_depth": 3, "max_bin": 32, "eta": 0.3, "reg_lambda": 2.0,
          "reg_alpha": 0.1}


def _rows(n=600, d=6, seed=0, classes=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    score = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + rng.randn(n) * 0.2
    if classes == 0:
        return X, score.astype(np.float32)
    if classes == 2:
        return X, (score > 0).astype(np.float32)
    return X, np.digitize(score, np.quantile(score, np.linspace(0, 1, classes + 1)[1:-1])
                          ).astype(np.float32)


def _pair(kind, **params):
    params = dict(PARAMS, **params)
    ref = getattr(jax_sklearn, "TPUXGB" + kind)(**params)
    ours = getattr(port_sklearn, "TorchXGB" + kind)(device="cpu", **params)
    return ref, ours


def test_regressor_matches_jax():
    X, y = _rows()
    ref, ours = _pair("Regressor")
    ref.fit(X, y)
    ours.fit(X, y)
    Xt, yt = _rows(200, seed=1)
    np.testing.assert_allclose(ours.predict(Xt), ref.predict(Xt), rtol=TOL, atol=TOL)
    assert abs(ours.score(Xt, yt) - ref.score(Xt, yt)) < 1e-6
    np.testing.assert_allclose(ours.feature_importances_, ref.feature_importances_, atol=1e-6)
    assert abs(float(ours.feature_importances_.sum()) - 1.0) < 1e-6
    assert isinstance(ours.get_booster(), Forest)
    assert ours._train_params() == ref._train_params()
    assert ours._train_params()["lambda"] == 2.0 and "reg_lambda" not in ours._train_params()


@pytest.mark.parametrize("classes", [2, 3])
def test_classifier_matches_jax(classes):
    # 800 rows: at 600 the binary fixture holds an f32 near-tie of two
    # splits (tree 3, node 3) that the two packages' sums resolve apart
    X, y = _rows(800, classes=classes)
    ref, ours = _pair("Classifier")
    ref.fit(X, y)
    ours.fit(X, y)
    assert ours.objective == ref.objective
    np.testing.assert_array_equal(ours.classes_, ref.classes_)
    Xt, yt = _rows(200, seed=2, classes=classes)
    np.testing.assert_allclose(ours.predict_proba(Xt), ref.predict_proba(Xt), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(ours.predict(Xt), ref.predict(Xt))
    assert ours.score(Xt, yt) == ref.score(Xt, yt)


def test_ranker_matches_jax():
    X, y = _rows(400, classes=4)
    group = [50] * 8
    ref, ours = _pair("Ranker")
    ref.fit(X, y, group=group)
    ours.fit(X, y, group=group)
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=TOL, atol=TOL)


def test_eval_set_sample_weight_and_save(tmp_path, capsys):
    X, y = _rows()
    w = np.random.RandomState(3).rand(len(y)).astype(np.float32) + 0.5
    ref, ours = _pair("Regressor")
    ref.fit(X, y, sample_weight=w, eval_set=[(X[:100], y[:100])])
    ours.fit(X, y, sample_weight=w, eval_set=[(X[:100], y[:100])])
    assert "validation_0-rmse" in capsys.readouterr().out
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=TOL, atol=TOL)
    ours.save_model(str(tmp_path / "m.json"))
    loaded = Forest.load_model(str(tmp_path / "m.json"), device="cpu")
    np.testing.assert_allclose(loaded.predict(X), ours.predict(X), rtol=1e-6)


def test_params_protocol_and_clone():
    from sklearn.base import clone, is_classifier, is_regressor

    ours = port_sklearn.TorchXGBRegressor(device="cpu", **PARAMS)
    assert ours.get_params() == dict(PARAMS, objective="reg:squarederror", device="cpu")
    copy = clone(ours)
    assert copy is not ours and copy.get_params() == ours.get_params()
    copy.set_params(max_depth=5, device="cuda", n_estimators=2)
    assert (copy.params["max_depth"], copy.device, copy.n_estimators) == (5, "cuda", 2)
    assert ours.params["max_depth"] == 3
    assert is_regressor(ours) and not is_classifier(ours)
    assert is_classifier(port_sklearn.TorchXGBClassifier(device="cpu"))
    with pytest.raises(RuntimeError, match="not fitted"):
        ours.predict(np.zeros((1, 6), np.float32))


@pytest.mark.parametrize("kind,classes", [("Regressor", 0), ("Classifier", 2)])
def test_cross_val_score_matches_jax(kind, classes):
    from sklearn.model_selection import cross_val_score

    X, y = _rows(450, classes=classes)
    ref, ours = _pair(kind)
    want = cross_val_score(ref, X, y, cv=3)
    got = cross_val_score(ours, X, y, cv=3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, y = _rows(50)
    with pytest.raises(exc.UserError, match="no CUDA device"):
        port_sklearn.TorchXGBRegressor(n_estimators=1).fit(X, y)


def test_works_without_sklearn(monkeypatch):
    """With sklearn unimportable the module imports, trains, predicts and
    scores (R^2 and accuracy in numpy, equal to sklearn's)."""
    from sklearn.metrics import accuracy_score, r2_score

    X, y = _rows(300)
    Xc, yc = _rows(300, classes=3)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    module = importlib.reload(port_sklearn)
    try:
        reg = module.TorchXGBRegressor(device="cpu", **PARAMS).fit(X, y)
        clf = module.TorchXGBClassifier(device="cpu", **PARAMS).fit(Xc, yc)
        r2, acc = reg.score(X, y), clf.score(Xc, yc)
        for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
            monkeypatch.setitem(sys.modules, name, None)
        with pytest.raises(ImportError):
            reg.__sklearn_tags__()
    finally:
        monkeypatch.undo()
        importlib.reload(port_sklearn)
    assert abs(r2 - r2_score(y, reg.predict(X))) < 1e-6
    assert acc == accuracy_score(yc, clf.predict(Xc))


def test_import_does_not_load_sklearn():
    code = ("import sys; import sagemaker_xgboost_container_tpu_torch.sklearn; "
            "print(sorted(m for m in ('sklearn', 'pandas', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
