"""The port's dart and gblinear boosters against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both packages' ``train``:

* dart: the dropped sets of every round are identical (read off the trees
  each round rescales), the trees are identical in feature / threshold /
  is_leaf (and ``default_left`` where a row with a missing value reaches
  the split), and the margins agree within 1e-5;
* gblinear: weights and bias agree within 1e-5 relative (plus 1e-6
  absolute for coordinates near 0): the port sums over the rows in another
  order than XLA's dot, and takes each round's hessian sums as one matmul;
  the coordinates an L1 penalty sets to 0 are the same exact zeros;
* a model file of either booster written by either package loads and
  predicts in the other within 1e-6, as JSON and as UBJSON.
"""

import json
import os
import re

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import compat as jax_compat
from sagemaker_xgboost_container_tpu.models import cv_parallel as jax_cv
from sagemaker_xgboost_container_tpu.training import callbacks as jax_callbacks
from sagemaker_xgboost_container_tpu_torch.convert import (forest_from_reference,
                                                           linear_from_reference)
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster, compat, cv_parallel
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.models.gblinear import LinearModel
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, callbacks
from test_torch_train_entry import _missing_reaches

MARGIN_TOL = 1e-5
WEIGHT_RTOL, WEIGHT_ATOL = 1e-5, 1e-6


def _regression(n=600, seed=2, missing=0.05):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 5).astype(np.float32)
    y = (10 * X[:, 0] + 5 * np.sin(6 * X[:, 1]) + X[:, 2]).astype(np.float32)
    X[rng.rand(n, 5) < missing] = np.nan
    return X, y


def _blobs(n=450, c=3, seed=5):
    """Classes apart along every feature, so that the best gains of a
    depth-3 tree are well separated."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    y = rng.randint(0, c, size=n).astype(np.float32)
    X[:, 0] += 3.0 * y
    X[:, 1] += 2.0 * (y == 1)
    X[:, 2] -= 1.5 * (y == 2) + np.sin(3 * X[:, 3])
    return X, y


def _linear_data(n=800, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    w = np.asarray([2.0, -1.0, 0.5, 0.0, 0.0, 3.0], np.float32)
    y = X @ w + 1.5 + rng.randn(n).astype(np.float32) * 0.05
    return X, y


class DropRecorder:
    """Callback of either package: the dropout units whose leaves a round
    rescaled, that is the round's dropped set."""

    def __init__(self):
        self.rounds = []
        self._values = []

    def after_iteration(self, model, epoch, evals_log):
        indptr = model.iteration_indptr
        units = len(indptr) - 2  # the units before this round's
        dropped = [u for u in range(units)
                   if any(not np.array_equal(model.trees[t].value, self._values[t])
                          for t in range(indptr[u], indptr[u + 1]))]
        self.rounds.append(dropped)
        self._values = [t.value.copy() for t in model.trees]
        return False


def _assert_same_forest(ref, ours, X):
    assert ref.iteration_indptr == ours.iteration_indptr
    assert list(ref.tree_info) == list(ours.tree_info)
    for a, b in zip(ref.trees, ours.trees):
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.is_leaf, b.is_leaf)
        split = ~a.is_leaf
        np.testing.assert_array_equal(a.feature[split], b.feature[split])
        np.testing.assert_array_equal(a.threshold[split], b.threshold[split])
        decided = _missing_reaches(a, X)
        np.testing.assert_array_equal(a.default_left[decided], b.default_left[decided])
        np.testing.assert_allclose(a.value[a.is_leaf], b.value[b.is_leaf], atol=MARGIN_TOL)
    np.testing.assert_allclose(ref.predict(X, output_margin=True),
                               ours.predict(X, output_margin=True), atol=MARGIN_TOL)


def _both(params, X, y, rounds, xgb_model=None, callbacks_for=None):
    """(JAX model, port model) of the same params, data and rounds."""
    out = []
    for package in ("jax", "port"):
        cbs = callbacks_for(package) if callbacks_for else None
        if package == "jax":
            dm = JaxDataMatrix(X, labels=y)
            out.append(jax_booster.train(params, dm, num_boost_round=rounds,
                                         evals=[(dm, "train")], callbacks=cbs,
                                         xgb_model=xgb_model, verbose_eval=False))
        else:
            dm = DataMatrix(X, labels=y)
            out.append(booster.train(params, dm, num_boost_round=rounds, evals=[(dm, "train")],
                                     callbacks=cbs, xgb_model=xgb_model, device="cpu",
                                     verbose_eval=False))
    return out


# --------------------------------------------------------------------- dart

DART = {"booster": "dart", "max_depth": 4, "max_bin": 32, "eta": 0.3, "seed": 7}
DART_CASES = {
    "rate_drop_one_drop": {"rate_drop": 0.3, "one_drop": 1},
    "normalize_forest": {"rate_drop": 0.3, "normalize_type": "forest"},
    "weighted": {"rate_drop": 0.3, "sample_type": "weighted"},
    "weighted_forest": {"rate_drop": 0.4, "sample_type": "weighted",
                        "normalize_type": "forest", "one_drop": 1},
    "skip_drop": {"rate_drop": 0.5, "skip_drop": 0.5},
    "sampling": {"rate_drop": 0.3, "subsample": 0.8, "colsample_bytree": 0.8},
    "multiclass": {"rate_drop": 0.3, "one_drop": 1, "objective": "multi:softprob",
                   "num_class": 3, "max_depth": 3},
}


@pytest.mark.parametrize("case", sorted(DART_CASES))
def test_dart_matches_jax(case):
    params = dict(DART, **DART_CASES[case])
    X, y = _blobs() if case == "multiclass" else _regression()
    recorders = {"jax": DropRecorder(), "port": DropRecorder()}
    ref, ours = _both(params, X, y, 6, callbacks_for=lambda p: [recorders[p]])
    assert recorders["port"].rounds == recorders["jax"].rounds
    assert sum(map(len, recorders["port"].rounds)) > 0
    _assert_same_forest(ref, ours, X)
    assert ours.num_boosted_rounds == 6
    if case == "multiclass":
        assert len(ours.trees) == 18 and ours.tree_info[:3] == [0, 1, 2]


def test_dart_rate_drop_zero_is_gbtree():
    X, y = _regression(400, seed=3, missing=0.0)
    dm = DataMatrix(X, labels=y)
    dart = booster.train(dict(DART, rate_drop=0.0), dm, 5, device="cpu", verbose_eval=False)
    gbtree = booster.train({k: v for k, v in DART.items() if k != "booster"}, dm, 5,
                           device="cpu", verbose_eval=False)
    np.testing.assert_allclose(dart.predict(X), gbtree.predict(X), atol=1e-4)


@pytest.mark.parametrize("kind", ["single", "multiclass"])
def test_dart_resume_matches_jax(kind, tmp_path):
    """Three rounds written by the JAX package, three more trained by each:
    dropout covers the checkpoint's trees in both, with the same draws."""
    params = dict(DART, rate_drop=0.3, one_drop=1)
    X, y = _regression()
    if kind == "multiclass":
        params.update(objective="multi:softprob", num_class=3, max_depth=3)
        X, y = _blobs()
    first = jax_booster.train(params, JaxDataMatrix(X, labels=y), num_boost_round=3)
    path = str(tmp_path / "xgboost-checkpoint.2")
    first.save_model(path)
    recorders = {"jax": DropRecorder(), "port": DropRecorder()}
    for rec in recorders.values():
        rec._values = [t.value.copy() for t in first.trees]
    ref, ours = _both(params, X, y, 3, xgb_model=path, callbacks_for=lambda p: [recorders[p]])
    assert recorders["port"].rounds == recorders["jax"].rounds
    assert ours.num_boosted_rounds == 6
    _assert_same_forest(ref, ours, X)


def test_dart_refuses_save_best_and_warns_on_parallel_trees(caplog):
    X, y = _regression(200)
    dm = DataMatrix(X, labels=y)
    stop = callbacks.EarlyStopping(2, "train", "rmse", maximize=False, save_best=True)
    with pytest.raises(exc.UserError, match="save_best is not supported for booster=dart"):
        booster.train(DART, dm, 2, evals=[(dm, "train")], callbacks=[stop], device="cpu")
    jax_stop = jax_callbacks.EarlyStopping(2, "train", "rmse", maximize=False, save_best=True)
    jdm = JaxDataMatrix(X, labels=y)
    with pytest.raises(Exception, match="save_best is not supported for booster=dart"):
        jax_booster.train(DART, jdm, 2, evals=[(jdm, "train")], callbacks=[jax_stop])
    forest = booster.train(dict(DART, num_parallel_tree=3), dm, 2, device="cpu",
                           verbose_eval=False)
    assert len(forest.trees) == 2
    assert "ignores num_parallel_tree=3" in caplog.text


# ----------------------------------------------------------------- gblinear

GBLINEAR_CASES = {
    "squarederror": ({"eta": 0.5, "lambda": 1.0}, "linear"),
    "alpha": ({"eta": 0.5, "alpha": 300.0, "lambda": 0.0}, "linear"),
    "lambda_bias": ({"eta": 0.5, "lambda": 0.5, "lambda_bias": 0.8}, "linear"),
    "logistic": ({"objective": "binary:logistic", "eta": 0.5, "alpha": 0.01}, "binary"),
    "softprob": ({"objective": "multi:softprob", "num_class": 3, "eta": 0.5}, "blobs"),
}


def _gblinear_data(kind):
    if kind == "blobs":
        return _blobs()
    X, y = _linear_data()
    if kind == "binary":
        y = (y > 1.5).astype(np.float32)
    X[::17, 2] = np.nan  # missing counts as 0
    return X, y


def _assert_same_linear(ref, ours):
    np.testing.assert_allclose(ours.weights, ref.weights, rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL)
    np.testing.assert_allclose(ours.bias, ref.bias, rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL)
    np.testing.assert_array_equal(ours.weights == 0, ref.weights == 0)
    assert ours.num_boosted_rounds == ref.num_boosted_rounds


@pytest.mark.parametrize("case", sorted(GBLINEAR_CASES))
def test_gblinear_matches_jax(case):
    extra, kind = GBLINEAR_CASES[case]
    X, y = _gblinear_data(kind)
    ref, ours = _both(dict(extra, booster="gblinear"), X, y, 12)
    assert isinstance(ours, LinearModel)
    _assert_same_linear(ref, ours)
    if case == "alpha":
        assert (ours.weights[3:5] == 0).all()
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=1e-5, atol=1e-5)


def test_gblinear_resume_matches_jax(tmp_path):
    X, y = _gblinear_data("linear")
    params = {"booster": "gblinear", "eta": 0.5}
    half = jax_booster.train(params, JaxDataMatrix(X, labels=y), num_boost_round=6)
    path = str(tmp_path / "ckpt")
    half.save_model(path)
    ref, ours = _both(params, X, y, 6, xgb_model=path)
    assert ours.num_boosted_rounds == 12
    _assert_same_linear(ref, ours)
    whole = booster.train(params, DataMatrix(X, labels=y), 12, device="cpu",
                          verbose_eval=False)
    np.testing.assert_allclose(ours.weights, whole.weights, rtol=1e-4, atol=1e-5)


def test_gblinear_refusals(tmp_path):
    X, y = _gblinear_data("linear")
    dm = DataMatrix(X, labels=y)
    base = booster.train({"booster": "gblinear"}, dm, 2, device="cpu", verbose_eval=False)
    with pytest.raises(exc.UserError, match="booster=gblinear does not support it"):
        booster.train({"booster": "gblinear", "process_type": "update", "updater": "refresh"},
                      dm, 2, xgb_model=base, device="cpu")
    tree_model = str(tmp_path / "tree")
    booster.train({"max_depth": 2}, dm, 1, device="cpu", verbose_eval=False).save_model(
        tree_model)
    with pytest.raises(exc.UserError, match="is not a gblinear model"):
        booster.train({"booster": "gblinear"}, dm, 2, xgb_model=tree_model, device="cpu")
    stop = callbacks.EarlyStopping(1, "train", "rmse", maximize=False, save_best=True)
    with pytest.raises(exc.UserError, match="save_best is not supported for booster=gblinear"):
        booster.train({"booster": "gblinear"}, dm, 3, evals=[(dm, "train")],
                      callbacks=[stop], device="cpu", verbose_eval=False)


def test_gblinear_metric_lines_and_callbacks(capsys):
    """One metric line a round, numbered on from a resumed model's rounds."""
    X, y = _gblinear_data("binary")
    dm = DataMatrix(X, labels=y)
    params = {"booster": "gblinear", "objective": "binary:logistic",
              "eval_metric": ["logloss", "auc"]}
    first = booster.train(params, dm, 2, evals=[(dm, "train")], device="cpu")
    booster.train(params, dm, 2, evals=[(dm, "train")], xgb_model=first, device="cpu")
    lines = re.findall(r"^\[(\d+)\]\ttrain-logloss:\S+\ttrain-auc:\S+$",
                       capsys.readouterr().out, re.M)
    assert lines == ["0", "1", "2", "3"]


# ------------------------------------------------------------ cross-loading

def _dart_with_weight_drop(doc):
    """A gbtree document as xgboost writes a dart model: nested under
    "gbtree", with a dropout scale a tree in "weight_drop"."""
    gb = doc["learner"]["gradient_booster"]
    n = len(gb["model"]["trees"])
    doc["learner"]["gradient_booster"] = {
        "name": "dart", "gbtree": gb, "weight_drop": [0.5 + 0.1 * (i % 4) for i in range(n)]}
    return doc


@pytest.mark.parametrize("fmt", ["json", "ubjson"])
@pytest.mark.parametrize("model", ["gblinear", "dart", "dart_weight_drop"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_model_files_load_in_the_other_package(writer, model, fmt, tmp_path):
    X, y = (_gblinear_data("linear") if model == "gblinear" else _regression(300))
    params = ({"booster": "gblinear", "eta": 0.5} if model == "gblinear"
              else dict(DART, rate_drop=0.3, one_drop=1))
    if writer == "jax":
        trained = jax_booster.train(params, JaxDataMatrix(X, labels=y), 4)
    else:
        trained = booster.train(params, DataMatrix(X, labels=y), 4, device="cpu",
                                verbose_eval=False)
    doc = json.loads(trained.save_json())
    if model == "dart_weight_drop":
        doc = _dart_with_weight_drop(doc)
    path = str(tmp_path / "xgboost-model")
    with open(path, "wb") as f:
        f.write(jax_compat.encode_ubjson(doc) if fmt == "ubjson" else json.dumps(doc).encode())
    ours, tag = compat.load_model_any_format(path, device="cpu")
    ref, ref_tag = jax_compat.load_model_any_format(path)
    assert tag == ref_tag
    assert type(ours).__name__ == type(ref).__name__
    for rows in (5, 120):  # the host path and the device path
        np.testing.assert_allclose(ours.predict(X[:rows]), ref.predict(X[:rows]), atol=1e-6)
    if model == "dart_weight_drop":
        scaled = np.asarray(doc["learner"]["gradient_booster"]["weight_drop"], np.float32)
        plain = Forest.from_dict(json.loads(trained.save_json()), device="cpu")
        np.testing.assert_array_equal(ours.trees[1].value, plain.trees[1].value * scaled[1])


def test_convert_carries_both_boosters():
    X, y = _gblinear_data("linear")
    linear = jax_booster.train({"booster": "gblinear"}, JaxDataMatrix(X, labels=y), 3)
    ours = linear_from_reference(linear.save_json(), device="cpu")
    assert ours.save_json() == linear.save_json()
    np.testing.assert_allclose(ours.predict(X), linear.predict(X), atol=1e-6)
    Xd, yd = _regression(300)
    dart = jax_booster.train(dict(DART, rate_drop=0.3), JaxDataMatrix(Xd, labels=yd), 3)
    np.testing.assert_allclose(forest_from_reference(dart.save_json(), device="cpu")
                               .predict(Xd), dart.predict(Xd), atol=1e-6)
    with pytest.raises(exc.UserError, match="gblinear is not a tree model"):
        Forest.from_dict(json.loads(linear.save_json()), device="cpu")


# -------------------------------------------------------------- k-fold CV

@pytest.mark.parametrize("params", [
    {"booster": "dart", "rate_drop": 0.1}, {"booster": "gblinear"},
    {"process_type": "update", "updater": "refresh"}, {},
])
def test_fold_parallel_eligibility_matches_jax(params):
    """dart and gblinear never take the fold-parallel path (it grows gbtree
    trees); process_type=update does, as in the JAX package."""
    full = dict({"objective": "binary:logistic"}, **params)
    got = cv_parallel.parallel_cv_supported(booster.TrainConfig(full), ["logloss"], False)
    assert got == jax_cv.parallel_cv_supported(jax_booster.TrainConfig(full), ["logloss"],
                                               False)
    assert got == (params.get("booster", "gbtree") == "gbtree")


def test_kfold_dart_trains_fold_by_fold(tmp_path, monkeypatch):
    rng = np.random.RandomState(8)
    X = rng.randn(300, 4).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    train = tmp_path / "train"
    train.mkdir()
    with open(str(train / "data.csv"), "w") as f:
        for label, row in zip(y, X):
            f.write(",".join([repr(float(label))] + [repr(float(v)) for v in row]) + "\n")
    monkeypatch.setattr(cv_parallel, "train_cv_parallel",
                        lambda *a, **k: pytest.fail("dart took the fold-parallel path"))
    monkeypatch.setenv("SM_OUTPUT_DATA_DIR", str(tmp_path / "output"))
    hp = {"num_round": "3", "max_depth": "3", "objective": "binary:logistic",
          "booster": "dart", "rate_drop": "0.2", "_kfold": "2"}
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    algorithm_train.sagemaker_train(hp, {"train": channel}, str(train), None,
                                            str(tmp_path / "model"), ["algo-1"], "algo-1", {},
                                            device="cpu")
    assert sorted(os.listdir(str(tmp_path / "model"))) == ["xgboost-model-0",
                                                            "xgboost-model-1"]
    for k in range(2):
        model = Forest.load_model(str(tmp_path / "model" / "xgboost-model-{}".format(k)),
                                  device="cpu")
        assert model.num_boosted_rounds == 3


@pytest.mark.parametrize("kind", ["gblinear", "dart"])
def test_entry_checkpoints_and_resumes(kind, tmp_path):
    """The train entry point checkpoints each round of either booster
    through its save_model and resumes from the newest checkpoint; a
    gblinear resume equals the uninterrupted run."""
    rng = np.random.RandomState(9)
    X = rng.randn(400, 4).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.randn(400) * 0.3 > 0).astype(np.float32)
    train = tmp_path / "train"
    train.mkdir()
    with open(str(train / "data.csv"), "w") as f:
        for label, row in zip(y, X):
            f.write(",".join([repr(float(label))] + [repr(float(v)) for v in row]) + "\n")
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    hp = {"objective": "binary:logistic", "booster": kind, "eta": "0.5", "max_depth": "3",
          "rate_drop": "0.2" if kind == "dart" else "0"}
    ckpt = str(tmp_path / "ckpt")

    def run(rounds, model_dir, checkpoint):
        algorithm_train.sagemaker_train(dict(hp, num_round=str(rounds)), {"train": channel},
                                        str(train), None, str(tmp_path / model_dir),
                                        ["algo-1"], "algo-1",
                                        {"LocalPath": ckpt} if checkpoint else {}, device="cpu")
        model, _ = compat.load_model_any_format(str(tmp_path / model_dir / "xgboost-model"),
                                                device="cpu")
        return model

    run(3, "first", True)
    resumed = run(6, "second", True)
    assert resumed.num_boosted_rounds == 6
    assert sorted(n for n in os.listdir(ckpt)) == [
        "xgboost-checkpoint.{}".format(i) for i in range(6)]
    if kind == "gblinear":
        assert isinstance(resumed, LinearModel)
        whole = run(6, "whole", False)
        np.testing.assert_allclose(resumed.weights, whole.weights, rtol=1e-5, atol=1e-6)
