"""Port parity for the custom (feval) metrics on the CPU: the port's numpy
metrics against the JAX package's sklearn-backed ones on the same margins
and labels (within 1e-6), the same errors where a binary average meets
multiclass labels, and the train entry point's metric lines with
``eval_metric=accuracy,f1,auc`` against the JAX entry point's (within
1e-5)."""

import importlib
import json
import os
import re

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu_torch.constants import MULTI_CLASS_F1_BINARY_ERROR
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.metrics import custom_metrics
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, train_utils

N = 2000
CLASSIFICATION = ("accuracy", "balanced_accuracy", "f1", "f1_binary", "f1_macro", "precision",
                  "precision_macro", "precision_micro", "recall", "recall_macro",
                  "recall_micro")
REGRESSION = ("mse", "rmse", "mae", "r2")
BINARY_AVERAGE = ("f1_binary", "precision", "recall")
METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")


def _jax(module):
    """A JAX-package module that imports sklearn, which the GPU machine
    lacks: imported inside the CPU tests."""
    return importlib.import_module("sagemaker_xgboost_container_tpu." + module)


def _inputs(kind, seed=0):
    """(margins, labels): binary margins, [n, 4] multiclass margins, or a
    regression target with its predictions."""
    rng = np.random.RandomState(seed)
    if kind == "multiclass":
        margin = rng.randn(N, 4).astype(np.float32)
        return margin, np.where(rng.rand(N) < 0.7, margin.argmax(1),
                                rng.randint(0, 4, N)).astype(np.float32)
    margin = rng.randn(N).astype(np.float32)
    if kind == "binary":
        return margin, np.where(rng.rand(N) < 0.7, margin > 0, rng.rand(N) < 0.4).astype(
            np.float32)
    return margin, (margin + 0.5 * rng.randn(N) + 0.2).astype(np.float32)


CASES = ([(m, "binary") for m in CLASSIFICATION + REGRESSION]
         + [(m, "multiclass") for m in CLASSIFICATION if m not in BINARY_AVERAGE]
         + [(m, "regression") for m in REGRESSION])


@pytest.mark.parametrize("name,kind", CASES, ids=["{}-{}".format(m, k) for m, k in CASES])
def test_custom_metric_matches_jax(name, kind):
    margin, label = _inputs(kind)
    ours = custom_metrics.CUSTOM_METRICS[name](margin, DataMatrix(np.zeros((N, 1)), label))
    ref = _jax("metrics.custom_metrics").CUSTOM_METRICS[name](
        margin, JaxDataMatrix(np.zeros((N, 1)), label))
    assert ours == pytest.approx(ref, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("name", ["accuracy", "f1", "precision_macro", "recall_micro",
                                  "balanced_accuracy", "f1_binary"])
def test_custom_metric_edge_cases_match_jax(name):
    """One class only, a predicted class absent from the labels, and no row."""
    jax_metrics = _jax("metrics.custom_metrics").CUSTOM_METRICS
    cases = [(np.full(50, 2.0, np.float32), np.ones(50, np.float32)),
             (np.full(50, -2.0, np.float32), np.ones(50, np.float32)),
             (np.linspace(-1, 1, 40).astype(np.float32), np.zeros(40, np.float32))]
    for margin, label in cases:
        ours = custom_metrics.CUSTOM_METRICS[name](margin, DataMatrix(np.zeros((len(label), 1)),
                                                                     label))
        ref = jax_metrics[name](margin, JaxDataMatrix(np.zeros((len(label), 1)), label))
        assert ours == pytest.approx(ref, abs=1e-6)
    empty = np.zeros(0, np.float32)
    assert custom_metrics.CUSTOM_METRICS[name](empty, DataMatrix(np.zeros((0, 1)), empty)) == (
        jax_metrics[name](empty, JaxDataMatrix(np.zeros((0, 1)), empty)))


def test_multiclass_binary_average_errors_match_jax():
    """f1_binary on multiclass labels raises the UserError with
    MULTI_CLASS_F1_BINARY_ERROR in both packages; precision and recall
    (average='binary') raise sklearn's ValueError of that text."""
    margin, label = _inputs("multiclass")
    jax_metrics = _jax("metrics.custom_metrics").CUSTOM_METRICS
    with pytest.raises(exc.UserError, match=MULTI_CLASS_F1_BINARY_ERROR):
        custom_metrics.CUSTOM_METRICS["f1_binary"](margin, DataMatrix(np.zeros((N, 1)), label))
    with pytest.raises(Exception, match=MULTI_CLASS_F1_BINARY_ERROR):
        jax_metrics["f1_binary"](margin, JaxDataMatrix(np.zeros((N, 1)), label))
    for name in ("precision", "recall"):
        with pytest.raises(ValueError) as ours:
            custom_metrics.CUSTOM_METRICS[name](margin, DataMatrix(np.zeros((N, 1)), label))
        with pytest.raises(ValueError) as ref:
            jax_metrics[name](margin, JaxDataMatrix(np.zeros((N, 1)), label))
        assert str(ours.value) == str(ref.value)
        assert MULTI_CLASS_F1_BINARY_ERROR in str(ours.value)


def test_feval_split_matches_jax():
    for tuning, metrics in ((None, ["accuracy", "f1", "auc"]), ("validation:f1", ["logloss"]),
                            ("validation:auc", None), (None, ["rmse", "mae", "r2"])):
        native, feval, tuning_list = train_utils.get_eval_metrics_and_feval(tuning, metrics)
        ref_native, ref_feval, ref_tuning = _jax("training.train_utils").get_eval_metrics_and_feval(
            tuning, metrics)
        assert (native, tuning_list) == (ref_native, ref_tuning)
        assert (feval is None) == (ref_feval is None)
        if feval is not None:
            margin, label = _inputs("binary")
            got = feval(margin, DataMatrix(np.zeros((N, 1)), label))
            want = ref_feval(margin, JaxDataMatrix(np.zeros((N, 1)), label))
            assert [k for k, _ in got] == [k for k, _ in want]
            np.testing.assert_allclose([v for _, v in got], [v for _, v in want], atol=1e-6)


# ---------------------------------------------------------------- entry point


def _data(n, seed, missing=0.05):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, 9), 4).astype(np.float32)
    logit = X[:, 0] * 0.8 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3]) - 0.2
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    X[rng.rand(n, 9) < missing] = np.nan
    return X, y


def _write_csv(path, X, y):
    os.makedirs(path)
    with open(os.path.join(path, "data.csv"), "w") as f:
        for label, row in zip(y, X):
            f.write(",".join([repr(float(label))] + ["" if np.isnan(v) else repr(float(v))
                                                     for v in row]) + "\n")


def _metric_lines(out):
    lines = {}
    for line in out.splitlines():
        m = METRIC_LINE.match(line)
        if m:
            lines[int(m.group(1))] = [(k, float(v)) for k, v in
                                      (part.split(":") for part in m.group(2).split("\t"))]
    return lines


def test_entry_metric_lines_with_custom_metrics_match_jax(tmp_path, capsys, monkeypatch):
    stage = jax_readers.stage_input_files
    monkeypatch.setattr(jax_readers, "stage_input_files",
                        lambda path: stage(path, staging_dir=str(tmp_path / "jax_stage")))
    X, y = _data(3000, 0)
    Xv, yv = _data(600, 100, missing=0.0)
    train, val = str(tmp_path / "train"), str(tmp_path / "validation")
    _write_csv(train, X, y)
    _write_csv(val, Xv, yv)
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    hp = {"num_round": "5", "max_depth": "4", "max_bin": "32", "eta": "0.3",
          "objective": "binary:logistic", "eval_metric": "accuracy,f1,auc",
          "_rounds_per_dispatch": "1"}
    lines = {}
    for package in ("port", "jax"):
        kw = dict(train_config=dict(hp), data_config={"train": channel,
                                                       "validation": dict(channel)},
                  train_path=train, val_path=val, model_dir=str(tmp_path / package),
                  sm_hosts=["algo-1"], sm_current_host="algo-1", checkpoint_config={})
        capsys.readouterr()
        if package == "port":
            algorithm_train.sagemaker_train(device="cpu", **kw)
        else:
            kw["train_config"]["_num_devices"] = "1"
            _jax("training.algorithm_train").sagemaker_train(**kw)
        lines[package] = _metric_lines(capsys.readouterr().out)
    ours, ref = lines["port"], lines["jax"]
    assert sorted(ours) == sorted(ref) == list(range(5))
    for rnd in ours:
        assert [k for k, _ in ours[rnd]] == [k for k, _ in ref[rnd]] == [
            "train-auc", "train-accuracy", "train-f1", "validation-auc",
            "validation-accuracy", "validation-f1"]
        np.testing.assert_allclose([v for _, v in ours[rnd]], [v for _, v in ref[rnd]],
                                   atol=1e-5)
    assert json.loads(open(str(tmp_path / "port" / "xgboost-model")).read())["learner"]


def test_feval_values_join_the_log_and_early_stopping(capsys):
    """train(feval=) puts the feval's values after the eval metrics in the
    metric line and the log, and early stopping can stop on one of them."""
    from sagemaker_xgboost_container_tpu_torch import train
    from sagemaker_xgboost_container_tpu_torch.training.callbacks import EarlyStopping

    X, y = _data(1500, 3)
    dval = DataMatrix(*_data(400, 4))
    feval = train_utils.get_eval_metrics_and_feval(None, ["accuracy", "logloss"])[1]
    stop = EarlyStopping(rounds=2, data_name="validation", metric_name="flat",
                         maximize=True, save_best=True)
    forest = train({"objective": "binary:logistic", "max_depth": 3, "max_bin": 32,
                    "eval_metric": "logloss"}, DataMatrix(X, y), 10,
                   evals=[(dval, "validation")], device="cpu", callbacks=[stop],
                   feval=lambda m, dm: feval(m, dm) + [("flat", 0.5)])
    lines = [line for line in capsys.readouterr().out.splitlines() if METRIC_LINE.match(line)]
    assert len(lines) == 3  # rounds 0-2: "flat" never improves after round 0
    assert [p.split(":")[0] for p in lines[0].split("\t")[1:]] == [
        "validation-logloss", "validation-accuracy", "validation-flat"]
    margin = forest.predict(dval.features, output_margin=True)
    assert forest.num_boosted_rounds == 1 and forest.attributes["best_iteration"] == "0"
    assert float(lines[0].split("validation-accuracy:")[1].split("\t")[0]) == pytest.approx(
        custom_metrics.CUSTOM_METRICS["accuracy"](margin, dval), abs=1e-5)
