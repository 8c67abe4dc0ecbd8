"""Port parity for k-fold cross-validation on the CPU: the numpy fold
splitters against sklearn's, the out-of-fold prediction recorder, the
fold-parallel trainer (``models/cv_parallel``) against the JAX package's
``train_cv_parallel`` on the same splits (identical trees a fold, metrics
within 1e-5), and the train entry point's ``_kfold`` path against the JAX
entry point's (the CV metric lines within 1e-5, one model a fold), both
sequential (a feval forces it) and fold-parallel."""

import importlib
import os
import re

import jax
import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import cv_parallel as jax_cv
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster, cv_parallel
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.models.sampling import TreeDraw, mask_layout
from sagemaker_xgboost_container_tpu_torch.ops import histogram, tree_build
from sagemaker_xgboost_container_tpu_torch.ops.split import ColumnMasks
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, folds
from sagemaker_xgboost_container_tpu_torch.training.prediction_utils import (
    ValidationPredictionRecorder,
)

METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")


def _jax(module):
    """A JAX-package module that imports sklearn, which the GPU machine
    lacks: imported inside the CPU tests."""
    return importlib.import_module("sagemaker_xgboost_container_tpu." + module)


def _data(n, seed=0, d=9, missing=0.03):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, d), 4).astype(np.float32)
    logit = 2.0 * X[:, 0] - 1.5 * (X[:, 1] > 0.3) + 0.8 * X[:, 2] * X[:, 3] + np.sin(X[:, 4])
    y = (logit + 0.4 * rng.randn(n) > 0).astype(np.float32)
    X[rng.rand(n, d) < missing] = np.nan
    return X, y


# ---------------------------------------------------------------- splitters


@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("n,k,repeats,classes", [(103, 5, 2, 2), (10, 3, 3, 2),
                                                 (1000, 7, 1, 4), (57, 4, 2, 3)])
def test_folds_match_sklearn(n, k, repeats, classes, stratified):
    sk = pytest.importorskip("sklearn.model_selection")
    y = np.random.RandomState(n).randint(0, classes, n).astype(np.float32)
    mine = (folds.RepeatedStratifiedKFold if stratified else folds.RepeatedKFold)(
        n_splits=k, n_repeats=repeats, random_state=np.random.RandomState(7))
    ref = (sk.RepeatedStratifiedKFold if stratified else sk.RepeatedKFold)(
        n_splits=k, n_repeats=repeats, random_state=np.random.RandomState(7))
    got = list(mine.split(X=range(n), y=y))
    want = list(ref.split(X=range(n), y=y))
    assert len(got) == len(want) == k * repeats
    for (tr, te), (tr_ref, te_ref) in zip(got, want):
        assert np.array_equal(tr, tr_ref) and np.array_equal(te, te_ref)


def test_folds_draw_from_numpys_global_state_as_sklearn():
    """random_state=None, as the entry point passes it: numpy's global
    RandomState, which sklearn takes too."""
    sk = pytest.importorskip("sklearn.model_selection")
    y = np.random.RandomState(0).randint(0, 2, 40).astype(np.float32)
    np.random.seed(11)
    got = list(folds.RepeatedStratifiedKFold(n_splits=4, n_repeats=2).split(X=range(40), y=y))
    np.random.seed(11)
    want = list(sk.RepeatedStratifiedKFold(n_splits=4, n_repeats=2).split(X=range(40), y=y))
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(got, want))


def test_stratified_folds_refuse_a_continuous_target_as_sklearn():
    with pytest.raises(ValueError, match="Supported target types"):
        list(folds.RepeatedStratifiedKFold(n_splits=2, n_repeats=1).split(
            X=range(4), y=np.array([0.5, 1.5, 2.0, 3.0])))
    with pytest.raises(ValueError, match="n_splits=5 cannot be greater"):
        list(folds.RepeatedStratifiedKFold(n_splits=5, n_repeats=1).split(
            X=range(6), y=np.array([0, 0, 0, 1, 1, 1.0])))
    with pytest.raises(ValueError, match="Cannot have number of splits"):
        list(folds.RepeatedKFold(n_splits=5, n_repeats=1).split(X=range(3)))


# ---------------------------------------------------------------- recorder


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_recorder_matches_jax(kind, tmp_path):
    rng = np.random.RandomState(3)
    n, k, repeats = 200, 4, 3
    y = rng.randint(0, 3, n).astype(np.float32)
    splits = list(folds.RepeatedKFold(n_splits=k, n_repeats=repeats,
                                      random_state=np.random.RandomState(1)).split(X=range(n)))
    recorders = [cls(y_true=y, num_cv_round=repeats, classification=kind != "regression",
                     output_data_dir=str(tmp_path / name))
                 for name, cls in (("port", ValidationPredictionRecorder),
                                   ("jax", _jax("training.prediction_utils")
                                    .ValidationPredictionRecorder))]
    for _train_idx, val_idx in splits:
        if kind == "multiclass":
            pred = rng.dirichlet(np.ones(3), len(val_idx)).astype(np.float32)
        else:
            pred = rng.rand(len(val_idx)).astype(np.float32)
        for r in recorders:
            r.record(val_idx, pred)
    for r in recorders:
        r.save()
    got = np.loadtxt(str(tmp_path / "port" / "predictions.csv"), delimiter=",")
    want = np.loadtxt(str(tmp_path / "jax" / "predictions.csv"), delimiter=",")
    assert got.shape == want.shape == (n, 3 if kind != "regression" else 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------- fold-parallel trainer


class JaxCvReplaySampler:
    """The JAX ``train_cv_parallel`` draws (``_rounds_per_dispatch`` 1), a
    fold a stream: round key ``fold_in(split(rng)[1], 0)``, fold i's key
    ``fold_in(round key, i)``; rows from ``fold_in(fold key, 13)``, the
    column set from ``fold_in(fold key, 777)``, the level and node masks
    from the fold key as JAX ``build_tree`` draws them."""

    def __init__(self, config, n, d, num_folds):
        self.config, self.n, self.d, self.F = config, n, d, num_folds
        self.rng = jax.random.PRNGKey(config.seed)

    def draw(self, rnd):
        cfg, n, d = self.config, self.n, self.d
        self.rng, sub = jax.random.split(self.rng)
        keys = [jax.random.fold_in(jax.random.fold_in(sub, 0), i) for i in range(self.F)]
        levels, _slots = mask_layout(cfg)
        keep = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 13), (n,))
                                    < cfg.subsample) for k in keys]).astype(np.float32)
        kf = max(1, int(round(cfg.colsample_bytree * d)))
        tree = np.zeros((self.F, d), np.float32)
        for i, k in enumerate(keys):
            tree[i, np.asarray(jax.random.permutation(jax.random.fold_in(k, 777), d)[:kf])] = 1
        level = np.stack([[np.asarray(jax.random.uniform(jax.random.fold_in(k, lv), (d,))
                                      < cfg.colsample_bylevel) for lv in range(levels)]
                          for k in keys]).astype(np.float32)
        node = np.stack([np.concatenate([
            np.asarray(jax.random.uniform(jax.random.fold_in(k, 7919 + lv), (2 ** lv, d))
                       < cfg.colsample_bynode) for lv in range(cfg.max_depth)])
            for k in keys]).astype(np.float32)
        masks = ColumnMasks(torch.as_tensor(tree), torch.as_tensor(level), torch.as_tensor(node))
        return [TreeDraw(torch.as_tensor(keep), masks)]


CV_PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32, "eta": 0.3,
             "min_child_weight": 2.0, "eval_metric": ["logloss", "auc", "error"],
             "_rounds_per_dispatch": 1}


@pytest.fixture(scope="module", params=["plain", "sampled"])
def cv_trained(request):
    X, y = _data(1500)
    splits = list(folds.RepeatedStratifiedKFold(
        n_splits=3, n_repeats=1, random_state=np.random.RandomState(2)).split(X=range(1500), y=y))
    params = dict(CV_PARAMS)
    if request.param == "sampled":
        params.update(subsample=0.7, colsample_bytree=0.7, colsample_bylevel=0.8,
                      colsample_bynode=0.8, seed=4)
    metrics = params["eval_metric"]
    cfg = booster.TrainConfig(params)
    calls = []
    level_histogram = tree_build.level_histogram
    tree_build.level_histogram = lambda *a: calls.append(a[2].shape) or level_histogram(*a)
    try:
        ours, ours_log = cv_parallel.train_cv_parallel(
            cfg, DataMatrix(X, y), splits, 3, metrics,
            lambda: Forest(objective_name=cfg.objective, base_score=cfg.base_score,
                           num_feature=X.shape[1], device="cpu"),
            "cpu", _sampler=(JaxCvReplaySampler(cfg, len(X), X.shape[1], len(splits))
                             if request.param == "sampled" else None))
    finally:
        tree_build.level_histogram = level_histogram
    jcfg = jax_booster.TrainConfig(params)
    ref, ref_log = jax_cv.train_cv_parallel(
        jcfg, JaxDataMatrix(X, y), splits, 3, metrics,
        lambda: JaxForest(objective_name=jcfg.objective, base_score=jcfg.base_score,
                          num_feature=X.shape[1]))
    return ours, ours_log, ref, ref_log, X, calls


def test_cv_parallel_matches_jax(cv_trained):
    ours, log, ref, ref_log, X, calls = cv_trained
    assert len(ours) == len(ref) == 3
    for fold, (a, b) in enumerate(zip(ours, ref)):
        assert a.num_boosted_rounds == b.num_boosted_rounds == 3
        for ta, tb in zip(a.trees, b.trees):
            for key in ("feature", "threshold", "default_left", "left", "right"):
                assert np.array_equal(getattr(ta, key), getattr(tb, key)), (fold, key)
            np.testing.assert_allclose(ta.value, tb.value, atol=1e-5)
        np.testing.assert_allclose(a.predict(X), b.predict(X), atol=1e-5)
        assert list(log[fold]) == list(ref_log[fold]) == ["train", "validation"]
        for data in ("train", "validation"):
            assert list(log[fold][data]) == list(ref_log[fold][data])
            for metric, values in ref_log[fold][data].items():
                np.testing.assert_allclose(log[fold][data][metric], values, atol=1e-5)
    # the folds grew different trees
    assert len({tuple(f.trees[0].feature) for f in ours}) > 1
    # one histogram call a level for all three folds, on [3, n] gradients
    assert calls == [(3, len(X))] * (3 * 3)


def test_cv_parallel_eligibility_matches_jax():
    cases = [({}, ["logloss"], False), ({}, ["logloss"], True), ({}, [], False),
             ({"grow_policy": "lossguide", "max_leaves": 8}, ["logloss"], False),
             ({"objective": "multi:softprob", "num_class": 3}, ["mlogloss"], False),
             ({"num_parallel_tree": 2}, ["logloss"], False),
             ({"objective": "rank:ndcg"}, ["ndcg"], False),
             ({"objective": "survival:cox"}, ["cox-nloglik"], False),
             ({}, ["aucpr"], False), ({"subsample": 0.5}, ["auc", "error"], False)]
    for extra, metrics, has_feval in cases:
        params = dict({"objective": "binary:logistic"}, **extra)
        assert cv_parallel.parallel_cv_supported(booster.TrainConfig(params), metrics,
                                                 has_feval) == jax_cv.parallel_cv_supported(
            jax_booster.TrainConfig(params), metrics, has_feval), (extra, metrics, has_feval)


# ---------------------------------------------------------------- entry point


def _write_csv(path, X, y):
    os.makedirs(path)
    with open(os.path.join(path, "data.csv"), "w") as f:
        for label, row in zip(y, X):
            f.write(",".join([repr(float(label))] + ["" if np.isnan(v) else repr(float(v))
                                                     for v in row]) + "\n")


class _FixedSplits:
    """Stands in for sklearn's splitter in the JAX entry point: the splits
    the port drew."""

    splits = None

    def __init__(self, n_splits, n_repeats):
        pass

    def split(self, X, y=None):
        return iter(self.splits)


@pytest.mark.parametrize("path", ["sequential", "fold_parallel"])
def test_entry_kfold_matches_jax(path, tmp_path, capsys, monkeypatch):
    stage = jax_readers.stage_input_files
    monkeypatch.setattr(jax_readers, "stage_input_files",
                        lambda p: stage(p, staging_dir=str(tmp_path / "jax_stage")))
    X, y = _data(1200, seed=5)
    train, val = str(tmp_path / "train"), str(tmp_path / "validation")
    _write_csv(train, X[:900], y[:900])
    _write_csv(val, X[900:], y[900:])
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    hp = {"num_round": "4", "max_depth": "3", "max_bin": "32", "eta": "0.3",
          "objective": "binary:logistic", "_kfold": "3", "_num_cv_round": "2",
          "eval_metric": "accuracy,logloss" if path == "sequential" else "logloss,auc",
          "_rounds_per_dispatch": "1"}
    # the port draws from numpy's global state; the JAX side gets its splits
    np.random.seed(21)
    _FixedSplits.splits = list(folds.RepeatedStratifiedKFold(n_splits=3, n_repeats=2).split(
        X=range(1200), y=y))
    jax_train = _jax("training.algorithm_train")
    monkeypatch.setattr(jax_train, "RepeatedStratifiedKFold", _FixedSplits)
    parallel = []
    monkeypatch.setattr(cv_parallel, "train_cv_parallel",
                        lambda *a, **k: parallel.append(1) or train_cv_parallel(*a, **k))
    lines = {}
    for package in ("port", "jax"):
        out_dir = tmp_path / ("output-" + package)
        monkeypatch.setenv("SM_OUTPUT_DATA_DIR", str(out_dir))
        kw = dict(train_config=dict(hp), data_config={"train": channel,
                                                       "validation": dict(channel)},
                  train_path=train, val_path=val, model_dir=str(tmp_path / package),
                  sm_hosts=["algo-1"], sm_current_host="algo-1", checkpoint_config={})
        capsys.readouterr()
        if package == "port":
            np.random.seed(21)
            algorithm_train.sagemaker_train(device="cpu", **kw)
        else:
            kw["train_config"]["_num_devices"] = "1"
            jax_train.sagemaker_train(**kw)
        lines[package] = [m.groups() for m in map(METRIC_LINE.match,
                                                   capsys.readouterr().out.splitlines()) if m]
        # (the JAX package writes a .manifest beside each model)
        assert sorted(f for f in os.listdir(str(tmp_path / package))
                      if not f.endswith(".manifest")) == [
            "xgboost-model-{}".format(k) for k in range(6)]
    assert parallel == ([1] if path == "fold_parallel" else [])
    ours, ref = lines["port"], lines["jax"]
    # a line a round a fold, then the means of each repeat and of both
    assert len(ours) == len(ref) == 6 * 4 + 3
    cv_lines = [line for line in ours if line[0] == "4"]
    assert len(cv_lines) == 3
    for (r, text), (r_ref, text_ref) in zip(ours, ref):
        parts = [p.split(":") for p in text.split("\t")]
        ref_parts = [p.split(":") for p in text_ref.split("\t")]
        assert r == r_ref and [k for k, _ in parts] == [k for k, _ in ref_parts]
        np.testing.assert_allclose([float(v) for _, v in parts],
                                   [float(v) for _, v in ref_parts], atol=1e-5)
    got = np.loadtxt(str(tmp_path / "output-port" / "predictions.csv"), delimiter=",")
    want = np.loadtxt(str(tmp_path / "output-jax" / "predictions.csv"), delimiter=",")
    assert got.shape == (1200, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


train_cv_parallel = cv_parallel.train_cv_parallel


@pytest.mark.cuda
def test_fold_axis_on_cuda_matches_cpu():
    """The fold-parallel trainer through the CUDA kernels (one hist_kernel
    launch a level and one totals_kernel launch a tree for all folds)
    against its plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this check on the card")
    X, y = _data(20_000, seed=8)
    splits = list(folds.RepeatedStratifiedKFold(
        n_splits=5, n_repeats=1, random_state=np.random.RandomState(2)).split(
        X=range(len(X)), y=y))
    cfg = booster.TrainConfig(dict(CV_PARAMS, max_depth=5))
    runs = {}
    for dev in ("cuda", "cpu"):
        histogram.reset_launch_counts()
        runs[dev] = cv_parallel.train_cv_parallel(
            cfg, DataMatrix(X, y), splits, 3, cfg.eval_metric,
            lambda: Forest(objective_name=cfg.objective, num_feature=X.shape[1], device="cpu"),
            dev)
        if dev == "cuda":
            assert histogram.LAUNCHES == {"hist_kernel": 5 * 3, "totals_kernel": 3}
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        np.testing.assert_allclose(a.predict(X), b.predict(X), atol=1e-4)
