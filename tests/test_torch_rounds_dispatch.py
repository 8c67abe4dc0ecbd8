"""``_rounds_per_dispatch``: K boosting rounds a dispatch, port against the
JAX package on the CPU.

The same numpy-seeded rows (600 x 4, depth 3) go through the JAX package's
``train`` and the port's (``device="cpu"``, where the K rounds run eagerly:
a CUDA graph is captured on the card only, ``chip_smoke.py`` phase 24). They
must commit the same rounds, give the same per-round device metrics, land
host-evaluated metric lines on the same rounds (the host cadence: once a
dispatch and at the last round), force K to 1 under approx's re-sketch, stop
early on the same round, and default K to 8 at the train entry point where
nothing must be saved every round. These mirror the JAX package's own
``tests/test_misc_components.py`` cases of the fused dispatch.
"""

import logging
import os
import re

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.data import readers as jax_readers
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu.models import cv_parallel as jax_cv
from sagemaker_xgboost_container_tpu.models.forest import Forest as JaxForest
from sagemaker_xgboost_container_tpu.telemetry import REGISTRY as JAX_REGISTRY
from sagemaker_xgboost_container_tpu.training import callbacks as jax_callbacks
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster, cv_parallel, round_graph
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY
from sagemaker_xgboost_container_tpu_torch.telemetry import device as device_telemetry
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, callbacks

N, N_VAL, D = 600, 200, 4
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32, "eta": 0.3}
PRED_RTOL, PRED_ATOL = 1e-4, 1e-5
METRIC_RTOL = 1e-4
METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")


def _data(n, seed):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, D), 4).astype(np.float32)
    logit = X[:, 0] * 1.2 + X[:, 1] * X[:, 2] * 0.8 - 0.3 * X[:, 3]
    y = (logit + rng.randn(n) * 0.8 > 0).astype(np.float32)
    return X, y


X, Y = _data(N, 0)
XV, YV = _data(N_VAL, 1)


class _Recorder:
    """Every round's evals_log snapshot, and the rounds that added values."""

    def __init__(self):
        self.fresh, self.log, self._seen = [], {}, 0

    def after_iteration(self, forest, rnd, evals_log):
        total = sum(len(v) for m in evals_log.values() for v in m.values())
        if total != self._seen:
            self._seen = total
            self.fresh.append(rnd)
        self.log = {d: {m: list(v) for m, v in ms.items()} for d, ms in evals_log.items()}
        return False


def _feval(margin, dm):
    labels = np.asarray(dm.labels)
    return [("err_at_0", float(np.mean((np.asarray(margin) > 0) != (labels > 0.5))))]


def _port(params, rounds, K, feval=None, callbacks_=None):
    rec = _Recorder()
    forest = train(dict(params, _rounds_per_dispatch=K), DataMatrix(X, Y), rounds,
                   evals=[(DataMatrix(XV, YV), "validation")], feval=feval, device="cpu",
                   callbacks=[rec] + list(callbacks_ or []), verbose_eval=False)
    return forest, rec


def _jax(params, rounds, K, feval=None, callbacks_=None):
    rec = _Recorder()
    forest = jax_booster.train(dict(params, _rounds_per_dispatch=K), JaxDataMatrix(X, Y),
                               rounds, evals=[(JaxDataMatrix(XV, YV), "validation")],
                               feval=feval, callbacks=[rec] + list(callbacks_ or []),
                               verbose_eval=False)
    return forest, rec


def _same_splits(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        np.testing.assert_array_equal(ta.left, tb.left)
        np.testing.assert_array_equal(ta.feature, tb.feature)
        np.testing.assert_array_equal(ta.threshold, tb.threshold)


@pytest.mark.parametrize("K,rounds", [(3, 6), (4, 6)], ids=["K3", "K4-ragged"])
def test_k_rounds_commit_what_one_round_a_dispatch_commits(K, rounds):
    one, _ = _port(PARAMS, rounds, 1)
    ours, _ = _port(PARAMS, rounds, K)
    ref, _ = _jax(PARAMS, rounds, K)
    assert ours.num_boosted_rounds == ref.num_boosted_rounds == rounds
    _same_splits(ours, one)
    _same_splits(ours, ref)
    np.testing.assert_allclose(ours.predict(XV), one.predict(XV), rtol=PRED_RTOL, atol=PRED_ATOL)
    np.testing.assert_allclose(ours.predict(XV), ref.predict(XV), rtol=PRED_RTOL, atol=PRED_ATOL)


def test_device_metrics_ride_the_dispatch_every_round():
    params = dict(PARAMS, eval_metric=["rmse", "auc"])
    _, one = _port(params, 8, 1)
    _, ours = _port(params, 8, 4)
    _, ref = _jax(params, 8, 4)
    assert ours.fresh == ref.fresh == list(range(8))
    for metric in ("rmse", "auc"):
        got = ours.log["validation"][metric]
        assert len(got) == 8
        np.testing.assert_allclose(got, one.log["validation"][metric], rtol=METRIC_RTOL)
        np.testing.assert_allclose(got, ref.log["validation"][metric], rtol=METRIC_RTOL)


@pytest.mark.parametrize("params,feval", [
    (dict(PARAMS, eval_metric=["auc"]), _feval),
    (dict(PARAMS, eval_metric=["aucpr"]), None),
], ids=["feval", "host-metric"])
def test_host_metrics_land_once_a_dispatch_and_at_the_last_round(params, feval):
    _, ours = _port(params, 6, 4, feval=feval)
    _, ref = _jax(params, 6, 4, feval=feval)
    assert ours.fresh == ref.fresh == [3, 5]
    assert sorted(ours.log["validation"]) == sorted(ref.log["validation"])
    for metric, values in ref.log["validation"].items():
        assert len(ours.log["validation"][metric]) == len(values) == 2
        np.testing.assert_allclose(ours.log["validation"][metric], values, atol=1e-5)


def test_approx_forces_one_round_a_dispatch_and_warns_once(caplog, monkeypatch):
    monkeypatch.setattr(booster, "_approx_k_forcing_warned", False)
    params = dict(PARAMS, tree_method="approx")
    with caplog.at_level(logging.WARNING, logger=booster.logger.name):
        _port(params, 3, 4)
        assert REGISTRY.gauge("dispatch_fused_rounds").value == 1
        _port(params, 3, 4)
    warned = [r for r in caplog.records if "forcing _rounds_per_dispatch=4 -> 1" in r.message]
    assert len(warned) == 1


@pytest.mark.parametrize("params,feval", [
    (dict(PARAMS, eval_metric=["logloss"], eta=1.0, max_depth=3), None),
    (dict(PARAMS, eval_metric=["auc"], eta=1.0, max_depth=3), _feval),
], ids=["device-metric", "host-cadence"])
def test_early_stopping_mid_dispatch_matches_jax(params, feval):
    metric = "err_at_0" if feval is not None else "logloss"
    ours_stop = callbacks.EarlyStopping(2, "validation", metric, maximize=False)
    ref_stop = jax_callbacks.EarlyStopping(2, "validation", metric, maximize=False)
    ours, _ = _port(params, 40, 4, feval=feval, callbacks_=[ours_stop])
    ref, _ = _jax(params, 40, 4, feval=feval, callbacks_=[ref_stop])
    ours = ours_stop.after_training(ours)
    ref = ref_stop.after_training(ref)
    assert ours.num_boosted_rounds == ref.num_boosted_rounds < 40
    assert ours.attributes["best_iteration"] == ref.attributes["best_iteration"]
    assert ours_stop.best_iteration == ref_stop.best_iteration


def test_fused_rounds_gauge_and_compiled_record(monkeypatch):
    monkeypatch.setenv("SM_DEVICE_TELEMETRY", "true")
    device_telemetry._reset_for_tests()
    try:
        _port(PARAMS, 6, 4)
        record = device_telemetry.last_compiled()
    finally:
        device_telemetry._reset_for_tests()
    _jax(PARAMS, 6, 4)
    assert REGISTRY.gauge("dispatch_fused_rounds").value == 4
    assert JAX_REGISTRY.gauge("dispatch_fused_rounds").value == 4
    assert record["rounds_per_dispatch"] == 4
    assert record["dispatch_graph"] == "eager"
    assert record["dispatch_graph_reason"] == "a cpu session runs its rounds eagerly"


@pytest.mark.parametrize("device,K,group,approx,extra,captured", [
    ("cuda", 8, None, False, {}, True),
    ("cuda", 8, None, False, {"grow_policy": "lossguide", "max_leaves": 7}, True),
    ("cuda", 8, None, False, {"objective": "rank:ndcg"}, True),
    ("cuda", 1, None, False, {}, False),
    ("cuda", 8, object(), False, {}, False),
    ("cuda", 8, None, True, {}, False),
    ("cuda", 8, None, False, {"booster": "dart"}, False),
    ("cpu", 8, None, False, {}, False),
])
def test_capture_decision_is_static(device, K, group, approx, extra, captured):
    import torch

    cfg = booster.TrainConfig(dict(PARAMS, **extra))
    got, reason = round_graph.capture_decision(torch.device(device), K, group, cfg, approx)
    assert got is captured and reason


def test_fold_parallel_cv_runs_k_rounds_a_dispatch():
    from sagemaker_xgboost_container_tpu_torch.training import folds

    params = dict(PARAMS, eval_metric=["logloss", "auc"], _rounds_per_dispatch=3)
    Xa, ya = np.concatenate([X, XV]), np.concatenate([Y, YV])
    splits = list(folds.RepeatedStratifiedKFold(
        n_splits=3, n_repeats=1, random_state=np.random.RandomState(2)).split(
            X=range(len(ya)), y=ya))
    cfg, jcfg = booster.TrainConfig(params), jax_booster.TrainConfig(params)
    ours, ours_log = cv_parallel.train_cv_parallel(
        cfg, DataMatrix(Xa, ya), splits, 5, params["eval_metric"],
        lambda: Forest(objective_name=cfg.objective, base_score=cfg.base_score,
                       num_feature=D, device="cpu"), "cpu")
    ref, ref_log = jax_cv.train_cv_parallel(
        jcfg, JaxDataMatrix(Xa, ya), splits, 5, params["eval_metric"],
        lambda: JaxForest(objective_name=jcfg.objective, base_score=jcfg.base_score,
                          num_feature=D))
    assert REGISTRY.gauge("dispatch_fused_rounds").value == 3
    for a, b, la, lb in zip(ours, ref, ours_log, ref_log):
        assert a.num_boosted_rounds == b.num_boosted_rounds == 5
        for data in ("train", "validation"):
            for metric in params["eval_metric"]:
                assert len(la[data][metric]) == 5
                np.testing.assert_allclose(la[data][metric], lb[data][metric],
                                           rtol=METRIC_RTOL)


# --------------------------------------------------------------- the entry point


def _write_csv(path, X, y):
    os.makedirs(path)
    np.savetxt(os.path.join(path, "data.csv"), np.column_stack([y, X]), delimiter=",",
               fmt="%.4f")


@pytest.fixture
def channels(tmp_path, monkeypatch):
    stage = jax_readers.stage_input_files
    monkeypatch.setattr(jax_readers, "stage_input_files",
                        lambda path: stage(path, staging_dir=str(tmp_path / "jax_stage")))
    _write_csv(str(tmp_path / "train"), X, Y)
    _write_csv(str(tmp_path / "validation"), XV, YV)
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    return {"data_config": {"train": channel, "validation": dict(channel)},
            "train_path": str(tmp_path / "train"), "val_path": str(tmp_path / "validation")}


def _entry(package, hp, channels, model_dir, capsys, checkpoint_dir=None):
    """sagemaker_train of one package -> {round: {key: value}} of its lines."""
    import importlib

    kw = dict(train_config=dict(hp), model_dir=model_dir, sm_hosts=["algo-1"],
              sm_current_host="algo-1",
              checkpoint_config={"LocalPath": checkpoint_dir} if checkpoint_dir else {},
              **channels)
    capsys.readouterr()
    if package == "port":
        algorithm_train.sagemaker_train(device="cpu", **kw)
    else:
        kw["train_config"]["_num_devices"] = "1"
        importlib.import_module(
            "sagemaker_xgboost_container_tpu.training.algorithm_train").sagemaker_train(**kw)
    lines = {}
    for line in capsys.readouterr().out.splitlines():
        m = METRIC_LINE.match(line)
        if m:
            lines[int(m.group(1))] = {k: float(v) for k, v in
                                      (p.split(":") for p in m.group(2).split("\t"))}
    return lines


ENTRY_HP = {"num_round": "3", "max_depth": "3", "max_bin": "32", "eta": "0.3",
            "objective": "binary:logistic", "eval_metric": "logloss"}


@pytest.mark.parametrize("extra,env,checkpoint,want", [
    ({}, None, False, 8),
    ({}, None, True, 1),
    ({"save_model_on_termination": "true"}, None, False, 1),
    ({"_rounds_per_dispatch": "3"}, None, False, 3),
    ({"_rounds_per_dispatch": "2"}, None, True, 2),
    ({}, "5", False, 5),
], ids=["default", "checkpoints", "save-on-termination", "explicit", "explicit-checkpoints",
        "env-default"])
def test_entry_point_default_rounds_a_dispatch(extra, env, checkpoint, want, channels,
                                               tmp_path, capsys, monkeypatch):
    if env is not None:
        monkeypatch.setenv("SM_ROUNDS_PER_DISPATCH_DEFAULT", env)
    seen = []
    real = booster._TrainingSession._plan_dispatch

    def plan(session, config, has_feval):
        real(session, config, has_feval)
        seen.append(session.rounds_per_dispatch)

    monkeypatch.setattr(booster._TrainingSession, "_plan_dispatch", plan)
    _entry("port", dict(ENTRY_HP, **extra), channels, str(tmp_path / "model"), capsys,
           checkpoint_dir=str(tmp_path / "ckpt") if checkpoint else None)
    assert seen == [want]


def test_entry_point_hpo_lines_match_jax_under_the_default(channels, tmp_path, capsys):
    # aucpr has no device form: both packages evaluate it on the host once
    # an 8-round dispatch and at the last round
    hp = dict(ENTRY_HP, num_round="10", eval_metric="aucpr,logloss")
    lines = {package: _entry(package, hp, channels, str(tmp_path / package), capsys)
             for package in ("port", "jax")}
    assert sorted(lines["port"]) == sorted(lines["jax"]) == [7, 9]
    for rnd, values in lines["jax"].items():
        assert sorted(lines["port"][rnd]) == sorted(values)
        for key, value in values.items():
            assert abs(lines["port"][rnd][key] - value) <= 1e-5 + 1e-12, (rnd, key)


# ------------------------------------------------------------- across ranks


@pytest.fixture(scope="module")
def across_ranks():
    from util_torch_ranks import dispatch_suite, run_ranks

    return run_ranks(dispatch_suite, args=(3,), timeout=300)


@pytest.mark.parametrize("name", ["device-metrics", "host-metric", "cox"])
def test_k_rounds_across_ranks_match_one_round_a_dispatch(name, across_ranks):
    """Two gloo ranks, each on its own rows: K=3 (eager across ranks, each
    round's metrics evaluated after it as at K=1) commits K=1's trees, and
    its lines carry K=1's values, every round for the device metrics and
    once a dispatch and at the last round for a host metric. Each round's
    collective fields stay at K=1's per-round scale: the bytes the same
    over the run, the round's host time a dispatch's over its rounds."""
    from util_torch_ranks import DISPATCH_CASES

    rounds = DISPATCH_CASES[name][1]
    for rank in across_ranks:
        (trees1, log1, fresh1, comm1) = rank[name][1]
        (trees3, log3, fresh3, comm3) = rank[name][3]
        for a, b in zip(trees1, trees3):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        assert fresh1 == list(range(rounds))
        want = list(range(rounds)) if name != "host-metric" else [2, 5, 6]
        assert fresh3 == want
        for metric, values in log3["train"].items():
            assert values == [log1["train"][metric][r] for r in want], metric
        assert len(comm1) == len(comm3) == rounds
        bytes1, bytes3 = [b for b, _ms in comm1], [b for b, _ms in comm3]
        assert min(bytes1) > 0
        # a dispatch's bytes over its k rounds: the same total, each round
        # within one byte of the dispatch's mean of K=1's
        assert abs(sum(bytes3) - sum(bytes1)) <= rounds
        for start in range(0, rounds, 3):
            chunk = bytes1[start:start + 3]
            assert all(abs(b - sum(chunk) / len(chunk)) <= 1
                       for b in bytes3[start:start + 3]), (bytes1, bytes3)
        # the round's ms is the same in each of its dispatch's rounds
        ms3 = [ms for _b, ms in comm3]
        assert ms3[0] == ms3[1] == ms3[2] and ms3[3] == ms3[4] == ms3[5], ms3
    assert across_ranks[0][name][3][1] == across_ranks[1][name][3][1]
