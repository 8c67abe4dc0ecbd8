"""The options beyond gbtree / hist that train across ranks, against the
JAX package's data mesh: ``tree_method=approx``,
``booster=dart``, ``booster=gblinear``, ``process_type=update``, ``rank:ndcg``
/ ``rank:pairwise`` with ranking metrics, and ``survival:cox`` with
``cox-nloglik`` on an uneven split.

One pair of CPU gloo ranks (spawned processes) trains every case
(``tests/util_torch_ranks.options_suite``); each is held to JAX
``train(mesh=)`` on two of conftest's eight virtual devices over all rows.
The features are integer-valued (``level_data``), so each rank's cuts, their
merge and the cuts of all rows coincide, and the trees compare exactly.
Also here: the merged cuts of a hessian-weighted sketch against the JAX
merge, the ranking metrics combined over query groups (not over ranks),
the refusal of ``tree_method=exact``, a slow peer that keeps beating, and
k-fold CV through the entry point on two hosts.
"""

import os

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
from sagemaker_xgboost_container_tpu.data.matrix import DataMatrix as JaxDataMatrix
from sagemaker_xgboost_container_tpu.models import booster as jax_booster
from sagemaker_xgboost_container_tpu_torch.data.binning import compute_cut_points
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster, eval_metrics
from sagemaker_xgboost_container_tpu_torch.parallel import collectives
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from tests import util_torch_ranks as ur

# leaf values and predictions: the ranks sum their histograms in another
# order than the JAX mesh's psum, an f32 rounding difference
VALUE_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    return ur.run_ranks(ur.options_suite, timeout=240)


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("data",))


@pytest.fixture(scope="module")
def jax_models(ranks, mesh2, tmp_path_factory):
    """Each case trained by the JAX package on all rows over the mesh."""
    base = tmp_path_factory.mktemp("update") / "base.json"
    base.write_bytes(ranks[0]["update base"])
    out = {}
    for name, (params, rounds, _kind) in ur.OPTION_CASES.items():
        X, y, groups = ur.option_data(name)
        out[name] = jax_booster.train(
            dict(params), JaxDataMatrix(X, labels=y, groups=groups), num_boost_round=rounds,
            mesh=mesh2, xgb_model=str(base) if name == "update" else None)
    return out


TREE_CASES = ("approx", "dart", "update", "ndcg", "pairwise", "cox")


@pytest.mark.parametrize("name", TREE_CASES)
def test_tree_options_across_ranks_match_jax_mesh(ranks, jax_models, name):
    arrays, preds, raw, _log, _kinds = ranks[0][name]
    assert raw == ranks[1][name][2]          # every rank commits the same model
    ref = jax_models[name]
    assert len(arrays) == len(ref.trees)
    for t, (a, b) in enumerate(zip(arrays, ref.trees)):
        for key in ("feature", "threshold", "default_left", "left", "right"):
            assert np.array_equal(a[key], np.asarray(getattr(b, key))), (name, t, key)
        np.testing.assert_allclose(a["value"], b.value, atol=VALUE_TOL, err_msg=name)
    X = ur.option_data(name)[0]
    np.testing.assert_allclose(preds, ref.predict(X), atol=VALUE_TOL, err_msg=name)


def test_gblinear_across_ranks_matches_jax_mesh(ranks, jax_models):
    arrays, preds, raw, _log, kinds = ranks[0]["gblinear"]
    assert raw == ranks[1]["gblinear"][2]
    ref = jax_models["gblinear"]
    np.testing.assert_allclose(arrays["weights"], ref.weights, atol=VALUE_TOL)
    np.testing.assert_allclose(arrays["bias"], ref.bias, atol=VALUE_TOL)
    np.testing.assert_allclose(preds, ref.predict(ur.option_data("gblinear")[0]),
                               atol=VALUE_TOL)
    # a round all-reduces the 5 features' hessian sums in one call (20
    # bytes), each feature's x_j . g in one of its own (4 bytes) and the
    # bias's (sum g, sum h) in one (8 bytes)
    rounds = ur.OPTION_CASES["gblinear"][1]
    assert kinds["linear"] == rounds * (5 * 4 + 5 * 4 + 2 * 4)


@pytest.mark.parametrize("name", sorted(ur.OPTION_CASES))
def test_metric_lines_identical_on_both_ranks(ranks, name):
    a, b = ranks[0][name][3], ranks[1][name][3]
    assert a == b and a["train"]
    rounds = ur.OPTION_CASES[name][1]
    assert all(len(v) == rounds for v in a["train"].values())


@pytest.mark.parametrize("name", ["approx", "dart", "gblinear", "update", "cox"])
def test_pointwise_metric_equals_the_metric_on_all_rows(ranks, name):
    """Combined from the ranks' partial stats (or, for cox-nloglik, the
    gathered global rows), the last line equals the metric of the final
    model's predictions over all rows."""
    _arrays, preds, _raw, log, _kinds = ranks[0][name]
    _X, y, _g = ur.option_data(name)
    metric = "cox-nloglik" if name == "cox" else "logloss"
    want = eval_metrics.evaluate(metric, preds, y)
    assert abs(log["train"][metric][-1] - want) < 1e-5, (name, log["train"][metric][-1], want)


@pytest.mark.parametrize("name, metric", [("ndcg", "ndcg@5"), ("ndcg", "map"),
                                          ("pairwise", "ndcg")])
def test_ranking_metric_is_the_mean_over_every_group(ranks, name, metric):
    """The line is the mean over all query groups of both ranks (30 and 50
    of them), not the mean of the two ranks' means."""
    _arrays, preds, _raw, log, _kinds = ranks[0][name]
    X, y, groups = ur.option_data(name)
    margin = preds   # the ranking objectives predict the margin
    want = eval_metrics.evaluate(metric, margin, y, groups=groups)
    got = log["train"][metric][-1]
    assert abs(got - want) < 1e-9, (metric, got, want)
    cut = int(groups[:ur.RANK_SPLIT].sum())
    per_rank = [eval_metrics.evaluate(metric, margin[:cut], y[:cut],
                                      groups=groups[:ur.RANK_SPLIT]),
                eval_metrics.evaluate(metric, margin[cut:], y[cut:],
                                      groups=groups[ur.RANK_SPLIT:])]
    assert abs(np.mean(per_rank) - want) > 1e-6     # the two readings differ here


def test_ranking_metric_combines_over_groups_in_process(monkeypatch):
    """``MetricCombiner``: a ranking metric weighs each rank's value by its
    group count, a pointwise host metric by its weight sum."""
    parts = [np.asarray([[0.9 * 3, 3.0], [0.5 * 4.0, 4.0]]),
             np.asarray([[0.6 * 1, 1.0], [0.25 * 6.0, 6.0]])]
    monkeypatch.setattr(collectives, "all_gather",
                        lambda t, group, kind="other": torch.stack(
                            [torch.as_tensor(p) for p in parts]))
    comb = booster.MetricCombiner(object(), "cpu")
    dm = DataMatrix(np.zeros((4, 1), np.float32), labels=np.zeros(4, np.float32),
                    groups=np.asarray([1, 1, 2]))
    comb.host_metric("train", dm, "ndcg@3", 0.9)
    comb.host_metric("train", dm, "rmse", 0.5)
    lines = comb.lines()
    assert lines[0] == ("train", "ndcg@3", pytest.approx((0.9 * 3 + 0.6) / 4))
    assert lines[1] == ("train", "rmse", pytest.approx((2.0 + 1.5) / 10))
    assert comb.pairs[0].tolist() == [0.9 * 3, 3.0]     # this rank: 3 groups
    assert comb.pairs[1].tolist() == [0.5 * 4, 4.0]     # 4 rows of weight 1


def test_cox_uneven_split_pads_to_the_agreed_rows(ranks):
    """The cox case's ranks hold 700 and 303 rows: both pad to 700, so a
    round gathers 700 f32 margins a rank, and the labels and weights once."""
    kinds = ranks[0]["cox"][4]
    rounds = ur.OPTION_CASES["cox"][1]
    # a round's margins for the gradients, and each round's metric line
    assert kinds["rows"] == 2 * rounds * ur.COX_SPLIT * 4
    assert ranks[0]["cox"][2] == ranks[1]["cox"][2]


def test_global_rows_segments_in_process(monkeypatch):
    """``GlobalRows`` lays every rank's rows out at rank * n_max, padded
    with label 0 and weight 0, and hands a rank back its own segment."""
    # rank 0's side of each gather: its row count, labels, weights
    rank0 = iter([torch.tensor([5]), torch.arange(1.0, 6.0), torch.ones(5)])
    monkeypatch.setattr(collectives, "all_gather",
                        lambda t, group, kind="other": torch.stack([next(rank0), t]))
    monkeypatch.setattr(collectives, "world", lambda group: (1, 2))
    rows = booster.GlobalRows(np.asarray([10, 11, 12], np.float32), np.ones(3, np.float32),
                              object(), "cpu")
    assert (rows.n, rows.n_max, rows.offset) == (3, 5, 5)
    assert rows.labels.tolist() == [1, 2, 3, 4, 5, 10, 11, 12, 0, 0]
    assert rows.weights.tolist() == [1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
    assert rows.own(torch.arange(10.0)).tolist() == [5.0, 6.0, 7.0]


def test_merged_cuts_with_hessian_weights_equal_jax_merge(ranks, monkeypatch):
    """``merged_distributed_cuts(weights=h)`` (the approx re-sketch across
    ranks) against JAX ``_merged_distributed_cuts(..., weights=h)`` with its
    gather replaced by the two ranks' candidates; and the two ranks' own
    merges, over gloo, equal it too."""
    from jax.experimental import multihost_utils

    shards = [ur.option_shard("approx", r)[0] for r in range(2)]
    weights = [ur.sketch_weights(r) for r in range(2)]
    max_bin, width = 32, 31
    mats, counts = zip(*(booster.candidate_matrix(compute_cut_points(x, w, max_bin), width)
                         for x, w in zip(shards, weights)))
    gathered = iter([np.stack(mats), np.stack(counts)])
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda x: next(gathered))
    ref = jax_booster._merged_distributed_cuts(JaxDataMatrix(shards[0]), max_bin,
                                               weights=weights[0])
    gathered_port = iter([np.stack(mats), np.stack(counts)])
    monkeypatch.setattr(collectives, "all_gather",
                        lambda t, group, kind="other": torch.as_tensor(next(gathered_port)))
    ours = booster.merged_distributed_cuts(DataMatrix(shards[0]), max_bin, object(), "cpu",
                                           weights=weights[0])
    assert len(ours) == len(ref) == 5
    for a, b, r0, r1 in zip(ours, ref, ranks[0]["merged cuts"], ranks[1]["merged cuts"]):
        assert np.array_equal(a, b)
        assert np.array_equal(a, r0) and np.array_equal(a, r1)


def test_approx_gathers_cut_candidates_every_round(ranks):
    """Each approx round gathers one [d, max_bin - 1] f32 candidate matrix
    and the [d] counts a rank: i64 from the device lowering, i32 from the
    host sketch, which the CPU runs."""
    kinds = ranks[0]["approx"][4]
    rounds = ur.OPTION_CASES["approx"][1]
    assert kinds["cuts"] == rounds * (5 * 255 * 4 + 5 * 4)


# ---------------------------------------------------------------- refusal
def test_exact_refused_with_the_jax_message():
    want = ("tree_method='exact' does not support distributed training (it doesn't in "
            "XGBoost either); use tree_method='hist'.")
    with pytest.raises(exc.UserError) as err:
        booster.refuse_across_ranks(booster.TrainConfig({"tree_method": "exact"}))
    assert str(err.value) == "Customer Error: " + want
    for params in ({"tree_method": "approx"}, {"booster": "dart"}, {"booster": "gblinear"},
                   {"process_type": "update"}, {"objective": "rank:ndcg"},
                   {"objective": "survival:cox", "eval_metric": "cox-nloglik"}):
        booster.refuse_across_ranks(booster.TrainConfig(params))


# -------------------------------------------------------------- slow peer
def test_slow_peer_that_keeps_beating_does_not_fail_the_job(monkeypatch):
    """Rank 1 reaches the first collective after its sketch 6 s late, past
    ``GRAFT_HEARTBEAT_TIMEOUT_S=3``, while its heartbeat thread beats: the
    collective waits for it (the process group's timeout is
    ``SM_COLLECTIVE_TIMEOUT_S``, 30 minutes), and both ranks commit the
    same model."""
    from tests.util_ports import free_port

    monkeypatch.setenv("GRAFT_HEARTBEAT_TIMEOUT_S", "3")
    monkeypatch.setenv("SM_HEARTBEAT_INTERVAL_S", str(ur.SLOW_PEER_HEARTBEAT_S))
    monkeypatch.setenv("SM_HEARTBEAT_PORT", str(free_port()))
    monkeypatch.delenv("SM_COLLECTIVE_TIMEOUT_S", raising=False)
    monkeypatch.delenv("SM_ABORT_ON_STALE", raising=False)
    (raw0, _none), (raw1, beats) = ur.run_ranks(ur.slow_peer_rank, own_group=True,
                                                timeout=120)
    assert raw0 == raw1
    assert beats >= 4        # it kept beating through its 6 s


# ------------------------------------------------------- k-fold, two hosts
def test_kfold_cv_on_two_hosts(tmp_path):
    """``_kfold=3`` through the entry point on two hosts: both exit 0 with
    identical metric lines (each fold's rounds, then the CV means), the
    master saves the three fold models, and each host writes the
    out-of-fold predictions of its own train + validation rows."""
    from tests.test_torch_parallel import _finish, _metric_lines, _start_hosts

    hp = dict(ur.ENTRY_HP, _kfold="3")
    outs = _finish(_start_hosts(str(tmp_path), hp), timeout=240)
    for code, _out, err, _root in outs:
        assert code == 0, err[-3000:]
    lines = [_metric_lines(out) for _code, out, _err, _root in outs]
    rounds = int(ur.ENTRY_HP["num_round"])
    assert len(lines[0]) == 3 * rounds + 1 and lines[0] == lines[1]
    assert lines[0][-1].startswith("[{}]\t".format(rounds))   # the CV means
    assert "validation-logloss" in lines[0][-1]
    roots = [root for _code, _out, _err, root in outs]
    models = sorted(f for f in os.listdir(os.path.join(roots[0], "model"))
                    if not f.endswith(".manifest"))
    assert models == ["xgboost-model-{}".format(k) for k in range(3)]
    assert not os.path.exists(os.path.join(roots[1], "model", "xgboost-model-0"))
    for rank, root in enumerate(roots):
        (X, _y), (Xv, _yv) = ur.entry_shards(rank)
        preds = np.loadtxt(os.path.join(root, "output", "data", "predictions.csv"),
                           delimiter=",")
        assert len(preds) == len(X) + len(Xv), rank
        assert np.all(np.isfinite(preds))
