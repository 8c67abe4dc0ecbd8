"""What decides ``correct``, driven on the CPU at a tiny size: a sound run
of the port passes; the control (the reference in bfloat16) fails; and a
run with the timed path broken underneath fails, once for each fault a
training cell can have on one chip (a round that leaves the margins
unchanged; half of the rows left out, the mean taken over the rest; a leaf
value altered where the tree is made), and once for each fault of the
commit that makes the saved model (a threshold one cut off where the tree
is compacted; a leaf value altered where the round is appended)."""

import time

import numpy as np
import pytest
import torch

from tiny_cells import tiny_cell

from benchmark import harness, inputs, judge

CELLS = ("higgs.depthwise", "mslr.ndcg", "higgs.lossguide")
CPU = torch.device("cpu")


def _run(cell, seed=20251018):
    return harness.run(cell, seed, 0.5, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    rate = [v["value"] for k, v in out["metrics"].items() if k.endswith("rounds_per_s")]
    assert len(rate) == 1 and rate[0] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    data = inputs.make(cell.config, 7, CPU)
    R = judge.Reference(data, cell.params, CPU)
    prog = judge.control(R, data, 3)
    numbers, _counts, _judged = judge.check(R, prog, range(3))
    assert not judge.verdict(numbers, cell.limits)[0], numbers


def _planted(fault):
    def wrap(inner):
        def built(bins, grad, hess, *a, **k):
            if fault == "half":
                keep = (torch.arange(grad.shape[-1]) % 2 == 0).to(grad.dtype) * 2
                grad, hess = grad * keep, hess * keep
            tree, row_out = inner(bins, grad, hess, *a, **k)
            if fault == "unchanged":
                row_out = torch.zeros_like(row_out)
            elif fault == "altered":
                lv = tree["leaf_value"].clone()
                i = torch.argmax(torch.where(tree["is_leaf"], lv.abs(), -1.0))
                lv[i] = -lv[i]
                tree = dict(tree, leaf_value=lv)
            return tree, row_out
        return built
    return wrap


@pytest.mark.parametrize("fault", judge.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    from sagemaker_xgboost_container_tpu_torch.models import booster

    wrap = _planted(fault)
    monkeypatch.setattr(booster, "build_tree", wrap(booster.build_tree))
    monkeypatch.setattr(booster, "build_tree_lossguide", wrap(booster.build_tree_lossguide))
    out = _run(tiny_cell(name))
    assert not out["correct"], out["checks"]


def _shifted_threshold(inner):
    def compact(padded, cut_points):
        tree = inner(padded, cut_points)
        if tree.left[0] >= 0:
            cuts = np.asarray(cut_points[int(tree.feature[0])], np.float32)
            b = int(np.searchsorted(cuts, tree.threshold[0]))
            tree.threshold[0] = cuts[b + 1 if b + 1 < len(cuts) else b - 1]
        return tree
    return compact


def _altered_commit(inner):
    def append_round(self, trees, tree_info):
        for tree in trees:
            i = int(np.argmax(np.where(tree.left < 0, np.abs(tree.value), -1.0)))
            tree.value[i] = -tree.value[i]
        return inner(self, trees, tree_info)
    return append_round


@pytest.mark.parametrize("fault", ("threshold", "leaf"))
@pytest.mark.parametrize("name", CELLS)
def test_broken_commit_is_not_correct(name, fault, monkeypatch):
    from sagemaker_xgboost_container_tpu_torch.models import booster, forest

    if fault == "threshold":
        monkeypatch.setattr(booster, "compact_padded_tree",
                            _shifted_threshold(booster.compact_padded_tree))
    else:
        monkeypatch.setattr(forest.Forest, "append_round",
                            _altered_commit(forest.Forest.append_round))
    out = _run(tiny_cell(name))
    assert not out["correct"], out["checks"]


def test_threshold_off_the_cuts_reads_illegal():
    from sagemaker_xgboost_container_tpu_torch.models.forest import Tree

    cuts = [np.array([0.5, 1.5, 2.5], np.float32)]
    tree = Tree(feature=np.array([0, 0, 0], np.int32),
                threshold=np.array([1.5, 0, 0], np.float32),
                default_left=np.zeros(3, bool), left=np.array([1, -1, -1], np.int32),
                right=np.array([2, -1, -1], np.int32),
                value=np.array([0, -0.1, 0.2], np.float32), base_weight=np.zeros(3, np.float32),
                gain=np.zeros(3, np.float32), sum_hess=np.ones(3, np.float32))
    mapped = judge.forest_tree(tree, cuts)
    assert mapped["bin"][0] == 1 and mapped["matched"][0]
    assert list(mapped["left"]) == [1, 1, 2] and list(mapped["is_leaf"]) == [False, True, True]
    tree.threshold[0] = np.float32(1.25)
    mapped = judge.forest_tree(tree, cuts)
    assert not mapped["matched"][0] and mapped["bin"][0] == 0


@pytest.mark.cuda
def test_sound_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = harness.run(tiny_cell("higgs.depthwise"), 3, 0.5, False, torch.device("cuda", 0),
                      time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
