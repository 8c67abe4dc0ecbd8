"""The least-work arithmetic on a tiny tree worked by hand, the rate of a
window between two dispatch boundaries, and where those boundaries fall."""

import numpy as np
import pytest
import torch

import tiny_cells  # noqa: F401  (puts the repo root on the path)

from benchmark import harness, work
from benchmark.reference import slot_depths


def test_rate_between_boundaries():
    # boundaries at round 8 (t = 10.0 s) and round 88 (t = 14.0 s)
    assert harness.rate((8, 10.0), (88, 14.0)) == pytest.approx(20.0)


def test_window_closes_at_a_dispatch_boundary():
    # K = 4 rounds a dispatch: boundaries after rounds 3, 7, 11 (0-based);
    # one warm-up dispatch, then a window of at least 0 s
    w = harness.Window(0.0, 1, 1, 4, torch.device("cpu"), False)
    stops = [w.after_iteration(None, r, {}) for r in range(8)]
    assert stops == [False] * 7 + [True]
    assert [r for r, _t in w.boundaries] == [4, 8]
    assert w.opened[0] == 4 and w.closed[0] == 8


def _tree():
    """Depthwise, max_depth 2: root splits; its left child splits, its
    right child is a leaf. Slots 0 / 1 2 / 3 4 5 6."""
    t = {"feature": np.zeros(7, np.int32), "bin": np.zeros(7, np.int32),
         "default_left": np.zeros(7, bool), "is_leaf": np.ones(7, bool),
         "leaf_value": np.zeros(7, np.float32), "left": np.arange(7), "right": np.arange(7)}
    for s in (0, 1):
        t["is_leaf"][s] = False
        t["left"][s], t["right"][s] = 2 * s + 1, 2 * s + 2
    return t


def test_depthwise_round_by_hand():
    tree = _tree()
    counts = np.array([100, 60, 40, 10, 50, 0, 0], float)   # rows through each slot
    vcounts = np.array([20, 12, 8, 2, 10, 0, 0], float)
    p = {"grow_policy": "depthwise", "max_depth": 2}
    d, B = 3, 5                                             # 1-byte bins
    w = work.round_work(tree, slot_depths(tree), counts, vcounts, p, d, B, "binary:logistic")
    hist_out = d * B * 8                                    # one node's G and H
    root = (100 * (3 + 12) + hist_out, 2 * 100 * 3)
    level1 = (40 * (3 + 12) + hist_out, 2 * 40 * 3)       # min(60, 40) rows, one pair
    totals = (60 * 12 + 4 * 8, 2 * 60)                     # rows at depth 2: 10 + 50
    assert w["hist_calls"] == [root, level1, totals]
    route = (100 + 60) * (1 + 8)
    rows = 100 * (16 + 12)
    valid = (20 + 12) * 1 + 20 * 12
    assert w["bytes"] == sum(c[0] for c in w["hist_calls"]) + route + rows + valid
    assert w["ops"] == sum(c[1] for c in w["hist_calls"]) + 100 * work.LOGISTIC_OPS


def test_lossguide_and_pairs_by_hand():
    tree = _tree()
    counts = np.array([100, 60, 40, 10, 50, 0, 0], float)
    vcounts = np.zeros(7)
    p = {"grow_policy": "lossguide"}
    w = work.round_work(tree, slot_depths(tree), counts, vcounts, p, 2, 300, "rank:ndcg",
                        pairs=7)
    out = 2 * 300 * 8                                        # 2-byte bins past 256
    assert w["hist_calls"] == [(100 * 16 + out, 400.0), (40 * 16 + out, 160.0),
                               (10 * 16 + out, 40.0)]
    assert w["ops"] == 600.0 + 7 * work.PAIR_OPS
    # two queries: labels (2, 0, 0) and (1, 1, 0, 3): 2 + 5 pairs differ
    assert work.ranking_pairs(np.array([2, 0, 0, 1, 1, 0, 3]), np.array([3, 4])) == 7


def test_least_seconds_takes_the_larger_bound():
    peaks = {"hbm_bytes_per_s": 1e12, "f32_ops_per_s": 1e13}
    assert work.least_seconds(2e12, 1e13, peaks) == 2.0
    assert work.least_seconds(1e11, 1e14, peaks) == 10.0
