"""Spawn-safe targets for the local-rank tests (one training process per
local GPU, ``parallel/local.py``): gloo ranks on the CPU, each told it is a
local rank of one host, dealing itself its shard of the host's rows as the
entry point deals them.

Imports torch and the PyTorch port only: spawned children import this
module.
"""

import os
import tempfile

import numpy as np

from tests import util_torch_ranks as ur

# the cuts fixture: continuous rows, so that a rank's own sketch and the
# host's sketch of all rows differ
CUT_ROWS, CUT_FEATURES, CUT_MAX_BIN = 20000, 4, 16


def cut_data():
    rng = np.random.RandomState(40)
    X = rng.lognormal(size=(CUT_ROWS, CUT_FEATURES)).astype(np.float32)
    X[:, 1] = rng.randn(CUT_ROWS)
    return X


def continuous_data(n, d, seed, task="binary", classes=3):
    """Continuous features (two decimals) and a noisy label: ``task``
    "binary" or "multi"."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, d) * 4, 2).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] - 0.75 * X[:, 2] + rng.randn(n) * 2
    if task == "multi":
        edges = np.quantile(score, np.linspace(0, 1, classes + 1)[1:-1])
        return X, np.digitize(score, edges).astype(np.float32)
    return X, (score > np.median(score)).astype(np.float32)


# name -> (params, rounds): trained by two local ranks of one host, against
# the JAX package's 2-device mesh over all rows
LOCAL_CASES = {
    "binary": ({"objective": "binary:logistic", "max_depth": 4, "eta": 0.3, "max_bin": 32,
                "eval_metric": ["logloss"]}, 4),
    "softprob": ({"objective": "multi:softprob", "num_class": 3, "max_depth": 3, "eta": 0.3,
                  "max_bin": 32}, 3),
    "lossguide": ({"objective": "binary:logistic", "grow_policy": "lossguide",
                   "max_leaves": 15, "max_depth": 0, "eta": 0.3, "max_bin": 32}, 3),
    "exact": ({"objective": "binary:logistic", "tree_method": "exact", "max_depth": 3,
               "eta": 0.3}, 3),
    "ndcg": ({"objective": "rank:ndcg", "max_depth": 4, "eta": 0.3, "max_bin": 32,
              "eval_metric": ["ndcg@5"]}, 3),
    "cox": ({"objective": "survival:cox", "max_depth": 4, "eta": 0.3, "max_bin": 32,
             "eval_metric": ["cox-nloglik"]}, 4),
}


def local_case_data(name):
    """(X, y, group sizes or None) of case ``name``, all of the host's rows."""
    if name == "ndcg":
        X, y, sizes = ur.ranking_data(60, 5, seed=41)
        X = X + np.round(np.random.RandomState(42).rand(*X.shape), 2).astype(np.float32)
        return X, y, sizes
    if name == "cox":
        X, y = ur.cox_data(1003, 5, seed=43)
        return X, y, None
    if name == "softprob":
        X, y = continuous_data(900, 5, seed=44, task="multi")
        return X, y, None
    X, y = continuous_data(1001, 5, seed=45)
    return X, y, None


def _topology(rank):
    from sagemaker_xgboost_container_tpu_torch.parallel import local

    topo = local.Topology(1, 0, 2, rank)
    local.set_topology(topo)
    return topo


def train_local_case(rank, group, name):
    """Case ``name`` trained on this local rank's shard -> (tree arrays,
    predictions of all rows, the saved model's bytes)."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train
    from sagemaker_xgboost_container_tpu_torch.parallel import local

    params, rounds = LOCAL_CASES[name]
    X, y, groups = local_case_data(name)
    shard = local.shard_matrix(DataMatrix(X, labels=y, groups=groups), _topology(rank))
    forest = train(dict(params), shard, rounds, evals=[(shard, "train")], device="cpu",
                   group=group, verbose_eval=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.json")
        forest.save_model(path)
        with open(path, "rb") as f:
            raw = f.read()
    return ur.forest_arrays(forest), forest.predict(X), raw


def local_suite(rank, world, group):
    """Everything ``tests/test_torch_local_ranks.py`` needs from one pair of
    local ranks: the host's cuts, each rank's merged cuts of its own rows,
    and every case's model."""
    import torch

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import merged_distributed_cuts
    from sagemaker_xgboost_container_tpu_torch.parallel import local

    out = {}
    topo = _topology(rank)
    shard = local.shard_matrix(DataMatrix(cut_data()), topo)
    out["rows"] = shard.num_row
    out["host cuts"] = local.host_cuts(shard, CUT_MAX_BIN, group, torch.device("cpu"))
    out["merged cuts"] = merged_distributed_cuts(shard, CUT_MAX_BIN, group,
                                                 torch.device("cpu"))
    for name in LOCAL_CASES:
        out[name] = train_local_case(rank, group, name)
    local.set_topology(None)
    return out


def kfold_predictions(rank, world, group, X, y, splits, params, rounds):
    """The folds of ``splits`` trained as the entry point trains them on two
    local ranks of one host (each rank a contiguous share of the fold's
    training rows, the leader holding them all for the host's cuts) -> the
    out-of-fold predictions of every row (each fold's model predicting its
    held-out rows)."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train
    from sagemaker_xgboost_container_tpu_torch.parallel import local

    topo = _topology(rank)
    host = DataMatrix(X, labels=y)
    out = np.zeros(len(y), np.float32)
    for train_idx, val_idx in splits:
        shard = host.slice(local.shard_indices(train_idx, topo))
        shard.host_rows = host.slice(train_idx) if topo.is_leader else None
        forest = train(dict(params), shard, rounds, device="cpu", group=group,
                       verbose_eval=False)
        out[val_idx] = forest.predict(X[val_idx])
    local.set_topology(None)
    return out


def two_host_cuts(rank, world, group):
    """Two hosts of two local ranks each (global rank = host x 2 + local
    rank), each host holding half of the cuts fixture -> this rank's cuts."""
    import torch

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.parallel import local

    topo = local.Topology(2, rank // 2, 2, rank % 2)
    local.set_topology(topo)
    X = cut_data()
    half = CUT_ROWS // 2
    host = DataMatrix(X[:half] if topo.host_index == 0 else X[half:])
    cuts = local.host_cuts(local.shard_matrix(host, topo), CUT_MAX_BIN, group,
                           torch.device("cpu"))
    local.set_topology(None)
    return cuts
