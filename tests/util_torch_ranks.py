"""Spawn-safe rank workers for the port's data-parallel tests.

Imports torch and the PyTorch port only: every rank is a process of its own
(the ``spawn`` context), joined over a CPU ``gloo`` process group on
loopback. ``run_ranks`` starts the ranks, hands each the group and collects
one picklable result a rank, every wait under its own timeout.
"""

import os
import queue as queue_mod
import time
import traceback

import numpy as np

from tests.util_ports import free_port


def _rank_main(target, rank, world, port, q, args):
    try:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{}".format(port),
                                world_size=world, rank=rank)
        try:
            result = target(rank, world, dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, "ok", result))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(target, args=(), world=2, timeout=180.0):
    """Run ``target(rank, world, group, *args)`` on ``world`` spawned gloo
    ranks -> their results in rank order. Raises on a rank's error or a
    timeout; never leaves a process behind."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, port, q, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = {}
        deadline = time.monotonic() + timeout
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("ranks {} gave no result within {} s".format(
                    sorted(set(range(world)) - set(results)), timeout))
            try:
                rank, status, value = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank died: exit codes {}".format(
                        [p.exitcode for p in procs]))
                continue
            if status != "ok":
                raise RuntimeError("rank {} failed:\n{}".format(rank, value))
            results[rank] = value
        for p in procs:
            p.join(timeout=30)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


# ------------------------------------------------------------------ data
def level_data(n, d, seed, task="binary", levels=16, classes=3):
    """Integer-valued features with ``levels`` distinct values (every shard
    of a few hundred rows holds each, so each rank's cuts, their merge and
    the cuts of all rows agree) and a noisy label: ``task`` "binary",
    "multi" (``classes`` classes) or "reg"."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, levels, size=(n, d)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] - 0.75 * X[:, 2] + rng.randn(n)
    if task == "multi":
        edges = np.quantile(score, np.linspace(0, 1, classes + 1)[1:-1])
        return X, np.digitize(score, edges).astype(np.float32)
    if task == "binary":
        return X, (score > np.median(score)).astype(np.float32)
    return X, score.astype(np.float32)


# the training cases of the data-parallel parity tests: name -> (params,
# rows, rank 0's rows, rounds, data kwargs)
TRAIN_CASES = {
    "binary": ({"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
                "eval_metric": ["logloss", "error"]}, 1000, 500, 4, {}),
    "softprob": ({"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
                  "eta": 0.3}, 900, 450, 3, {"task": "multi"}),
    "lossguide": ({"objective": "binary:logistic", "grow_policy": "lossguide",
                   "max_leaves": 15, "max_depth": 0, "eta": 0.3}, 1000, 500, 3, {}),
    "uneven": ({"objective": "reg:squarederror", "max_depth": 4, "eta": 0.3}, 1003, 700, 4,
               {"task": "reg", "d": 4}),
}


# trained across ranks, held to themselves (the JAX package's threefry
# draws cannot be replayed across ranks): row and column sampling
OWN_CASES = {
    "sampled": ({"objective": "binary:logistic", "max_depth": 4, "eta": 0.3, "seed": 3,
                 "subsample": 0.8, "colsample_bytree": 0.8, "colsample_bynode": 0.7},
                1003, 600, 3, {}),
}
CASES = dict(TRAIN_CASES, **OWN_CASES)


def case_data(name):
    _params, n, _split, _rounds, kw = CASES[name]
    kw = dict(kw)
    d = kw.pop("d", 5)
    return level_data(n, d, seed=len(name), **kw)


def forest_arrays(forest):
    """A Forest's trees as plain arrays (picklable, comparable)."""
    return [{k: np.asarray(getattr(t, k)) for k in
             ("feature", "threshold", "default_left", "left", "right", "value")}
            for t in forest.trees]


def train_case(rank, world, group, name, comm):
    """Train case ``name`` on this rank's rows under ``GRAFT_HIST_COMM``
    ``comm`` -> (trees, predictions on all rows, the saved model's bytes,
    the metric log)."""
    import tempfile

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train

    params, _n, split, rounds, _kw = CASES[name]
    X, y = case_data(name)
    rows = slice(0, split) if rank == 0 else slice(split, None)
    dm = DataMatrix(X[rows], labels=y[rows])
    os.environ["GRAFT_HIST_COMM"] = comm

    class Log:
        log = None

        def after_iteration(self, forest, rnd, evals_log):
            Log.log = {k: dict(v) for k, v in evals_log.items()}
            return False

    try:
        forest = train(dict(params), dm, rounds, evals=[(dm, "train")], device="cpu",
                       group=group, callbacks=[Log()], verbose_eval=False)
    finally:
        os.environ.pop("GRAFT_HIST_COMM", None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.json")
        forest.save_model(path)
        with open(path, "rb") as f:
            raw = f.read()
    return forest_arrays(forest), forest.predict(X), raw, Log.log


# ------------------------------------------------- the collective helpers
HIST_SHAPE = (3, 5, 17)   # W, d (odd: the reduce-scatter pads it), B
SPLIT_D_LOCAL = 4


def hist_inputs(rank):
    """Rank ``rank``'s local (G, H) [W, d, B] histograms."""
    rng = np.random.RandomState(100 + rank)
    return (rng.randn(*HIST_SHAPE).astype(np.float32),
            rng.rand(*HIST_SHAPE).astype(np.float32))


def totals_inputs(rank):
    """Rank ``rank``'s (G, H) [W, k, B] feature slice for the node-totals
    broadcast: multiples of 1/8, so that a sum over the bins is exact in f32
    in any order and the two packages' totals compare bit for bit."""
    rng = np.random.RandomState(200 + rank)
    return (rng.randint(-64, 64, HIST_SHAPE).astype(np.float32) / 8,
            rng.randint(0, 64, HIST_SHAPE).astype(np.float32) / 8)


def split_inputs(rank):
    """Rank ``rank``'s per-node best splits of its feature slice, with
    exact gain ties across the ranks (nodes 0, 2, 4), all -inf (node 3) and
    a winner on either rank (nodes 1, 5)."""
    inf = np.float32(np.inf)
    gains = [np.array([1.0, 2.0, 3.0, -inf, 0.5, 7.0], np.float32),
             np.array([1.0, 5.0, 3.0, -inf, 0.5, 1.0], np.float32)]
    feats = [np.array([3, 0, 1, 0, 2, 2], np.int32), np.array([0, 0, 1, 0, 2, 3], np.int32)]
    return {
        "gain": gains[rank],
        "feature": feats[rank],
        "bin": np.array([5, 6, 7, 8, 9, 10], np.int32) + 10 * rank,
        "default_left": np.array([1, 0, 1, 0, 1, 0], bool) ^ bool(rank),
        "g_total": np.arange(6, dtype=np.float32),
        "h_total": np.arange(6, dtype=np.float32) + 1,
    }


def distributed_suite(rank, world, group):
    """Everything ``tests/test_torch_distributed.py`` needs from one rank
    pair: the collective helpers' outputs, the training cases under both
    lowerings, and the fingerprint's world size."""
    import torch

    from sagemaker_xgboost_container_tpu_torch.ops.histogram import apply_hist_collective
    from sagemaker_xgboost_container_tpu_torch.ops.split import (
        broadcast_node_totals,
        combine_splits_across_shards,
    )
    from sagemaker_xgboost_container_tpu_torch.utils import integrity

    out = {}
    G, H = hist_inputs(rank)
    for comm in ("psum", "reduce_scatter"):
        g, h = apply_hist_collective(torch.tensor(G), torch.tensor(H), group, comm)
        out["hist", comm] = (g.numpy(), h.numpy())
        pending = apply_hist_collective(torch.tensor(G), torch.tensor(H), group, comm,
                                        async_op=True)
        out["hist async", comm] = tuple(t.numpy() for t in pending.wait())
    splits = {k: torch.tensor(v) for k, v in split_inputs(rank).items()}
    merged = combine_splits_across_shards(splits, rank, SPLIT_D_LOCAL, group)
    out["combine"] = {k: v.numpy() for k, v in merged.items()}
    Gt, Ht = totals_inputs(rank)
    gt, ht = broadcast_node_totals(torch.tensor(Gt), torch.tensor(Ht), rank, group)
    out["totals"] = (gt.numpy(), ht.numpy())
    for name in CASES:
        out["train", name, "psum"] = train_case(rank, world, group, name, "psum")
    for name in ("binary", "softprob", "lossguide"):
        out["train", name, "reduce_scatter"] = train_case(rank, world, group, name,
                                                          "reduce_scatter")
    out["world_size"] = integrity.config_fingerprint({})["world_size"]
    return out


# ------------------------------------------------ rendezvous across packages
CLUSTER_HOSTS = ["127.0.0.1", "localhost"]


def cluster_sync(package, host, port, q):
    """One host of a rendezvous: the port's ``Cluster`` (package "port") or
    the JAX package's ("jax"), both host-only code, syncing one payload."""
    if package == "port":
        from sagemaker_xgboost_container_tpu_torch.parallel.distributed import Cluster
    else:
        from sagemaker_xgboost_container_tpu.parallel.distributed import Cluster
    try:
        cluster = Cluster(CLUSTER_HOSTS, host, port=port)
        out = cluster.synchronize({"host": host, "package": package,
                                   "include_in_training": host != "localhost"}, timeout=60)
        q.put((host, "ok", out))
    except BaseException:
        q.put((host, "error", traceback.format_exc()))


# ------------------------------------------------------- the train entry
ENTRY_HP = {"num_round": "4", "max_depth": "4", "eta": "0.3", "max_bin": "32",
            "objective": "binary:logistic", "eval_metric": "logloss,error"}
ENTRY_ROWS, ENTRY_VAL_ROWS, ENTRY_SPLIT, ENTRY_VAL_SPLIT = 1003, 301, 640, 150


def entry_data():
    """(train X, y), (validation X, y) of the two-host entry tests."""
    X, y = level_data(ENTRY_ROWS + ENTRY_VAL_ROWS, 5, seed=11)
    return (X[:ENTRY_ROWS], y[:ENTRY_ROWS]), (X[ENTRY_ROWS:], y[ENTRY_ROWS:])


def entry_shards(rank):
    """Host ``rank``'s own rows of the training and validation channels."""
    (X, y), (Xv, yv) = entry_data()
    t = slice(0, ENTRY_SPLIT) if rank == 0 else slice(ENTRY_SPLIT, None)
    v = slice(0, ENTRY_VAL_SPLIT) if rank == 0 else slice(ENTRY_VAL_SPLIT, None)
    return (X[t], y[t]), (Xv[v], yv[v])


def entry_reference(rank, world, group):
    """``train(group=)`` over the entry test's shards with the parameters
    the entry point validates ``ENTRY_HP`` into -> (trees, predictions of
    all training rows)."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train

    (X, y), (Xv, yv) = entry_shards(rank)
    dtrain, dval = DataMatrix(X, labels=y), DataMatrix(Xv, labels=yv)
    params = {"max_depth": 4, "eta": 0.3, "max_bin": 32, "objective": "binary:logistic",
              "eval_metric": ["logloss", "error"]}
    forest = train(params, dtrain, 4, evals=[(dtrain, "train"), (dval, "validation")],
                   device="cpu", group=group, verbose_eval=False)
    return forest_arrays(forest), forest.predict(entry_data()[0][0])
