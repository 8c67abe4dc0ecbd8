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


def _rank_main(target, rank, world, port, q, args, own_group):
    try:
        import torch.distributed as dist

        if own_group:
            # the target brings its own process group up on ``port``
            result = target(rank, world, port, *args)
            if dist.is_initialized():
                dist.destroy_process_group()
            q.put((rank, "ok", result))
            return
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{}".format(port),
                                world_size=world, rank=rank)
        try:
            result = target(rank, world, dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        q.put((rank, "ok", result))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(target, args=(), world=2, timeout=180.0, own_group=False):
    """Run ``target(rank, world, group, *args)`` on ``world`` spawned gloo
    ranks -> their results in rank order (with ``own_group``,
    ``target(rank, world, port, *args)``, which brings up its own process
    group on the free loopback ``port``). Raises on a rank's error or a
    timeout; never leaves a process behind."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, port, q, args, own_group))
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
    for i, params in enumerate(ONCE_REFUSED):
        out["once refused", i] = train_once_refused(rank, group, params)
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


# ----------------------------------------- the options trained across ranks
def ranking_data(n_groups, d, seed):
    """Integer-valued features, relevance labels 0-4 and query groups of
    5-24 documents -> (X, y, group sizes)."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(5, 25, size=n_groups)
    n = int(sizes.sum())
    X = rng.randint(0, 16, size=(n, d)).astype(np.float32)
    score = X[:, 0] - 0.5 * X[:, 1] + 0.25 * X[:, 2] + rng.randn(n) * 2
    y = np.clip(np.round(score / 4 + 2), 0, 4).astype(np.float32)
    return X, y, sizes


def cox_data(n, d, seed):
    """Integer-valued features, 5 % of them missing (so that every split's
    default direction is decided by rows, not by an f32 rounding tie), and
    survival labels: event times > 0, a third of them censored (negative)."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 16, size=(n, d)).astype(np.float32)
    risk = 0.2 * X[:, 0] - 0.1 * X[:, 1]
    X[rng.rand(n, d) < 0.05] = np.nan
    t = np.round(rng.exponential(np.exp(-risk)) * 100 + 1).astype(np.float32)
    censored = rng.rand(n) < 1 / 3
    return X, np.where(censored, -t, t).astype(np.float32)


# name -> (params, rounds, data kind). "split" is rank 0's rows (for the
# ranking cases, its query groups)
OPTION_CASES = {
    "approx": ({"objective": "binary:logistic", "tree_method": "approx", "max_depth": 4,
                "eta": 0.3, "eval_metric": ["logloss"]}, 4, "binary"),
    "dart": ({"objective": "binary:logistic", "booster": "dart", "max_depth": 4, "eta": 0.3,
              "rate_drop": 0.3, "one_drop": 1, "seed": 5, "eval_metric": ["logloss"]}, 5,
             "binary"),
    "gblinear": ({"objective": "binary:logistic", "booster": "gblinear", "eta": 0.5,
                  "lambda": 0.5, "alpha": 0.01, "eval_metric": ["logloss", "error"]}, 4,
                 "binary"),
    "update": ({"objective": "binary:logistic", "process_type": "update",
                "updater": "refresh,prune", "gamma": 2.0, "max_depth": 4, "eta": 0.3,
                "eval_metric": ["logloss"]}, 4, "binary"),
    "ndcg": ({"objective": "rank:ndcg", "max_depth": 4, "eta": 0.3,
              "eval_metric": ["ndcg@5", "map"]}, 3, "ranking"),
    "pairwise": ({"objective": "rank:pairwise", "max_depth": 4, "eta": 0.3,
                  "eval_metric": ["ndcg"]}, 3, "ranking"),
    "cox": ({"objective": "survival:cox", "max_depth": 4, "eta": 0.3,
             "eval_metric": ["cox-nloglik"]}, 4, "cox"),
}
OPTION_ROWS, OPTION_SPLIT = 1000, 500        # binary cases
RANK_GROUPS, RANK_SPLIT = 80, 30            # ranking cases: query groups
COX_ROWS, COX_SPLIT = 1003, 700             # uneven, ShardedByS3Key-style
# the base model that the update case refreshes and prunes: trained on
# every row, then updated on labels with a share flipped
UPDATE_BASE = ({"objective": "binary:logistic", "max_depth": 4, "eta": 0.3}, 4)
UPDATE_FLIP = 0.15


def option_data(name):
    """(X, y, group sizes or None) of case ``name`` over all rows."""
    kind = OPTION_CASES[name][2]
    if kind == "ranking":
        return ranking_data(RANK_GROUPS, 5, seed=21)
    if kind == "cox":
        X, y = cox_data(COX_ROWS, 5, seed=22)
        return X, y, None
    X, y = level_data(OPTION_ROWS, 5, seed=23)
    if name == "update":
        flip = np.random.RandomState(24).rand(len(y)) < UPDATE_FLIP
        y = np.where(flip, 1.0 - y, y).astype(np.float32)
    return X, y, None


def option_shard(name, rank):
    """Rank ``rank``'s DataMatrix arguments (X, y, groups) of case ``name``."""
    X, y, sizes = option_data(name)
    kind = OPTION_CASES[name][2]
    if kind == "ranking":
        cut = int(sizes[:RANK_SPLIT].sum())
        rows = slice(0, cut) if rank == 0 else slice(cut, None)
        groups = sizes[:RANK_SPLIT] if rank == 0 else sizes[RANK_SPLIT:]
        return X[rows], y[rows], groups
    split = COX_SPLIT if kind == "cox" else OPTION_SPLIT
    rows = slice(0, split) if rank == 0 else slice(split, None)
    return X[rows], y[rows], None


def update_base_model():
    """The saved bytes of the update case's base model (the port on the
    CPU, every row of the unflipped labels)."""
    import tempfile

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train

    X, y = level_data(OPTION_ROWS, 5, seed=23)
    params, rounds = UPDATE_BASE
    forest = train(dict(params), DataMatrix(X, labels=y), rounds, device="cpu",
                   verbose_eval=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base.json")
        forest.save_model(path)
        with open(path, "rb") as f:
            return f.read()


def _model_arrays(model):
    if hasattr(model, "trees"):
        return forest_arrays(model)
    return {"weights": np.asarray(model.weights), "bias": np.asarray(model.bias)}


def train_option(rank, world, group, name, base=None):
    """Train option case ``name`` on this rank's rows over ``group`` ->
    (model arrays, predictions of all rows, the saved model's bytes, the
    metric log, the collectives' calls by kind)."""
    import tempfile

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train
    from sagemaker_xgboost_container_tpu_torch.parallel import collectives

    params, rounds, _kind = OPTION_CASES[name]
    X, y, groups = option_shard(name, rank)
    dm = DataMatrix(X, labels=y, groups=groups)

    class Log:
        log = None

        def after_iteration(self, model, rnd, evals_log):
            Log.log = {k: dict(v) for k, v in evals_log.items()}
            return False

    with tempfile.TemporaryDirectory() as tmp:
        xgb_model = None
        if base is not None:
            xgb_model = os.path.join(tmp, "base.json")
            with open(xgb_model, "wb") as f:
                f.write(base)
        collectives.reset_stats()
        model = train(dict(params), dm, rounds, evals=[(dm, "train")], device="cpu",
                      group=group, callbacks=[Log()], verbose_eval=False, xgb_model=xgb_model)
        kinds = dict(collectives.STATS["kinds"])
        path = os.path.join(tmp, "model.json")
        model.save_model(path)
        with open(path, "rb") as f:
            raw = f.read()
    return _model_arrays(model), model.predict(option_data(name)[0]), raw, Log.log, kinds


def options_suite(rank, world, group):
    """Everything ``tests/test_torch_distributed_options.py`` needs from one
    rank pair: each option case trained across the two ranks, and the
    merged approx cuts of one hessian-weighted sketch."""
    import torch

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import merged_distributed_cuts

    out = {"update base": update_base_model()}
    for name in OPTION_CASES:
        out[name] = train_option(rank, world, group, name,
                                 base=out["update base"] if name == "update" else None)
    X, _y, _g = option_shard("approx", rank)
    h = sketch_weights(rank)
    out["merged cuts"] = merged_distributed_cuts(DataMatrix(X), 32, group, torch.device("cpu"),
                                                 weights=h)
    return out


def sketch_weights(rank):
    """Rank ``rank``'s hessian-like sketch weights for the merged-cut test."""
    return np.random.RandomState(30 + rank).rand(OPTION_SPLIT).astype(np.float32) + 0.05


# --------------------------------------------------------- the slow peer
SLOW_PEER_SLEEP_S, SLOW_PEER_HEARTBEAT_S = 6.0, 0.5


def slow_peer_rank(rank, world, port):
    """One rank of the slow-peer drill: the port's process group (under
    the test's ``GRAFT_HEARTBEAT_TIMEOUT_S``), the heartbeat plane, and the
    binary case trained over them, rank 1 sleeping ``SLOW_PEER_SLEEP_S``
    before its merged-cut gather while its heartbeat thread beats ->
    (the saved model's bytes, heartbeats rank 1 sent during its sleep)."""
    import time as time_mod

    import torch

    from sagemaker_xgboost_container_tpu_torch.models import booster
    from sagemaker_xgboost_container_tpu_torch.parallel import distributed
    from sagemaker_xgboost_container_tpu_torch.telemetry import cluster

    group = distributed.init_process_group(CLUSTER_HOSTS, CLUSTER_HOSTS[rank],
                                           torch.device("cpu"), backend="gloo", port=port)
    plane = cluster.start_cluster_telemetry(CLUSTER_HOSTS, CLUSTER_HOSTS[rank])
    beats = {}
    merged = booster.merged_distributed_cuts

    def slow_merged(*args, **kwargs):
        if rank == 1:
            sent = plane.sender._m_sent
            before = sent.value
            time_mod.sleep(SLOW_PEER_SLEEP_S)
            beats["during_sleep"] = sent.value - before
        return merged(*args, **kwargs)

    booster.merged_distributed_cuts = slow_merged
    try:
        _trees, _preds, raw, _log = train_case(rank, world, group, "binary", "psum")
    finally:
        booster.merged_distributed_cuts = merged
        cluster.stop_cluster_telemetry()
    return raw, beats.get("during_sleep")


# the options that were refused across ranks before they trained there:
# each trains a small case over the rank pair of tests/test_torch_distributed.py
ONCE_REFUSED = (
    {"objective": "rank:ndcg"},
    {"objective": "rank:pairwise"},
    {"objective": "survival:cox"},
    {"eval_metric": "cox-nloglik"},
    {"booster": "dart"},
    {"booster": "gblinear"},
    {"process_type": "update"},
    {"tree_method": "approx"},
)


def train_once_refused(rank, group, params):
    """Two rounds of ``params`` on this rank's share of a small data set of
    the option's kind -> (the saved model's bytes, the metric log)."""
    import tempfile

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train

    params = dict(params, max_depth=3)
    groups = None
    if params.get("objective", "").startswith("rank:"):
        X, y, sizes = ranking_data(20, 4, seed=40)
        cut = int(sizes[:8].sum())
        rows = slice(0, cut) if rank == 0 else slice(cut, None)
        groups = sizes[:8] if rank == 0 else sizes[8:]
    else:
        if "cox" in params.get("objective", "") + str(params.get("eval_metric", "")):
            X, y = cox_data(301, 4, seed=41)
            if "objective" not in params:
                # cox-nloglik of a squared-error fit: times on its scale
                y = y / 100
        else:
            X, y = level_data(300, 4, seed=42)
        rows = slice(0, 170) if rank == 0 else slice(170, None)
    dm = DataMatrix(X[rows], labels=y[rows], groups=groups)

    class Log:
        log = None

        def after_iteration(self, model, rnd, evals_log):
            Log.log = {k: dict(v) for k, v in evals_log.items()}
            return False

    with tempfile.TemporaryDirectory() as tmp:
        xgb_model = None
        if params.get("process_type") == "update":
            xgb_model = os.path.join(tmp, "base.json")
            train({"max_depth": 3}, DataMatrix(X, labels=y), 2, device="cpu",
                  verbose_eval=False).save_model(xgb_model)
        model = train(params, dm, 2, evals=[(dm, "train")], device="cpu", group=group,
                      callbacks=[Log()], verbose_eval=False, xgb_model=xgb_model)
        path = os.path.join(tmp, "model.json")
        model.save_model(path)
        with open(path, "rb") as f:
            return f.read(), Log.log


# -------------------------------------- the round fields after a session
def comm_fields_after_ranks(rank, world, group):
    """Train on this rank's half across the ranks, then on it alone in the
    same process, each under a ``RoundTimer`` -> (the first run's
    ``training.round`` records, the second run's, the second run's
    ``training.attribution`` record)."""
    import contextlib
    import io
    import json

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train
    from sagemaker_xgboost_container_tpu_torch.training.profiling import RoundTimer

    X, y = level_data(400, 4, seed=43)
    rows = slice(0, 200) if rank == 0 else slice(200, None)
    dm = DataMatrix(X[rows], labels=y[rows])
    params = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3}
    outs = []
    for run_group in (group, None):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train(dict(params), dm, 3, device="cpu", group=run_group,
                  callbacks=[RoundTimer(log_every=0)], verbose_eval=False)
        outs.append([json.loads(line) for line in buf.getvalue().splitlines()
                     if line.startswith('{"metric": ')])

    def records(out, metric):
        return [r for r in out if r["metric"] == metric]

    return (records(outs[0], "training.round"), records(outs[1], "training.round"),
            records(outs[1], "training.attribution")[-1])
