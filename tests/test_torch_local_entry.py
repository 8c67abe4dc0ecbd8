"""The ``train`` entry point with local ranks (``SM_LOCAL_RANKS``, one
training process per local GPU) on the CPU, every host a process that
spawns its workers, all joined over gloo on loopback.

* one host with L = 2: exit 0, one model with the trees of one rank on all
  rows, each metric line once; ``tree_method=exact`` trains there and is
  still refused across hosts with the JAX package's message;
* two hosts x two local ranks: one model, written by global rank 0, and one
  metric line a round a host;
* a worker killed at its 3rd round end: both hosts exit 80 and no process
  of the job is left.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from tests import util_torch_local as ul
from tests import util_torch_ranks as ur
from tests.util_ports import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")
PIDS = re.compile(r"spawned local ranks .* pids \[([0-9, ]*)\]")
ENTRY = ("from sagemaker_xgboost_container_tpu_torch.training.entry import main; "
         "main(device='cpu')")
VALUE_TOL = 1e-5


def _write_csv(path, X, y):
    os.makedirs(path)
    np.savetxt(os.path.join(path, "data.csv"), np.column_stack([y, X]), delimiter=",",
               fmt="%.9g")


def _host_env(tmp, hosts, rank, hp, ports, shards, extra=None):
    """The SM_* env of host ``rank`` of ``hosts`` with its own channels
    (``shards``: (train X, y), (validation X, y)) and model dir."""
    root = os.path.join(tmp, "host{}".format(rank))
    (X, y), (Xv, yv) = shards
    _write_csv(os.path.join(root, "train"), X, y)
    _write_csv(os.path.join(root, "validation"), Xv, yv)
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    for name, doc in (("hp.json", hp), ("data.json", {"train": channel,
                                                        "validation": dict(channel)})):
        with open(os.path.join(root, name), "w") as f:
            json.dump(doc, f)
    env = dict(os.environ)
    for key in ("SM_FAULT_SPEC", "SM_ABORT_ON_STALE", "SM_HEARTBEAT_INTERVAL_S",
                "SM_LOCAL_FAULT_SPEC"):
        env.pop(key, None)
    env.update({
        "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(root, "hp.json"),
        "SM_INPUT_DATA_CONFIG_FILE": os.path.join(root, "data.json"),
        "SM_CHECKPOINT_CONFIG_FILE": os.path.join(root, "none.json"),
        "SM_CHANNEL_TRAIN": os.path.join(root, "train"),
        "SM_CHANNEL_VALIDATION": os.path.join(root, "validation"),
        "SM_MODEL_DIR": os.path.join(root, "model"),
        "SM_OUTPUT_DATA_DIR": os.path.join(root, "output", "data"),
        "SM_OUTPUT_DIR": os.path.join(root, "output"),
        "SM_HOSTS": json.dumps(hosts),
        "SM_CURRENT_HOST": hosts[rank],
        "SM_RENDEZVOUS_PORT": str(ports[0]),
        "SM_PROCESS_GROUP_PORT": str(ports[1]),
        "SM_ABORT_PORT": str(ports[2] + rank),
        "SM_HEARTBEAT_PORT": str(ports[4]),
        "SM_FLEET_TRACE_PORT": str(ports[5]),
        "SM_LOCAL_RANKS": "2",
        # a few threads a process: the tests run beside others on one box
        "OMP_NUM_THREADS": "2",
        "PYTHONPATH": REPO,
    })
    env.update(extra or {})
    return env, root


def _run_hosts(tmp, hosts, hp, shards, extra=None, timeout=180):
    """Start one entry process a host and wait -> [(code, stdout, stderr,
    root)] in host order; never leaves a process behind."""
    ports = [free_port() for _ in range(6)]
    procs = []
    for rank in range(len(hosts)):
        env, root = _host_env(tmp, hosts, rank, hp, ports, shards[rank],
                              (extra or {}).get(rank))
        procs.append((subprocess.Popen([sys.executable, "-c", ENTRY], env=env, cwd=root,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), root))
    outs = []
    try:
        for p, root in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err, root))
    finally:
        for p, _root in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    return outs


def _metric_lines(stdout):
    return [line for line in stdout.splitlines() if METRIC_LINE.match(line)]


def _worker_pids(text):
    return [int(v) for m in PIDS.finditer(text) for v in m.group(1).split(",") if v.strip()]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie not yet reaped by its new parent is gone for our purposes
    try:
        with open("/proc/{}/stat".format(pid)) as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _single_rank_reference(params):
    """The trees of one rank on all of the host's rows (``train()``)."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train

    (X, y), (Xv, yv) = ur.entry_data()
    forest = train(params, DataMatrix(X, labels=y), 4,
                   evals=[(DataMatrix(Xv, labels=yv), "validation")], device="cpu",
                   verbose_eval=False)
    return forest


@pytest.mark.parametrize("method", ["hist", "exact"])
def test_one_host_two_local_ranks(tmp_path, method):
    hp = dict(ur.ENTRY_HP, tree_method=method)
    if method == "exact":
        hp.pop("max_bin")
    ((code, out, err, root),) = _run_hosts(str(tmp_path), ["algo-1"], hp,
                                           [ur.entry_data()])
    assert code == 0, err[-3000:]
    lines = _metric_lines(out)
    assert [METRIC_LINE.match(line).group(1) for line in lines] == ["0", "1", "2", "3"]
    assert len(_worker_pids(out + err)) == 1
    params = {"max_depth": 4, "eta": 0.3, "objective": "binary:logistic",
              "eval_metric": ["logloss", "error"], "tree_method": method}
    if method == "hist":
        params["max_bin"] = 32
    ref = _single_rank_reference(params)
    forest = Forest.load_model(os.path.join(root, "model", "xgboost-model"), device="cpu")
    trees, want = ur.forest_arrays(forest), ur.forest_arrays(ref)
    assert len(trees) == len(want) == 4
    for a, b in zip(trees, want):
        for key in ("feature", "threshold", "left", "right"):
            assert np.array_equal(a[key], b[key]), key
        np.testing.assert_allclose(a["value"], b["value"], atol=VALUE_TOL)


def test_exact_still_refused_across_hosts(tmp_path):
    hp = dict(ur.ENTRY_HP, tree_method="exact")
    hp.pop("max_bin")
    outs = _run_hosts(str(tmp_path), ur.CLUSTER_HOSTS, hp,
                      [ur.entry_shards(0), ur.entry_shards(1)], timeout=120)
    for code, out, err, root in outs:
        assert code == 1, err[-2000:]
        with open(os.path.join(root, "output", "failure")) as f:
            assert "tree_method='exact' does not support distributed training" in f.read()
        assert not _worker_pids(out + err)     # refused before any spawn


def test_two_hosts_two_local_ranks(tmp_path):
    outs = _run_hosts(str(tmp_path), ur.CLUSTER_HOSTS, ur.ENTRY_HP,
                      [ur.entry_shards(0), ur.entry_shards(1)])
    for code, out, err, _root in outs:
        assert code == 0, err[-3000:]
        assert len(_worker_pids(out + err)) == 1
    lines = [_metric_lines(out) for _code, out, _err, _root in outs]
    # one line a round a host, the same on both hosts
    assert len(lines[0]) == 4 and lines[0] == lines[1]
    assert all("validation-logloss" in line for line in lines[0])
    root0, root1 = outs[0][3], outs[1][3]
    assert os.path.exists(os.path.join(root0, "model", "xgboost-model"))
    assert not os.path.exists(os.path.join(root1, "model", "xgboost-model"))
    forest = Forest.load_model(os.path.join(root0, "model", "xgboost-model"), device="cpu")
    assert len(forest.trees) == 4


def test_killed_worker_ends_both_hosts_with_80(tmp_path):
    """Local rank 1 of host 1 is SIGKILLed at its 3rd round end: both hosts
    exit 80, host 1's failure file names its dead worker, no model is
    written and no process of the job is left."""
    hp = dict(ur.ENTRY_HP, num_round="40")
    t = time.monotonic()
    outs = _run_hosts(str(tmp_path), ur.CLUSTER_HOSTS, hp,
                      [ur.entry_shards(0), ur.entry_shards(1)],
                      extra={1: {"SM_LOCAL_FAULT_SPEC": "1=training.round_end:kill@3"}},
                      timeout=150)
    assert time.monotonic() - t < 150
    pids = []
    for code, out, err, root in outs:
        assert code == 80, err[-3000:]
        assert not os.path.exists(os.path.join(root, "model", "xgboost-model"))
        pids += _worker_pids(out + err)
    assert len(pids) == 2
    with open(os.path.join(outs[1][3], "output", "failure")) as f:
        assert "local rank 1" in f.read()
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not [p for p in pids if _alive(p)]


def test_kfold_over_local_ranks(tmp_path):
    """``_kfold=3`` on one host with two local ranks: every rank splits the
    host's rows with the leader's seed, each fold trains over both ranks on
    contiguous shares of its rows, and the leader writes the out-of-fold
    predictions of all the host's rows in channel order."""
    from sagemaker_xgboost_container_tpu_torch.training.folds import RepeatedStratifiedKFold

    hp = dict(ur.ENTRY_HP, _kfold="3")
    ((code, out, err, root),) = _run_hosts(str(tmp_path), ["algo-1"], hp,
                                           [ur.entry_data()],
                                           extra={0: {"GRAFT_PARALLEL_CV": "0"}})
    assert code == 0, err[-3000:]
    seed = int(re.search(r"k-fold splits of the host's rows seeded with (\d+)", out).group(1))
    (X, y), (Xv, yv) = ur.entry_data()
    X, y = np.concatenate([X, Xv]), np.concatenate([y, yv])
    got = np.loadtxt(os.path.join(root, "output", "data", "predictions.csv"), delimiter=",")
    assert got.shape[0] == len(y)
    np.testing.assert_array_equal(got[:, 0], y)
    splits = list(RepeatedStratifiedKFold(3, 1, random_state=seed).split(range(len(y)), y))
    params = {"max_depth": 4, "eta": 0.3, "max_bin": 32, "objective": "binary:logistic"}
    want = ur.run_ranks(ul.kfold_predictions, (X, y, splits, params, 4), timeout=120)[0]
    # predictions.csv holds six decimals
    np.testing.assert_allclose(got[:, 1], want, atol=5e-7)
    assert len(os.listdir(os.path.join(root, "model"))) == 6    # 3 models + manifests


def test_chunked_ingest_deals_the_binned_matrix(tmp_path):
    """``SM_INGEST_MODE=chunked`` ingests once, in the leader; the local
    ranks train on row shards of its pre-binned matrix, and the model's
    trees are those of one rank on the same ingest."""
    chunked = {0: {"SM_INGEST_MODE": "chunked", "SM_INGEST_CHUNK_BYTES": "4096",
                   "SM_INGEST_PORT": str(free_port())}}
    ((code, out, err, root),) = _run_hosts(str(tmp_path / "two"), ["algo-1"], ur.ENTRY_HP,
                                           [ur.entry_data()], extra=chunked)
    assert code == 0, err[-3000:]
    assert "chunked ingest of channel 'train'" in out
    assert len(_worker_pids(out + err)) == 1
    one = {0: dict(chunked[0], SM_LOCAL_RANKS="1")}
    ((code1, out1, err1, root1),) = _run_hosts(str(tmp_path / "one"), ["algo-1"], ur.ENTRY_HP,
                                               [ur.entry_data()], extra=one)
    assert code1 == 0, err1[-3000:]
    assert _metric_lines(out) == _metric_lines(out1)
    trees, want = (ur.forest_arrays(Forest.load_model(os.path.join(r, "model", "xgboost-model"),
                                                      device="cpu")) for r in (root, root1))
    assert len(trees) == len(want) == 4
    for a, b in zip(trees, want):
        for key in ("feature", "threshold", "left", "right"):
            assert np.array_equal(a[key], b[key]), key
        np.testing.assert_allclose(a["value"], b["value"], atol=VALUE_TOL)


def test_worker_error_reaches_the_failure_file(tmp_path):
    """Local rank 1 raises at its 2nd round end: the host exits 80 and its
    failure file carries the worker's error text."""
    hp = dict(ur.ENTRY_HP, num_round="20")
    ((code, out, err, root),) = _run_hosts(
        str(tmp_path), ["algo-1"], hp, [ur.entry_data()],
        extra={0: {"SM_LOCAL_FAULT_SPEC": "1=training.round_end:error:disk on fire@2"}})
    assert code == 80, err[-3000:]
    with open(os.path.join(root, "output", "failure")) as f:
        text = f.read()
    assert "local rank 1" in text and "disk on fire" in text, text
    assert not os.path.exists(os.path.join(root, "model", "xgboost-model"))
    pids = _worker_pids(out + err)
    assert len(pids) == 1 and not _alive(pids[0])


def test_sigterm_to_the_leader_reaps_its_worker(tmp_path):
    """SIGTERM to a leader mid-training: it dies by the signal, as without
    local ranks, after killing and reaping its worker."""
    import signal

    hp = dict(ur.ENTRY_HP, num_round="400")
    env, root = _host_env(str(tmp_path), ["algo-1"], 0, hp, [free_port() for _ in range(6)],
                          ur.entry_data())
    p = subprocess.Popen([sys.executable, "-c", ENTRY], env=env, cwd=root,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seen = []
    try:
        for line in p.stdout:
            seen.append(line)
            if METRIC_LINE.match(line):
                break
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=10)
    assert p.returncode == -signal.SIGTERM
    pids = _worker_pids("".join(seen) + out)
    assert len(pids) == 1
    assert not _alive(pids[0])
