"""The port's multi-host ``train`` entry point and its cluster lifecycle on
the CPU: two hosts as two processes on loopback (``SM_HOSTS`` =
["127.0.0.1", "localhost"], the JAX tests' trick), joined by a gloo
process group.

* a port ``Cluster`` and a JAX ``Cluster`` rendezvous with each other;
* two hosts run ``training.entry`` end to end: both exit 0 with identical
  metric lines, and rank 0's model equals ``train(group=)`` over the same
  shards, with a two-lane ``trace-fleet.json``;
* host loss: the survivor exits 80 (the coordinated abort) well within the
  heartbeat timeout, leaves one ``training.abort`` record and no model;
* what does not train across hosts is refused by name, and the elastic and
  consensus knobs are not (k-fold CV across hosts:
  ``tests/test_torch_distributed_options.py``).
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
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train
from tests import util_torch_ranks as ur
from tests.util_ports import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")
ENTRY = ("from sagemaker_xgboost_container_tpu_torch.training.entry import main; "
         "main(device='cpu')")


# ----------------------------------------------------------- rendezvous
@pytest.mark.parametrize("master", ["port", "jax"])
def test_port_and_jax_clusters_synchronize(master):
    """Same framing, same ranks: a port host and a JAX host allgather their
    membership payloads with each other, either one the master."""
    import multiprocessing as mp
    import queue as queue_mod

    worker = "jax" if master == "port" else "port"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=ur.cluster_sync, args=(master, "127.0.0.1", port, q)),
             ctx.Process(target=ur.cluster_sync, args=(worker, "localhost", port, q))]
    for p in procs:
        p.start()
    try:
        out = {}
        deadline = time.monotonic() + 120
        while len(out) < 2 and time.monotonic() < deadline:
            try:
                host, status, value = q.get(timeout=5)
            except queue_mod.Empty:
                continue
            assert status == "ok", value
            out[host] = value
        assert len(out) == 2, out
        want = [{"host": "127.0.0.1", "package": master, "include_in_training": True},
                {"host": "localhost", "package": worker, "include_in_training": False}]
        assert out["127.0.0.1"] == out["localhost"] == want
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# ------------------------------------------------------------ the entry
def _write_csv(path, X, y):
    os.makedirs(path)
    with open(os.path.join(path, "data.csv"), "w") as f:
        for label, row in zip(y, X):
            f.write(",".join([repr(float(label))] + [repr(float(v)) for v in row]) + "\n")


def _host_env(tmp, rank, hp, ports, extra=None):
    """The SM_* env of host ``rank`` with its own channels and model dir."""
    root = os.path.join(tmp, "host{}".format(rank))
    (X, y), (Xv, yv) = ur.entry_shards(rank)
    _write_csv(os.path.join(root, "train"), X, y)
    _write_csv(os.path.join(root, "validation"), Xv, yv)
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    for name, doc in (("hp.json", hp), ("data.json", {"train": channel,
                                                        "validation": dict(channel)})):
        with open(os.path.join(root, name), "w") as f:
            json.dump(doc, f)
    env = dict(os.environ)
    for key in ("SM_FAULT_SPEC", "SM_ABORT_ON_STALE", "SM_HEARTBEAT_INTERVAL_S"):
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
        "SM_HOSTS": json.dumps(ur.CLUSTER_HOSTS),
        "SM_CURRENT_HOST": ur.CLUSTER_HOSTS[rank],
        "SM_RENDEZVOUS_PORT": str(ports[0]),
        "SM_PROCESS_GROUP_PORT": str(ports[1]),
        "SM_ABORT_PORT": str(ports[2] + rank),   # two "hosts" on one box
        "SM_HEARTBEAT_PORT": str(ports[4]),
        "SM_FLEET_TRACE_PORT": str(ports[5]),
        "GRAFT_HEARTBEAT_TIMEOUT_S": "60",
        "PYTHONPATH": REPO,
    })
    env.update(extra or {})
    return env, root


def _start_hosts(tmp, hp, extra=(None, None)):
    ports = [free_port() for _ in range(6)]
    procs = []
    for rank in range(2):
        env, root = _host_env(tmp, rank, hp, ports, extra[rank])
        procs.append((subprocess.Popen([sys.executable, "-c", ENTRY], env=env, cwd=root,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), root))
    return procs


def _finish(procs, timeout):
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


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("two_hosts"))
    procs = _start_hosts(tmp, ur.ENTRY_HP, extra=[
        {"SM_TRACE": "true", "SM_FLEET_TRACE": "true", "SM_FLEET_FLUSH_S": "0.2"},
        {"SM_TRACE": "true", "SM_FLEET_TRACE": "true", "SM_FLEET_FLUSH_S": "0.2"}])
    return _finish(procs, timeout=240)


def test_two_hosts_exit_0_with_identical_metric_lines(two_hosts):
    for code, out, err, _root in two_hosts:
        assert code == 0, err[-3000:]
    lines = [_metric_lines(out) for _code, out, _err, _root in two_hosts]
    assert len(lines[0]) == 4 and lines[0] == lines[1]
    assert all("validation-logloss" in line for line in lines[0])


def test_two_hosts_model_equals_train_with_group(two_hosts):
    ref_trees, ref_preds = ur.run_ranks(ur.entry_reference, timeout=120)[0]
    root0, root1 = two_hosts[0][3], two_hosts[1][3]
    assert not os.path.exists(os.path.join(root1, "model", "xgboost-model"))  # master only
    forest = Forest.load_model(os.path.join(root0, "model", "xgboost-model"), device="cpu")
    trees = ur.forest_arrays(forest)
    assert len(trees) == len(ref_trees) == 4
    for a, b in zip(trees, ref_trees):
        for key in ("feature", "threshold", "default_left", "left", "right", "value"):
            assert np.array_equal(a[key], b[key]), key
    np.testing.assert_array_equal(forest.predict(ur.entry_data()[0][0]), ref_preds)


def test_two_hosts_fleet_trace_has_two_rank_lanes(two_hosts):
    root0 = two_hosts[0][3]
    with open(os.path.join(root0, "model", "trace-fleet.json")) as f:
        doc = json.load(f)
    lanes = {e["pid"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert lanes == {0, 1}
    assert os.path.exists(os.path.join(root0, "model", "trace-rank0.json"))


def test_host_loss_survivor_exits_80(tmp_path):
    """Rank 1 dies (SIGKILL) at its 3rd round end; rank 0 must exit with
    the coordinated abort's 80, well within the heartbeat timeout plus a
    margin, with one ``training.abort`` record and no model."""
    hp = dict(ur.ENTRY_HP, num_round="40")
    common = {"SM_ABORT_ON_STALE": "true", "SM_HEARTBEAT_INTERVAL_S": "0.5",
              "SM_STRUCTURED_METRICS": "true", "GRAFT_HEARTBEAT_TIMEOUT_S": "20"}
    t = time.monotonic()
    outs = _finish(_start_hosts(str(tmp_path), hp, extra=[
        dict(common), dict(common, SM_FAULT_SPEC="training.round_end:kill@3")]), timeout=120)
    elapsed = time.monotonic() - t
    (code0, out0, err0, root0), (code1, _out1, _err1, _root1) = outs
    assert code1 == -9
    assert code0 == 80, err0[-3000:]
    # the closed connection fails rank 0's next collective at once: well
    # within GRAFT_HEARTBEAT_TIMEOUT_S plus a margin
    assert elapsed < 20 + 60
    aborts = [line for line in out0.splitlines() if '"training.abort"' in line]
    assert len(aborts) == 1, out0[-2000:]
    assert not os.path.exists(os.path.join(root0, "model", "xgboost-model"))
    assert len(_metric_lines(out0)) < 40   # it never completed


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("hp, env, named", [
    ({"tree_method": "approx"}, {"SM_INGEST_MODE": "chunked"}, "SM_INGEST_MODE=chunked"),
    ({"tree_method": "exact"}, {}, "tree_method='exact'"),
])
def test_entry_refuses_across_hosts(tmp_path, monkeypatch, hp, env, named):
    """Refused by name before any peer is contacted: ``tree_method=exact``
    with the JAX package's message, and streaming ingest with a config it
    cannot serve (approx re-sketches from floats) with the JAX package's
    ``UserError``."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(algorithm_train.distributed, "wait_hostname_resolution",
                        lambda hosts: pytest.fail("a peer was contacted"))
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    (train_dir / "data.csv").write_text("1,0.5\n0,0.25\n")
    with pytest.raises(exc.UserError, match=named) as err:
        algorithm_train.sagemaker_train(
            dict(ur.ENTRY_HP, **hp), {"train": channel}, str(train_dir), None,
            str(tmp_path / "model"), ur.CLUSTER_HOSTS, "127.0.0.1", {}, device="cpu")
    if "exact" in named:
        assert "it doesn't in XGBoost either" in str(err.value)
    else:
        import importlib

        jax_at = importlib.import_module("sagemaker_xgboost_container_tpu.training.algorithm_train")
        with pytest.raises(jax_at.exc.UserError) as jax_err:
            jax_at._streaming_plan(dict(ur.ENTRY_HP, **hp), 1, False, False, 2)
        assert str(err.value) == str(jax_err.value)


class _Rendezvous(Exception):
    pass


@pytest.mark.parametrize("env", [
    {"SM_ELASTIC": "1"},
    {"SM_CONSENSUS_EVERY": "5"},
    {"SM_ELASTIC": "true", "SM_CONSENSUS_EVERY": "1", "SM_ELASTIC_MIN_HOSTS": "2"},
])
def test_entry_accepts_elastic_and_consensus_knobs(tmp_path, monkeypatch, env):
    """``SM_ELASTIC`` and ``SM_CONSENSUS_EVERY`` train across hosts: a
    multi-host job with them reads its data and reaches the rendezvous (the
    drills: ``tests/test_torch_elastic_drills.py``,
    ``tests/test_torch_consensus.py``)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def reached(hosts):
        raise _Rendezvous(hosts)

    monkeypatch.setattr(algorithm_train.distributed, "wait_hostname_resolution", reached)
    channel = {"ContentType": "text/csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    (train_dir / "data.csv").write_text("1,0.5\n0,0.25\n")
    with pytest.raises(_Rendezvous):
        algorithm_train.sagemaker_train(
            dict(ur.ENTRY_HP), {"train": channel}, str(train_dir), None,
            str(tmp_path / "model"), ur.CLUSTER_HOSTS, "127.0.0.1", {}, device="cpu")
