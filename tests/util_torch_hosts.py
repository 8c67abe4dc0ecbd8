"""N hosts of the port's multi-host ``train`` entry point on one box, for
the elastic and consensus drills (``tests/test_torch_elastic_drills.py``,
``tests/test_torch_consensus.py``).

Each host is a process running ``training.entry.main(device='cpu')`` with
its own channels (``HOST_ROWS`` x ``HOST_FEATURES`` rows a host, made from a
seed), model, checkpoint and output dirs and abort port; the other ports
are shared and free. The three hosts' names all resolve to loopback and sort
as rank 0, 1, 2. The child prints, as it exits, one ``{"drill": ...}``
line: the model it trained (path under its output dir; every rank saves
one) and the consensus checks it made.
"""

import json
import os
import subprocess
import sys

import numpy as np

from tests.util_ports import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = ["127.0.0.1", "127.0.0.2", "localhost"]   # sorted: rank 0, 1, 2
HOST_ROWS, HOST_VAL_ROWS, HOST_FEATURES = 2_000, 500, 8
ROUNDS = 10
HP = {"num_round": str(ROUNDS), "max_depth": "4", "eta": "0.3", "max_bin": "32",
      "objective": "binary:logistic", "eval_metric": "logloss"}
# heartbeats every 0.5 s, a host stale after 10 missed (5 s): a loaded test
# box must not call a live host dead
PLANE_ENV = {"SM_HEARTBEAT_INTERVAL_S": "0.5", "SM_STALE_HEARTBEATS": "10",
             "SM_STRUCTURED_METRICS": "true", "SM_IO_RETRY_BACKOFF_S": "0.05"}

CHILD = """
import atexit, json, os
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY, snapshot_fields
from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, entry, watchdog

doc = {}
train_job = algorithm_train.train_job

def keep_model(*args, **kwargs):
    bst = train_job(*args, **kwargs)
    path = os.path.join(os.environ["SM_OUTPUT_DIR"], "rank-model")
    bst.save_model(path)
    doc["model"] = path
    return bst

def report():
    doc["checks"] = snapshot_fields(REGISTRY).get("consensus_checks_total", 0.0)
    print(json.dumps({"drill": doc}), flush=True)

real_exit = watchdog._exit

def exit_with_report(code):
    report()
    real_exit(code)

algorithm_train.train_job = keep_model
watchdog._exit = exit_with_report
atexit.register(report)
entry.main(device="cpu")
"""


def host_rows(rank, seed=0):
    """Host ``rank``'s training and validation rows (a linear rule with
    noise, as the entry tests' data)."""
    rng = np.random.RandomState(seed * 100 + rank)
    n = HOST_ROWS + HOST_VAL_ROWS
    X = rng.randn(n, HOST_FEATURES).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return (X[:HOST_ROWS], y[:HOST_ROWS]), (X[HOST_ROWS:], y[HOST_ROWS:])


def _write_csv(path, X, y):
    os.makedirs(path)
    with open(os.path.join(path, "data.csv"), "w") as f:
        for label, row in zip(y, X):
            f.write(",".join(["%d" % label] + ["%.6g" % v for v in row]) + "\n")


def free_port_pair():
    """A free port whose successor is free too: the process group's store
    moves to SM_PROCESS_GROUP_PORT + 1 after the first shrink."""
    for _ in range(50):
        port = free_port()
        if port < 65535:
            import socket

            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                try:
                    s.bind(("0.0.0.0", port + 1))
                except OSError:
                    continue
            return port
    raise RuntimeError("no free port pair")


def start_hosts(tmp, n, extra, hp=None, checkpoints=True):
    """Start ``n`` hosts (``extra[rank]``: env of each) -> [(Popen, root)]."""
    hosts = HOSTS[:n]
    shared = {"SM_RENDEZVOUS_PORT": free_port(), "SM_PROCESS_GROUP_PORT": free_port_pair(),
              "SM_HEARTBEAT_PORT": free_port(), "SM_CONSENSUS_PORT": free_port(),
              "SM_REFORM_PORT": free_port(), "SM_FLEET_TRACE_PORT": free_port()}
    procs = []
    for rank in range(n):
        root = os.path.join(str(tmp), "host{}".format(rank))
        (X, y), (Xv, yv) = host_rows(rank)
        _write_csv(os.path.join(root, "train"), X, y)
        _write_csv(os.path.join(root, "validation"), Xv, yv)
        channel = {"ContentType": "csv", "TrainingInputMode": "File",
                   "S3DistributionType": "FullyReplicated"}
        docs = (("hp.json", hp or HP),
                ("data.json", {"train": channel, "validation": dict(channel)}),
                ("checkpoint.json",
                 {"LocalPath": os.path.join(root, "checkpoints")} if checkpoints else {}))
        for name, doc in docs:
            with open(os.path.join(root, name), "w") as f:
                json.dump(doc, f)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
        env.update({k: str(v) for k, v in shared.items()})
        env.update({
            "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(root, "hp.json"),
            "SM_INPUT_DATA_CONFIG_FILE": os.path.join(root, "data.json"),
            "SM_CHECKPOINT_CONFIG_FILE": os.path.join(root, "checkpoint.json"),
            "SM_CHANNEL_TRAIN": os.path.join(root, "train"),
            "SM_CHANNEL_VALIDATION": os.path.join(root, "validation"),
            "SM_MODEL_DIR": os.path.join(root, "model"),
            "SM_OUTPUT_DIR": os.path.join(root, "output"),
            "SM_OUTPUT_DATA_DIR": os.path.join(root, "output", "data"),
            "SM_HOSTS": json.dumps(hosts), "SM_CURRENT_HOST": hosts[rank],
            "SM_ABORT_PORT": str(free_port()),
            "PYTHONPATH": REPO,
        })
        env.update(PLANE_ENV)
        env.update(extra[rank] or {})
        os.makedirs(env["SM_OUTPUT_DIR"], exist_ok=True)
        procs.append((subprocess.Popen([sys.executable, "-c", CHILD], env=env, cwd=root,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), root))
    return procs


def finish(procs, timeout):
    """-> [(exit code, stdout, stderr, root)]; every host is killed when a
    wait fails."""
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


def records(text, metric):
    needle = '"metric": "{}"'.format(metric)
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and needle in line]


def drill_report(text):
    found = [json.loads(line)["drill"] for line in text.splitlines()
             if line.startswith('{"drill"')]
    return found[-1] if found else {}


# ------------------------------------- the agreed resume point (two ranks)
RESUME_AT, RESUME_ROUNDS = 3, 6
RESUME_PARAMS = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3, "max_bin": 32}


def agreed_resume_rank(rank, world, group):
    """Both ranks train ``RESUME_AT`` rounds over ``group``; only rank 0
    checkpoints (the master). Then each agrees the resume point from its
    own checkpoint dir and trains to ``RESUME_ROUNDS``; and both train
    ``RESUME_ROUNDS`` uninterrupted. -> (resumed trees, the agreed
    iteration, whether this rank's own dir held a checkpoint); the resumed
    trees are checked against the uninterrupted run's here."""
    import shutil
    import tempfile

    import torch

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.booster import train
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, checkpointing

    (X, y), _val = host_rows(rank)
    dtrain = DataMatrix(X, labels=y)
    tmp = tempfile.mkdtemp(prefix="agreed-resume-")
    try:
        ckpt, scratch = os.path.join(tmp, "ckpt"), os.path.join(tmp, "scratch")
        os.makedirs(ckpt)
        os.makedirs(scratch)
        first = train(RESUME_PARAMS, dtrain, RESUME_AT, device="cpu", group=group,
                      verbose_eval=False)
        if rank == 0:
            checkpointing._atomic_save(first, ckpt, "{}.{}".format(
                checkpointing.CHECKPOINT_FILENAME, RESUME_AT - 1), iteration=RESUME_AT - 1)
        had = checkpointing.load_checkpoint(ckpt)[0] is not None
        torch.distributed.barrier(group)
        path, iteration = algorithm_train._agree_resume_point(ckpt, torch.device("cpu"),
                                                              scratch)
        resumed = train(RESUME_PARAMS, dtrain, RESUME_ROUNDS - iteration, device="cpu",
                        group=group, xgb_model=path, verbose_eval=False)
        whole = train(RESUME_PARAMS, dtrain, RESUME_ROUNDS, device="cpu", group=group,
                      verbose_eval=False)
        trees = [{k: np.asarray(getattr(t, k)) for k in
                  ("feature", "threshold", "default_left", "left", "right", "value")}
                 for t in resumed.trees]
        want = [{k: np.asarray(getattr(t, k)) for k in trees[0]} for t in whole.trees]
        assert len(trees) == len(want)
        for a, b in zip(trees, want):
            for k in a:
                assert np.array_equal(a[k], b[k]), k
        return trees, iteration, had
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
