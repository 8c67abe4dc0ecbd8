"""Elastic shrink-to-continue with local ranks (``SM_ELASTIC`` with
``SM_LOCAL_RANKS=2``) through the port's multi-host ``train`` entry point on
the CPU: every host a leader process that spawns its worker, all joined
over gloo on loopback (``tests/util_torch_hosts``: 2,000 rows a host, 10
rounds of depth 4).

* the checkpoint fingerprint counts hosts, as the JAX package does: one host
  of two local ranks writes ``world_size`` 1 (the JAX reading of the same
  job), which resumes in a one-rank job and passes the JAX loader's
  ``validate_resume`` under ``SM_RESUME_STRICT``; two hosts of two write 2;
* three hosts x two local ranks, host 2's leader killed at its 5th round
  end: both survivor hosts re-form as two hosts x two ranks and exit 0 with
  byte-equal models, one 3 -> 2 transition, the cuts and trees of the same
  drill at one rank a host, and the metric of the uninterrupted run;
* a dead worker is its host's death: on host 2, host 2 exits 80 and the
  others shrink it away; on rank 0's host (a dead master) every host exits
  80;
* a faulted reform exits 82 on both survivors, with every worker reaped;
* in process: a worker's failed collective unwinds at once and its group
  goes down before it waits for the relayed verdict; the control pipe's
  verdicts; the dead worker's verdict by host and by reform state.
"""

import os
import re
import shutil
import signal
import threading
import time

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
from sagemaker_xgboost_container_tpu_torch.utils import integrity
from tests import util_torch_hosts as uh

KILL_AT = 5    # the victim dies at its 5th round end: rounds 0-4 are committed
LOCAL = {"SM_LOCAL_RANKS": "2", "OMP_NUM_THREADS": "2"}
ELASTIC = dict(LOCAL, SM_ELASTIC="1")
KILL = "training.round_end:kill@{}".format(KILL_AT)
PIDS = re.compile(r"spawned local ranks .* pids \[([0-9, ]*)\]")
LEAF_RTOL = 1e-4
# the last validation logloss: against the same shrink at one rank a host
# (the same rows every round), the multi-rank rule of the port's option
# tests; against the uninterrupted run, whose last 5 rounds saw a third more
# rows, the rule of the card's elastic phase (chip_smoke.py
# ELASTIC_LOGLOSS_TOL)
METRIC_TOL = 2e-3
UNINTERRUPTED_TOL = 1e-2
TIMEOUT = 150


def _worker_pids(text):
    return [int(v) for m in PIDS.finditer(text) for v in m.group(1).split(",") if v.strip()]


def _alive(pid):
    try:
        with open("/proc/{}/stat".format(pid)) as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


def _assert_reaped(outs):
    pids = [p for _code, out, err, _root in outs for p in _worker_pids(out + err)]
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert pids and not [p for p in pids if _alive(p)]
    return pids


def _rounds_printed(out):
    return [int(line[1:line.index("]")]) for line in out.splitlines()
            if line.startswith("[") and "\t" in line]


def _last_logloss(out):
    lines = [line for line in out.splitlines() if line.startswith("[") and "\t" in line]
    return float(re.search(r"validation-logloss:(\S+)", lines[-1]).group(1))


def _model(root):
    return Forest.load_model(os.path.join(root, "model", "xgboost-model"), device="cpu")


def _manifest_fingerprint(root, iteration):
    path = os.path.join(root, "checkpoints", "xgboost-checkpoint.{}".format(iteration))
    return path, integrity.read_manifest(path)["fingerprint"]


# ---------------------------------------------------------- the fingerprint
@pytest.fixture(scope="module")
def fingerprint_runs(tmp_path_factory):
    """One host x two local ranks and two hosts x two, at once."""
    tmp = tmp_path_factory.mktemp("fingerprint")
    one = uh.start_hosts(tmp / "one", 1, [dict(LOCAL)])
    two = uh.start_hosts(tmp / "two", 2, [dict(LOCAL), dict(LOCAL)])
    outs = uh.finish(one + two, timeout=TIMEOUT)
    for code, _out, err, _root in outs:
        assert code == 0, err[-3000:]
    return tmp, outs


@pytest.mark.parametrize("hosts", [1, 2])
def test_checkpoint_fingerprint_counts_hosts(fingerprint_runs, hosts):
    """Each host's leader spawned one worker, and the checkpoint carries the
    host count, not the 2 x hosts processes."""
    _tmp, outs = fingerprint_runs
    mine = outs[:1] if hosts == 1 else outs[1:]
    assert all(len(_worker_pids(out + err)) == 1 for _code, out, err, _root in mine)
    _path, fp = _manifest_fingerprint(mine[0][3], uh.ROUNDS - 1)
    assert fp["world_size"] == hosts
    model_manifest = integrity.read_manifest(os.path.join(mine[0][3], "model", "xgboost-model"))
    assert model_manifest["fingerprint"]["world_size"] == hosts


def test_one_host_checkpoint_resumes_at_one_rank_and_in_the_jax_loader(fingerprint_runs,
                                                                        monkeypatch):
    """The 1 x 2 checkpoint's world size is the JAX package's reading of the
    same job (no membership registered, one process); under
    SM_RESUME_STRICT=true it resumes in a one-rank port job (2 more rounds)
    and passes the JAX loader's ``validate_resume``: the one key the two
    differ in is the runtime's ``jax_version``, by design."""
    tmp, outs = fingerprint_runs
    root = outs[0][3]
    path, fp = _manifest_fingerprint(root, uh.ROUNDS - 1)
    cfg = {k: fp[k] for k in ("objective", "tree_method", "max_bin", "max_depth")}
    jax_live = jax_integrity.config_fingerprint(cfg)
    assert jax_live["world_size"] == fp["world_size"] == 1
    assert [k for k, _a, _b in jax_integrity.fingerprint_mismatches(fp, jax_live)] == [
        "jax_version"]
    monkeypatch.setenv("SM_RESUME_STRICT", "true")
    assert jax_integrity.validate_resume(path, dict(jax_live, jax_version=fp["jax_version"]))
    with pytest.raises(Exception, match="world_size"):
        jax_integrity.validate_resume(path, dict(jax_live, jax_version=fp["jax_version"],
                                                 world_size=2))

    resumed = tmp / "resumed"
    shutil.copytree(os.path.join(root, "checkpoints"),
                    os.path.join(str(resumed), "host0", "checkpoints"))
    hp = dict(uh.HP, num_round=str(uh.ROUNDS + 2))
    ((code, out, err, root1),) = uh.finish(uh.start_hosts(
        resumed, 1, [{"SM_LOCAL_RANKS": "1", "SM_RESUME_STRICT": "true"}], hp=hp),
        timeout=TIMEOUT)
    assert code == 0, err[-3000:]
    assert "Resuming from iteration {}".format(uh.ROUNDS) in out + err
    assert "fingerprint disagrees" not in out + err
    assert "fingerprint mismatch" not in out + err
    assert not _worker_pids(out + err)
    assert _rounds_printed(out) == [uh.ROUNDS, uh.ROUNDS + 1]
    assert _model(root1).num_boosted_rounds == uh.ROUNDS + 2


# ------------------------------------------------------ the 3 x 2 shrink
@pytest.fixture(scope="module")
def shrink_runs(tmp_path_factory):
    """The 3 x 2 shrink and the same shrink at one rank a host at once, then
    the uninterrupted 3 x 2 run (not beside them: a starved heartbeat
    thread would read as a dead host) -> {name: [(code, stdout, stderr,
    root)]}."""
    tmp = tmp_path_factory.mktemp("shrink")
    local = uh.start_hosts(tmp / "local", 3, [
        dict(ELASTIC), dict(ELASTIC), dict(ELASTIC, SM_FAULT_SPEC=KILL)], same_validation=True)
    one = uh.start_hosts(tmp / "one", 3, [
        {"SM_ELASTIC": "1"}, {"SM_ELASTIC": "1"}, {"SM_ELASTIC": "1", "SM_FAULT_SPEC": KILL}],
        same_validation=True)
    outs = uh.finish(local + one, timeout=TIMEOUT)
    whole = uh.finish(uh.start_hosts(tmp / "whole", 3, [dict(LOCAL)] * 3,
                                     same_validation=True), timeout=TIMEOUT)
    return {"local": outs[:3], "one": outs[3:], "whole": whole}


def test_shrink_three_to_two_hosts_of_two_local_ranks(shrink_runs):
    outs = shrink_runs["local"]
    assert outs[2][0] == -signal.SIGKILL
    for code, out, err, _root in outs[:2]:
        assert code == 0, err[-3000:]
        assert len(_worker_pids(out + err)) == 1
        assert "not supported yet" not in out + err
        # every HPO line once: 0-4 before the shrink, 5-9 after
        assert _rounds_printed(out) == list(range(uh.ROUNDS))
    _assert_reaped(outs[:2])
    reports = [uh.drill_report(o[1]) for o in outs[:2]]
    with open(reports[0]["model"], "rb") as f0, open(reports[1]["model"], "rb") as f1:
        assert f0.read() == f1.read()
    transitions = [uh.records(o[1], "training.membership") for o in outs[:2]]
    assert transitions[0] == transitions[1] and len(transitions[0]) == 1
    t = transitions[0][0]
    assert (t["old_world_size"], t["new_world_size"], t["surviving_ranks"], t["generation"],
            t["epoch"]) == (3, 2, [0, 1], 1, KILL_AT - 1)
    root0 = outs[0][3]
    manifest = integrity.read_manifest(os.path.join(root0, "model", "xgboost-model"))
    assert manifest["fingerprint"]["world_size"] == 2
    assert [e["new_world_size"] for e in manifest["membership_log"]] == [2]
    final = _model(root0)
    assert final.num_boosted_rounds == uh.ROUNDS
    ckpt = Forest.load_model(os.path.join(root0, "checkpoints", "xgboost-checkpoint.{}".format(
        KILL_AT - 1)), device="cpu")
    assert len(ckpt.trees) == KILL_AT
    for a, b in zip(final.trees[:KILL_AT], ckpt.trees):
        for k in ("feature", "threshold", "default_left", "left", "right", "value"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_shrink_at_two_local_ranks_matches_one_rank_a_host(shrink_runs):
    """The survivors' re-formed session bins with the cuts the L = 1 drill's
    gets (one set of candidates a surviving host), and grows its trees:
    the same splits, leaf values within LEAF_RTOL."""
    local, one = shrink_runs["local"], shrink_runs["one"]
    for code, _out, err, _root in one[:2]:
        assert code == 0, err[-3000:]
    cuts = [uh.drill_report(o[1]).get("cuts") for o in (local[0], local[1], one[0])]
    assert cuts[0] and cuts[0] == cuts[1] == cuts[2]
    a, b = _model(local[0][3]), _model(one[0][3])
    assert len(a.trees) == len(b.trees) == uh.ROUNDS
    for ta, tb in zip(a.trees, b.trees):
        for k in ("feature", "threshold", "default_left"):
            assert np.array_equal(getattr(ta, k), getattr(tb, k)), k
        assert np.array_equal(ta.left < 0, tb.left < 0)
        leaves = ta.left < 0
        np.testing.assert_allclose(ta.value[leaves], tb.value[leaves], rtol=LEAF_RTOL,
                                   atol=LEAF_RTOL * np.abs(tb.value[leaves]).max())


def test_shrink_metric_against_the_uninterrupted_run(shrink_runs):
    """Every host holds the same validation rows, so the metric reads the
    same rows before and after the shrink."""
    whole = shrink_runs["whole"]
    for code, _out, err, _root in whole:
        assert code == 0, err[-3000:]
    got = _last_logloss(shrink_runs["local"][0][1])
    one = _last_logloss(shrink_runs["one"][0][1])
    assert abs(got - one) <= METRIC_TOL * max(1.0, abs(one)), (got, one)
    ref = _last_logloss(whole[0][1])
    assert abs(got - ref) <= UNINTERRUPTED_TOL, (got, ref)


# ------------------------------------------------------ the dead workers
@pytest.fixture(scope="module")
def dead_worker_runs(tmp_path_factory):
    """Local rank 1 of host 2 killed, then local rank 1 of host 0 (one
    after the other, as the shrink drills)."""
    tmp = tmp_path_factory.mktemp("dead_worker")
    worker_kill = dict(ELASTIC, SM_LOCAL_FAULT_SPEC="1=" + KILL)
    host2 = uh.finish(uh.start_hosts(tmp / "host2", 3, [
        dict(ELASTIC), dict(ELASTIC), worker_kill]), timeout=TIMEOUT)
    host0 = uh.finish(uh.start_hosts(tmp / "host0", 3, [
        worker_kill, dict(ELASTIC), dict(ELASTIC)], hp=dict(uh.HP, num_round="40")),
        timeout=TIMEOUT)
    return host2, host0


def test_dead_worker_is_its_hosts_death(dead_worker_runs):
    """Host 2's leader exits 80 alone (its failure file names the worker);
    rank 0 finds host 2 stale and the other two shrink and finish."""
    outs, _ = dead_worker_runs
    code2, out2, err2, root2 = outs[2]
    assert code2 == 80, err2[-3000:]
    with open(os.path.join(root2, "output", "failure")) as f:
        assert "local rank 1" in f.read()
    assert [a["reason"] for a in uh.records(out2, "training.abort")] == ["local_rank_failed"]
    for code, out, err, _root in outs[:2]:
        assert code == 0, err[-3000:]
        assert not uh.records(out, "training.abort")
        assert _rounds_printed(out) == list(range(uh.ROUNDS))
    transitions = [uh.records(o[1], "training.membership") for o in outs[:2]]
    assert transitions[0] == transitions[1] and len(transitions[0]) == 1
    assert transitions[0][0]["surviving_ranks"] == [0, 1]
    assert _model(outs[0][3]).num_boosted_rounds == uh.ROUNDS
    _assert_reaped(outs)


def test_dead_worker_on_the_masters_host_ends_every_host(dead_worker_runs):
    _, outs = dead_worker_runs
    for code, out, err, root in outs:
        assert code == 80, err[-3000:]
        assert not uh.records(out, "training.membership")
        assert not os.path.exists(os.path.join(root, "model", "xgboost-model"))
    with open(os.path.join(outs[0][3], "output", "failure")) as f:
        assert "local rank 1" in f.read()
    _assert_reaped(outs)


# ------------------------------------------------------ a faulted reform
def test_faulted_reform_exits_82_with_the_workers_reaped(tmp_path):
    faulted = dict(ELASTIC, SM_FAULT_SPEC="rendezvous.reform:error:injected reform outage",
                   SM_IO_RETRY_ATTEMPTS="2", SM_TRACE="true")
    outs = uh.finish(uh.start_hosts(tmp_path, 3, [
        dict(faulted), dict(faulted), dict(ELASTIC, SM_FAULT_SPEC=KILL)]), timeout=TIMEOUT)
    assert outs[2][0] == -signal.SIGKILL
    for rank, (code, out, err, root) in enumerate(outs[:2]):
        assert code == 82, err[-3000:]
        aborts = uh.records(out, "training.abort")
        assert len(aborts) == 1 and aborts[0]["reason"] == "reform_failed"
        assert aborts[0]["generation"] == 1
        assert os.path.basename(aborts[0]["flight_recorder"]) == \
            "flight-recorder-rank{}.json".format(rank)
        assert not uh.records(out, "training.membership")
        assert not os.path.exists(os.path.join(root, "model", "xgboost-model"))
    _assert_reaped(outs[:2])


# ------------------------------------------------- in process: the pieces
@pytest.fixture
def port_state(monkeypatch):
    """The port's elastic, watchdog and topology state, clean before and
    after; exits recorded instead of taken."""
    from sagemaker_xgboost_container_tpu_torch.parallel import local
    from sagemaker_xgboost_container_tpu_torch.training import elastic, watchdog

    def reset():
        elastic._reset_for_tests()
        watchdog._reset_abort_for_tests()
        local.set_topology(None)

    reset()
    codes = []
    monkeypatch.setattr(watchdog, "_exit", codes.append)
    monkeypatch.setenv(elastic.ELASTIC_ENV, "1")
    yield codes
    reset()


HOSTS3 = ["algo-1", "algo-2", "algo-3"]


def test_worker_collective_failure_unwinds_at_once(port_state):
    """A relay-mode worker does not wait inside its failed collective: it
    raises CollectiveLost at once, or the verdict its leader already
    relayed, with the leader's epoch."""
    from sagemaker_xgboost_container_tpu_torch.training import elastic, watchdog

    elastic.register_cluster(HOSTS3, "algo-2", config=elastic.resolve_elastic_config(),
                             relay=True)
    t = time.monotonic()
    with pytest.raises(elastic.CollectiveLost):
        watchdog.on_collective_failure(RuntimeError("Connection closed by peer"))
    assert time.monotonic() - t < 1.0
    watchdog.on_leader_verdict({"verb": "reform", "generation": 1, "epoch": 4,
                                "survivors": ["algo-2", "algo-1"], "reason": "stale_host"})
    assert elastic.reform_in_flight()
    with pytest.raises(elastic.ReformRequested) as err:
        watchdog.on_collective_failure(RuntimeError("Connection closed by peer"))
    assert not isinstance(err.value, elastic.CollectiveLost)
    assert (err.value.survivors, err.value.generation, err.value.epoch) == (
        ["algo-1", "algo-2"], 1, 4)
    assert port_state == []


def test_supervised_train_tears_down_then_waits_for_the_verdict(port_state, monkeypatch):
    """After CollectiveLost the worker's group goes first, then the relayed
    verdict is awaited and performed; without one the worker fails."""
    from sagemaker_xgboost_container_tpu_torch.parallel import distributed
    from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
    from sagemaker_xgboost_container_tpu_torch.training import elastic, watchdog

    elastic.register_cluster(HOSTS3, "algo-2", config=elastic.resolve_elastic_config(),
                             relay=True)
    order = []
    monkeypatch.setattr(distributed, "teardown_process_group", lambda: order.append("down"))
    monkeypatch.setattr(elastic, "perform_reform", lambda req, **kw: order.append(req))
    calls = []

    def train_once():
        calls.append(1)
        if len(calls) == 1:
            raise elastic.CollectiveLost(epoch=3)
        return "forest"

    verdict = {"verb": "reform", "generation": 1, "epoch": 4, "survivors": HOSTS3[:2],
               "reason": "stale_host"}
    threading.Timer(0.3, watchdog.on_leader_verdict, args=(verdict,)).start()
    assert elastic.supervised_train(train_once) == "forest"
    assert order[0] == "down" and order[1].survivors == HOSTS3[:2] and order[1].epoch == 4

    elastic._reset_for_tests()
    monkeypatch.setenv(elastic.REFORM_DRAIN_TIMEOUT_ENV, "1")
    elastic.register_cluster(HOSTS3, "algo-2", config=elastic.resolve_elastic_config(),
                             relay=True)
    del calls[:]
    with pytest.raises(exc.PlatformError, match="no reform verdict"):
        elastic.supervised_train(train_once)


def test_leader_verdicts_over_the_control_pipe(port_state):
    """The leader's pipe: a reform verdict arms the worker's reform, an
    abort verdict exits with the leader's code."""
    import multiprocessing as mp

    from sagemaker_xgboost_container_tpu_torch.parallel import local
    from sagemaker_xgboost_container_tpu_torch.training import elastic, watchdog

    elastic.register_cluster(HOSTS3, "algo-3", config=elastic.resolve_elastic_config(),
                             relay=True)
    reader, writer = mp.get_context("spawn").Pipe(duplex=False)
    thread = local.listen_to_leader(reader, watchdog.on_leader_verdict)
    writer.send({"verb": "reform", "generation": 1, "epoch": 2, "survivors": HOSTS3[1:],
                 "reason": "stale_host"})
    writer.send({"verb": "abort", "exit_code": 82})
    writer.close()
    thread.join(10)
    assert not thread.is_alive()
    assert elastic.pending_reform()["survivors"] == HOSTS3[1:]
    assert elastic.pending_reform()["epoch"] == 2
    assert port_state == [82]


@pytest.mark.parametrize("host, in_flight, want", [
    ("algo-2", False, ("local", 80)),      # a dead worker is its host's death
    ("algo-1", False, ("cluster", 80)),    # rank 0's host: a dead master
    ("algo-2", True, ("local", 82)),       # during a reform
])
def test_dead_worker_verdict(port_state, monkeypatch, tmp_path, host, in_flight, want):
    from sagemaker_xgboost_container_tpu_torch.training import elastic, watchdog

    monkeypatch.setenv("SM_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setattr(watchdog, "_local_failure_lock", threading.Lock())
    monkeypatch.setattr(watchdog, "_plane_hosts", (HOSTS3, host))
    seen = []
    monkeypatch.setattr(watchdog, "request_abort",
                        lambda reason, code, **kw: seen.append(("local", code)))
    monkeypatch.setattr(watchdog, "coordinate_abort",
                        lambda hosts, me, reason, **kw: seen.append(("cluster", 80)))
    elastic.register_cluster(HOSTS3, host)
    if in_flight:
        elastic.request_reform(HOSTS3[:2], "stale_host", generation=1)
    watchdog.on_local_rank_failure(1, "local rank 1 failed (killed by signal 9)")
    assert seen == [want]
    with open(os.path.join(str(tmp_path), "failure")) as f:
        assert "local rank 1" in f.read()
