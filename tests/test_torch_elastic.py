"""The port's elastic shrink-to-continue plane (``training/elastic.py``,
the reform half of ``parallel/distributed.py``, the watchdog's shrink
decision) against the JAX package's, in process on the CPU.

* parity: the same knobs, membership and requests give both packages the
  same config, proposals, idempotence verdicts and transition record;
* a checkpoint manifest with a ``membership_log`` written by either package
  passes the other's ``validate_resume``;
* the reform handshake: a port survivor and a JAX survivor re-rendezvous
  with each other, a fault is retried, mixed generations are refused;
* the port's own drain: a failed collective waits for the shrink verdict
  and unwinds with ``ReformRequested`` (or takes the exit 80 without one),
  the process group is torn down under a deadline and re-formed on the
  generation's port, and every survivor resumes at rank 0's checkpoint.

The subprocess drills (three hosts, one killed) are in
``tests/test_torch_elastic_drills.py``.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.parallel import distributed as jax_distributed
from sagemaker_xgboost_container_tpu.training import checkpointing as jax_checkpointing
from sagemaker_xgboost_container_tpu.training import consensus as jax_consensus
from sagemaker_xgboost_container_tpu.training import elastic as jax_elastic
from sagemaker_xgboost_container_tpu.training import watchdog as jax_watchdog
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity
from sagemaker_xgboost_container_tpu_torch.constants import (EXIT_CLUSTER_ABORT,
                                                             EXIT_REFORM_FAILED)
from sagemaker_xgboost_container_tpu_torch.parallel import distributed
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc
from sagemaker_xgboost_container_tpu_torch.training import (checkpointing, consensus, elastic,
                                                            watchdog)
from sagemaker_xgboost_container_tpu_torch.utils import faults, integrity
from tests import util_torch_hosts as uh
from tests import util_torch_ranks as ur
from tests.util_ports import free_port

PACKAGES = {
    "port": types.SimpleNamespace(elastic=elastic, watchdog=watchdog, consensus=consensus,
                                  distributed=distributed, checkpointing=checkpointing,
                                  integrity=integrity, faults=faults),
    "jax": types.SimpleNamespace(elastic=jax_elastic, watchdog=jax_watchdog,
                                 consensus=jax_consensus, distributed=jax_distributed,
                                 checkpointing=jax_checkpointing, integrity=jax_integrity,
                                 faults=jax_faults),
}
HOSTS = ["algo-1", "algo-2", "algo-3"]


def _reset():
    for m in PACKAGES.values():
        m.faults.reset()
        m.elastic._reset_for_tests()
        m.consensus._reset_for_tests()
        m.watchdog._reset_abort_for_tests()
        m.watchdog.stop_abort_plane()


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("SM_IO_RETRY_BACKOFF_S", "0.001")
    _reset()
    yield
    _reset()


@pytest.fixture
def exits(monkeypatch):
    codes = []
    for m in PACKAGES.values():
        monkeypatch.setattr(m.watchdog, "_exit", codes.append)
    return codes


def _enable(monkeypatch, min_hosts=1, max_shrinks=2):
    monkeypatch.setenv(elastic.ELASTIC_ENV, "1")
    monkeypatch.setenv(elastic.ELASTIC_MIN_HOSTS_ENV, str(min_hosts))
    monkeypatch.setenv(elastic.ELASTIC_MAX_SHRINKS_ENV, str(max_shrinks))


def _both(fn):
    """fn(package namespace) on the port and the JAX package -> (port, jax)."""
    out = []
    for name in ("port", "jax"):
        _reset()
        out.append(fn(PACKAGES[name]))
    return tuple(out)


class _JsonModel:
    def save_model(self, path):
        with open(path, "w") as f:
            json.dump({"tag": "m"}, f)


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("env, want", [
    ({}, (False, 1, 2, 60.0, 300.0)),
    ({"SM_ELASTIC": "1", "SM_ELASTIC_MIN_HOSTS": "0", "SM_REFORM_TIMEOUT_S": "0.01"},
     (True, 1, 2, 1.0, 300.0)),
    ({"SM_ELASTIC": "true", "SM_ELASTIC_MAX_SHRINKS": "500",
      "SM_REFORM_DRAIN_TIMEOUT_S": "0.5"}, (True, 1, 64, 60.0, 1.0)),
    ({"SM_ELASTIC": "0", "SM_ELASTIC_MIN_HOSTS": "3", "SM_REFORM_TIMEOUT_S": "9999"},
     (False, 3, 2, 3600.0, 300.0)),
])
def test_resolve_elastic_config_defaults_and_clamps_like_jax(monkeypatch, env, want):
    for var in ("SM_ELASTIC", "SM_ELASTIC_MIN_HOSTS", "SM_ELASTIC_MAX_SHRINKS",
                "SM_REFORM_TIMEOUT_S", "SM_REFORM_DRAIN_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def config(m):
        cfg = m.elastic.resolve_elastic_config()
        return (cfg.enabled, cfg.min_hosts, cfg.max_shrinks, cfg.reform_timeout_s,
                cfg.drain_timeout_s)

    port, ref = _both(config)
    assert port == ref == want


@pytest.mark.parametrize("enabled, min_hosts, max_shrinks, hosts, stale, want", [
    (False, 1, 2, HOSTS, "algo-3", None),
    (True, 2, 2, HOSTS, "algo-3", ["algo-1", "algo-2"]),
    (True, 1, 2, HOSTS, "algo-9", None),              # already shrunk away
    (True, 2, 2, HOSTS[:2], "algo-2", None),          # below the floor
    (True, 1, 0, HOSTS[:2], "algo-2", None),          # budget exhausted
    (True, 1, 2, HOSTS[:2], "algo-1", ["algo-2"]),
])
def test_propose_survivors_gates_and_budget_like_jax(monkeypatch, enabled, min_hosts,
                                                     max_shrinks, hosts, stale, want):
    _enable(monkeypatch, min_hosts=min_hosts, max_shrinks=max_shrinks)
    if not enabled:
        monkeypatch.delenv(elastic.ELASTIC_ENV)

    def propose(m):
        m.elastic.register_cluster(hosts, hosts[0])
        return m.elastic.propose_survivors(stale)

    port, ref = _both(propose)
    assert port == ref == want


def test_propose_survivors_budget_spent_by_a_shrink_like_jax(monkeypatch):
    _enable(monkeypatch, min_hosts=1, max_shrinks=1)

    def shrink_then_propose(m):
        m.elastic.register_cluster(HOSTS, "algo-1")
        m.elastic._commit_transition(
            m.elastic.ReformRequested(["algo-1", "algo-2"], "stale_host", 1, epoch=3), HOSTS)
        return m.elastic.propose_survivors("algo-2")

    port, ref = _both(shrink_then_propose)
    assert port is None and ref is None


def test_request_reform_idempotent_per_generation_like_jax(monkeypatch):
    _enable(monkeypatch)

    def requests(m):
        m.elastic.register_cluster(HOSTS, "algo-1")
        verdicts = [m.elastic.request_reform(["algo-1", "algo-2"], "stale_host", generation=1),
                    m.elastic.request_reform(["algo-1", "algo-2"], "stale_host", generation=1),
                    m.elastic.request_reform(["algo-1"], "whatever", generation=0),
                    m.elastic.request_reform(["algo-1"], "again", generation=1)]
        pending = m.elastic.pending_reform()
        m.elastic._disarm_pending("test")
        return verdicts, pending

    port, ref = _both(requests)
    assert port == ref
    assert port[0] == [True, False, False, False]
    assert port[1] == {"survivors": ["algo-1", "algo-2"], "reason": "stale_host",
                       "generation": 1, "epoch": None}


def test_request_reform_without_cluster_is_refused_like_jax():
    port, ref = _both(lambda m: m.elastic.request_reform(["a"], "stale_host"))
    assert port is False and ref is False


def test_transition_record_keys_and_values_like_jax(monkeypatch, capfd):
    """perform_reform over one survivor (its rendezvous short-circuits) in
    both packages: the same membership_log entry, training.membership
    record, counters and consensus membership."""
    monkeypatch.setenv("SM_STRUCTURED_METRICS", "true")
    _enable(monkeypatch)

    def reform(m):
        m.elastic.register_cluster(HOSTS, "algo-2")
        rewired = []
        req = m.elastic.ReformRequested(["algo-2"], "stale_host", 1, epoch=6)
        m.elastic.perform_reform(req, on_reform=lambda hosts, cur: rewired.append((hosts, cur)))
        return (m.elastic.membership_log(), m.elastic.world_size(), m.elastic.generation(),
                m.elastic.pending_reform(), rewired, m.consensus._hosts)

    capfd.readouterr()
    port, ref = _both(reform)
    assert port == ref
    log = port[0]
    assert log == [{"event": "shrink", "generation": 1, "old_world_size": 3,
                    "new_world_size": 1, "epoch": 6, "reason": "stale_host",
                    "surviving_ranks": [1], "hosts": ["algo-2"]}]
    assert port[1:] == (1, 1, None, [(["algo-2"], "algo-2")], ["algo-2"])
    records = [json.loads(line) for line in capfd.readouterr().out.splitlines()
               if line.startswith('{"metric": "training.membership"')]
    assert len(records) == 2 and records[0] == records[1]
    assert {k: v for k, v in records[0].items() if k != "metric"} == log[0]
    assert REGISTRY.gauge("cluster_world_size").value == 1


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("where", ["manifest", "live"])
def test_membership_manifest_resumes_across_packages(tmp_path, monkeypatch, writer, reader,
                                                     where):
    """A checkpoint written at world size 3 by one package, resumed at
    world size 2 under SM_RESUME_STRICT by the other: the transition in the
    writer's manifest (or in the reader's live log) sanctions it; without
    one it is refused."""
    monkeypatch.setenv("SM_RESUME_STRICT", "true")
    w, r = PACKAGES[writer], PACKAGES[reader]
    cfg = {"objective": "binary:logistic", "max_depth": "4"}
    log = [{"event": "shrink", "generation": 1, "old_world_size": 3, "new_world_size": 2,
            "epoch": 4, "reason": "stale_host", "surviving_ranks": [0, 1],
            "hosts": ["algo-1", "algo-2"]}]
    w.checkpointing._atomic_save(_JsonModel(), str(tmp_path), "xgboost-checkpoint.4",
                                 iteration=4,
                                 fingerprint=r.integrity.config_fingerprint(cfg, world_size=3),
                                 membership_log=log if where == "manifest" else None)
    path = str(tmp_path / "xgboost-checkpoint.4")
    assert r.integrity.read_manifest(path).get("membership_log") == (
        log if where == "manifest" else None)
    live = r.integrity.config_fingerprint(cfg, world_size=2)
    live_log = log if where == "live" else None
    assert r.integrity.validate_resume(path, live, membership_log=live_log) is True
    with pytest.raises(Exception, match="fingerprint disagrees"):
        r.integrity.validate_resume(path, r.integrity.config_fingerprint(cfg, world_size=5),
                                    membership_log=live_log)


def test_checkpoint_saver_stamps_membership_log(tmp_path):
    transitions = [{"old_world_size": 3, "new_world_size": 2, "generation": 1,
                    "reason": "stale_host"}]
    for i, provider in enumerate((lambda: list(transitions), lambda: [])):
        saver = checkpointing.SaveCheckpointCallBack(str(tmp_path), membership_provider=provider)
        try:
            saver.after_iteration(_JsonModel(), i, {})
        finally:
            saver.stop()
    assert integrity.read_manifest(str(tmp_path / "xgboost-checkpoint.0"))[
        "membership_log"] == transitions
    assert "membership_log" not in integrity.read_manifest(
        str(tmp_path / "xgboost-checkpoint.1"))


# -------------------------------------------------------- the shrink verb
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_shrink_frames_arm_or_abort(monkeypatch, exits, pkg):
    """A shrink frame arms the reform on a survivor; on the host it excludes
    it exits 80 (80 is what a JAX frame and a port frame both carry)."""
    m = PACKAGES[pkg]
    _enable(monkeypatch)
    frame = {"type": "abort", "verb": "shrink", "reason": "stale_host",
             "survivors": ["algo-1", "algo-2"], "generation": 1, "source": "algo-1"}
    m.elastic.register_cluster(HOSTS, "algo-2")
    m.watchdog._on_abort_frame(frame)
    assert m.elastic.pending_reform()["generation"] == 1 and exits == []
    _reset()
    m.elastic.register_cluster(HOSTS, "algo-3")
    m.watchdog._on_abort_frame(frame)
    assert exits == [EXIT_CLUSTER_ABORT] and m.elastic.pending_reform() is None


def test_handle_stale_host_decides_shrink_abort_or_defer(monkeypatch):
    aborts, shrinks = [], []
    monkeypatch.setattr(watchdog, "coordinate_abort", lambda *a, **k: aborts.append(a))
    monkeypatch.setattr(elastic, "coordinate_shrink", lambda *a, **k: shrinks.append(a))
    elastic.register_cluster(HOSTS, "algo-1")        # SM_ELASTIC unset
    watchdog.handle_stale_host(HOSTS, "algo-1", 2, "algo-3", 9.0)
    assert len(aborts) == 1 and not shrinks
    elastic._reset_for_tests()
    _enable(monkeypatch, min_hosts=2)
    elastic.register_cluster(HOSTS, "algo-1")
    watchdog.handle_stale_host(HOSTS, "algo-1", 2, "algo-3", 9.0)
    assert len(aborts) == 1 and shrinks == [(["algo-1", "algo-2"], "stale_host")]
    elastic.request_reform(["algo-1", "algo-2"], "stale_host", generation=1)
    watchdog.handle_stale_host(HOSTS, "algo-1", 1, "algo-2", 9.0)   # deferred
    assert len(aborts) == 1 and len(shrinks) == 1


def test_coordinate_shrink_reaches_port_and_jax_listeners(monkeypatch):
    """Rank 0's fan-out reaches every member: a port listener (survivor) and
    a JAX listener (the excluded host) get the same shrink frame."""
    got = {"port": [], "jax": []}
    listeners = [distributed.AbortListener(handler=got["port"].append, port=0).start(),
                 jax_distributed.AbortListener(handler=got["jax"].append, port=0).start()]
    try:
        _enable(monkeypatch)
        elastic.register_cluster(HOSTS, "algo-1", peer_addrs={
            "algo-2": ("127.0.0.1", listeners[0].port),
            "algo-3": ("127.0.0.1", listeners[1].port)})
        elastic.coordinate_shrink(["algo-1", "algo-2"], "stale_host", epoch=4)
        deadline = time.monotonic() + 5
        while not (got["port"] and got["jax"]) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        for listener in listeners:
            listener.stop()
    assert got["port"] and got["port"] == got["jax"]
    assert {k: got["port"][0][k] for k in ("verb", "survivors", "generation", "source")} == {
        "verb": "shrink", "survivors": ["algo-1", "algo-2"], "generation": 1,
        "source": "algo-1"}
    assert elastic.pending_reform()["generation"] == 1


def test_abort_listener_passes_shrink_frames_once():
    """The listener hands a shrink frame to its handler like an abort, with
    the same duplicate suppression (frames differing only in source), and a
    later generation passes."""
    calls = []
    listener = distributed.AbortListener(handler=calls.append, port=0)
    frame = {"type": "abort", "verb": "shrink", "reason": "stale_host",
             "survivors": ["algo-1"], "generation": 1}
    threads = [threading.Thread(target=listener._dispatch,
                                args=(dict(frame, source="algo-{}".format(i)),
                                      ("127.0.0.1", 1000 + i)))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and calls[0]["verb"] == "shrink"
    assert listener._dispatch(dict(frame, generation=2), ("127.0.0.1", 1)) is True
    assert len(calls) == 2
    listener.stop()


def test_rendezvous_announces_abort_ports(monkeypatch):
    """Hosts of one box listen on distinct abort ports: each announces its
    own at the rendezvous, and a broadcast without peer_addrs uses them."""
    got = []
    listener = distributed.AbortListener(handler=got.append, port=0).start()
    try:
        distributed._note_abort_ports([
            {"host": "algo-1", "include_in_training": True, "abort_port": 1},
            {"host": "algo-2", "include_in_training": True, "abort_port": listener.port}])
        assert distributed.announced_abort_addrs()["algo-2"] == ("algo-2", listener.port)
        distributed._note_abort_ports([
            {"host": "127.0.0.1", "abort_port": listener.port}])
        assert distributed.broadcast_abort(["127.0.0.1"], "stale_host", source="t") == 1
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        listener.stop()
        distributed._note_abort_ports([])
    assert got and got[0]["reason"] == "stale_host"


# ------------------------------------------------------ the reform handshake
def _reform_pair(funcs, generations, faulted=None):
    port = free_port()
    results, errors = {}, {}

    def run(rank):
        try:
            cluster, membership = funcs[rank](
                ["algo-1", "algo-2"], "algo-{}".format(rank + 1), generations[rank],
                payload={"package": ("port", "jax")[rank] if len(set(funcs)) > 1 else "same"},
                port=port, timeout=15.0, master_addr="127.0.0.1")
            results[rank] = (cluster.num_hosts, membership)
        except Exception as e:
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    threads[0].start()
    time.sleep(0.2)
    threads[1].start()
    for t in threads:
        t.join(timeout=40)
    return results, errors


@pytest.mark.parametrize("master", ["port", "jax"])
def test_reform_cluster_port_and_jax_survivors_rendezvous(master):
    """Same framing, same generation check: a port survivor and a JAX
    survivor re-form with each other, either one the master; one injected
    fault at ``rendezvous.reform`` on the port side is retried."""
    faults.configure("rendezvous.reform:error:transient bind race@1")
    funcs = [distributed.reform_cluster, jax_distributed.reform_cluster]
    if master == "jax":
        funcs.reverse()
    results, errors = _reform_pair(funcs, (3, 3))
    assert not errors, errors
    assert results[0][0] == results[1][0] == 2
    assert results[0][1] == results[1][1]
    assert [m["host"] for m in results[0][1]] == ["algo-1", "algo-2"]
    assert {m["generation"] for m in results[0][1]} == {3}
    assert faults.fault_counts()["rendezvous.reform"] == 1


def test_reform_cluster_refuses_mixed_generations():
    f = distributed.reform_cluster
    results, errors = _reform_pair([f, f], (2, 1))
    assert set(errors) == {0, 1}
    assert all(isinstance(e, exc.PlatformError) for e in errors.values())
    assert "mixed shrink generations" in str(errors[0])


def test_perform_reform_failure_exits_82_without_commit(monkeypatch, exits):
    monkeypatch.setenv("SM_IO_RETRY_ATTEMPTS", "2")
    faults.configure("rendezvous.reform:error:injected reform outage")
    _enable(monkeypatch)
    elastic.register_cluster(["algo-1", "algo-2", "algo-3"], "algo-1")
    req = elastic.ReformRequested(["algo-1", "algo-2"], "stale_host", 1, epoch=2)
    with pytest.raises(OSError):
        elastic.perform_reform(req, master_addr="127.0.0.1", port=free_port())
    assert exits == [EXIT_REFORM_FAILED]
    assert elastic.membership_log() == [] and elastic.world_size() == 3


def test_drain_deadline_demotes_or_is_disarmed(monkeypatch, exits):
    """An armed reform never drained exits 80 at the drain deadline; one
    that a reform consumes, or that training outlived, does not."""
    monkeypatch.setenv(elastic.REFORM_DRAIN_TIMEOUT_ENV, "1")
    _enable(monkeypatch)
    elastic.register_cluster(HOSTS, "algo-2")
    assert elastic.request_reform(["algo-1", "algo-2"], "stale_host", generation=1)
    deadline = time.monotonic() + 10
    while not exits and time.monotonic() < deadline:
        time.sleep(0.05)
    assert exits == [EXIT_CLUSTER_ABORT]
    _reset()
    del exits[:]
    elastic.register_cluster(["algo-1", "algo-2"], "algo-1")
    elastic.request_reform(["algo-1"], "stale_host", generation=1)
    elastic.perform_reform(elastic.ReformRequested(["algo-1"], "stale_host", 1, epoch=3))
    assert elastic.supervised_train(
        lambda: elastic.request_reform(["algo-1"], "late", generation=2) and "forest") == "forest"
    assert elastic.pending_reform() is None
    time.sleep(1.3)
    assert exits == [] and elastic.world_size() == 1


def test_supervised_train_reforms_without_the_old_traceback(monkeypatch):
    """The reform gets a copy of the request: the raised one's traceback
    (whose frames hold the old session and its process group) and context
    are gone."""
    seen = []
    monkeypatch.setattr(elastic, "perform_reform",
                        lambda req, **kw: seen.append(req))
    calls = []

    def train_once():
        calls.append(1)
        if len(calls) == 1:
            try:
                raise RuntimeError("Connection closed by peer")
            except RuntimeError:
                raise elastic.ReformRequested(["algo-1"], "stale_host", 1, epoch=4)
        return "forest"

    assert elastic.supervised_train(train_once) == "forest"
    assert len(seen) == 1 and seen[0].epoch == 4 and seen[0].survivors == ["algo-1"]
    assert seen[0].__traceback__ is None and seen[0].__context__ is None


# ------------------------------------------------------- the port's drain
def test_collective_failure_waits_for_the_verdict(monkeypatch, exits):
    """With the elastic plane armed, a failed collective does not exit 80:
    it waits for the shrink verdict and raises ReformRequested carrying the
    last committed round."""
    from sagemaker_xgboost_container_tpu_torch.telemetry.cluster import ROUND_STATE

    _enable(monkeypatch)
    elastic.register_cluster(HOSTS, "algo-2")
    monkeypatch.setattr(watchdog, "_plane_hosts", (HOSTS, "algo-2"))
    ROUND_STATE.reset()
    ROUND_STATE.note_round(4, 0.01)
    timer = threading.Timer(0.3, lambda: watchdog._on_abort_frame(
        {"type": "abort", "verb": "shrink", "reason": "stale_host",
         "survivors": ["algo-1", "algo-2"], "generation": 1}))
    timer.start()
    t = time.monotonic()
    with pytest.raises(elastic.ReformRequested) as err:
        watchdog.on_collective_failure(RuntimeError("Connection reset by peer"))
    ROUND_STATE.reset()
    assert 0.2 < time.monotonic() - t < 5
    assert err.value.survivors == ["algo-1", "algo-2"] and err.value.epoch == 4
    assert exits == []


def test_collective_failure_without_verdict_exits_80(monkeypatch, exits):
    """No verdict within SM_REFORM_DRAIN_TIMEOUT_S (rank 0 itself died, or
    the floors refused the shrink): the coordinated abort, exit 80."""
    monkeypatch.setenv(elastic.REFORM_DRAIN_TIMEOUT_ENV, "1")
    _enable(monkeypatch)
    elastic.register_cluster(["127.0.0.1", "localhost"], "localhost")
    monkeypatch.setattr(watchdog, "_plane_hosts", (["127.0.0.1", "localhost"], "localhost"))
    t = time.monotonic()
    watchdog.on_collective_failure(RuntimeError("Connection reset by peer"))
    assert 0.9 < time.monotonic() - t < 10
    assert exits == [EXIT_CLUSTER_ABORT]


def test_abort_plane_armed_by_elastic(monkeypatch):
    monkeypatch.delenv(watchdog.ABORT_ON_STALE_ENV, raising=False)
    assert watchdog.start_abort_plane(["127.0.0.1", "localhost"], "localhost", port=0) is None
    _enable(monkeypatch)
    elastic.register_cluster(["127.0.0.1", "localhost"], "localhost")
    listener = watchdog.start_abort_plane(["127.0.0.1", "localhost"], "localhost", port=0)
    assert listener is not None
    watchdog.stop_abort_plane()


# --------------------------------------------------- the process group
def test_teardown_process_group_is_bounded(monkeypatch):
    """No group: a no-op. A teardown that hangs raises PlatformError at the
    deadline instead of wedging the survivor."""
    import torch.distributed as dist

    distributed.teardown_process_group(timeout_s=1.0)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a: time.sleep(30))
    t = time.monotonic()
    with pytest.raises(exc.PlatformError, match="did not tear down"):
        distributed.teardown_process_group(timeout_s=0.5)
    assert time.monotonic() - t < 5


@pytest.mark.parametrize("generation", [1, 2])
def test_reform_process_group_uses_the_generation_port(monkeypatch, generation):
    """One gloo rank: the old group goes, the new one's store listens on
    SM_PROCESS_GROUP_PORT + generation."""
    import torch
    import torch.distributed as dist

    store = free_port()
    monkeypatch.setenv("SM_PROCESS_GROUP_PORT", str(store - generation))
    monkeypatch.setenv("SM_PROCESS_GROUP_BACKEND", "gloo")
    seen = []
    real_init = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: (seen.append(k["init_method"]), real_init(*a, **k))[1])
    try:
        distributed.init_process_group(["127.0.0.1"], "127.0.0.1", torch.device("cpu"),
                                       port=free_port())
        old = dist.group.WORLD
        group = distributed.reform_process_group(["127.0.0.1"], "127.0.0.1",
                                                 torch.device("cpu"), generation)
        assert group is not old and dist.get_world_size() == 1
        assert seen[-1] == "tcp://127.0.0.1:{}".format(store)
    finally:
        distributed.destroy_process_group()


def test_survivors_agree_on_rank_0s_resume_point():
    """Rank 0 holds a checkpoint at round k, rank 1 none: both resume at k
    from rank 0's bytes and finish with equal forests, equal to one
    uninterrupted run of the same rounds (the JAX package re-reads each
    rank's own directory, and its rank 1 would restart at round 0)."""
    out = ur.run_ranks(uh.agreed_resume_rank, timeout=120)
    (trees0, it0, had0), (trees1, it1, had1) = out
    assert (it0, it1) == (uh.RESUME_AT, uh.RESUME_AT) and had0 and not had1
    assert len(trees0) == len(trees1) == uh.RESUME_ROUNDS
    for a, b in zip(trees0, trees1):
        for key in a:
            assert np.array_equal(a[key], b[key]), key
