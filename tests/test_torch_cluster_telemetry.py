"""The port's multi-host cluster plane (heartbeats, rank-0 aggregation, the
abort plane) against the JAX package's, in process: the same payloads
folded into both packages' aggregators give the same series and episodes,
the wire framing is byte-equal, and a JAX broadcast reaches a port
listener."""

import json
import socket
import threading
import time

import pytest

from sagemaker_xgboost_container_tpu.parallel import distributed as jax_distributed
from sagemaker_xgboost_container_tpu.telemetry import cluster as jax_cluster
from sagemaker_xgboost_container_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from sagemaker_xgboost_container_tpu_torch.constants import EXIT_CLUSTER_ABORT
from sagemaker_xgboost_container_tpu_torch.parallel import distributed
from sagemaker_xgboost_container_tpu_torch.telemetry import cluster
from sagemaker_xgboost_container_tpu_torch.telemetry.registry import MetricsRegistry
from sagemaker_xgboost_container_tpu_torch.training import watchdog
from tests.util_cluster import make_heartbeat
from tests.util_ports import free_port


def _series(reg, skip=("cluster_heartbeat_age_seconds",)):
    """{(name, labels): value} of a registry's cluster_* series."""
    out = {}
    for name, _kind, _help, series in reg.collect():
        if name.startswith("cluster_") and name not in skip:
            for m in series:
                out[name, tuple(sorted(m.labels.items()))] = m.value
    return out


def _aggregators(**kw):
    regs = MetricsRegistry(), JaxRegistry()
    aggs = (cluster.HeartbeatAggregator(registry=regs[0], port=0, **kw),
            jax_cluster.HeartbeatAggregator(registry=regs[1], port=0, **kw))
    return regs, aggs


def _close(aggs):
    """Release never-started aggregators' sockets."""
    for agg in aggs:
        agg._server.close()


def test_fold_and_straggler_episodes_match_jax(capfd):
    regs, aggs = _aggregators(num_hosts=3, interval=60.0, factor=3.0)
    try:
        payloads = [make_heartbeat(0, round_index=4, last_round_ms=100.0),
                    make_heartbeat(1, round_index=4, last_round_ms=110.0),
                    make_heartbeat(2, round_index=3, last_round_ms=900.0),
                    {"type": "heartbeat", "rank": 9}, {"type": "nope"}, None, "junk"]
        for agg in aggs:
            assert [agg.fold(p) for p in payloads] == [True, True, True] + [False] * 4
            agg.evaluate()
        assert _series(regs[0]) == _series(regs[1])
        assert _series(regs[0])["cluster_straggler_episodes_total", (("rank", "2"),)] == 1
        for r in range(3):
            assert aggs[0]._hosts[r]["straggling"] == aggs[1]._hosts[r]["straggling"]
        out = capfd.readouterr().out
        records = [json.loads(l) for l in out.splitlines() if l.startswith('{"metric": "cluster.')]
        kinds = sorted(r["metric"] for r in records)
        assert kinds == ["cluster.heartbeat"] * 2 + ["cluster.straggler"] * 2
    finally:
        _close(aggs)


def test_stale_host_hook_matches_jax():
    calls = ([], [])
    regs, aggs = _aggregators(num_hosts=2, interval=0.05, stale_after=2,
                              hosts=["127.0.0.1", "localhost"])
    aggs[0].on_stale = lambda *a: calls[0].append(a)
    aggs[1].on_stale = lambda *a: calls[1].append(a)
    try:
        for agg in aggs:
            agg.fold(make_heartbeat(0))
            agg.fold(make_heartbeat(1))
        time.sleep(0.25)            # past stale_after * interval
        for agg in aggs:
            agg.fold(make_heartbeat(0))
            agg.evaluate()
            agg.evaluate()          # one call an episode
        assert [c[:2] for c in calls[0]] == [c[:2] for c in calls[1]] == [(1, "fake-host-1")]
        assert _series(regs[0]) == _series(regs[1])
        assert regs[0].gauge("cluster_reporting_hosts").value == 1
    finally:
        _close(aggs)


def test_sender_payload_keys_match_jax():
    state = cluster.RoundState()
    jax_state = jax_cluster.RoundState()
    for i in range(4):
        state.note_round(i, 0.1 * (i + 1))
        jax_state.note_round(i, 0.1 * (i + 1))
    kw = dict(rank=1, host="h", aggregator_addr=("127.0.0.1", 1), interval=1.0)
    ours = cluster.HeartbeatSender(round_state=state, registry=MetricsRegistry(), **kw)
    ref = jax_cluster.HeartbeatSender(round_state=jax_state, registry=JaxRegistry(), **kw)
    a, b = ours.build_payload(), ref.build_payload()
    assert set(a) == set(b)
    for key in ("type", "v", "rank", "host", "round", "rounds_total", "last_round_ms",
                "round_ms_p50", "round_ms_p95"):
        assert a[key] == b[key], key


def test_frames_byte_equal_and_bounded():
    obj = {"type": "abort", "reason": "stale_host", "exit_code": 80, "source": "a"}
    assert distributed.frame_message(obj) == jax_distributed.frame_message(obj)
    a, b = socket.socketpair()
    try:
        a.sendall(jax_distributed.frame_message(obj))
        assert distributed.recv_message_bounded(b, 5.0) == obj
        a.sendall(b"GET / HTTP/1.1\r\n")   # a stray client's request line
        with pytest.raises(ValueError, match="oversized"):
            distributed.recv_message_bounded(b, 5.0)
    finally:
        a.close()
        b.close()


def test_plane_inert_without_interval(monkeypatch):
    monkeypatch.delenv(cluster.HEARTBEAT_INTERVAL_ENV, raising=False)
    before = set(threading.enumerate())
    assert cluster.start_cluster_telemetry(["a", "b"], "a") is None
    assert set(threading.enumerate()) == before


def test_plane_heartbeats_reach_rank0(monkeypatch):
    monkeypatch.setenv(cluster.HEARTBEAT_INTERVAL_ENV, "0.05")
    monkeypatch.setenv(cluster.HEARTBEAT_PORT_ENV, str(free_port()))
    monkeypatch.delenv(cluster.CLUSTER_METRICS_ENV, raising=False)
    reg = MetricsRegistry()
    plane = cluster.start_cluster_telemetry(["127.0.0.1"], "127.0.0.1", registry=reg)
    try:
        assert plane.aggregator is not None and plane.sender is not None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not reg.counter(
                "cluster_heartbeats_received_total", labels={"rank": "0"}).value:
            time.sleep(0.05)
        assert reg.counter("cluster_heartbeats_received_total", labels={"rank": "0"}).value >= 1
    finally:
        cluster.stop_cluster_telemetry()


@pytest.fixture
def fake_exit(monkeypatch):
    exits = []
    monkeypatch.setattr(watchdog, "_exit", exits.append)
    watchdog._reset_abort_for_tests()
    yield exits
    watchdog._reset_abort_for_tests()


def test_abort_plane_inert_without_knob(monkeypatch, fake_exit):
    monkeypatch.delenv(watchdog.ABORT_ON_STALE_ENV, raising=False)
    assert watchdog.start_abort_plane(["a", "b"], "a") is None


def test_jax_broadcast_reaches_port_listener(monkeypatch, fake_exit):
    """A JAX rank's abort frame makes a port rank abort with the frame's
    code; a duplicate frame fires once."""
    monkeypatch.setenv(watchdog.ABORT_ON_STALE_ENV, "true")
    port = free_port()
    listener = watchdog.start_abort_plane(["127.0.0.1", "localhost"], "localhost", port=port)
    assert listener is not None
    for source in ("127.0.0.1", "again"):
        assert jax_distributed.broadcast_abort(["127.0.0.1"], "stale_host", source=source,
                                               port=port, exit_code=EXIT_CLUSTER_ABORT) == 1
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not fake_exit:
        time.sleep(0.02)
    time.sleep(0.2)
    assert fake_exit == [EXIT_CLUSTER_ABORT]


def test_stale_host_coordinates_abort(monkeypatch, fake_exit, capfd):
    """Rank 0's verdict: the frame goes to the peer (a listener here), and
    this rank exits 80 with one training.abort record."""
    monkeypatch.setenv("SM_STRUCTURED_METRICS", "true")
    got = []
    peer = distributed.AbortListener(handler=got.append, port=0).start()
    try:
        watchdog.coordinate_abort(["127.0.0.1", "peer"], "127.0.0.1", "stale_host",
                                  peer_addrs={"peer": ("127.0.0.1", peer.port)},
                                  stale_rank=1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not got:
            time.sleep(0.02)
    finally:
        peer.stop()
    assert fake_exit == [EXIT_CLUSTER_ABORT]
    assert got and got[0]["exit_code"] == EXIT_CLUSTER_ABORT
    records = [l for l in capfd.readouterr().out.splitlines() if '"training.abort"' in l]
    assert len(records) == 1 and '"stale_rank": 1' in records[0]


def test_collective_failure_without_plane_fails_the_job(fake_exit):
    from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

    with pytest.raises(exc.PlatformError, match="collective"):
        watchdog.on_collective_failure(RuntimeError("Connection reset by peer"))
    assert fake_exit == []
