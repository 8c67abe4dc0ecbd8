"""The port's fleet plane (``telemetry/fleet.py``) against the JAX
package's, in process: the span wire round trip, the collector's merged
trace and skew reports, ``/status`` and ``/debug/flight`` over HTTP, the
SIGQUIT dump, the inert guard, and the four callers that feed ``/status``
(the device plane, the checkpoint saver, the entry point's planned rounds
and RoundTimer's attribution)."""

import json
import os
import signal
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.telemetry import cluster as jax_cluster
from sagemaker_xgboost_container_tpu.telemetry import fleet as jax_fleet
from sagemaker_xgboost_container_tpu.telemetry import model as jax_model
from sagemaker_xgboost_container_tpu.telemetry import tracing as jax_tracing
from sagemaker_xgboost_container_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from sagemaker_xgboost_container_tpu_torch.telemetry import cluster, fleet, tracing
from sagemaker_xgboost_container_tpu_torch.telemetry import model as model_telemetry
from sagemaker_xgboost_container_tpu_torch.telemetry.registry import MetricsRegistry
from tests.util_ports import free_port


@pytest.fixture
def fleet_env(monkeypatch):
    for knob in (fleet.FLEET_TRACE_ENV, fleet.FLEET_TRACE_PORT_ENV, fleet.FLEET_FLUSH_ENV,
                 fleet.STATUS_PORT_ENV, "SM_TRACE_EXPORT_DIR", "SM_DEVICE_TELEMETRY"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("SM_TRACE", "1")
    # /status also renders the round state and the learning stats, which
    # a training test earlier in the same worker may have left behind
    for state in (cluster.ROUND_STATE, jax_cluster.ROUND_STATE):
        state.reset()
    for mod in (tracing, fleet, model_telemetry, jax_tracing, jax_fleet, jax_model):
        mod._reset_for_tests()
    yield monkeypatch
    for mod in (tracing, fleet, jax_tracing, jax_fleet):
        mod._reset_for_tests()


def _wire_round(rank, round_index, dur_us, phases=()):
    """Wire spans of one round: its phase children, then the root."""
    base = float(round_index) * 1_000_000.0
    spans = [{"name": name, "trace_id": "t{}-{}".format(rank, round_index),
              "span_id": "s{}-{}-{}".format(rank, round_index, i), "start_us": base + i,
              "dur_us": float(d), "tid": 1, "thread_name": "MainThread"}
             for i, (name, d) in enumerate(phases)]
    spans.append({"name": "round", "trace_id": "t{}-{}".format(rank, round_index),
                  "span_id": "s{}-{}-root".format(rank, round_index), "start_us": base,
                  "dur_us": float(dur_us), "tid": 1, "thread_name": "MainThread",
                  "attributes": {"round": round_index}})
    return spans


def test_span_wire_round_trip_equals_jax(fleet_env):
    span = types.SimpleNamespace(
        name="round", trace_id="abc", span_id="s1", parent_id="p0", start_us=12.3456789,
        dur_us=1000.00049, tid=7, thread_name="MainThread", attributes={"round": 3})
    wire = tracing.span_to_wire(span)
    assert wire == jax_tracing.span_to_wire(span)
    assert json.loads(json.dumps(wire)) == wire
    spans = [wire, dict(wire, span_id="s2", tid=8, thread_name="w", parent_id=None)]
    assert (tracing.events_from_wire(spans, pid=1, process_label="rank 1")
            == jax_tracing.events_from_wire(spans, pid=1, process_label="rank 1"))
    # a finished span carries the shipper's watermark
    with tracing.trace_span("round", attributes={"round": 0}):
        pass
    (finished,) = tracing.snapshot_spans()
    assert finished.seq == 1
    assert tracing.span_to_wire(finished)["attributes"] == {"round": 0}


@pytest.mark.parametrize("phase, slow_us, want", [
    ("collective.dispatch", 41_000.0, "collective"),
    ("host_dispatch", 41_000.0, "host"),
    ("device_sync", 1_000.0, "wire"),
])
def test_collector_docs_and_skew_equal_jax(fleet_env, phase, slow_us, want):
    batches = [{"type": "spans", "rank": 0,
                "spans": _wire_round(0, 0, 10_000.0, phases=((phase, 1000.0),))},
               {"type": "spans", "rank": 1,
                "spans": _wire_round(1, 0, 50_000.0, phases=((phase, slow_us),))},
               {"type": "spans", "rank": 5, "spans": []}, {"type": "nope"}, None]
    ours = fleet.FleetCollector(num_ranks=2, port=0, registry=MetricsRegistry(),
                                hosts=["a", "b"])
    ref = jax_fleet.FleetCollector(num_ranks=2, port=0, registry=JaxRegistry(),
                                   hosts=["a", "b"])
    try:
        assert [ours.fold(b) for b in batches] == [ref.fold(b) for b in batches]
        assert ours.skew_snapshot() == ref.skew_snapshot()
        (report,) = ours.skew_snapshot()
        assert report["critical_rank"] == 1 and report["phase"] == want
        assert ours.merged_doc() == ref.merged_doc()
        assert {e["pid"] for e in ours.merged_doc()["traceEvents"]} == {0, 1}
        assert ours.span_counts() == ref.span_counts()
    finally:
        ours._server.close()
        ref._server.close()


def test_shipper_delivers_to_collector(fleet_env, tmp_path):
    collector = fleet.FleetCollector(num_ranks=2, port=0, registry=MetricsRegistry()).start()
    try:
        shipper = fleet.SpanShipper(rank=1, host="b", collector_addr=("127.0.0.1",
                                                                     collector.port),
                                    interval=0.2, span_source=lambda: _wire_round(1, 0, 10.0),
                                    registry=MetricsRegistry())
        assert shipper.send_once()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not collector.span_counts()[1]:
            time.sleep(0.02)
        assert collector.span_counts() == {0: 0, 1: 1}
        path = collector.write_fleet_trace(str(tmp_path))
        with open(path) as f:
            assert json.load(f)["otherData"]["ranks"] == [1]
    finally:
        collector.stop()


def test_inert_without_knobs(fleet_env):
    before = set(threading.enumerate())
    assert fleet.start_fleet_plane(["a", "b"], "a") is None
    assert fleet.export_fleet_trace(default_dir=".") is None
    assert set(threading.enumerate()) == before


def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:{}{}".format(port, path), timeout=5) as r:
        return json.loads(r.read().decode("utf-8"))


def test_status_flight_and_profile_over_http(fleet_env, tmp_path):
    fleet_env.setenv(fleet.STATUS_PORT_ENV, str(free_port()))
    tracing.set_rank(0)
    plane = fleet.start_fleet_plane(["algo-1"], "algo-1")
    assert plane.status_server is not None and plane.collector is None
    fleet.note_status(rounds_planned=10,
                      last_checkpoint={"path": str(tmp_path / "ckpt.5"), "round": 5})
    fleet.note_attribution({"total_ms": 123.0, "host_pct": 50.0})
    port = plane.status_server.port
    with tracing.trace_span("round", attributes={"round": 0}):
        flight = _get(port, "/debug/flight")
    status = _get(port, "/status")
    # the same facts give the JAX package's document, but for the clock
    jax_fleet.note_status(rounds_planned=10,
                          last_checkpoint={"path": str(tmp_path / "ckpt.5"), "round": 5})
    jax_fleet.note_attribution({"total_ms": 123.0, "host_pct": 50.0})
    ref = jax_fleet.StatusServer.status_doc(types.SimpleNamespace(_collector=None))
    for doc in (status, ref):
        doc.pop("uptime_s")
        doc.pop("round")
    assert status == ref
    assert flight["rank"] == 0 and "round" in {s["name"] for s in flight["spans"]}
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen("http://127.0.0.1:{}/debug/profile".format(port), timeout=5)
    assert err.value.code == 404        # unarmed without SM_PROFILER_TRACE_DIR
    fleet_env.setenv("SM_PROFILER_TRACE_DIR", str(tmp_path / "prof"))
    doc = _get(port, "/debug/profile?ms=20")
    assert os.path.isfile(os.path.join(doc["path"], "trace.json"))


def test_sigquit_dumps_without_aborting(fleet_env, tmp_path, capfd):
    fleet_env.setenv("SM_TRACE_EXPORT_DIR", str(tmp_path))
    fleet_env.setenv("SM_STRUCTURED_METRICS", "true")
    with tracing.trace_span("round", attributes={"round": 1}):
        pass
    fleet.note_status(rounds_planned=3)
    assert fleet.install_sigquit_handler(default_dir=str(tmp_path)) is True
    try:
        os.kill(os.getpid(), signal.SIGQUIT)
        path = tmp_path / "fleet-status-rank0.json"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not path.is_file():
            time.sleep(0.02)
        with open(str(path)) as f:
            doc = json.load(f)
        assert doc["rounds_planned"] == 3 and "round" in doc and "uptime_s" in doc
        assert (tmp_path / "flight-recorder-rank0.json").is_file()
        assert '"training.sigquit_dump"' in capfd.readouterr().out
    finally:
        signal.signal(signal.SIGQUIT, signal.SIG_DFL)


def test_status_callers_feed_the_plane(fleet_env, tmp_path):
    """The four callers: the device plane's compiled record and roofline,
    the checkpoint saver's last checkpoint, train_job's planned rounds and
    RoundTimer's attribution."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.telemetry import device
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, checkpointing

    fleet_env.setenv("SM_DEVICE_TELEMETRY", "true")
    device._reset_for_tests()
    try:
        record = device.note_compiled(device.cost_from_launches(1000, 500))
        assert fleet.status_snapshot()["compiled"] == record
        fields = device.maybe_roofline(1.0, 1, "residual", emit=True)
        assert fleet.status_snapshot()["roofline"] == fields
    finally:
        device._reset_for_tests()
    saver = checkpointing.SaveCheckpointCallBack(str(tmp_path / "ckpt"), num_round=10)
    from sagemaker_xgboost_container_tpu_torch.models.booster import train

    rng = np.random.RandomState(0)
    X = rng.rand(64, 3).astype(np.float32)
    dm = DataMatrix(X, labels=(X[:, 0] > 0.5).astype(np.float32))
    forest = train({"max_depth": 2}, dm, 1, device="cpu")
    saver.after_iteration(forest, 0, {})
    saver.stop()
    assert fleet.status_snapshot()["last_checkpoint"]["round"] == 0
    model_dir = tmp_path / "model"
    algorithm_train.train_job({"num_round": 2, "max_depth": 2}, dm, None, dm, str(model_dir),
                              None, is_master=True, device="cpu")
    try:
        snap = fleet.status_snapshot()
        assert snap["rounds_planned"] == 2
        assert snap["attribution"]["rounds"] == 2
    finally:
        signal.signal(signal.SIGQUIT, signal.SIG_DFL)
