"""Stage stamps inside the round and the session's spans on the profiler's
clock (``ops/stamps``, ``telemetry/tracing``, ``models/booster``).

With the tracer armed, every round of a K=2 dispatch splits into the five
stages, which cover the round body's wall time and leave the trees as they
were; the stages reach ``training.round``'s ``phases_ms``, attribution and
the roofline. Under a ``torch.profiler`` session a span is also a
profiler range on the same clock. Unarmed, a ``train()`` opens
no range and records no span. A profiler started between dispatches arms
the next one (on a CUDA session, with one ``round.recapture``). The lint
gate's capture pass is clean on the stamped body."""

import gc
import json
import time

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster
from sagemaker_xgboost_container_tpu_torch.ops import stamps
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY, device, span, tracing
from sagemaker_xgboost_container_tpu_torch.training import profiling

KNOBS = ("SM_TRACE", "SM_TRACE_DEVICE_SYNC", "SM_DEVICE_TELEMETRY", "SM_PROFILER_TRACE_DIR",
         "SM_MODEL_TELEMETRY")
PARAMS = {
    "depthwise": {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16},
    "lossguide": {"objective": "binary:logistic", "grow_policy": "lossguide", "max_leaves": 7,
                  "max_depth": 0, "max_bin": 16},
    "rank:ndcg": {"objective": "rank:ndcg", "max_depth": 3, "max_bin": 16,
                  "eval_metric": "ndcg@5"},
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    tracing._reset_for_tests()
    device._reset_for_tests()
    yield
    tracing._reset_for_tests()
    device._reset_for_tests()


def _arm(monkeypatch):
    monkeypatch.setenv("SM_TRACE", "1")
    tracing._reset_for_tests()


def _matrices(kind, n=400, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    if kind == "rank:ndcg":
        y = np.clip(np.round(X[:, 0] + rng.rand(n)), 0, 3).astype(np.float32)
        groups = [20] * (n // 20)
        return DataMatrix(X, y, groups=groups), DataMatrix(X[:100], y[:100], groups=[20] * 5)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    return DataMatrix(X, y), DataMatrix(X[:100], y[:100])


def _train(kind, rounds=4, callbacks=None):
    dtrain, dvalid = _matrices(kind)
    params = dict(PARAMS[kind], _rounds_per_dispatch=2)
    return train(params, dtrain, rounds, evals=[(dvalid, "v")], device="cpu",
                 verbose_eval=False, callbacks=callbacks)


def _stage_spans():
    """{round: {stage: device span}} of the tracer's stage spans."""
    out = {}
    for s in tracing.snapshot_spans():
        if s.name.startswith("round.") and s.attributes.get("clock") == "device":
            out.setdefault(s.attributes["round"], {})[s.name[len("round."):]] = s
    return out


def _records(out, metric):
    needle = '"metric": "{}"'.format(metric)
    return [json.loads(line) for line in out.splitlines() if needle in line]


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_armed_rounds_split_into_five_stages(monkeypatch, kind):
    """Every round of a K=2 dispatch: five non-negative stage times that
    sum to within 10 % of the round body's wall time, laid end to end on
    the device lane; the trees bit-identical to an unarmed run's."""
    plain = _train(kind)
    _arm(monkeypatch)
    walls = []
    inner = booster._TrainingSession._round_body

    def timed(self, draws, clock=None):
        t0 = time.perf_counter_ns()
        out = inner(self, draws, clock)
        walls.append(time.perf_counter_ns() - t0)
        return out

    monkeypatch.setattr(booster._TrainingSession, "_round_body", timed)
    # a collection of the test process's heap between the body's last stamp
    # and its return is no part of the round
    gc.disable()
    try:
        armed = _train(kind)
    finally:
        gc.enable()
    spans = _stage_spans()
    assert sorted(spans) == [0, 1, 2, 3] and len(walls) == 4
    for rnd, by_stage in spans.items():
        assert sorted(by_stage) == sorted(stamps.STAGES)
        durs = [by_stage[s].dur_us * 1e3 for s in stamps.STAGES]
        assert min(durs) >= 0
        assert abs(sum(durs) - walls[rnd]) <= 0.1 * walls[rnd], (rnd, durs, walls)
        ordered = [by_stage[s] for s in stamps.STAGES]
        for a, b in zip(ordered, ordered[1:]):
            assert b.start_us == pytest.approx(a.start_us + a.dur_us, abs=1.0)
        assert all(s.tid == tracing.DEVICE_LANE_TID for s in ordered)
    assert len(armed.trees) == len(plain.trees) == 4
    assert armed.save_json() == plain.save_json()
    assert armed.get_dump(with_stats=True) == plain.get_dump(with_stats=True)


def test_stage_clock_writes_a_row_a_round_of_each_dispatch():
    """Round j of a dispatch writes row j: a full dispatch leaves the row
    index at 0 for the next; each row's stages sum to its last stamp less
    its first."""
    clock = stamps.StageClock(torch.device("cpu"), 3)
    for k in (3, 3, 2):
        for j in range(k):
            clock.begin()
            for stage in range(stamps.MARGINS):
                clock(stage)
            clock.end()
            row = clock.read(k)[j]
            assert int(row[stamps.FIRST]) > 0
            assert int(sum(row[:stamps.FIRST])) == pytest.approx(
                int(row[stamps.FIRST + 1] - row[stamps.FIRST]), abs=512)
        firsts = clock.read(k)[:, stamps.FIRST].tolist()
        assert firsts == sorted(firsts) and len(set(firsts)) == k


def test_stages_reach_round_records_attribution_and_roofline(monkeypatch, capsys):
    """The stages as ``device.<stage>`` phases of each ``training.round``
    record, kept out of its host remainder; attribution's device time is
    their sum (``stamps``), and the roofline's the histogram stage's."""
    _arm(monkeypatch)
    monkeypatch.setenv("SM_DEVICE_TELEMETRY", "true")
    _train("depthwise", callbacks=[profiling.RoundTimer()])
    out = capsys.readouterr().out
    rounds = _records(out, "training.round")
    assert len(rounds) == 4
    keys = ["device." + s for s in stamps.STAGES]
    for r in rounds:
        assert set(keys) <= set(r["phases_ms"])
        host = sum(v for k, v in r["phases_ms"].items()
                   if not k.startswith("device.") and k != "build_eval")
        assert r["phases_ms"]["build_eval"] == pytest.approx(
            max(r["round_ms"] - host, 0.0), abs=0.01)
    stamped = sum(r["phases_ms"][k] for r in rounds for k in keys)
    hist = sum(r["phases_ms"]["device.histogram"] for r in rounds)
    (attribution,) = _records(out, "training.attribution")
    assert attribution["device_time_source"] == "stamps"
    assert attribution["device_ms"] == pytest.approx(stamped, rel=1e-3, abs=0.01)
    (roofline,) = _records(out, "training.roofline")
    assert roofline["device_time_source"] == "stamps"
    assert roofline["device_ms"] == pytest.approx(hist, rel=1e-3, abs=0.01)


class _Sleeper:
    """A callback whose round takes a few milliseconds, timed as a phase by
    the training entry point's delegate (``cb.work``)."""

    def after_iteration(self, forest, rnd, evals_log):
        time.sleep(0.003)
        return False


def _round_accounting(out):
    """Each ``training.round`` record's host phase keys, and whether its
    ``build_eval`` is the round's time less those phases."""
    rows = []
    for r in _records(out, "training.round"):
        host = {k: v for k, v in r["phases_ms"].items()
                if not k.startswith("device.") and k != "build_eval"}
        rest = max(r["round_ms"] - sum(host.values()), 0.0)
        rows.append((sorted(host), abs(r["phases_ms"]["build_eval"] - rest) <= 0.01))
    return rows


def test_session_leaves_leave_round_spans_and_accounting_alone(monkeypatch, capsys):
    """Under SM_TRACE, with RoundTimer and a callback timed as a phase:
    every ``round`` span is a root of its own trace, each
    ``session.callbacks`` leaf closes inside its round, and the round
    records count the same host phases as an untraced run's (no
    ``session.*`` key, the callback's phase once, in its own round)."""
    from sagemaker_xgboost_container_tpu_torch.training.callbacks import _TimedCallback

    def run():
        _train("depthwise", callbacks=[_TimedCallback(_Sleeper(), "cb.work"),
                                       profiling.RoundTimer()])
        return _round_accounting(capsys.readouterr().out)

    plain = run()
    _arm(monkeypatch)
    traced = run()
    assert len(plain) == len(traced) == 4
    assert plain == traced == [(["cb.work"], True)] * 4
    spans = tracing.snapshot_spans()
    rounds = [s for s in spans if s.name == "round"]
    assert len(rounds) == 5   # one a round, and the tail after the last
    assert all(s.parent_id is None for s in rounds)
    assert len({s.trace_id for s in rounds}) == 5
    by_id = {s.span_id: s for s in spans}
    leaves = [s for s in spans if s.name == "session.callbacks"]
    assert len(leaves) == 4
    for leaf in leaves:
        parent = by_id[leaf.parent_id]
        assert parent.name == "round"
        assert leaf.start_us + leaf.dur_us <= parent.start_us + parent.dur_us + 1.0
        assert [s.name for s in spans if s.parent_id == leaf.span_id] == ["cb.work"]


def test_span_is_a_profiler_range_on_the_tracers_clock():
    """Under a profiler a ``span()`` is a ``RecordFunction`` event that
    starts within 200 us of the tracer's own start, a host event only (no
    annotation on the card's timeline), and its tracer span is recorded
    though ``SM_TRACE`` is unset."""
    assert not tracing.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.profiler_recording() and tracing.recording()
        with span("session.warm"):
            pass
        with span("session.probe"):
            time.sleep(0.002)
    (probe,) = [s for s in tracing.snapshot_spans() if s.name == "session.probe"]
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "session.probe"]
    assert event.device_type() == torch.autograd.DeviceType.CPU
    assert abs(event.start_ns() / 1e3 - probe.start_us) <= 200.0
    assert abs(event.duration_ns() / 1e3 - probe.dur_us) <= 200.0
    assert not tracing.profiler_recording()


def test_tracer_export_overlays_the_profilers_chrome_trace(monkeypatch, tmp_path):
    """``SM_PROFILER_TRACE_DIR``'s Chrome trace and the tracer's own export
    put one span at the same ``ts`` (within 200 us): the export subtracts
    the profiler's ``baseTimeNanoseconds``."""
    _arm(monkeypatch)
    monkeypatch.setenv("SM_PROFILER_TRACE_DIR", str(tmp_path))
    with profiling.torch_trace():
        with span("session.probe"):
            time.sleep(0.002)
    with open(tmp_path / "torch-trace-rank0.json") as f:
        theirs = json.load(f)
    ours = tracing.chrome_trace_doc()
    assert ours["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"] > 0
    (a,) = [e for e in theirs["traceEvents"] if e.get("name") == "session.probe"]
    (b,) = [e for e in ours["traceEvents"] if e.get("name") == "session.probe"]
    assert abs(float(a["ts"]) - b["ts"]) <= 200.0
    assert abs(float(a["dur"]) - b["dur"]) <= 200.0


def test_untraced_train_enters_no_range_and_records_no_span(monkeypatch):
    """SM_TRACE unset and no profiler: ``train()`` opens no
    ``record_function`` range and the tracer records nothing."""
    entered, made = [], []

    class Counting(torch.autograd.profiler.record_function):
        def __init__(self, *a, **k):
            entered.append(a)
            super().__init__(*a, **k)

    class CountingSpan(tracing.Span):
        __slots__ = ()

        def __init__(self, *a, **k):
            made.append(a)
            super().__init__(*a, **k)

    opened = []

    def counting_range(name):
        opened.append(name)
        return real_range(name)

    real_range = tracing._open_range
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(tracing, "_open_range", counting_range)
    monkeypatch.setattr(tracing, "Span", CountingSpan)
    for kind in ("depthwise", "rank:ndcg"):
        _train(kind)
    assert entered == [] and opened == [] and made == []
    assert tracing.snapshot_spans() == []
    # the same counters see a span under a profiler
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("session.probe"):
            pass
    assert opened == ["session.probe"] and len(made) == 1


class _StartProfiler:
    """Starts a profiler (CPU activity, and the card's with ``cuda``) at the
    end of the first dispatch (round 1 of K=2) and stops it at the end of
    training."""

    def __init__(self, cuda=False):
        self.prof = None
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)

    def after_iteration(self, forest, rnd, evals_log):
        if rnd == 1:
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()
        return False

    def after_training(self, forest):
        self.prof.stop()
        return forest


def test_profiler_between_dispatches_arms_the_next_dispatch():
    """A profiler started between dispatches arms the next one: its rounds
    carry stage spans and its phases are the profiler's ranges; the rounds
    before it carry none."""
    starter = _StartProfiler()
    _train("depthwise", rounds=6, callbacks=[starter])
    assert sorted(_stage_spans()) == [2, 3, 4, 5]
    names = [e.name() for e in starter.prof.profiler.kineto_results.events()]
    assert names.count("session.enqueue") == 2 and names.count("session.copy_out") == 2
    assert names.count("session.commit") == 4


def test_partly_stamped_run_divides_by_its_stamped_rounds(monkeypatch, capsys):
    """A profiler that arms 4 of 6 rounds: the roofline and attribution's
    device share are over those 4 rounds and their wall time, not over the
    run's 6."""
    monkeypatch.setenv("SM_DEVICE_TELEMETRY", "true")
    _train("depthwise", rounds=6, callbacks=[_StartProfiler(), profiling.RoundTimer()])
    out = capsys.readouterr().out
    rounds = _records(out, "training.round")
    stamped = [r for r in rounds if "device.histogram" in r["phases_ms"]]
    assert [r["round"] for r in stamped] == [2, 3, 4, 5]
    device_ms = sum(v for r in stamped for k, v in r["phases_ms"].items()
                    if k.startswith("device."))
    wall_ms = sum(r["round_ms"] for r in stamped)
    (attribution,) = _records(out, "training.attribution")
    assert attribution["device_time_source"] == "stamps"
    assert attribution["rounds"] == 6 and attribution["device_rounds"] == 4
    assert attribution["device_ms"] == pytest.approx(device_ms, rel=1e-3, abs=0.01)
    assert attribution["device_pct"] == pytest.approx(100.0 * device_ms / wall_ms, abs=0.2)
    (roofline,) = _records(out, "training.roofline")
    assert roofline["rounds"] == 4
    hist_ms = sum(r["phases_ms"]["device.histogram"] for r in stamped)
    assert roofline["device_ms"] == pytest.approx(hist_ms, rel=1e-3, abs=0.01)


def _phase_count(phase):
    for name, _kind, _help, series in REGISTRY.collect():
        if name == "training_phase_seconds":
            for metric in series:
                if metric.labels.get("phase") == phase:
                    return metric.count
    return 0


@pytest.mark.cuda
def test_profiler_between_dispatches_recaptures_the_cuda_graph():
    """On a CUDA session the graph captured unarmed is released and captured
    again with its stamps before the armed dispatch's first replay: one
    ``round.recapture``, and every armed round's five stages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the captured round exists only on the card")
    rng = np.random.RandomState(0)
    X = rng.randn(20000, 8).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    before = _phase_count("round.recapture"), _phase_count("round.capture")
    starter = _StartProfiler(cuda=True)
    params = dict(PARAMS["depthwise"], _rounds_per_dispatch=2)
    plain = train(params, DataMatrix(X, y), 6, device="cuda", verbose_eval=False)
    armed = train(params, DataMatrix(X, y), 6, device="cuda", verbose_eval=False,
                  callbacks=[starter])
    assert _phase_count("round.recapture") - before[0] == 1
    assert _phase_count("round.capture") - before[1] == 2
    spans = _stage_spans()
    assert sorted(spans) == [2, 3, 4, 5]
    for by_stage in spans.values():
        assert sorted(by_stage) == sorted(stamps.STAGES)
        assert all(s.dur_us >= 0 for s in by_stage.values())
        assert sum(s.dur_us for s in by_stage.values()) > 0
    kernels = [e for e in starter.prof.profiler.kineto_results.events()
               if "stage_stamp_kernel" in e.name()]
    assert kernels, "the stamps ran as kernels of the replayed graph"
    assert len(plain.trees) == len(armed.trees) == 6


def test_capture_pass_is_clean_on_the_tree():
    """The lint gate's capture pass over the port's package, with the
    stamped round body and builders it reaches: no finding."""
    import os

    from sagemaker_xgboost_container_tpu_torch.toolkit.graftlint import core

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    report = core.run(root, select=["capture-env-read", "capture-host-sync",
                                    "capture-uncached-graph"], use_baseline=False)
    assert not report.errors, report.errors
    assert not report.findings, [(f.path, f.line, f.rule) for f in report.findings]
