"""The readers of the program's own records (``benchmark/spans.py`` and the
``round.*``, ``session.*``, ``setup.sketch_s`` / ``setup.capture_s``
metrics): ms a round over the traced window's rounds, on a synthetic
context; None where the program recorded nothing; and a traced tiny run on
the CPU that reports every new metric of its cell."""

import time
import types

import pytest
import torch

from tiny_cells import tiny_cell

from benchmark import harness, spans
from sagemaker_xgboost_container_tpu_torch.telemetry.registry import MetricsRegistry

STAGES = ("gradient", "histogram", "split", "partition", "margins")


def _span(name, rnd, dur_us, clock="device"):
    return types.SimpleNamespace(name=name, dur_us=dur_us,
                                 attributes={"round": rnd, "clock": clock})


def _context(rounds=3):
    # rounds 0-1 before the window (the recapture dispatch), 2-4 in it;
    # stage s of round r takes (s + 1) * (r + 1) ms
    recorded = [_span("round." + st, r, 1000.0 * (s + 1) * (r + 1))
                for r in range(5) for s, st in enumerate(STAGES)]
    recorded.append(_span("round.histogram", 4, 99.0, clock="host"))   # not a device span
    host = [(0, 2_000_000, "session.commit"), (5, 3_000_000, "session.commit"),
            (9, 1_000_009, "session.commit"), (20, 30_000_020, "session.eval"),
            (30, 40, "aten::to")]
    ctx = types.SimpleNamespace(rounds=rounds, trace=types.SimpleNamespace(_host=host))
    return ctx, recorded


@pytest.mark.parametrize("s,stage", list(enumerate(STAGES)))
def test_stage_ms_reads_the_windows_rounds(s, stage):
    ctx, recorded = _context()
    want = sum((s + 1) * (r + 1) for r in (2, 3, 4)) / 3.0
    assert spans.stage_ms(ctx, stage, recorded) == pytest.approx(want)


def test_stage_ms_is_none_without_stage_spans():
    ctx, _recorded = _context()
    assert spans.stage_ms(ctx, "gradient", [_span("session.commit", 0, 5.0)]) is None
    assert spans.stage_ms(types.SimpleNamespace(rounds=0), "gradient", _context()[1]) is None


def test_host_ms_sums_the_windows_events_over_its_rounds():
    ctx, _recorded = _context()
    assert spans.host_ms(ctx, "session.commit") == pytest.approx(6.0 / 3)
    assert spans.host_ms(ctx, "session.eval") == pytest.approx(30.0 / 3)
    assert spans.host_ms(ctx, "session.callbacks") is None


def test_phase_s_reads_the_registry_sums():
    reg = MetricsRegistry()
    for value in (1.5, 2.25):
        reg.histogram("training_phase_seconds", labels={"phase": "setup.sketch"}).observe(value)
    reg.histogram("training_phase_seconds", labels={"phase": "round.capture"})
    assert spans.phase_s("setup.sketch", reg) == pytest.approx(3.75)
    assert spans.phase_s("round.capture", reg) is None     # made, never observed
    assert spans.phase_s("round.recapture", reg) is None


def test_a_traced_tiny_run_reports_every_new_metric():
    """On the CPU (no captured round, so no ``setup.capture_s``)."""
    cell = tiny_cell("mslr.ndcg")
    out = harness.run(cell, 4294967311, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for st in STAGES:
        assert got["round.{}_ms.rank".format(st)]["value"] >= 0.0
    for name in ("session.commit_ms.rank", "session.eval_ms", "setup.sketch_s"):
        assert got[name]["value"] > 0.0, name
    assert "setup.capture_s" not in got
