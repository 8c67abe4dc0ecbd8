"""Training profiling (``training/profiling.py``): ``RoundTimer``'s records
against the JAX package's for the same callback sequence, the shared
``attribution_fields`` math (equal on the same inputs), the
``training.round_end`` fault point, the fenced round's ``host_dispatch`` /
``device_sync`` phases feeding attribution and the roofline, and the
``torch.profiler`` trace under ``SM_PROFILER_TRACE_DIR``."""

import json
import logging
import os

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.telemetry import device as jax_device
from sagemaker_xgboost_container_tpu.telemetry import emit as jax_emit
from sagemaker_xgboost_container_tpu.training import profiling as jax_profiling
from sagemaker_xgboost_container_tpu.utils import faults as jax_faults
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.telemetry import device, emit, tracing
from sagemaker_xgboost_container_tpu_torch.training import profiling
from sagemaker_xgboost_container_tpu_torch.utils import faults

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16, "eta": 0.3}
KNOBS = ("SM_ATTRIBUTION_EVERY", "SM_ROUND_TIMING", "SM_PROFILER_TRACE_DIR",
         "SM_TRACE_DEVICE_SYNC", "SM_TRACE", "SM_DEVICE_TELEMETRY", "SM_HBM_SAMPLE_EVERY",
         "SM_FAULT_SPEC", "SM_MODEL_TELEMETRY")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)

    def reset():
        for mod in (faults, jax_faults):
            mod.reset()
        for mod in (device, jax_device, tracing):
            mod._reset_for_tests()
        # every round field, not only this file's probe: a multi-rank run
        # earlier in the process leaves its session's fields (hist_comm_*)
        for mod in (emit, jax_emit):
            mod.set_round_fields(**{k: None for k in mod.get_round_fields()})

    reset()
    yield
    reset()


def _records(out, metric):
    needle = '"metric": "{}"'.format(metric)
    return [json.loads(line) for line in out.splitlines() if needle in line]


def _data(n=600, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    return X, y


def _drive(timer, rounds=4):
    timer.before_training(None)
    for epoch in range(rounds):
        timer.after_iteration(None, epoch, {})
    timer.after_training(None)


@pytest.mark.parametrize("case", [
    (1000.0, 0.0, 0.0, 0.0, 0.0), (1000.0, 120.5, 300.25, 500.0, 0.0),
    (0.0, 1.0, 2.0, 3.0, 4.0), (12.3456, 1.23456, 2.34567, 3.45678, 0.1),
    (5e6, 1e3, 2e6, 2.5e6, 1e5)])
def test_attribution_fields_equal_jax(case):
    assert profiling.attribution_fields(*case) == jax_profiling.attribution_fields(*case)


@pytest.mark.parametrize("fold,every", [(None, None), (2, None), (None, "2")])
def test_round_timer_records_have_jax_shapes(monkeypatch, capsys, fold, every):
    if every:
        monkeypatch.setenv("SM_ATTRIBUTION_EVERY", every)
    emit.set_round_fields(probe=7)
    jax_emit.set_round_fields(probe=7)
    _drive(profiling.RoundTimer(num_rows=100, fold=fold))
    ours = capsys.readouterr().out
    _drive(jax_profiling.RoundTimer(num_rows=100, fold=fold))
    ref = capsys.readouterr().out
    for metric in ("training.round", "training.summary", "training.attribution"):
        got, want = _records(ours, metric), _records(ref, metric)
        assert len(got) == len(want) > 0, metric
        for a, b in zip(got, want):
            assert set(a) == set(b), metric
            assert a.get("fold") == b.get("fold") == fold
            assert a.get("rolling") == b.get("rolling")
    assert [r["probe"] for r in _records(ours, "training.round")] == [7] * 4
    assert not _records(ours, "training.roofline")  # the device plane is off


def test_round_end_fault_point_fires_in_both(capsys):
    for flt, timer_cls in ((faults, profiling.RoundTimer),
                           (jax_faults, jax_profiling.RoundTimer)):
        flt.configure("training.round_end:error:stall@2")
        timer = timer_cls()
        timer.before_training(None)
        timer.after_iteration(None, 0, {})
        with pytest.raises(OSError, match="stall"):
            timer.after_iteration(None, 1, {})
        timer.after_training(None)
        assert flt.fault_counts() == {"training.round_end": 1}


def test_round_timing_log_lines(monkeypatch, caplog):
    with caplog.at_level(logging.INFO, logger=profiling.__name__):
        _drive(profiling.RoundTimer(num_rows=1000, log_every=2))
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("round ")]
    assert len(lines) == 2 and "rows/sec" in lines[0]


def test_fenced_rounds_feed_attribution_and_roofline(monkeypatch, capsys):
    """SM_TRACE_DEVICE_SYNC=1: every round is fenced into host_dispatch and
    device_sync phases, the attribution reads device_sync (not the
    residual), and with the device plane armed the roofline names it."""
    monkeypatch.setenv("SM_TRACE_DEVICE_SYNC", "1")
    monkeypatch.setenv("SM_DEVICE_TELEMETRY", "true")
    monkeypatch.setenv("SM_HBM_SAMPLE_EVERY", "1")
    X, y = _data()
    train(PARAMS, DataMatrix(X, y), 4, device="cpu", callbacks=[profiling.RoundTimer()],
          verbose_eval=False)
    out = capsys.readouterr().out
    rounds = _records(out, "training.round")
    assert len(rounds) == 4
    for r in rounds:
        assert {"host_dispatch", "device_sync", "build_eval"} <= set(r["phases_ms"])
    (attribution,) = _records(out, "training.attribution")
    assert attribution["device_ms"] >= 0.0 and attribution["host_ms"] > 0.0
    (roofline,) = _records(out, "training.roofline")
    assert roofline["device_time_source"] == "device_sync" and roofline["rounds"] == 4
    assert roofline["ridge_flops_per_byte"] == device.DEFAULT_RIDGE_FLOPS_PER_BYTE
    (compiled,) = _records(out, "training.compiled")
    assert compiled["flops_per_round"] > 0 and compiled["bytes_per_round"] > 0
    assert attribution["roofline"]["binding"] == roofline["binding"]


def test_unfenced_rounds_attribute_the_residual(monkeypatch, capsys):
    monkeypatch.setenv("SM_DEVICE_TELEMETRY", "true")
    X, y = _data()
    train(PARAMS, DataMatrix(X, y), 3, device="cpu", callbacks=[profiling.RoundTimer()],
          verbose_eval=False)
    out = capsys.readouterr().out
    for r in _records(out, "training.round"):
        assert "device_sync" not in r["phases_ms"]
    (roofline,) = _records(out, "training.roofline")
    assert roofline["device_time_source"] == "residual"


def test_torch_trace_writes_a_chrome_trace(monkeypatch, tmp_path, capsys):
    assert profiling.xla_trace is profiling.torch_trace
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("SM_PROFILER_TRACE_DIR", str(trace_dir))
    X, y = _data(n=200)
    with profiling.xla_trace():
        train(PARAMS, DataMatrix(X, y), 2, device="cpu", verbose_eval=False)
    (record,) = _records(capsys.readouterr().out, "training.trace")
    assert record["trace_dir"] == str(trace_dir)
    doc = json.loads(open(record["path"]).read())
    assert os.path.dirname(record["path"]) == str(trace_dir) and doc["traceEvents"]


def test_trace_is_inert_unset_and_survives_a_failed_start(monkeypatch, tmp_path, capsys, caplog):
    with profiling.torch_trace():
        pass
    assert not _records(capsys.readouterr().out, "training.trace")
    import torch

    def refuse(*args, **kwargs):
        raise RuntimeError("profiler already active")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setenv("SM_PROFILER_TRACE_DIR", str(tmp_path / "t"))
    ran = []
    with caplog.at_level(logging.WARNING, logger=profiling.__name__):
        with profiling.torch_trace():
            ran.append(1)
    assert ran == [1]
    assert any("continues untraced" in r.getMessage() for r in caplog.records)
    assert not _records(capsys.readouterr().out, "training.trace")
