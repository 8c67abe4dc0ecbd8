"""The round watchdog and the abort path (``training/watchdog.py``) against
the JAX package's, and the drills on the CPU with ``_exit`` monkeypatched:
a stalled round exits 79 once even with two triggers, and a CUDA
out-of-memory error inside a round exits 86 with its forensics written."""

import json
import os
import time

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.training import checkpointing as jax_checkpointing
from sagemaker_xgboost_container_tpu.training import watchdog as jax_watchdog
from sagemaker_xgboost_container_tpu_torch import train
from sagemaker_xgboost_container_tpu_torch.constants import (EXIT_DEVICE_OOM,
                                                             EXIT_NUMERIC_POISON,
                                                             EXIT_ROUND_DEADLINE)
from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
from sagemaker_xgboost_container_tpu_torch.models import booster
from sagemaker_xgboost_container_tpu_torch.telemetry import device, tracing
from sagemaker_xgboost_container_tpu_torch.training import checkpointing, watchdog
from sagemaker_xgboost_container_tpu_torch.training.profiling import RoundTimer
from sagemaker_xgboost_container_tpu_torch.utils import faults

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16, "eta": 0.3}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in (watchdog.ROUND_DEADLINE_ENV, faults.FAULT_SPEC_ENV, tracing.TRACE_ENV,
                 tracing.TRACE_EXPORT_DIR_ENV, "SM_MODEL_DIR"):
        monkeypatch.delenv(knob, raising=False)

    def reset():
        faults.reset()
        for mod in (watchdog, jax_watchdog):
            mod._reset_abort_for_tests()
        tracing._reset_for_tests()
        device._reset_for_tests()

    reset()
    yield
    reset()


def _records(out, metric):
    needle = '"metric": "{}"'.format(metric)
    return [json.loads(line) for line in out.splitlines() if needle in line]


class _JsonModel:
    def save_model(self, path):
        with open(path, "w") as f:
            json.dump({"tag": "m"}, f)


def _data(n=500, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    return X, (X[:, 0] > 0).astype(np.float32)


def test_exit_codes_are_the_jax_packages():
    from sagemaker_xgboost_container_tpu import constants as jax_constants

    assert (EXIT_ROUND_DEADLINE, EXIT_DEVICE_OOM, EXIT_NUMERIC_POISON) == (
        jax_constants.EXIT_ROUND_DEADLINE, jax_constants.EXIT_DEVICE_OOM,
        jax_constants.EXIT_NUMERIC_POISON) == (79, 86, 87)


@pytest.mark.parametrize("value", [None, "0", "-3", "0.2", "12", "x"])
def test_deadline_knob_and_gate_match_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(watchdog.ROUND_DEADLINE_ENV, raising=False)
    else:
        monkeypatch.setenv(watchdog.ROUND_DEADLINE_ENV, value)
    assert watchdog.round_deadline_s() == jax_watchdog.round_deadline_s()
    ours, ref = watchdog.maybe_round_watchdog(), jax_watchdog.maybe_round_watchdog()
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert (ours.deadline_s, ours.check_interval) == (ref.deadline_s, ref.check_interval)


def test_watchdog_quiet_while_rounds_progress():
    fired = []
    wd = watchdog.RoundWatchdog(0.3, on_expire=lambda r, s: fired.append(r), check_interval=0.05)
    wd.before_training(None)
    for epoch in range(4):
        time.sleep(0.05)
        wd.after_iteration(None, epoch, {})
    wd.after_training(None)
    assert fired == [] and wd._thread is None


def test_watchdog_fires_on_a_stalled_round():
    fired = []
    wd = watchdog.RoundWatchdog(0.2, on_expire=lambda r, s: fired.append((r, s)),
                                check_interval=0.05)
    wd.before_training(None)
    wd.after_iteration(None, 0, {})
    try:
        deadline = time.monotonic() + 5
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired and fired[0][0] == 0 and fired[0][1] > 0.2
    finally:
        wd.stop()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_request_abort_flushes_once_and_exits_once(monkeypatch, tmp_path, capsys, package):
    wd, ck = (watchdog, checkpointing) if package == "port" else (jax_watchdog, jax_checkpointing)
    codes = []
    monkeypatch.setattr(wd, "_exit", codes.append)
    saver = ck.SaveCheckpointCallBack(str(tmp_path))
    saver.after_iteration(_JsonModel(), 0, {})
    wd.request_abort("test_reason", EXIT_ROUND_DEADLINE, last_round=0)
    wd.request_abort("again", EXIT_DEVICE_OOM)
    assert codes == [EXIT_ROUND_DEADLINE]
    assert not saver.thread.is_alive(), "deleter drained before the exit"
    (record,) = _records(capsys.readouterr().out, "training.abort")
    assert record == {"metric": "training.abort", "reason": "test_reason",
                      "exit_code": EXIT_ROUND_DEADLINE, "last_round": 0}
    assert os.path.isfile(str(tmp_path / "xgboost-checkpoint.0.manifest"))


def test_abort_dumps_the_flight_recorder_into_the_checkpoint_dir(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv(tracing.TRACE_ENV, "true")
    tracing._reset_for_tests()
    codes = []
    monkeypatch.setattr(watchdog, "_exit", codes.append)
    saver = checkpointing.SaveCheckpointCallBack(str(tmp_path / "ckpt"))
    assert checkpointing.active_checkpoint_dirs() == [str(tmp_path / "ckpt")]
    with tracing.trace_span("round"):
        watchdog.request_abort("round_deadline", EXIT_ROUND_DEADLINE)
    (record,) = _records(capsys.readouterr().out, "training.abort")
    path = tmp_path / "ckpt" / "flight-recorder-rank0.json"
    assert record["flight_recorder"] == str(path)
    doc = json.loads(path.read_text())
    assert doc["otherData"]["exit_code"] == EXIT_ROUND_DEADLINE
    assert any(e.get("args", {}).get("in_flight") for e in doc["traceEvents"])
    saver.stop()


def test_stalled_round_in_training_exits_79_once(monkeypatch, capsys):
    """A round stalls past a 0.2 s deadline inside ``train()``: the watchdog
    aborts once with exit 79; a second trigger after it changes nothing."""
    codes = []
    monkeypatch.setattr(watchdog, "_exit", codes.append)
    faults.configure("training.round_end:sleep:0.8@2")
    X, y = _data()
    wd = watchdog.RoundWatchdog(0.2, check_interval=0.05)
    train(PARAMS, DataMatrix(X, y), 3, device="cpu", callbacks=[wd, RoundTimer()],
          verbose_eval=False)
    watchdog.request_abort("round_deadline", EXIT_ROUND_DEADLINE)
    out = capsys.readouterr().out
    assert codes == [EXIT_ROUND_DEADLINE]
    (record,) = _records(out, "training.abort")
    # the watchdog is pet before RoundTimer's round_end point stalls round 1
    assert record["reason"] == "round_deadline" and record["last_round"] == 1
    assert record["stalled_s"] >= 0.2 and record["deadline_s"] == 0.2


class _Exited(BaseException):
    pass


@pytest.mark.parametrize("error", [
    lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    lambda: RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB")])
def test_oom_inside_a_round_exits_86_with_forensics(monkeypatch, tmp_path, capsys, error):
    monkeypatch.setenv(tracing.TRACE_EXPORT_DIR_ENV, str(tmp_path))
    codes = []

    def _exit(code):
        codes.append(code)
        raise _Exited()

    monkeypatch.setattr(watchdog, "_exit", _exit)
    real = booster.build_tree
    calls = []

    def builder(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise error()
        return real(*args, **kwargs)

    monkeypatch.setattr(booster, "build_tree", builder)
    X, y = _data()
    with pytest.raises(_Exited):
        train(PARAMS, DataMatrix(X, y), 4, device="cpu", verbose_eval=False)
    assert codes == [EXIT_DEVICE_OOM]
    (record,) = _records(capsys.readouterr().out, "training.abort")
    assert record["reason"] == "device_oom" and "out of memory" in record["error"]
    path = tmp_path / "hbm-forensics-rank0.json"
    assert record["forensics"] == str(path)
    doc = json.loads(path.read_text())
    assert doc["reason"] == "device_oom" and doc["rank"] == 0
    assert doc["memory"]["source"] == "none" and doc["top_live_buffers"] == []


def test_other_round_errors_propagate_unchanged(monkeypatch):
    codes = []
    monkeypatch.setattr(watchdog, "_exit", codes.append)

    def builder(*args, **kwargs):
        raise ValueError("a plain bug")

    monkeypatch.setattr(booster, "build_tree", builder)
    X, y = _data()
    with pytest.raises(ValueError, match="a plain bug"):
        train(PARAMS, DataMatrix(X, y), 2, device="cpu", verbose_eval=False)
    assert codes == []
