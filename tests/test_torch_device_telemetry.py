"""The device-window plane (``telemetry/device.py``) against the JAX
package's: the roofline math and the ``training.compiled`` record equal on
the same inputs, the snapshot and forensics documents in the JAX keys, the
OOM classifier, and the port's own round cost (the two kernels' counted
work). The tests marked ``cuda`` read the card's allocator."""

import json

import numpy as np
import pytest
import torch

from sagemaker_xgboost_container_tpu.telemetry import device as jax_device
from sagemaker_xgboost_container_tpu_torch.ops import histogram
from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY, device

COMPILED = [
    {"flops_per_round": 1.2e9, "bytes_per_round": 3.4e8},
    {"flops_per_round": 5e11, "bytes_per_round": 1e9},
    {"flops_per_round": 0.0, "bytes_per_round": 0.0},
    {"flops_per_round": 7e6, "bytes_per_round": 0.0},
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in (device.DEVICE_TELEMETRY_ENV, device.HBM_SAMPLE_EVERY_ENV,
                 "SM_TRACE_EXPORT_DIR"):
        monkeypatch.delenv(knob, raising=False)
    device._reset_for_tests()
    jax_device._reset_for_tests()
    yield
    device._reset_for_tests()
    jax_device._reset_for_tests()


def test_ridge_is_the_h100s():
    assert device.DEFAULT_RIDGE_FLOPS_PER_BYTE == 67e12 / 3.35e12 == 20.0
    assert device.LATENCY_FLOOR_MS > 0


@pytest.mark.parametrize("compiled", COMPILED)
@pytest.mark.parametrize("device_ms,rounds,source", [
    (120.0, 10, "device_sync"), (3.0, 10, "stamps"), (0.0, 4, "stamps"),
    (55.5, 1, "device_sync"), (9.0, 0, "stamps")])
@pytest.mark.parametrize("ridge,floor", [(10.0, 0.5), (20.0, 2.0)])
def test_roofline_fields_equal_jax(compiled, device_ms, rounds, source, ridge, floor):
    got = device.roofline_fields(compiled, device_ms, rounds, source, ridge=ridge,
                                 latency_floor_ms=floor)
    want = jax_device.roofline_fields(compiled, device_ms, rounds, source, ridge=ridge,
                                      latency_floor_ms=floor)
    assert got == want


def test_cost_and_compiled_record_in_the_jax_keys():
    class _NoAnalysis:
        def cost_analysis(self):
            return {}

        def memory_analysis(self):
            return None

    cost = device.cost_from_launches(4.5e8, 2.2e8, resident_bytes=1000, peak_bytes=5000)
    assert set(cost) == set(jax_device.cost_from_compiled(_NoAnalysis()))
    assert cost["temp_bytes"] == 4000 and cost["arg_bytes"] == 1000
    got = device.note_compiled(cost, backend="cuda")
    want = jax_device.note_compiled(cost, backend="cuda")
    assert got == want
    assert got["hbm_peak_bytes"] == 5000 and got["flops_per_round"] == 2.2e8
    assert device.last_compiled() == got


def test_gated_paths(monkeypatch):
    assert device.sample_cadence() == 0
    assert device.memory_status() is None
    assert device.maybe_roofline(10.0, 2, "stamps") is None
    monkeypatch.setenv(device.DEVICE_TELEMETRY_ENV, "true")
    monkeypatch.setenv(device.HBM_SAMPLE_EVERY_ENV, "3")
    assert device.sample_cadence() == jax_device.sample_cadence() == 3
    assert device.maybe_roofline(10.0, 2, "stamps") is None  # nothing counted yet
    device.note_compiled(device.cost_from_launches(1e6, 1e6))
    # a device time nothing measured (no stamps, no fence) makes no roofline
    assert device.maybe_roofline(10.0, 2, None) is None
    fields = device.maybe_roofline(10.0, 2, "stamps", extra={"fold": 1})
    assert fields["fold"] == 1 and fields["rounds"] == 2
    assert fields["device_time_source"] == "stamps"
    mark = device.sample_watermark(4)
    assert mark == {"round": 4, "bytes_in_use": 0, "peak_bytes": 0, "source": "none"}
    status = device.memory_status()
    assert status["watermark"] == mark and status["compiled_hbm_peak_bytes"] == 0


def test_cpu_snapshot_is_zeros_in_the_jax_keys():
    snap = device.sample_device_memory(max_age_s=0.0)
    assert set(snap) == set(jax_device.sample_device_memory(max_age_s=0.0))
    assert snap == {"total_bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0,
                    "source": "none", "devices": []}
    assert device.sample_device_memory() is device.sample_device_memory()  # cached


@pytest.mark.parametrize("exc,oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 8.00 MiB"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (ValueError("out of memory"), False),
    (MemoryError(), False)])
def test_is_oom_error(exc, oom):
    assert device.is_oom_error(exc) is oom


def test_forensics_document_has_the_jax_keys(tmp_path):
    error = RuntimeError("CUDA out of memory. Tried to allocate 8.00 MiB")
    device.note_compiled(device.cost_from_launches(1e6, 2e6))
    jax_device.note_compiled(device.cost_from_launches(1e6, 2e6))
    device.sample_watermark(3)
    jax_device.sample_watermark(3)
    ours = json.loads(open(device.dump_oom_forensics(error, default_dir=str(tmp_path / "a")))
                      .read())
    ref = json.loads(open(jax_device.dump_oom_forensics(error, default_dir=str(tmp_path / "b")))
                     .read())
    assert set(ours) == set(ref)
    assert ours["compiled"] == ref["compiled"] and ours["error"] == ref["error"]
    assert ours["top_live_buffers"] == []


@pytest.mark.parametrize("n,d,W,B,C,dtype", [
    (1000, 5, 4, 17, 1, np.uint8), (777, 3, 2, 300, 1, np.uint16), (500, 4, 8, 9, 3, np.uint8)])
def test_round_work_is_counted_per_call(n, d, W, B, C, dtype):
    """Each wrapper call adds what hist_work / totals_work count: every row
    as active, chip_smoke.py's bound with all rows in some node."""
    rng = np.random.RandomState(n)
    bins = torch.as_tensor(rng.randint(0, B, (n, d)).astype(dtype))
    shape = (n,) if C == 1 else (C, n)
    grad = torch.as_tensor(rng.randn(*shape).astype(np.float32))
    node = torch.as_tensor(rng.randint(-1, W, shape).astype(np.int32))
    before = dict(histogram.WORK)
    histogram.level_histogram(bins, grad, grad.abs(), node, W, B)
    nbytes = C * n * 4 + C * n * 8 + n * d * bins.element_size() + 2 * C * W * d * B * 4
    assert histogram.WORK["bytes"] - before["bytes"] == nbytes
    assert histogram.WORK["adds"] - before["adds"] == 2 * C * n * d
    before = dict(histogram.WORK)
    histogram.node_totals(grad, grad.abs(), node, W)
    assert histogram.WORK["bytes"] - before["bytes"] == C * n * 12 + 2 * C * W * 4
    assert histogram.WORK["adds"] - before["adds"] == 2 * C * n


@pytest.mark.cuda
def test_cuda_sampler_reads_the_allocator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py phase 16 runs this check on the card")
    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    snap = device.sample_device_memory(max_age_s=0.0)
    allocated = torch.cuda.memory_allocated()
    assert snap["source"] == "memory_stats" and snap["devices"]
    assert keep.numel() <= snap["total_bytes_in_use"] <= allocated
    assert snap["bytes_limit"] >= torch.cuda.get_device_properties(0).total_memory // 2
    refreshed = REGISTRY.gauge("device_live_bytes")
    from sagemaker_xgboost_container_tpu_torch.telemetry import refresh_runtime_gauges

    refresh_runtime_gauges()
    assert refreshed.value > 0
    del keep


@pytest.mark.cuda
def test_cuda_oom_lists_the_largest_blocks(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py phase 16c runs this drill on the card")
    keep = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
    except Exception as e:  # the allocator's own error, whatever its class
        assert device.is_oom_error(e)
        doc = json.loads(open(device.dump_oom_forensics(e, default_dir=str(tmp_path))).read())
    else:
        pytest.fail("an allocation of twice the card's memory succeeded")
    assert doc["top_live_buffers"][0]["total_bytes"] >= keep.numel()
    assert doc["memory"]["source"] == "memory_stats"
    del keep
