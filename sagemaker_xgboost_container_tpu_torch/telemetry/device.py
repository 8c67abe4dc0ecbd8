"""Device-window plane (``SM_DEVICE_TELEMETRY``): what a boosting round
costs the card, what device memory is resident, and why an allocation
failed.

The port's counterpart of the JAX package's ``telemetry/device.py``, with
zero threads, records or registry series while ``SM_DEVICE_TELEMETRY`` is
unset:

* **Round cost**: the JAX package reads XLA's cost analysis of the
  compiled round. The port has no compiled program to ask, so it counts
  the round's kernel launches instead (:func:`cost_from_launches`): the
  bytes and f32 adds of the round's ``level_histogram`` and ``node_totals``
  calls (``ops/histogram.WORK``), and the device memory the round held.
  :func:`note_compiled` emits the same ``training.compiled`` record and
  gauges from that count.
* **Per-round watermark**: ``RoundTimer`` samples :func:`sample_device_memory`
  every ``SM_HBM_SAMPLE_EVERY`` rounds (:func:`sample_watermark`). The
  sampler is one cached walk shared with the runtime gauges
  (``telemetry/cluster.py``). On the card it reads ``torch.cuda.memory_stats``
  and ``torch.cuda.mem_get_info`` of each visible device that this process
  has used (``source: "memory_stats"``); on the CPU torch keeps no allocator
  tally, and the snapshot is zeros with ``source: "none"``.
* **Roofline**: :func:`roofline_fields` combines the measured device time
  with the counted cost into achieved FLOP/s and bytes/s and the binding
  resource; ``RoundTimer`` emits one ``training.roofline`` record. The time
  is the rounds' ``histogram`` stage, stamped on the card (``ops/stamps``),
  against the work of exactly those kernels, else the fenced wait; where
  neither measured the device there is no record.
* **OOM forensics**: :func:`dump_oom_forensics` writes
  ``hbm-forensics-rank<r>.json`` (the largest allocated blocks of
  ``torch.cuda.memory_snapshot()``, the allocator stats, the round cost,
  the last watermark) on the booster's out-of-memory path before the abort
  (exit 86, ``EXIT_DEVICE_OOM``). That path is robustness, not telemetry:
  it runs whatever the gate says.

Binding resource: a round whose device time is under ``LATENCY_FLOOR_MS``
is bound by the launch floor ("latency"); otherwise operational intensity
(flops / bytes) against ``DEFAULT_RIDGE_FLOPS_PER_BYTE`` splits "compute"
from "memory". The ridge travels in every record.
"""

import json
import logging
import os
import threading
import time

from ..utils.envconfig import env_bool, env_int
from .emit import emit_metric
from .registry import REGISTRY

logger = logging.getLogger(__name__)

#: master gate: unset -> no records, no gauges, no sampling cadence
DEVICE_TELEMETRY_ENV = "SM_DEVICE_TELEMETRY"
#: watermark cadence in rounds (>= 1); read once per training session
HBM_SAMPLE_EVERY_ENV = "SM_HBM_SAMPLE_EVERY"
DEFAULT_HBM_SAMPLE_EVERY = 8

#: flops per byte splitting compute- from memory-bound: an H100 SXM's
#: 67e12 f32 FLOP/s outside the tensor cores over its 3.35e12 B/s of HBM3
#: (NVIDIA's data sheet, at the 700 W power limit)
DEFAULT_RIDGE_FLOPS_PER_BYTE = 20.0
#: a round whose device time is under this is bound by the launch floor,
#: not by its work: the device time of a main-path round (depth 8,
#: max_bin 256, 28 features; 1,289 launches) at 1,000 rows, 2.4219 ms,
#: measured by chip_smoke.py phase 16a on one NVIDIA H100 80GB HBM3 at
#: 700.00 W
LATENCY_FLOOR_MS = 2.42

#: one cached memory walk serves every consumer inside this window
SAMPLE_MAX_AGE_S = 1.0

# memory_stats keys kept in each device entry of a snapshot
_ALLOCATOR_KEYS = (
    "reserved_bytes.all.current",
    "inactive_split_bytes.all.current",
    "num_alloc_retries",
    "num_ooms",
)

_state_lock = threading.Lock()
_last_compiled = None  # the note_compiled record (train round)
_last_watermark = None  # the last sample_watermark result
_watermark_high = 0  # high-water bytes_in_use across watermark samples

_sample_lock = threading.Lock()
_sample_cache = None  # (monotonic stamp, snapshot dict)


def enabled():
    return env_bool(DEVICE_TELEMETRY_ENV, False)


def hbm_sample_every():
    return env_int(HBM_SAMPLE_EVERY_ENV, DEFAULT_HBM_SAMPLE_EVERY, minimum=1)


def sample_cadence():
    """Watermark cadence for RoundTimer: 0 (never) when the plane is
    unarmed, else ``SM_HBM_SAMPLE_EVERY``; resolved once by the caller."""
    return hbm_sample_every() if enabled() else 0


# ------------------------------------------------------- cached memory walk
def _sample_uncached():
    """One walk over the visible devices this process has used. Never
    raises; on the CPU (or before CUDA is initialized, when nothing can be
    allocated) the snapshot is zeros with ``source: "none"``."""
    snap = {
        "total_bytes_in_use": 0,
        "peak_bytes_in_use": 0,
        "bytes_limit": 0,
        "source": "none",
        "devices": [],
    }
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return snap
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats.get("allocated_bytes.all.peak", 0):
                continue  # never used here: mem_get_info would make a context
            free, total = torch.cuda.mem_get_info(i)
            entry = {
                "id": i,
                "kind": torch.cuda.get_device_name(i),
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(total),
                "free_bytes": int(free),
            }
            entry.update({k: int(stats.get(k, 0)) for k in _ALLOCATOR_KEYS})
            snap["devices"].append(entry)
            snap["total_bytes_in_use"] += entry["bytes_in_use"]
            snap["peak_bytes_in_use"] += entry["peak_bytes_in_use"]
            snap["bytes_limit"] += entry["bytes_limit"]
        if snap["devices"]:
            snap["source"] = "memory_stats"
    except Exception:
        logger.debug("device memory sample failed", exc_info=True)
    return snap


def sample_device_memory(max_age_s=SAMPLE_MAX_AGE_S):
    """The shared device-memory snapshot, cached for ``max_age_s`` seconds;
    ``max_age_s=0`` forces a fresh walk (OOM forensics). Passive and
    ungated: no threads, no records."""
    global _sample_cache
    now = time.monotonic()
    with _sample_lock:
        cached = _sample_cache
        if cached is not None and now - cached[0] <= max_age_s:
            return cached[1]
    snap = _sample_uncached()
    with _sample_lock:
        _sample_cache = (time.monotonic(), snap)
    return snap


# --------------------------------------------------------------- round cost
def cost_from_launches(nbytes, adds, resident_bytes=0, peak_bytes=0):
    """The round's cost dict, in the keys of the JAX package's
    ``cost_from_compiled``, from the port's own count: ``nbytes`` and
    ``adds`` are the round's ``level_histogram`` and ``node_totals`` work
    (differences of ``ops/histogram.WORK``). It counts those two kernels
    only, not the split scan, the routing or the objective's ops.
    ``resident_bytes`` (device memory allocated before the round) stands
    for the arguments and ``peak_bytes`` (the round's high-water mark) for
    the arguments plus temporaries."""
    return {
        "flops": float(adds),
        "bytes_accessed": float(nbytes),
        "transcendentals": 0.0,
        "arg_bytes": int(resident_bytes),
        "out_bytes": 0,
        "temp_bytes": int(max(peak_bytes - resident_bytes, 0)),
        "alias_bytes": 0,
    }


def note_compiled(cost, mesh_shape=None, rounds_per_dispatch=1, backend=None,
                  kind="train_round", registry=None):
    """Fold one round's cost dict (:func:`cost_from_launches`) into the
    plane: emit the ``training.compiled`` record, set the gauges and keep
    the record for the roofline and the OOM forensics. The caller gates on
    :func:`enabled`. -> the record."""
    k = max(int(rounds_per_dispatch or 1), 1)
    record = dict(cost)
    record["kind"] = kind
    record["rounds_per_dispatch"] = k
    record["flops_per_round"] = round(record.get("flops", 0.0) / k, 1)
    record["bytes_per_round"] = round(record.get("bytes_accessed", 0.0) / k, 1)
    peak = (record.get("arg_bytes", 0) + record.get("out_bytes", 0)
            + record.get("temp_bytes", 0) - record.get("alias_bytes", 0))
    record["hbm_peak_bytes"] = int(max(peak, 0))
    if mesh_shape:
        record["mesh_shape"] = {str(a): int(n) for a, n in dict(mesh_shape).items()}
    if backend:
        record["backend"] = backend
    global _last_compiled
    with _state_lock:
        if kind == "train_round" or _last_compiled is None:
            _last_compiled = record
    reg = registry or REGISTRY
    reg.gauge(
        "device_flops_per_round",
        "Counted f32 adds of one boosting round's histogram kernels",
    ).set(record["flops_per_round"])
    reg.gauge(
        "device_hbm_peak_bytes",
        "Peak device bytes allocated during one boosting round",
    ).set(record["hbm_peak_bytes"])
    emit_metric("training.compiled", **record)
    from . import fleet

    fleet.note_status(compiled=record)
    return record


def last_compiled():
    with _state_lock:
        return dict(_last_compiled) if _last_compiled is not None else None


# ---------------------------------------------------------------- watermark
def sample_watermark(round_index, registry=None):
    """One per-round device-memory watermark (RoundTimer owns the cadence).
    Updates the ``hbm_watermark_bytes`` gauge. -> the watermark dict."""
    snap = sample_device_memory()
    watermark = {
        "round": int(round_index),
        "bytes_in_use": int(snap["total_bytes_in_use"]),
        "peak_bytes": int(snap["peak_bytes_in_use"]),
        "source": snap["source"],
    }
    global _last_watermark, _watermark_high
    with _state_lock:
        _last_watermark = watermark
        _watermark_high = max(_watermark_high, watermark["bytes_in_use"])
    (registry or REGISTRY).gauge(
        "hbm_watermark_bytes",
        "Live HBM bytes at the last per-round watermark sample",
    ).set(watermark["bytes_in_use"])
    return watermark


def watermark_wire():
    """The latest watermark for the fleet span shipper: None while the
    plane is unarmed or no round was sampled."""
    if not enabled():
        return None
    with _state_lock:
        if _last_watermark is None:
            return None
        wire = dict(_last_watermark)
        wire["high_bytes"] = _watermark_high
        return wire


def memory_status():
    """The local memory section: a (cached) sample, the watermark history
    and the counted round's peak. None when the plane is unarmed."""
    if not enabled():
        return None
    doc = {"current": sample_device_memory()}
    with _state_lock:
        if _last_watermark is not None:
            doc["watermark"] = dict(_last_watermark)
            doc["high_bytes"] = _watermark_high
        if _last_compiled is not None:
            doc["compiled_hbm_peak_bytes"] = _last_compiled.get("hbm_peak_bytes", 0)
    return doc


# ----------------------------------------------------------------- roofline
def roofline_fields(compiled, device_ms, rounds, source="stamps",
                    ridge=DEFAULT_RIDGE_FLOPS_PER_BYTE, latency_floor_ms=LATENCY_FLOOR_MS):
    """Pure roofline math -> the ``training.roofline`` field dict.

    ``compiled`` is a :func:`note_compiled`-shaped dict; ``device_ms`` the
    measured device time over ``rounds`` rounds, ``source`` how it was
    measured: ``stamps``, the round's ``histogram`` stage on the card
    (``ops/stamps``), the time of the kernels whose work ``compiled``
    counts, or ``device_sync``, the fenced wait for the whole round."""
    rounds = max(int(rounds), 1)
    flops_per_round = float(compiled.get("flops_per_round", 0.0) or 0.0)
    bytes_per_round = float(compiled.get("bytes_per_round", 0.0) or 0.0)
    seconds = max(float(device_ms), 0.0) / 1000.0
    per_round_ms = device_ms / rounds if rounds else 0.0
    achieved_flops = flops_per_round * rounds / seconds if seconds > 0 else 0.0
    achieved_bytes = bytes_per_round * rounds / seconds if seconds > 0 else 0.0
    intensity = flops_per_round / bytes_per_round if bytes_per_round > 0 else 0.0
    if per_round_ms < latency_floor_ms:
        binding = "latency"
    elif intensity >= ridge:
        binding = "compute"
    else:
        binding = "memory"
    return {
        "rounds": rounds,
        "device_ms": round(float(device_ms), 3),
        "device_ms_per_round": round(per_round_ms, 3),
        "device_time_source": source,
        "flops_per_round": round(flops_per_round, 1),
        "bytes_per_round": round(bytes_per_round, 1),
        "achieved_flops_per_sec": round(achieved_flops, 1),
        "achieved_bytes_per_sec": round(achieved_bytes, 1),
        "operational_intensity": round(intensity, 3),
        "ridge_flops_per_byte": ridge,
        "binding": binding,
    }


def maybe_roofline(device_ms, rounds, source, emit=False, extra=None):
    """The gated roofline: None when the plane is unarmed, no round cost
    was counted or the device time was not measured (``source`` None); else
    the field dict, with ``emit`` one ``training.roofline`` record."""
    if not enabled() or source is None:
        return None
    compiled = last_compiled()
    if compiled is None or rounds <= 0:
        return None
    fields = roofline_fields(compiled, device_ms, rounds, source)
    if extra:
        fields.update(extra)
    if emit:
        emit_metric("training.roofline", **fields)
        from . import fleet

        fleet.note_status(roofline=fields)
    return fields


# ------------------------------------------------------------ OOM forensics
def is_oom_error(exc):
    """Is this a device allocator exhaustion: ``torch.cuda.OutOfMemoryError``,
    or a ``RuntimeError`` whose text says "CUDA out of memory"?"""
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    return isinstance(exc, RuntimeError) and "CUDA out of memory" in str(exc)


def _top_live_buffers(top_n=32):
    """The largest allocated blocks of ``torch.cuda.memory_snapshot()``,
    largest first: the "what is resident" table of the forensics dump
    (empty on the CPU)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    blocks = []
    for segment in torch.cuda.memory_snapshot():
        for block in segment.get("blocks", ()):
            if block.get("state") == "active_allocated":
                blocks.append({
                    "device": int(segment.get("device", 0)),
                    "address": int(block.get("address", 0)),
                    "count": 1,
                    "total_bytes": int(block.get("size", 0)),
                })
    blocks.sort(key=lambda e: -e["total_bytes"])
    return blocks[:top_n]


def _forensics_dir(default_dir=None):
    """Where a forensics dump lands: the explicit trace export dir, then the
    caller's hint, then the live checkpoint dir, then the model dir, then
    the working directory."""
    from . import tracing

    explicit = os.environ.get(tracing.TRACE_EXPORT_DIR_ENV)
    if explicit:
        return explicit
    if default_dir:
        return default_dir
    try:
        from ..training import checkpointing

        dirs = checkpointing.active_checkpoint_dirs()
        if dirs:
            return dirs[0]
    except Exception:
        pass
    from ..constants import SM_MODEL_DIR

    return os.environ.get(SM_MODEL_DIR) or "."


def dump_oom_forensics(exc, default_dir=None, top_n=32):
    """Write ``hbm-forensics-rank<r>.json`` for a device OOM: the error, a
    fresh memory walk with the allocator stats, the largest allocated
    blocks, the counted round cost and the last watermark. Runs whatever
    ``SM_DEVICE_TELEMETRY`` says. Never raises. -> the path or None."""
    try:
        from . import tracing

        rank = tracing.get_rank()
        doc = {"reason": "device_oom", "rank": rank, "error": str(exc)[:2000]}
        try:
            doc["memory"] = sample_device_memory(max_age_s=0.0)
        except Exception:
            pass
        try:
            doc["top_live_buffers"] = _top_live_buffers(top_n)
        except Exception:
            pass
        with _state_lock:
            if _last_compiled is not None:
                doc["compiled"] = dict(_last_compiled)
            if _last_watermark is not None:
                doc["last_watermark"] = dict(_last_watermark)
                doc["watermark_high_bytes"] = _watermark_high
        directory = _forensics_dir(default_dir)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "hbm-forensics-rank{}.json".format(rank))
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
            f.write("\n")
        logger.error("device OOM: forensics (largest allocated blocks, allocator stats, "
                     "round cost) dumped to %s", path)
        return path
    except Exception:
        logger.exception("OOM forensics dump failed; aborting anyway")
        return None


def _reset_for_tests():
    global _last_compiled, _last_watermark, _watermark_high, _sample_cache
    with _state_lock:
        _last_compiled = None
        _last_watermark = None
        _watermark_high = 0
    with _sample_lock:
        _sample_cache = None
