"""The single-host half of the JAX package's cluster plane: the round state
the training loop publishes, and the process runtime gauges.

* ``ROUND_STATE`` (``RoundState``): ``RoundTimer`` notes every round's
  latency; a snapshot gives the round counter and p50 / p95. The JAX
  package's heartbeat sender reads it; in the port it backs the same
  snapshot for whatever reads it next (ROADMAP Queue 1 item 9 brings the
  heartbeats).
* Runtime gauges: process RSS, open file descriptors, Python threads and
  the card's allocated bytes, refreshed right before each ``/metrics``
  render. The counterpart of an XLA compile is an nvcc build of the
  kernels (``_build.py``): ``compile_stats`` counts the builds this process
  ran and their seconds (a process builds once, at its first kernel
  launch), and each build is a ``xla.compile`` span when tracing is on.

Everything here is passive: no thread, no socket.
"""

import collections
import logging
import os
import threading

from . import tracing
from .registry import REGISTRY, percentile

logger = logging.getLogger(__name__)


# --------------------------------------------------------------- round state
class RoundState:
    """Thread-safe bridge between the training round loop and its readers.

    ``RoundTimer.after_iteration`` calls :meth:`note_round` every round (a
    deque append under a lock). Only the last ``maxlen`` round times are
    kept, so a long job costs the same bytes as a short one. The
    process-wide ``ROUND_STATE`` is last-writer-wins: sequential k-fold CV
    feeds it fold by fold.
    """

    def __init__(self, maxlen=512):
        self._lock = threading.Lock()
        self._times_ms = collections.deque(maxlen=maxlen)
        self._round = -1
        self._total = 0

    def note_round(self, round_index, elapsed_s):
        with self._lock:
            self._round = int(round_index)
            self._total += 1
            self._times_ms.append(float(elapsed_s) * 1000.0)

    def reset(self):
        with self._lock:
            self._times_ms.clear()
            self._round = -1
            self._total = 0

    def snapshot(self):
        """-> dict(round, rounds_total, last_round_ms, round_ms_p50/_p95)."""
        with self._lock:
            times = list(self._times_ms)
            rnd = self._round
            total = self._total
        if times:
            return {
                "round": rnd,
                "rounds_total": total,
                "last_round_ms": round(times[-1], 3),
                "round_ms_p50": round(percentile(times, 0.5), 3),
                "round_ms_p95": round(percentile(times, 0.95), 3),
            }
        return {
            "round": rnd,
            "rounds_total": total,
            "last_round_ms": 0.0,
            "round_ms_p50": 0.0,
            "round_ms_p95": 0.0,
        }


ROUND_STATE = RoundState()


# ------------------------------------------------------ device-runtime gauges
_runtime_lock = threading.Lock()
_compile_stats = {"count": 0, "seconds": 0.0}


def note_build(seconds):
    """One kernel build of this process (``_build.py``): count it, add its
    seconds, and record it as a span under the open one."""
    with _runtime_lock:
        _compile_stats["count"] += 1
        _compile_stats["seconds"] += float(seconds)
    REGISTRY.counter("xla_compile_total", help="Kernel builds (nvcc) run by this process").inc()
    REGISTRY.counter(
        "xla_compile_seconds_total", help="Cumulative kernel build (nvcc) time"
    ).inc(float(seconds))
    tracing.record_compile(float(seconds))


def register_runtime_gauges():
    """Prime the process gauges (idempotent; starts nothing). Call at
    training and serving start-up."""
    refresh_runtime_gauges()


def compile_stats():
    with _runtime_lock:
        return dict(_compile_stats)


def _rss_bytes():
    try:
        import psutil

        return int(psutil.Process().memory_info().rss)
    except Exception:
        pass
    try:
        import resource

        # ru_maxrss is KB on Linux: the high-water mark, not the current
        # size, but an honest upper bound when psutil is missing
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return 0


def _open_fds():
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        try:
            import psutil

            return int(psutil.Process().num_fds())
        except Exception:
            return 0


def _device_live_bytes():
    """The card's allocated bytes, through ``telemetry/device.py``'s cached
    sampler (0 on the CPU, where torch keeps no allocator tally)."""
    try:
        from . import device

        return int(device.sample_device_memory()["total_bytes_in_use"])
    except Exception:
        return 0


def runtime_snapshot():
    """-> dict of host and device runtime stats."""
    comp = compile_stats()
    return {
        "rss_bytes": _rss_bytes(),
        "open_fds": _open_fds(),
        "threads": threading.active_count(),
        "device_bytes": _device_live_bytes(),
        "compile_count": comp["count"],
        "compile_seconds": round(comp["seconds"], 3),
    }


def refresh_runtime_gauges(registry=None):
    """Write the current runtime snapshot into the process gauges; the
    ``/metrics`` route calls it before each render. Safe to call anytime."""
    reg = registry or REGISTRY
    snap = runtime_snapshot()
    reg.gauge("process_rss_bytes", help="Resident set size").set(snap["rss_bytes"])
    reg.gauge("process_open_fds", help="Open file descriptors").set(snap["open_fds"])
    reg.gauge("process_threads", help="Live Python threads").set(snap["threads"])
    reg.gauge(
        "device_live_bytes", help="Live device buffer bytes (allocator or live arrays)"
    ).set(snap["device_bytes"])
    return snap
