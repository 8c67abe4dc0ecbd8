"""Span API: time named phases into the registry, stdout records, and an
optional per-round phase accumulator.

Three consumers, one call site:

* ``span("data_ingest", emit=True)`` — one-off phases (algorithm_train's
  ingest/train/save) record a ``training.phase`` stdout line and a
  ``training_phase_seconds{phase=...}`` histogram observation.
* ``PhaseRecorder`` — per-round breakdown: while a recorder is installed on
  this thread (``RoundTimer`` installs one for the whole training run), every
  finished span also accumulates into it; the timer drains it each round so
  the round record carries ``phases_ms``.
* the registry — every span observes ``training_phase_seconds`` so phase
  latencies show up in ``/metrics`` exposition too.

Recorders are thread-local: the booster's callback loop is single-threaded,
and parallel serving threads never share a recorder by accident.

While the tracer records (``SM_TRACE``, or a ``torch.profiler`` session:
``tracing.recording``, telemetry/tracing.py) every ``span()`` additionally
opens a tracer span, and under a profiler a ``record_function`` range of
the same name, so existing call sites upgrade in place: the flat per-round
phases become children of the per-round root span RoundTimer owns, and sit
in the profiler's trace. Otherwise the added cost is the two checks.

Training's one-off phases, always on: ``setup.sketch`` / ``setup.apply``
(``data/binning``), ``round.capture`` / ``round.recapture``
(``models/round_graph``). The session's leaves (``session.enqueue``,
``session.copy_out``, ``session.commit``, ``session.eval``,
``session.callbacks``, ``models/booster``) are tracer spans and profiler
ranges only (``tracing.trace_span``), not phases: the round's own phases
already count that time. The booster adds each round's device stages to
the active recorder as ``device.gradient`` ... ``device.margins``
(``ops/stamps``); RoundTimer keeps those out of its host remainder.
"""

import contextlib
import threading
import time

from . import tracing
from .emit import emit_metric
from .registry import REGISTRY

_tls = threading.local()

PHASE_HISTOGRAM = "training_phase_seconds"


class PhaseRecorder:
    """Accumulates ``{phase: seconds}`` between drains (single-thread use)."""

    def __init__(self):
        self.phases = {}

    def add(self, name, seconds):
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def drain(self):
        drained, self.phases = self.phases, {}
        return drained


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def push_recorder(recorder=None):
    """Install a recorder on this thread; pair with ``pop_recorder``."""
    recorder = recorder or PhaseRecorder()
    _stack().append(recorder)
    return recorder


def pop_recorder(recorder):
    stack = _stack()
    if recorder in stack:
        stack.remove(recorder)


def active_recorder():
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def span(name, emit=False, registry=None):
    """Time the enclosed block as phase ``name``.

    The duration always lands in the phase histogram and in this thread's
    active ``PhaseRecorder`` (if any); ``emit=True`` additionally writes one
    ``training.phase`` stdout record — use it for one-off phases, never for
    per-round work (the round record owns that).
    """
    tspan = tracing.start_span(name)
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if tspan is not None:
            tracing.finish_span(tspan)
        (registry or REGISTRY).histogram(
            PHASE_HISTOGRAM,
            help="Wall time of named training phases",
            labels={"phase": name},
        ).observe(elapsed)
        recorder = active_recorder()
        if recorder is not None:
            recorder.add(name, elapsed)
        if emit:
            emit_metric(
                "training.phase", phase=name, seconds=round(elapsed, 6)
            )
