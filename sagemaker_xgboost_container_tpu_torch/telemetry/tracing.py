"""Hierarchical tracing: spans with parent links, a bounded flight recorder,
and its Chrome-trace / Perfetto JSON dump.

* **Spans**: id, parent link, attributes and wall window, kept on a
  thread-local stack so nested ``trace_span`` calls form a tree. A hop to
  another thread (the batcher's worker) passes the parent context
  explicitly.
* **Flight recorder**: finished spans land in a ring buffer of
  ``SM_TRACE_BUFFER`` spans. The predict watchdog and the drain abort dump
  the last spans, still-open ones included (flagged ``in_flight``), to
  ``flight-recorder-rank<r>.json``: the post-mortem of what was live when the
  process gave up.
* **Device sync**: ``SM_TRACE_DEVICE_SYNC=N`` makes every N-th device
  predict wait for the card inside a ``device_sync`` span
  (``torch.cuda.synchronize``), so the trace splits the host's enqueue from
  the device's work. The training round's fence is the booster's own
  (``models/booster.py``: ``host_dispatch`` / ``device_sync`` phases).
* **Export**: ``export_traces`` writes this rank's finished spans to
  ``trace-rank<r>.json`` at the end of a training job; ``record_span`` /
  ``record_compile`` add already-finished spans (a kernel build).
* **Fleet wire**: ``span_to_wire`` / ``events_from_wire`` are the one
  serialization of a finished span for the local export and for the fleet
  plane's cross-rank merge (``telemetry/fleet.py``); each span landing in the
  recorder gets a sequence number, the shipper's drain watermark.

Everything is gated on ``SM_TRACE``: unset (the default), a call site costs
one cached-boolean check; no spans, no buffer, no threads, no files.
"""

import collections
import contextlib
import json
import logging
import os
import threading
import time
import uuid

from ..utils.envconfig import env_bool, env_int

logger = logging.getLogger(__name__)

TRACE_ENV = "SM_TRACE"
TRACE_BUFFER_ENV = "SM_TRACE_BUFFER"
TRACE_EXPORT_DIR_ENV = "SM_TRACE_EXPORT_DIR"
DEVICE_SYNC_ENV = "SM_TRACE_DEVICE_SYNC"

DEFAULT_BUFFER_SPANS = 4096

# perf_counter base: the trace's timestamps only need to be consistent
# within the process, and a monotonic clock keeps spans ordered
_T0 = time.perf_counter()


def _now_us():
    return (time.perf_counter() - _T0) * 1e6


def new_id():
    return uuid.uuid4().hex[:16]


class Span:
    """One timed node of the trace tree. Finish it on the thread that
    started it (the thread-local stack is popped by identity)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attributes", "start_us",
                 "dur_us", "tid", "thread_name", "seq")

    def __init__(self, name, trace_id, parent_id, attributes=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_id()
        self.parent_id = parent_id
        self.attributes = dict(attributes or {})
        self.start_us = _now_us()
        self.dur_us = None  # None while open
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        # the recorder-append sequence number, the fleet shipper's drain
        # watermark (it ships spans with seq above the last shipped)
        self.seq = None

    def context(self):
        return (self.trace_id, self.span_id)


# --------------------------------------------------------------------- state
_tls = threading.local()

_state_lock = threading.Lock()
_enabled = None  # cached SM_TRACE verdict; None = not yet resolved
_rank = 0  # this process's rank (set_rank, from the multi-host pre-exec)
_sync_every = 0  # cached SM_TRACE_DEVICE_SYNC, resolved with _enabled
_sync_calls = 0
_recorder = None  # deque of finished Span, created on first use
_live = {}  # span_id -> open Span (for the flight-recorder dump)
_seq = 0  # recorder appends so far (outlives the ring buffer's drops)


def enabled():
    """Cached ``SM_TRACE`` verdict: one call and a boolean test per site."""
    global _enabled, _sync_every
    value = _enabled
    if value is None:
        with _state_lock:
            if _enabled is None:
                # graftlint: disable=capture-env-read not captured: reached from the
                # round only through a failed collective's abort (across ranks, which
                # run eagerly) or the kernels' first build (the eager warm-up round)
                _sync_every = env_int(DEVICE_SYNC_ENV, 0, minimum=0)
                # graftlint: disable=capture-env-read not captured: reached from the
                # round only through a failed collective's abort (across ranks, which
                # run eagerly) or the kernels' first build (the eager warm-up round)
                _enabled = env_bool(TRACE_ENV, False)
            value = _enabled
    return value


def set_rank(rank):
    """Record this process's rank for the export file names and lanes."""
    global _rank
    _rank = int(rank)


def get_rank():
    return _rank


def _get_recorder():
    global _recorder
    rec = _recorder
    if rec is None:
        with _state_lock:
            if _recorder is None:
                _recorder = collections.deque(
                    # graftlint: disable=capture-env-read not captured: reached from the
                    # round only through a failed collective's abort (across ranks,
                    # which run eagerly) or the kernels' first build (the eager warm-up
                    # round)
                    maxlen=env_int(TRACE_BUFFER_ENV, DEFAULT_BUFFER_SPANS, minimum=16))
            rec = _recorder
    return rec


def _reset_for_tests():
    """Drop the cached knobs, the ring buffer, live spans and this thread's
    span stack."""
    global _enabled, _recorder, _sync_every, _sync_calls, _rank, _seq
    with _state_lock:
        _enabled = None
        _recorder = None
        _rank = 0
        _sync_every = 0
        _sync_calls = 0
        _seq = 0
        _live.clear()
    _tls.stack = []


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span():
    stack = _stack()
    return stack[-1] if stack else None


def current_context():
    """(trace_id, span_id) of this thread's innermost open span, or None.
    Hand it to another thread (``parent=``) to keep its spans in the tree."""
    span = current_span()
    return span.context() if span is not None else None


def _resolve_parent(parent, trace_id, root):
    """-> (trace_id, parent_id): an explicit parent (a Span or a (trace_id,
    span_id) pair) first, then this thread's open span, else a new root."""
    if parent is not None:
        if isinstance(parent, Span):
            return parent.trace_id, parent.span_id
        return parent[0], parent[1]
    if not root:
        implicit = current_span()
        if implicit is not None:
            return implicit.trace_id, implicit.span_id
    return trace_id or new_id(), None


# ----------------------------------------------------------------- span API
def start_span(name, attributes=None, parent=None, trace_id=None, root=False):
    """Open a span (None when tracing is off). ``trace_id`` seeds a new
    trace (the serving request id); ``root=True`` ignores an open span on
    this thread."""
    if not enabled():
        return None
    tid, parent_id = _resolve_parent(parent, trace_id, root)
    span = Span(name, tid, parent_id, attributes)
    _stack().append(span)
    with _state_lock:
        _live[span.span_id] = span
    return span


def finish_span(span, **attributes):
    """Close ``span`` (no-op on None), merging ``attributes``, and append it
    to the flight recorder."""
    if span is None:
        return
    span.dur_us = max(_now_us() - span.start_us, 0.0)
    if attributes:
        span.attributes.update(attributes)
    stack = _stack()
    if span in stack:
        stack.remove(span)
    recorder = _get_recorder()  # resolve before the lock (it may take it)
    # append under the state lock: snapshot_spans copies the deque under it,
    # and an append racing that copy would break the abort-path dump
    global _seq
    with _state_lock:
        _live.pop(span.span_id, None)
        _seq += 1
        span.seq = _seq
        recorder.append(span)


@contextlib.contextmanager
def trace_span(name, attributes=None, parent=None, trace_id=None, root=False):
    """Context-managed span; yields the Span (or None when tracing is off)."""
    if not enabled():
        yield None
        return
    span = start_span(name, attributes=attributes, parent=parent, trace_id=trace_id,
                      root=root)
    try:
        yield span
    finally:
        finish_span(span)


def record_span(name, duration_s=0.0, attributes=None, parent=None):
    """Record an already-finished span ending now (an event whose duration
    is reported after the fact, such as a kernel build), parented to this
    thread's open span unless ``parent`` is given."""
    if not enabled():
        return None
    tid, parent_id = _resolve_parent(parent, None, False)
    span = Span(name, tid, parent_id, attributes)
    span.dur_us = max(float(duration_s), 0.0) * 1e6
    span.start_us = max(span.start_us - span.dur_us, 0.0)
    recorder = _get_recorder()
    global _seq
    with _state_lock:
        _seq += 1
        span.seq = _seq
        recorder.append(span)
    return span


def record_compile(duration_s):
    """A kernel build (``_build.py``'s nvcc run, the counterpart of an XLA
    compile) as a span under the open one: a first round's build becomes a
    visible node of the tree."""
    return record_span("xla.compile", duration_s, attributes={"kind": "nvcc_build"})


def device_sync(device):
    """With ``SM_TRACE`` and ``SM_TRACE_DEVICE_SYNC=N`` set, every N-th call
    on a CUDA ``device`` waits for the card inside a ``device_sync`` span;
    otherwise nothing."""
    global _sync_calls
    if not enabled() or _sync_every <= 0 or device.type != "cuda":
        return
    with _state_lock:
        _sync_calls += 1
        due = _sync_calls % _sync_every == 0
    if due:
        import torch

        with trace_span("device_sync", attributes={"device": str(device)}):
            torch.cuda.synchronize(device)


# ------------------------------------------------------------------- export
def snapshot_spans(include_open=False):
    """Finished spans oldest first, plus, when asked, copies of the open
    ones flagged ``in_flight`` (the abort dump's view of what was live)."""
    recorder = _get_recorder()
    with _state_lock:
        spans = list(recorder)
    if include_open:
        now_us = _now_us()
        with _state_lock:
            open_spans = list(_live.values())
        for span in open_spans:
            ghost = Span(span.name, span.trace_id, span.parent_id, span.attributes)
            ghost.span_id = span.span_id
            ghost.start_us = span.start_us
            ghost.dur_us = max(now_us - span.start_us, 0.0)
            ghost.tid = span.tid
            ghost.thread_name = span.thread_name
            ghost.attributes["in_flight"] = True
            spans.append(ghost)
    return spans


def span_to_wire(span):
    """The flat-dict form of a finished span: the fleet shipper's wire
    payload (``telemetry/fleet.py``) and the event builder's input, one
    serialization for the local export and the cross-rank merge."""
    wire = {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "start_us": round(span.start_us, 3),
        "dur_us": round(span.dur_us or 0.0, 3),
        "tid": span.tid,
        "thread_name": span.thread_name,
    }
    if span.parent_id:
        wire["parent_id"] = span.parent_id
    if span.attributes:
        wire["attributes"] = dict(span.attributes)
    return wire


def events_from_wire(wire_spans, pid, process_label):
    """Chrome-trace events (process and thread names, complete "X" events)
    of one pid lane. ``pid`` is the rank, so the ranks' lanes stack in one
    Perfetto view: the per-rank export and the merged ``trace-fleet.json``
    both build their lanes here."""
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": process_label}}]
    thread_names = {}
    for wire in wire_spans:
        thread_names.setdefault(wire.get("tid", 0), wire.get("thread_name", ""))
    for tid, tname in sorted(thread_names.items(), key=lambda kv: str(kv[0])):
        events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                       "args": {"name": tname}})
    for wire in wire_spans:
        args = dict(wire.get("attributes") or {})
        args["span_id"] = wire.get("span_id")
        args["trace_id"] = wire.get("trace_id")
        if wire.get("parent_id"):
            args["parent_id"] = wire["parent_id"]
        events.append({"name": wire.get("name", "?"), "cat": "span", "ph": "X", "pid": pid,
                       "tid": wire.get("tid", 0),
                       "ts": round(float(wire.get("start_us") or 0.0), 3),
                       "dur": round(float(wire.get("dur_us") or 0.0), 3), "args": args})
    return events


def chrome_trace_doc(spans=None, extra_metadata=None):
    """-> Chrome-trace JSON object: complete ("X") events in microseconds,
    with span, parent and trace ids in ``args`` so the tree survives, plus
    process and thread name events. ``spans`` defaults to the finished
    ones."""
    if spans is None:
        spans = snapshot_spans()
    rank = get_rank()
    events = events_from_wire([span_to_wire(span) for span in spans], pid=rank,
                              process_label="rank {} (os pid {})".format(rank, os.getpid()))
    metadata = {"rank": rank, "os_pid": os.getpid(), "spans": len(spans)}
    if extra_metadata:
        metadata.update(extra_metadata)
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": metadata}


def _write_doc(directory, filename, doc):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


def export_traces(default_dir=None, filename=None):
    """End-of-job export: this rank's Chrome trace into
    ``SM_TRACE_EXPORT_DIR`` (else ``default_dir``, the model dir of a
    training job) and one ``training.trace_export`` record. -> the path, or
    None (tracing off, or no directory)."""
    if not enabled():
        return None
    directory = os.environ.get(TRACE_EXPORT_DIR_ENV) or default_dir
    if not directory:
        return None
    doc = chrome_trace_doc()
    path = _write_doc(directory, filename or "trace-rank{}.json".format(get_rank()), doc)
    from .emit import emit_metric

    emit_metric("training.trace_export", path=path, spans=doc["otherData"]["spans"])
    logger.info("exported %d trace spans to %s", doc["otherData"]["spans"], path)
    return path


def dump_flight_recorder(default_dir=None, reason=None, exit_code=None):
    """Abort-path dump: the last finished spans plus every open one into
    ``flight-recorder-rank<r>.json`` under ``SM_TRACE_EXPORT_DIR`` (else
    ``default_dir``, else the working directory). Never raises: the exit
    must happen even when the disk is what broke. -> the path, or None
    (tracing off, or the write failed)."""
    if not enabled():
        return None
    # graftlint: disable=capture-env-read not captured: reached from the round only
    # through a failed collective's abort (across ranks, which run eagerly) or the
    # kernels' first build (the eager warm-up round)
    directory = os.environ.get(TRACE_EXPORT_DIR_ENV) or default_dir or "."
    extra = {}
    if reason is not None:
        extra["abort_reason"] = reason
    if exit_code is not None:
        extra["exit_code"] = exit_code
    try:
        doc = chrome_trace_doc(snapshot_spans(include_open=True), extra_metadata=extra)
        path = _write_doc(directory, "flight-recorder-rank{}.json".format(get_rank()), doc)
    except Exception as e:
        logger.error("flight-recorder dump failed (%s); continuing abort", e)
        return None
    logger.error("flight recorder dumped to %s (%d spans, incl. in-flight)", path,
                 doc["otherData"]["spans"])
    return path
