"""Request coalescing for GPU serving.

One process owns the GPU, so throughput under concurrency comes from
batching: concurrent /invocations requests are coalesced into one forest
predict on the device and the per-row results are scattered back to their
callers.

A single daemon worker drains the queue; callers block on an Event with a
timeout. Requests joining a batch must share the feature width (they do:
one model per batcher); row counts concatenate.

Each batcher counts into the metrics registry under ``batcher=<name>``
(requests, inline runs, dispatches, coalesced requests, rejections, queue
timeouts, queue depth, batch rows and requests, linger), the JAX package's
series. A multi-model endpoint names each model's batcher after the model
and retires its series when the model goes.
"""

import logging
import queue
import threading
import time

import numpy as np

from ..models.forest import _host_predict_rows
from ..telemetry import POW2_BUCKETS, REGISTRY, get_request_id, tracing
from ..utils.faults import fault_point
from . import lifecycle

logger = logging.getLogger(__name__)

# linger is bounded by max_wait_ms (default 2ms): sub-ms buckets
_LINGER_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05)

# put in the queue by close(): the worker stops when it takes it
_STOP = object()

# stats() keys -> the counters they read
_STATS = (("requests", "_m_requests"), ("inline", "_m_inline"),
          ("dispatches", "_m_dispatch"), ("coalesced", "_m_coalesced"),
          ("rejected", "_m_rejected"), ("timeouts", "_m_timeouts"))


class _Pending:
    __slots__ = ("features", "event", "result", "error", "ctx", "dispatched")

    def __init__(self, features):
        self.features = features
        self.event = threading.Event()
        self.result = None
        self.error = None
        # the caller's trace context (SM_TRACE), so that the worker's
        # dispatch span joins the request's trace
        self.ctx = tracing.current_context()
        # set when the batch holding this request starts its dispatch: a
        # deadline expiring after that is a `predict`-stage expiry, before
        # it a `queue`-stage one
        self.dispatched = False


class JobQueueFull(Exception):
    """Raised when the bounded job queue rejects a request (the MMS analog:
    SAGEMAKER_MODEL_JOB_QUEUE_SIZE; MMS returns 503 when a model's job queue
    is exhausted)."""


class PredictBatcher:
    """Coalesce predict calls into batched dispatches.

    ``predict_fn(features) -> np.ndarray`` must be thread-safe.
    ``max_batch_rows`` bounds a batch; ``max_wait_ms`` bounds the added
    latency under low load; ``max_queue`` (None = unbounded) bounds
    in-flight requests, rejecting beyond it.

    Ordering note: requests are not strictly FIFO under light concurrency.
    The idle inline fast path runs small requests on the caller's thread
    under a non-blocking exec lock, so a new request can execute ahead of
    one the worker has already dequeued. The reordering is bounded to a
    single overtaken request and is harmless for stateless prediction.

    ``close()`` ends the worker thread (a model leaving an endpoint); the
    batcher still answers afterwards, on the caller's thread.
    """

    def __init__(self, predict_fn, max_batch_rows=16384, max_wait_ms=2.0, max_queue=None,
                 name="default", registry=None):
        self.predict_fn = predict_fn
        self.max_batch_rows = max_batch_rows
        self.max_wait_ms = max_wait_ms
        reg = registry or REGISTRY
        labels = {"batcher": name}
        self._m_requests = reg.counter("batcher_requests_total", "Predict calls accepted", labels)
        self._m_inline = reg.counter(
            "batcher_inline_total", "Idle fast-path runs on the caller thread", labels)
        self._m_rejected = reg.counter("batcher_rejected_total", "JobQueueFull rejections", labels)
        self._m_timeouts = reg.counter(
            "batcher_queue_timeout_total",
            "Callers that gave up waiting (zombie pendings: the worker may still dispatch "
            "their rows)", labels)
        self._m_dispatch = reg.counter(
            "batcher_dispatch_total", "Kernel dispatches (batches executed)", labels)
        self._m_coalesced = reg.counter(
            "batcher_coalesced_requests_total",
            "Requests that shared a dispatch with at least one other (coalescing ratio = this "
            "/ batcher_requests_total)", labels)
        self._m_queue_depth = reg.gauge(
            "batcher_queue_depth", "Requests waiting in the coalescing queue", labels)
        self._m_batch_rows = reg.histogram(
            "batcher_batch_rows", "Rows per dispatched batch", labels, POW2_BUCKETS)
        self._m_batch_requests = reg.histogram(
            "batcher_batch_requests", "Requests coalesced per dispatched batch", labels,
            POW2_BUCKETS)
        self._m_linger = reg.histogram(
            "batcher_linger_seconds", "Time spent collecting a batch before dispatch", labels,
            _LINGER_BUCKETS)
        # the series are shared by every batcher of one name: stats() counts
        # this batcher's from here
        self._stats_base = {key: getattr(self, attr).value for key, attr in _STATS}
        # test-and-set under a lock: a timeout storm expires many waiters at
        # one instant, and the log-once guard must hold exactly then
        self._log_lock = threading.Lock()
        self._timeout_logged = False
        self._rejection_logged = False
        # bounded queue -> the limit is atomic (put_nowait raises Full); a
        # qsize() check-then-put would race under concurrent WSGI threads.
        # Clamped to >= 1 when bounded: Queue(maxsize=0) means unlimited.
        self.max_queue = None if max_queue is None else max(1, max_queue)
        self._queue = queue.Queue(maxsize=self.max_queue or 0)
        self._carry = None  # width-mismatched request deferred to next batch
        self._exec_lock = threading.Lock()  # held around every predict_fn run
        # closed -> new requests run on the caller's thread; the enqueue and
        # close() take this lock, so nothing is queued behind _STOP
        self._close_lock = threading.Lock()
        self._closed = False
        # the dispatch in flight, for the predict watchdog: its start time
        # and (requests, rows), None / zeros when idle. Kept only while a
        # watchdog watches this batcher (`watched`, set by its register), so
        # that without SM_PREDICT_STUCK_S a predict reads no clock for it
        self.watched = False
        self._dispatch_lock = threading.Lock()
        self._dispatch_started = None
        self._dispatch_meta = (0, 0)
        self._thread = threading.Thread(target=self._worker, daemon=True, name="predict-batcher")
        self._thread.start()

    def stats(self):
        """This batcher's counts: requests, inline runs, dispatches (batches
        the worker ran), coalesced requests (those that shared a dispatch),
        rejections and caller timeouts."""
        return {key: int(getattr(self, attr).value - self._stats_base[key])
                for key, attr in _STATS}

    def dispatch_age_s(self):
        """Seconds the predict_fn run in flight has taken so far, or None
        when none is (the predict watchdog's probe)."""
        with self._dispatch_lock:
            started = self._dispatch_started
        return None if started is None else time.monotonic() - started

    def dispatch_info(self):
        """-> (requests, rows) of the dispatch in flight ((0, 0) when idle)."""
        with self._dispatch_lock:
            return self._dispatch_meta

    def _dispatch_begin(self, requests, rows):
        if not self.watched:
            return
        with self._dispatch_lock:
            self._dispatch_started = time.monotonic()
            self._dispatch_meta = (requests, rows)

    def _dispatch_end(self):
        # dispatches are single-flight (the exec lock), so the begin that
        # set the start ran on this thread: the unlocked read sees it
        if self._dispatch_started is None:
            return
        with self._dispatch_lock:
            self._dispatch_started = None
            self._dispatch_meta = (0, 0)

    def _run(self, feats, requests):
        self._dispatch_begin(requests, int(feats.shape[0]))
        try:
            return np.asarray(self.predict_fn(feats))
        finally:
            self._dispatch_end()

    def predict(self, features, timeout=60.0, deadline=None):
        feats = np.asarray(features, np.float32)
        # Idle fast path: nothing queued and the worker not mid-batch -> run
        # predict_fn on the caller's thread, skipping the cross-thread
        # queue/Event handoff. The exec lock keeps predict_fn single-flight:
        # under any concurrency the non-blocking acquire fails and requests
        # take the coalescing queue. Restricted to host-path-sized payloads:
        # the numpy traversal cannot hang, so forgoing the queue path's
        # wait-timeout is safe.
        if (
            0 < feats.shape[0] <= _host_predict_rows()
            and self._queue.empty()
            and self._exec_lock.acquire(blocking=False)
        ):
            try:
                if self._queue.empty() and self._carry is None:
                    if deadline is not None:
                        deadline.check("predict")
                    self._m_requests.inc()
                    self._m_inline.inc()
                    with tracing.trace_span("batcher.inline",
                                            attributes={"rows": int(feats.shape[0])}):
                        return self._run(feats, 1)
            finally:
                self._exec_lock.release()
        if deadline is not None:
            # a request whose budget is gone must not take a queue slot
            deadline.check("queue")
        pending = _Pending(feats)
        qspan = tracing.start_span("batcher.queue", attributes={"rows": int(feats.shape[0])})
        try:
            with self._close_lock:
                closed = self._closed
                if not closed:
                    try:
                        self._queue.put_nowait(pending)
                    except queue.Full:
                        self._reject()
            if closed:
                self._m_requests.inc()
                with self._exec_lock:
                    return self._run(feats, 1)
            self._m_requests.inc()
            self._m_queue_depth.set(self._queue.qsize())
            # SM_REQUEST_DEADLINE_S bounds the queue wait plus the dispatch
            wait_s = timeout if deadline is None else min(timeout, deadline.remaining())
            if not pending.event.wait(wait_s):
                # a zombie pending: this caller gives up, but the worker still
                # holds it and may dispatch its rows later
                self._m_timeouts.inc()
                if deadline is not None and deadline.expired():
                    lifecycle.expire("predict" if pending.dispatched else "queue",
                                     deadline.budget_s)
                with self._log_lock:
                    should_log, self._timeout_logged = not self._timeout_logged, True
                if should_log:
                    logger.warning(
                        "prediction (request %s) timed out after %.1fs in the batch queue; the "
                        "batch worker may still dispatch the abandoned rows. Further timeouts "
                        "are counted in batcher_queue_timeout_total without logging.",
                        get_request_id() or "untracked", timeout)
                raise TimeoutError("prediction timed out in the batch queue")
            if pending.error is not None:
                raise pending.error
            return pending.result
        finally:
            tracing.finish_span(qspan)

    def _reject(self):
        self._m_rejected.inc()
        with self._log_lock:
            should_log, self._rejection_logged = not self._rejection_logged, True
        if should_log:
            logger.warning(
                "rejecting prediction (request %s): job queue full (%s pending). Further "
                "rejections are counted in batcher_rejected_total without logging.",
                get_request_id() or "untracked", self.max_queue)
        raise JobQueueFull("job queue full ({} pending)".format(self.max_queue))

    def close(self, timeout=10.0):
        """End the worker once it has answered the requests queued before
        this call, and wait up to ``timeout`` s for it. Later predicts run on
        the caller's thread. -> True when the worker ended."""
        with self._close_lock:
            if not self._closed:
                self._closed = True
                try:
                    self._queue.put(_STOP, timeout=timeout)
                except queue.Full:
                    logger.error("batcher worker did not drain its queue in %.1fs", timeout)
                    return False
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # ------------------------------------------------------------------ int
    def _drain_batch(self, first, wait):
        """Collect a batch starting from ``first``.

        ``wait``: whether to linger max_wait_ms for stragglers. A lone
        request on an idle endpoint must not pay the linger; under
        concurrency the queue accumulates while predict_fn runs, so
        coalescing happens even with wait=False. The worker passes
        wait=True only after a batch that coalesced.
        """
        batch = [first]
        rows = first.features.shape[0]
        # one deadline for the whole batch: re-arming it per straggler would
        # let a trickle of arrivals defer dispatch without bound
        deadline = time.monotonic() + (self.max_wait_ms / 1000.0 if wait else 0.0)
        while rows < self.max_batch_rows:
            try:
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    nxt = self._queue.get(timeout=remaining)
                else:
                    nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP or nxt.features.shape[1] != first.features.shape[1]:
                # the stop mark or a different width: deferred to the next
                # turn (the caller holds _exec_lock)
                self._carry = nxt
                break
            batch.append(nxt)
            rows += nxt.features.shape[0]
        return batch

    def _worker(self):
        loaded = False  # previous batch coalesced -> linger for stragglers
        while True:
            # swap the carry out under the exec lock so the inline fast
            # path's `self._carry is None` check always sees a consistent
            # value
            with self._exec_lock:
                first, self._carry = self._carry, None
            if first is None:
                first = self._queue.get()
            if first is _STOP:
                return
            # drain inside the exec lock: while an inline run holds it, the
            # worker must not vacuum the queue into a private batch (queued
            # requests keep counting against max_queue)
            with self._exec_lock:
                drain_start = time.monotonic()
                batch = self._drain_batch(first, wait=loaded)
                loaded = len(batch) > 1
                rows = sum(p.features.shape[0] for p in batch)
                self._m_linger.observe(time.monotonic() - drain_start)
                self._m_queue_depth.set(self._queue.qsize())
                self._m_dispatch.inc()
                self._m_batch_requests.observe(len(batch))
                self._m_batch_rows.observe(rows)
                if len(batch) > 1:
                    self._m_coalesced.inc(len(batch))
                # parented to the first traced request of the batch, so its
                # trace id survives the thread hop
                ctx = next((p.ctx for p in batch if p.ctx is not None), None)
                with tracing.trace_span("batcher.dispatch", parent=ctx,
                                        attributes={"requests": len(batch), "rows": rows}):
                    self._dispatch_begin(len(batch), rows)
                    for pending in batch:
                        pending.dispatched = True
                    try:
                        # a sleep here wedges the dispatch (the stuck-predict
                        # watchdog's drill)
                        fault_point("batcher.dispatch", requests=len(batch))
                        stacked = (
                            batch[0].features
                            if len(batch) == 1
                            else np.concatenate([p.features for p in batch], axis=0)
                        )
                        out = np.asarray(self.predict_fn(stacked))
                        offset = 0
                        for pending in batch:
                            k = pending.features.shape[0]
                            pending.result = out[offset : offset + k]
                            offset += k
                            pending.event.set()
                    except Exception as e:  # propagate to every caller in the batch
                        for pending in batch:
                            pending.error = e
                            pending.event.set()
                    finally:
                        self._dispatch_end()
