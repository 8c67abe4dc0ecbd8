"""Request coalescing for GPU serving.

One process owns the GPU, so throughput under concurrency comes from
batching: concurrent /invocations requests are coalesced into one forest
predict on the device and the per-row results are scattered back to their
callers.

A single daemon worker drains the queue; callers block on an Event with a
timeout. Requests joining a batch must share the feature width (they do:
one model per endpoint); row counts concatenate.
"""

import logging
import queue
import threading
import time

import numpy as np

from ..models.forest import HOST_PREDICT_ROWS

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("features", "event", "result", "error")

    def __init__(self, features):
        self.features = features
        self.event = threading.Event()
        self.result = None
        self.error = None


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

    ``stats()`` counts requests, inline runs, dispatches (batches executed
    by the worker), coalesced requests (those that shared a dispatch with
    at least one other), rejections and caller timeouts.
    """

    def __init__(self, predict_fn, max_batch_rows=16384, max_wait_ms=2.0, max_queue=None):
        self.predict_fn = predict_fn
        self.max_batch_rows = max_batch_rows
        self.max_wait_ms = max_wait_ms
        self._stats_lock = threading.Lock()
        self._stats = dict.fromkeys(
            ("requests", "inline", "dispatches", "coalesced", "rejected", "timeouts"), 0)
        # bounded queue -> the limit is atomic (put_nowait raises Full); a
        # qsize() check-then-put would race under concurrent WSGI threads.
        # Clamped to >= 1 when bounded: Queue(maxsize=0) means unlimited.
        self.max_queue = None if max_queue is None else max(1, max_queue)
        self._queue = queue.Queue(maxsize=self.max_queue or 0)
        self._carry = None  # width-mismatched request deferred to next batch
        self._exec_lock = threading.Lock()  # held around every predict_fn run
        self._thread = threading.Thread(target=self._worker, daemon=True, name="predict-batcher")
        self._thread.start()

    def stats(self):
        with self._stats_lock:
            return dict(self._stats)

    def _count(self, key, n=1):
        with self._stats_lock:
            self._stats[key] += n

    def predict(self, features, timeout=60.0):
        feats = np.asarray(features, np.float32)
        # Idle fast path: nothing queued and the worker not mid-batch -> run
        # predict_fn on the caller's thread, skipping the cross-thread
        # queue/Event handoff. The exec lock keeps predict_fn single-flight:
        # under any concurrency the non-blocking acquire fails and requests
        # take the coalescing queue. Restricted to host-path-sized payloads:
        # the numpy traversal cannot hang, so forgoing the queue path's
        # wait-timeout is safe.
        if (
            0 < feats.shape[0] <= HOST_PREDICT_ROWS
            and self._queue.empty()
            and self._exec_lock.acquire(blocking=False)
        ):
            try:
                if self._queue.empty() and self._carry is None:
                    self._count("requests")
                    self._count("inline")
                    return np.asarray(self.predict_fn(feats))
            finally:
                self._exec_lock.release()
        pending = _Pending(feats)
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            self._count("rejected")
            raise JobQueueFull("job queue full ({} pending)".format(self.max_queue))
        self._count("requests")
        if not pending.event.wait(timeout):
            # the worker still holds the pending and may dispatch its rows
            self._count("timeouts")
            raise TimeoutError("prediction timed out in the batch queue")
        if pending.error is not None:
            raise pending.error
        return pending.result

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
            if nxt.features.shape[1] != first.features.shape[1]:
                # different width: defer to its own batch (the caller holds
                # _exec_lock)
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
            # drain inside the exec lock: while an inline run holds it, the
            # worker must not vacuum the queue into a private batch (queued
            # requests keep counting against max_queue)
            with self._exec_lock:
                batch = self._drain_batch(first, wait=loaded)
                loaded = len(batch) > 1
                self._count("dispatches")
                if len(batch) > 1:
                    self._count("coalesced", len(batch))
                try:
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
