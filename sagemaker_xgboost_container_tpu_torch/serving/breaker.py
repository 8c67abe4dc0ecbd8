"""Batcher-saturation circuit breaker: graceful degradation for serving.

When the GPU can't keep up, the batcher's bounded job queue starts
rejecting (``JobQueueFull``) and callers start timing out. The breaker turns
that saturation into protocol:

* ``closed``  - normal flow; consecutive saturation events are counted.
* ``open``    - after ``SM_SHED_REJECTION_THRESHOLD`` consecutive events,
  /invocations sheds immediately with 503 + Retry-After (no decode, no
  queue pressure) for ``SM_SHED_COOLDOWN_S``; ``/ping`` reports 503 so the
  platform stops routing new connections to the degraded instance.
* ``half_open`` - after the cooldown, exactly one probe request flows; its
  success closes the breaker, another saturation event re-opens it.

Set ``SM_LOAD_SHEDDING=false`` to disable (saturation then surfaces as
per-request 503s without the fast-path shed or the /ping flip).
"""

import logging
import math
import threading
import time

from ..utils.envconfig import env_bool, env_float, env_int

logger = logging.getLogger(__name__)

LOAD_SHEDDING_ENV = "SM_LOAD_SHEDDING"
SHED_THRESHOLD_ENV = "SM_SHED_REJECTION_THRESHOLD"
SHED_COOLDOWN_ENV = "SM_SHED_COOLDOWN_S"
SHED_RETRY_AFTER_ENV = "SM_SHED_RETRY_AFTER_S"

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


def load_shedding_enabled():
    return env_bool(LOAD_SHEDDING_ENV, True)


def retry_after_hint():
    """Whole-second Retry-After (>= 1) for stateless 503 sites."""
    value = env_float(SHED_RETRY_AFTER_ENV, 0.0, minimum=0.0, maximum=3600.0)
    if not value:
        value = env_float(SHED_COOLDOWN_ENV, 5.0, minimum=0.1, maximum=3600.0)
    return max(1, int(math.ceil(value)))


class CircuitBreaker:
    """Thread-safe three-state breaker driven by saturation events.

    ``clock`` is injectable for tests. ``shed`` counts the requests shed
    while open.
    """

    def __init__(self, threshold=None, cooldown_s=None, retry_after_s=None,
                 clock=time.monotonic):
        self.enabled = load_shedding_enabled()
        self.threshold = (
            threshold
            if threshold is not None
            else env_int(SHED_THRESHOLD_ENV, 5, minimum=1, maximum=10000)
        )
        self.cooldown_s = (
            cooldown_s
            if cooldown_s is not None
            else env_float(SHED_COOLDOWN_ENV, 5.0, minimum=0.1, maximum=3600.0)
        )
        default_retry = retry_after_s if retry_after_s is not None else env_float(
            SHED_RETRY_AFTER_ENV, 0.0, minimum=0.0, maximum=3600.0
        )
        # 0 = "derive from the cooldown", the honest default hint
        self._retry_after_s = default_retry or self.cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_out = False
        self._probe_at = 0.0
        self.shed = 0

    def _transition(self, state):
        # lock held by caller
        if state == self._state:
            return
        self._state = state
        if state == OPEN:
            logger.warning(
                "circuit breaker OPEN: shedding /invocations with 503 for "
                "%.1fs and reporting /ping unready (threshold %d saturation "
                "events reached)",
                self.cooldown_s,
                self.threshold,
            )
        elif state == CLOSED:
            logger.info("circuit breaker closed: serving recovered")

    @property
    def state(self):
        with self._lock:
            return self._state

    @property
    def degraded(self):
        """True while /ping should report unready: only a cooling-down open
        breaker. Once the cooldown elapses the state advances to half-open
        and /ping reports ready, so the platform routes the probe request
        that can close it."""
        with self._lock:
            if (
                self._state == OPEN
                and self._clock() - self._opened_at >= self.cooldown_s
            ):
                self._transition(HALF_OPEN)
                self._probe_out = False
            return self._state == OPEN

    def allow(self):
        """-> False when this request should be shed right now (503)."""
        if not self.enabled:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now - self._opened_at < self.cooldown_s:
                    self.shed += 1
                    return False
                self._transition(HALF_OPEN)
                self._probe_out = False
            # half-open: one probe in flight at a time; a probe that dies
            # before reaching predict never reports back, so an aged-out
            # token is reissued rather than wedging the breaker half-open
            if self._probe_out and now - self._probe_at < self.cooldown_s:
                self.shed += 1
                return False
            self._probe_out = True
            self._probe_at = now
            return True

    def record_saturation(self):
        """One saturation event (JobQueueFull or a batch-queue timeout)."""
        if not self.enabled:
            return
        with self._lock:
            self._consecutive += 1
            self._probe_out = False
            if self._state == HALF_OPEN or (
                self._state == CLOSED and self._consecutive >= self.threshold
            ):
                self._opened_at = self._clock()
                self._transition(OPEN)

    def record_success(self):
        """A predict made it through. Closes the breaker only from half-open
        (the probe proving recovery): a success while open is a straggler
        admitted before the breaker tripped."""
        if not self.enabled:
            return
        with self._lock:
            self._consecutive = 0
            if self._state == HALF_OPEN:
                self._probe_out = False
                self._transition(CLOSED)

    def retry_after_s(self):
        """Whole-second Retry-After hint (>= 1) for 503 responses."""
        with self._lock:
            if self._state == OPEN:
                remaining = self.cooldown_s - (self._clock() - self._opened_at)
            else:
                remaining = self._retry_after_s
        return max(1, int(math.ceil(max(remaining, 0.0))))
