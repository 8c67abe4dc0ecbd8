"""Serving SLO window: rolling-window latency against a p95 target, with a
burn rate.

* ``SM_SLO_P95_MS`` arms it (unset or 0: no window, no series, one
  ``is None`` test a request);
* every ``/invocations`` latency lands in a rolling ``SM_SLO_WINDOW_S``
  window (default 300 s);
* a sample over the target counts ``serving_slo_violation_total``, and the
  window's violating share over the 5 % error budget of a p95 target is
  ``serving_slo_burn_rate`` (1.0 spends exactly the budget);
* the window has a breaker's ``degraded`` property, so the lifecycle folds
  a sustained burn into its ``degraded`` state (visible in
  ``serving_state``) without flipping ``/ping``.

Fed by the WSGI middleware (``wsgi.py``) on both serving apps.
"""

import collections
import logging
import threading
import time

from ..utils.envconfig import env_float
from .registry import REGISTRY, percentile

logger = logging.getLogger(__name__)

SLO_P95_ENV = "SM_SLO_P95_MS"
SLO_WINDOW_ENV = "SM_SLO_WINDOW_S"

DEFAULT_WINDOW_S = 300.0

#: a p95 objective tolerates 5 % of requests above the target
ERROR_BUDGET = 0.05

#: below this many samples the window is never degraded: one cold-start
#: request must not flip the lifecycle state
MIN_SAMPLES = 20


def slo_target_ms():
    return env_float(SLO_P95_ENV, 0.0, minimum=0.0)


def slo_window_s():
    return env_float(SLO_WINDOW_ENV, DEFAULT_WINDOW_S, minimum=1.0)


class SloWindow:
    """Rolling latency window against a p95 target. ``observe_ms`` is
    amortized O(1); percentiles are computed only by :meth:`snapshot`.
    ``clock`` is injectable for tests."""

    def __init__(self, target_p95_ms, window_s=None, registry=None, clock=None):
        self.target_p95_ms = float(target_p95_ms)
        self.window_s = float(window_s if window_s is not None else slo_window_s())
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._samples = collections.deque()  # (t, latency_ms, violating)
        self._violating = 0
        reg = registry or REGISTRY
        # created at zero, so the series are scraped from the first request
        self._m_violations = reg.counter(
            "serving_slo_violation_total", "Requests over the SM_SLO_P95_MS latency target")
        self._m_burn = reg.gauge(
            "serving_slo_burn_rate",
            "Rolling-window SLO violation fraction over the 5% error budget")
        self._m_burn.set(0.0)

    def observe_seconds(self, elapsed_s):
        self.observe_ms(float(elapsed_s) * 1000.0)

    def observe_ms(self, latency_ms):
        now = self._clock()
        violating = latency_ms > self.target_p95_ms
        with self._lock:
            self._samples.append((now, float(latency_ms), violating))
            if violating:
                self._violating += 1
            self._trim_locked(now)
            burn = self._burn_locked()
        if violating:
            self._m_violations.inc()
        self._m_burn.set(round(burn, 4))

    def _trim_locked(self, now):
        cutoff = now - self.window_s
        samples = self._samples
        while samples and samples[0][0] < cutoff:
            _t, _ms, was_violating = samples.popleft()
            if was_violating:
                self._violating -= 1

    def _burn_locked(self):
        n = len(self._samples)
        if n == 0:
            return 0.0
        return (self._violating / n) / ERROR_BUDGET

    @property
    def degraded(self):
        """True while the window holds enough samples and burns the error
        budget faster than the objective allows (burn rate above 1)."""
        with self._lock:
            self._trim_locked(self._clock())
            return len(self._samples) >= MIN_SAMPLES and self._burn_locked() > 1.0

    def snapshot(self):
        """-> target, window, samples, p50, p95, violation and burn rates,
        degraded."""
        with self._lock:
            self._trim_locked(self._clock())
            lat = [ms for _t, ms, _v in self._samples]
            n = len(lat)
            violating = self._violating
            burn = self._burn_locked()
        return {
            "target_p95_ms": self.target_p95_ms,
            "window_s": self.window_s,
            "samples": n,
            "p50_ms": round(percentile(lat, 0.5), 3) if lat else 0.0,
            "p95_ms": round(percentile(lat, 0.95), 3) if lat else 0.0,
            "violation_rate": round(violating / n, 4) if n else 0.0,
            "burn_rate": round(burn, 4),
            "degraded": n >= MIN_SAMPLES and burn > 1.0,
        }


_window_lock = threading.Lock()
_window = None


def maybe_install(registry=None):
    """Arm the process-wide window when ``SM_SLO_P95_MS`` is above 0
    (idempotent). -> the window, or None when disarmed."""
    global _window
    if _window is not None:
        return _window
    target = slo_target_ms()
    if target <= 0:
        return None
    with _window_lock:
        if _window is None:
            _window = SloWindow(target, registry=registry)
            logger.info("serving SLO armed: p95 target %.1f ms over a %.0fs window",
                        _window.target_p95_ms, _window.window_s)
    return _window


def active_window():
    """The installed window, or None when disarmed."""
    return _window


def _reset_for_tests():
    global _window
    with _window_lock:
        _window = None
