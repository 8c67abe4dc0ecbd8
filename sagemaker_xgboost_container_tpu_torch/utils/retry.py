"""Bounded transient-failure retries with jittered exponential backoff.

Channel ingest and checkpoint writes sit on network filesystems (S3 via
Fast File mode, EBS under load) where transient ``OSError``s are routine; a
single blip must not fail a multi-hour training job, and an unbounded retry
loop must not mask a real outage. Policy:

* bounded attempts (``SM_IO_RETRY_ATTEMPTS``, default 3 — i.e. 2 retries),
* exponential backoff from ``SM_IO_RETRY_BACKOFF_S`` (default 0.1s) with
  half-to-full jitter so a fleet of hosts doesn't retry in lockstep,
* one WARNING per call-site per process (``utils/warn_once``); every retry is counted in ``io_retries_total{site=...}`` and
  exhaustion in ``io_retry_exhausted_total{site=...}``,
* only ``retry_on`` exception types retry (default ``OSError`` — which
  covers IOError, ConnectionError, socket.timeout); semantic errors
  (UserError, parse failures) propagate immediately.
"""

import logging
import random
import time

from .envconfig import env_float, env_int
# reset_warnings, the test hook, forgets which sites have warned
from .warn_once import reset_warnings, warn_once  # noqa: F401

logger = logging.getLogger(__name__)

RETRY_ATTEMPTS_ENV = "SM_IO_RETRY_ATTEMPTS"
RETRY_BACKOFF_ENV = "SM_IO_RETRY_BACKOFF_S"
_WARN_KEY = "retry.{}"  # warn_once's key of a call site


def retry_attempts():
    return env_int(RETRY_ATTEMPTS_ENV, 3, minimum=1, maximum=20)


def retry_backoff_s():
    return env_float(RETRY_BACKOFF_ENV, 0.1, minimum=0.0, maximum=30.0)


def retry_transient(
    fn,
    site,
    retry_on=(OSError,),
    attempts=None,
    backoff_s=None,
    sleep=time.sleep,
    rng=random.random,
):
    """Run ``fn()`` with bounded retries on transient errors.

    ``site`` names the call site for the warn-once guard and metric labels
    (e.g. ``"reader.csv"``). The final failure re-raises the original
    exception unchanged so callers' error taxonomy keeps working.
    """
    from ..telemetry.registry import REGISTRY

    max_attempts = attempts if attempts is not None else retry_attempts()
    base = backoff_s if backoff_s is not None else retry_backoff_s()
    for attempt in range(1, max_attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt >= max_attempts:
                REGISTRY.counter(
                    "io_retry_exhausted_total",
                    "Operations that failed after exhausting retries",
                    {"site": site},
                ).inc()
                logger.warning(
                    "giving up on %s after %d attempt(s): %s", site, attempt, e
                )
                raise
            # exponential backoff with half-to-full jitter: delay in
            # [0.5, 1.0] x base*2^(attempt-1); jitter decorrelates a host
            # fleet hammering the same recovering filesystem
            delay = base * (2 ** (attempt - 1)) * (0.5 + rng() / 2.0)
            REGISTRY.counter(
                "io_retries_total", "Transient-failure retries", {"site": site}
            ).inc()
            warn_once(
                logger, _WARN_KEY.format(site),
                "transient failure at %s (attempt %d/%d): %s — retrying in %.2fs; "
                "further retries are counted in io_retries_total without logging",
                site, attempt, max_attempts, e, delay,
            )
            if delay > 0:
                sleep(delay)
