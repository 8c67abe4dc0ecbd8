"""Serving lifecycle and request-plane supervision.

One process owns the GPU and the HTTP surface, so it carries the contract
that the MMS / gunicorn front end carries for the SageMaker XGBoost
container:

* **Health state machine**: ``starting -> ready -> degraded -> draining ->
  stopped``, consulted by ``/ping`` on both serving apps. ``degraded`` is
  derived live from the circuit breakers the lifecycle was told about (the
  saturation breaker and the predict watchdog both trip them);
  ``draining`` / ``stopped`` answer 503 + ``Retry-After``, so the load
  balancer deregisters the instance while in-flight work finishes.
* **In-flight latch**: the WSGI middleware reports each request's start and
  finish (finish = the response body written), feeding the
  ``serving_inflight`` gauge and the drain's wait.
* **Request deadlines**: ``SM_REQUEST_DEADLINE_S`` arms a per-request budget
  drawn down by the ``decode`` / ``queue`` / ``predict`` / ``encode``
  stages. Expiry raises :class:`DeadlineExceeded` (a ``TimeoutError``, so
  the saturation handling answers 503 + ``Retry-After`` and feeds the
  breaker) and counts ``serving_deadline_exceeded_total{stage}``.
* **Predict watchdog**: ``SM_PREDICT_STUCK_S`` arms a monitor thread that
  finds a batcher wedged inside one dispatch (a device call that never
  returns: every later request would hang behind it). It trips the
  breaker open, emits one ``serving.stuck`` record with the flight
  recorder's spans, and per ``SM_PREDICT_STUCK_ACTION`` sheds until the
  dispatch returns (``shed``, the default) or exits with
  ``EXIT_PREDICT_STUCK`` so the platform restarts a clean process
  (``abort``).

Every knob is resolved once, when the lifecycle is built, and everything is
inert by default: no deadline knob, no per-request clock reads; no stuck
knob, no monitor thread; no lifecycle installed (apps built directly in
tests), every hook below a no-op. Knob names, states, series and records
are the JAX package's.
"""

import logging
import os
import threading
import time

from ..constants import EXIT_PREDICT_STUCK
from ..constants import SM_MODEL_DIR as SM_MODEL_DIR_ENV
from ..telemetry import tracing
from ..telemetry import wsgi as telemetry_wsgi
from ..telemetry.emit import emit_metric
from ..telemetry.registry import REGISTRY
from ..utils.envconfig import env_bool, env_float
from .breaker import SHED_COOLDOWN_ENV

logger = logging.getLogger(__name__)

GRACEFUL_DRAIN_ENV = "SM_GRACEFUL_DRAIN"
DRAIN_TIMEOUT_ENV = "SM_DRAIN_TIMEOUT_S"
REQUEST_DEADLINE_ENV = "SM_REQUEST_DEADLINE_S"
PREDICT_STUCK_ENV = "SM_PREDICT_STUCK_S"
PREDICT_STUCK_ACTION_ENV = "SM_PREDICT_STUCK_ACTION"

STARTING, READY, DEGRADED, DRAINING, STOPPED = (
    "starting", "ready", "degraded", "draining", "stopped")

#: ``serving_state`` gauge encoding
_STATE_GAUGE = {STARTING: 0.0, READY: 1.0, DEGRADED: 2.0, DRAINING: 3.0, STOPPED: 4.0}

_STUCK_ACTIONS = ("shed", "abort")

#: request budget stages (the closed label set of the deadline counter)
STAGES = ("decode", "queue", "predict", "encode")

# test hook: tests replace it to observe the exit instead of dying
_exit = os._exit

_abort_lock = threading.Lock()
_aborting = False


def _stuck_action():
    raw = (os.getenv(PREDICT_STUCK_ACTION_ENV) or "shed").strip().lower()
    if raw not in _STUCK_ACTIONS:
        logger.warning("ignoring malformed %s=%r (expected one of %s); using 'shed'",
                       PREDICT_STUCK_ACTION_ENV, raw, _STUCK_ACTIONS)
        return "shed"
    return raw


class DeadlineExceeded(TimeoutError):
    """A request used up its ``SM_REQUEST_DEADLINE_S`` budget in ``stage``.

    A ``TimeoutError``: the invocation paths already turn batcher timeouts
    into 503 + ``Retry-After`` and feed the breaker, and a deadline expiry
    is the same saturation protocol, attributed to a stage.
    """

    def __init__(self, stage, budget_s):
        super().__init__("request deadline exceeded in stage {!r} (budget {:.3f}s)".format(
            stage, budget_s))
        self.stage = stage
        self.budget_s = budget_s


def note_deadline_exceeded(stage, registry=None):
    """Count one deadline expiry of ``stage`` (labels bounded by STAGES)."""
    (registry or REGISTRY).counter(
        "serving_deadline_exceeded_total",
        "Requests that blew the SM_REQUEST_DEADLINE_S budget, by stage",
        {"stage": stage if stage in STAGES else "other"},
    ).inc()


def expire(stage, budget_s, registry=None):
    """Count and raise a :class:`DeadlineExceeded` for ``stage``."""
    note_deadline_exceeded(stage, registry=registry)
    raise DeadlineExceeded(stage, budget_s)


class RequestDeadline:
    """One request's time budget, drawn down across its stages: each stage
    gets what is left when it runs (a slow decode leaves less for predict).
    ``check(stage)`` raises once the budget is gone; ``remaining()`` bounds
    blocking waits (the batcher's queue wait)."""

    __slots__ = ("budget_s", "_deadline", "_clock")

    def __init__(self, budget_s, clock=time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._deadline = clock() + self.budget_s

    def remaining(self):
        return max(0.0, self._deadline - self._clock())

    def expired(self):
        return self._clock() >= self._deadline

    def check(self, stage):
        if self.expired():
            expire(stage, self.budget_s)


class PredictWatchdog:
    """Monitor thread finding a batcher wedged inside one dispatch.

    It polls each registered batcher's :meth:`dispatch_age_s`. One stuck
    episode:

    * trips the batcher's breaker open on every check while stuck (the
      cooldown restarts, so ``/ping`` stays 503 and new requests shed
      instead of queueing behind the wedge);
    * emits one ``serving.stuck`` record with the flight-recorder dump
      (when ``SM_TRACE`` is on);
    * with ``action='abort'``, exits with ``EXIT_PREDICT_STUCK``.

    When the dispatch returns, the episode ends with a log line and the
    breaker recovers through its half-open probe.
    """

    def __init__(self, stuck_s, action="shed", check_interval=None, clock=time.monotonic):
        self.stuck_s = float(stuck_s)
        self.action = action
        if check_interval is None:
            # the re-forced breaker keeps /ping unready while stuck: checking
            # less often than its cooldown would let it half-open between
            # checks and flap a wedged instance back into rotation
            cooldown = env_float(SHED_COOLDOWN_ENV, 5.0, minimum=0.1, maximum=3600.0)
            check_interval = min(self.stuck_s / 4.0, cooldown / 2.0)
        self.check_interval = max(check_interval, 0.05)
        self._clock = clock
        self._lock = threading.Lock()
        self._targets = {}   # name -> (batcher, breaker)
        self._stuck = set()  # names in a stuck episode (log and record once)
        self._stop = threading.Event()
        self._thread = None

    def register(self, name, batcher, breaker=None):
        with self._lock:
            self._targets[name] = (batcher, breaker)
        # the batcher times its dispatches only while watched
        batcher.watched = True
        self.start()

    def unregister(self, name):
        with self._lock:
            batcher, _ = self._targets.pop(name, (None, None))
            self._stuck.discard(name)
        if batcher is not None:
            batcher.watched = False

    def start(self):
        with self._lock:
            if self._thread is not None:
                return self
            # a fresh event per thread: a start() after stop() must not
            # inherit the set event, and the old thread keeps its own
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._run, args=(self._stop,), daemon=True,
                                            name="predict-watchdog")
            self._thread.start()
        logger.info("predict watchdog armed: %s after a dispatch exceeds %.1fs", self.action,
                    self.stuck_s)
        return self

    def stop(self):
        with self._lock:
            stop_event = self._stop
            thread, self._thread = self._thread, None
        stop_event.set()
        if thread is not None:
            thread.join(timeout=5.0)

    def _run(self, stop_event):
        while not stop_event.wait(self.check_interval):
            try:
                self.check_once()
            except Exception:
                logger.exception("predict watchdog check failed; continuing")

    def check_once(self):
        with self._lock:
            targets = dict(self._targets)
        for name, (batcher, breaker) in targets.items():
            age = batcher.dispatch_age_s()
            if age is not None and age > self.stuck_s:
                self._handle_stuck(name, batcher, breaker, age)
            else:
                with self._lock:
                    was_stuck = name in self._stuck
                    self._stuck.discard(name)
                if was_stuck:
                    logger.warning("predict dispatch on batcher %r returned after a stuck "
                                   "episode; breaker recovers via its half-open probe", name)

    def _handle_stuck(self, name, batcher, breaker, age):
        with self._lock:
            first = name not in self._stuck
            self._stuck.add(name)
        if breaker is not None:
            breaker.force_open("predict_stuck")
        if not first:
            if self.action == "abort":
                self._abort(name, age, dump=None)
            return
        requests, rows = batcher.dispatch_info()
        logger.error("predict dispatch STUCK on batcher %r: one dispatch has run %.1fs "
                     "(> %.1fs deadline, %d request(s) / %d row(s) aboard); action=%s",
                     name, age, self.stuck_s, requests, rows, self.action)
        dump = tracing.dump_flight_recorder(
            default_dir=os.environ.get(SM_MODEL_DIR_ENV) or None, reason="predict_stuck")
        fields = {"batcher": name, "stuck_s": round(age, 1), "deadline_s": self.stuck_s,
                  "requests": requests, "rows": rows, "action": self.action}
        if dump:
            fields["flight_recorder"] = dump
        emit_metric("serving.stuck", **fields)
        if self.action == "abort":
            self._abort(name, age, dump=dump)

    def _abort(self, name, age, dump=None):
        abort_serving("predict_stuck", EXIT_PREDICT_STUCK, batcher=name, stuck_s=round(age, 1),
                      flight_recorder=dump)


def abort_serving(reason, exit_code, **fields):
    """Dump the flight recorder, emit one ``serving.abort`` record and exit
    the process. Safe from any thread; the first caller wins (a drain timing
    out while the watchdog aborts must not fight over the exit code)."""
    global _aborting
    with _abort_lock:
        if _aborting:
            return
        _aborting = True
    logger.error("ABORTING serving (%s, exit code %d): the platform restarts a clean instance",
                 reason, exit_code)
    try:
        if not fields.get("flight_recorder"):
            fields["flight_recorder"] = tracing.dump_flight_recorder(
                default_dir=os.environ.get(SM_MODEL_DIR_ENV) or None, reason=reason,
                exit_code=exit_code)
    except Exception:
        logger.exception("flight-recorder dump failed; exiting anyway")
    fields = {k: v for k, v in fields.items() if v is not None}
    emit_metric("serving.abort", reason=reason, exit_code=exit_code, **fields)
    _exit(exit_code)


def _reset_abort_for_tests():
    global _aborting
    with _abort_lock:
        _aborting = False


class ServingLifecycle:
    """The serving process's health state machine and in-flight latch. One
    a server process, installed with :func:`install`."""

    def __init__(self, registry=None, clock=time.monotonic):
        self.graceful_drain = env_bool(GRACEFUL_DRAIN_ENV, True)
        self.drain_timeout_s = env_float(DRAIN_TIMEOUT_ENV, 30.0, minimum=0.0, maximum=3600.0)
        self.request_deadline_s = env_float(REQUEST_DEADLINE_ENV, 0.0, minimum=0.0,
                                            maximum=3600.0)
        self.predict_stuck_s = env_float(PREDICT_STUCK_ENV, 0.0, minimum=0.0, maximum=3600.0)
        self.predict_stuck_action = _stuck_action()
        self._clock = clock
        self._cond = threading.Condition()
        self._publish_lock = threading.Lock()
        self._base_state = STARTING
        self._last_published = STARTING
        self._inflight = 0
        self._breakers = []
        reg = registry or REGISTRY
        self._m_inflight = reg.gauge(
            "serving_inflight", "In-flight HTTP requests (response not yet fully written)")
        self._m_state = reg.gauge(
            "serving_state",
            "Lifecycle state (0 starting, 1 ready, 2 degraded, 3 draining, 4 stopped)")
        self._m_drain = reg.gauge(
            "serving_drain_seconds",
            "Duration of the last SIGTERM drain (set when the drain settles)")
        self._m_inflight.set(0.0)
        self._m_state.set(_STATE_GAUGE[STARTING])
        self.watchdog = None
        if self.predict_stuck_s > 0:
            self.watchdog = PredictWatchdog(self.predict_stuck_s,
                                            action=self.predict_stuck_action)

    # ----------------------------------------------------------- state plane
    @property
    def state(self):
        """The effective state, ``degraded`` derived live from the breakers.
        Reading it publishes it (gauge and one ``serving.lifecycle`` record
        per change): the load balancer's /ping polls surface ready <->
        degraded flips."""
        return self._publish_state()

    def _publish_state(self):
        # derive and publish under one lock hold, so a late publisher
        # converges on the current state instead of overwriting it
        with self._publish_lock:
            with self._cond:
                base = self._base_state
            effective = base
            if base == READY and any(b.degraded for b in self._breakers):
                effective = DEGRADED
            prev, self._last_published = self._last_published, effective
            if prev != effective:
                self._m_state.set(_STATE_GAUGE[effective])
                emit_metric("serving.lifecycle", state=effective, prev=prev)
                logger.info("serving lifecycle: %s -> %s", prev, effective)
            return effective

    @property
    def accepting(self):
        """False once draining or stopped: /ping and new work get 503. One
        attribute read, taken without the lock: every request asks."""
        return self._base_state not in (DRAINING, STOPPED)

    def note_breaker(self, breaker):
        """Tell the lifecycle about a breaker feeding the degraded state."""
        if breaker is not None and breaker not in self._breakers:
            self._breakers.append(breaker)

    def _set_state(self, state, only_from=None):
        """Move the base state; ``only_from`` makes it a compare-and-set, so
        a mark_ready racing a SIGTERM never overwrites DRAINING. -> the
        previous state, or None when the guard refused."""
        with self._cond:
            if only_from is not None and self._base_state not in only_from:
                return None
            prev, self._base_state = self._base_state, state
        self._publish_state()
        return prev

    def mark_ready(self):
        """First model load: ``starting -> ready`` (idempotent; a load that
        completes mid-drain never un-drains)."""
        self._set_state(READY, only_from=(STARTING,))

    def begin_drain(self):
        """Stop accepting. -> False when already draining or stopped."""
        return self._set_state(DRAINING, only_from=(STARTING, READY)) is not None

    def mark_stopped(self):
        self._set_state(STOPPED)

    # -------------------------------------------------------- in-flight latch
    def request_started(self):
        with self._cond:
            self._inflight += 1
            self._m_inflight.set(float(self._inflight))

    def request_finished(self):
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            self._m_inflight.set(float(self._inflight))
            self._cond.notify_all()

    @property
    def inflight(self):
        with self._cond:
            return self._inflight

    def wait_drained(self, timeout):
        """Block until nothing is in flight. -> False on timeout."""
        deadline = self._clock() + max(0.0, timeout)
        with self._cond:
            while self._inflight > 0:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def observe_drain_seconds(self, seconds):
        self._m_drain.set(round(seconds, 3))

    # ------------------------------------------------------------- deadlines
    def request_deadline(self):
        """-> a fresh :class:`RequestDeadline`, or None when the knob is off."""
        if self.request_deadline_s <= 0:
            return None
        return RequestDeadline(self.request_deadline_s, clock=self._clock)

    # -------------------------------------------------------------- watchdog
    def register_batcher(self, name, batcher, breaker=None):
        self.note_breaker(breaker)
        if self.watchdog is not None:
            self.watchdog.register(name, batcher, breaker)

    def unregister_batcher(self, name):
        if self.watchdog is not None:
            self.watchdog.unregister(name)

    def shutdown(self):
        """Stop the threads this lifecycle owns."""
        if self.watchdog is not None:
            self.watchdog.stop()


# ------------------------------------------------------- module-level install
_install_lock = threading.Lock()
_current = None


def install(lifecycle):
    """Make ``lifecycle`` the process's active lifecycle and wire it as the
    WSGI in-flight tracker. Returns it."""
    global _current
    with _install_lock:
        _current = lifecycle
    telemetry_wsgi.set_request_tracker(lifecycle)
    emit_metric("serving.lifecycle", state=lifecycle.state, prev=None)
    return lifecycle


def uninstall():
    """Clear the active lifecycle and stop its threads; returns it."""
    global _current
    with _install_lock:
        lifecycle, _current = _current, None
    telemetry_wsgi.set_request_tracker(None)
    if lifecycle is not None:
        lifecycle.shutdown()
    return lifecycle


def current():
    return _current


# each hook is a no-op without an installed lifecycle, so apps built
# directly behave as they would without the plane
def mark_ready():
    lifecycle = _current
    if lifecycle is not None:
        lifecycle.mark_ready()


def accepting():
    lifecycle = _current
    return True if lifecycle is None else lifecycle.accepting


def observe(breaker=None):
    """Publish the effective state from a readiness poll; ``breaker`` is
    noted first (apps are often built before a lifecycle is installed).
    -> the state, or None without a lifecycle."""
    lifecycle = _current
    if lifecycle is None:
        return None
    if breaker is not None:
        lifecycle.note_breaker(breaker)
    return lifecycle.state


def request_deadline():
    lifecycle = _current
    return None if lifecycle is None else lifecycle.request_deadline()


def register_batcher(name, batcher, breaker=None):
    lifecycle = _current
    if lifecycle is not None:
        lifecycle.register_batcher(name, batcher, breaker)


def unregister_batcher(name):
    lifecycle = _current
    if lifecycle is not None:
        lifecycle.unregister_batcher(name)
