"""Round watchdog and the local abort path.

The port's counterpart of the local half of the JAX package's
``training/watchdog.py``:

* **RoundWatchdog**: a booster-protocol callback plus a monitor thread.
  Every ``after_iteration`` pets it; if no round completes within
  ``SM_ROUND_DEADLINE_S`` the process flushes the checkpoint machinery,
  dumps the flight recorder, emits one ``training.abort`` record and
  hard-exits with ``EXIT_ROUND_DEADLINE`` (79), so the platform restarts
  the job and ``load_checkpoint`` resumes at the last saved round.
* **request_abort**: the one abort path, shared by the watchdog, the
  numeric-poison guard (exit 87) and the device-OOM path (exit 86).
  Idempotent: concurrent triggers flush once and exit once.

The exit is ``os._exit`` from whichever thread asks, because the main
thread may be blocked inside a device call that Python cannot unwind.
The cross-host abort plane (the JAX package's ``start_abort_plane``) comes
with ROADMAP Queue 1 item 9.

Inert by default: no deadline, no thread.
"""

import logging
import os
import threading
import time

from ..constants import EXIT_ROUND_DEADLINE
from ..constants import SM_MODEL_DIR as SM_MODEL_DIR_ENV
from ..telemetry.emit import emit_metric
from ..utils.envconfig import env_float
from . import checkpointing

logger = logging.getLogger(__name__)

ROUND_DEADLINE_ENV = "SM_ROUND_DEADLINE_S"

# test hook: tests replace this to observe the exit instead of dying
_exit = os._exit

_abort_lock = threading.Lock()
_aborting = False


def round_deadline_s():
    return env_float(ROUND_DEADLINE_ENV, 0.0, minimum=0.0)


def request_abort(reason, exit_code, **fields):
    """Flush checkpoints, dump the flight recorder, emit one
    ``training.abort`` record and hard-exit with ``exit_code``.

    Safe from any thread. The first caller wins; later triggers return at
    once, so racing supervisors neither flush twice nor fight over the
    exit code.
    """
    global _aborting
    with _abort_lock:
        if _aborting:
            return
        _aborting = True
    logger.error(
        "ABORTING training (%s, exit code %d): flushing checkpoints and "
        "exiting so the platform can restart and resume", reason, exit_code
    )
    try:
        checkpointing.flush_checkpoints()
    except Exception:
        logger.exception("checkpoint flush during abort failed; exiting anyway")
    # the post-mortem of the hung round: the flight recorder (last finished
    # spans and every open one) into the live checkpoint dir, else the model
    # dir, unless SM_TRACE_EXPORT_DIR names one; SM_TRACE gated, and it
    # never raises
    try:
        from ..telemetry import tracing

        dirs = checkpointing.active_checkpoint_dirs()
        dump_dir = dirs[0] if dirs else (os.environ.get(SM_MODEL_DIR_ENV) or None)
        dump_path = tracing.dump_flight_recorder(
            default_dir=dump_dir, reason=reason, exit_code=exit_code
        )
        if dump_path:
            fields = dict(fields, flight_recorder=dump_path)
    except Exception:
        logger.exception("flight-recorder dump failed; exiting anyway")
    emit_metric("training.abort", reason=reason, exit_code=exit_code, **fields)
    _exit(exit_code)


def _reset_abort_for_tests():
    global _aborting
    with _abort_lock:
        _aborting = False


class RoundWatchdog:
    """Deadline supervisor riding the booster callback protocol.

    ``before_training`` arms it (the first window also covers the kernels'
    build and the binning upload: size ``SM_ROUND_DEADLINE_S`` for it);
    ``after_iteration`` pets it; ``after_training`` disarms it. The monitor
    wakes every deadline/4, so it fires within ~1.25x the deadline.
    """

    def __init__(self, deadline_s, on_expire=None, check_interval=None):
        self.deadline_s = float(deadline_s)
        self.on_expire = on_expire or self._default_expire
        self.check_interval = check_interval or max(self.deadline_s / 4.0, 0.05)
        self._last_pet = None
        self._round = -1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # ----------------------------------------------------- callback protocol
    def before_training(self, model):
        with self._lock:
            self._last_pet = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="round-watchdog")
        self._thread.start()
        logger.info("round watchdog armed: abort if any round exceeds %.1fs", self.deadline_s)
        return model

    def after_iteration(self, model, epoch, evals_log):
        with self._lock:
            self._last_pet = time.monotonic()
            self._round = epoch
        return False

    def after_training(self, model):
        self.stop()
        return model

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------- internals
    def _run(self):
        while not self._stop.wait(self.check_interval):
            with self._lock:
                last, rnd = self._last_pet, self._round
            if last is None:
                continue
            stalled = time.monotonic() - last
            if stalled > self.deadline_s:
                self.on_expire(rnd, stalled)
                return

    def _default_expire(self, last_round, stalled_s):
        logger.error(
            "round watchdog expired: no round completed for %.1fs (deadline %.1fs, "
            "last finished round %d): a device hang or a stalled round",
            stalled_s, self.deadline_s, last_round,
        )
        request_abort(
            "round_deadline",
            EXIT_ROUND_DEADLINE,
            last_round=last_round,
            stalled_s=round(stalled_s, 1),
            deadline_s=self.deadline_s,
        )


def maybe_round_watchdog():
    """-> a RoundWatchdog when ``SM_ROUND_DEADLINE_S`` > 0, else None."""
    deadline = round_deadline_s()
    if deadline <= 0:
        return None
    return RoundWatchdog(deadline)
