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

* **abort plane** (``SM_ABORT_ON_STALE``, or ``SM_ELASTIC``): every
  participating host runs an ``AbortListener``
  (``parallel/distributed.py``); when rank 0's heartbeat aggregator
  declares a host stale it broadcasts one abort frame to every peer and
  aborts itself with ``EXIT_CLUSTER_ABORT`` (80), so the whole cluster exits
  cleanly instead of waiting in a collective. A collective that fails (gloo
  raises when a peer's connection closes) takes the same coordinated abort
  while the plane is up.
* **elastic shrink** (``SM_ELASTIC``, ``training/elastic.py``): rank 0's
  verdict becomes a shrink where the floors allow, carried by ``verb:
  "shrink"`` frames on the same channel, and a failed collective waits for
  that verdict (up to ``SM_REFORM_DRAIN_TIMEOUT_S``) and unwinds the round
  with ``ReformRequested`` instead of exiting 80.
* **local ranks** (``parallel/local.py``): the planes are the leader's; it
  relays its verdicts to its workers (``on_leader_verdict``: a reform, or
  an abort with its exit code). Under ``SM_ELASTIC`` a dead worker is its
  host's death: the leader exits 80 alone and rank 0 shrinks the host away
  (rank 0's own host cannot be survived: exit 80 everywhere, as before);
  during a reform it exits 82.

The exit is ``os._exit`` from whichever thread asks, because the main
thread may be blocked inside a device call or a collective that Python
cannot unwind (``torch.distributed`` waits release the interpreter lock,
so the listener's thread runs while the main thread waits).

Inert by default: no deadline, no thread; ``SM_ABORT_ON_STALE`` and
``SM_ELASTIC`` unset, no listener socket.
"""

import logging
import os
import threading
import time

from ..constants import EXIT_CLUSTER_ABORT, EXIT_REFORM_FAILED, EXIT_ROUND_DEADLINE
from ..constants import SM_MODEL_DIR as SM_MODEL_DIR_ENV
from ..telemetry.emit import emit_metric
from ..utils.envconfig import env_bool, env_float
from . import checkpointing

logger = logging.getLogger(__name__)

ROUND_DEADLINE_ENV = "SM_ROUND_DEADLINE_S"
ABORT_ON_STALE_ENV = "SM_ABORT_ON_STALE"

# test hook: tests replace this to observe the exit instead of dying
_exit = os._exit

_abort_lock = threading.Lock()
_aborting = False


def round_deadline_s():
    return env_float(ROUND_DEADLINE_ENV, 0.0, minimum=0.0)


def abort_on_stale_enabled():
    return env_bool(ABORT_ON_STALE_ENV, False)


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
        # graftlint: disable=capture-env-read not captured: reached from the round only
        # through a failed collective's abort (across ranks, which run eagerly) or the
        # kernels' first build (the eager warm-up round)
        dump_dir = dirs[0] if dirs else (os.environ.get(SM_MODEL_DIR_ENV) or None)
        dump_path = tracing.dump_flight_recorder(
            default_dir=dump_dir, reason=reason, exit_code=exit_code
        )
        if dump_path:
            fields = dict(fields, flight_recorder=dump_path)
    except Exception:
        logger.exception("flight-recorder dump failed; exiting anyway")
    emit_metric("training.abort", reason=reason, exit_code=exit_code, **fields)
    # the host's local ranks go down with it, told the exit code and reaped
    # here (parallel/local.py)
    from ..parallel import local

    local.kill_local_ranks(exit_code)
    _exit(exit_code)


def _reset_abort_for_tests():
    global _aborting
    with _abort_lock:
        _aborting = False
    stop_abort_plane()


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


# ------------------------------------------------------------- abort plane
def _frame_exit_code(msg):
    """Exit code carried by an abort frame, defaulting to the cluster-abort
    code. Bounded to the supervision range (79-99), so that a malformed
    frame cannot make a rank exit 0 (the platform would not restart it)."""
    try:
        code = int(msg.get("exit_code", EXIT_CLUSTER_ABORT))
    except (TypeError, ValueError):
        return EXIT_CLUSTER_ABORT
    return code if 79 <= code <= 99 else EXIT_CLUSTER_ABORT


def on_leader_verdict(msg):
    """A worker's side of its leader's control pipe (``parallel/local.py``):
    ``reform`` arms the relayed reform (the leader's survivors, generation,
    epoch and reason); ``abort`` exits with the leader's code at once, from
    this thread (the main thread may be inside a collective), leaving the
    record, the checkpoint flush and the dumps to the leader."""
    verb = msg.get("verb")
    if verb == "reform":
        from . import elastic

        elastic.request_reform(msg["survivors"], msg.get("reason", "shrink"),
                               generation=msg["generation"], epoch=msg.get("epoch"))
    elif verb == "abort":
        code = _frame_exit_code(msg)
        logger.error("the host's leader is aborting (exit %d); this local rank exits with it",
                     code)
        _exit(code)
    else:
        logger.warning("ignoring an unknown verdict from the leader: %r", msg)


def _on_abort_frame(msg):
    if msg.get("verb") == "shrink":
        # a survivor set, not an exit: the shrink plane takes it (and aborts
        # where this host was itself declared dead)
        from . import elastic

        elastic.on_shrink_frame(msg)
        return
    request_abort(
        str(msg.get("reason", "cluster_abort")),
        _frame_exit_code(msg),
        source=msg.get("source"),
    )


_listener_lock = threading.Lock()
_active_listener = None
_plane_hosts = None   # (sorted participating hosts, this host) while the plane is up


def start_abort_plane(hosts, current_host, port=None):
    """Start this host's abort listener, gated on ``SM_ABORT_ON_STALE`` or
    an armed elastic plane (its shrink frames come over the same channel).

    Every participant, rank 0 included, gets a listener; rank 0 also wires
    its heartbeat aggregator's stale-host detection to
    :func:`handle_stale_host` (``telemetry/cluster.py``). Returns the
    listener, or None when the plane is off or there is one host. The
    active listener is tracked so that :func:`stop_abort_plane` can tear it
    down (a membership reform rebinds it).
    """
    global _active_listener, _plane_hosts
    from . import elastic

    if not (abort_on_stale_enabled() or elastic.is_active()) or len(hosts) <= 1:
        return None
    from ..parallel.distributed import AbortListener

    stop_abort_plane()
    try:
        listener = AbortListener(handler=_on_abort_frame, port=port).start()
    except OSError as e:
        logger.warning(
            "abort listener could not bind (%s); this host will rely on the process "
            "group's timeout instead", e
        )
        return None
    logger.info("abort listener up on port %d (host %s)", listener.port, current_host)
    with _listener_lock:
        _active_listener = listener
        _plane_hosts = (sorted(hosts), current_host)
    return listener


def stop_abort_plane():
    """Stop the tracked abort listener (teardown, test cleanup)."""
    global _active_listener, _plane_hosts
    with _listener_lock:
        listener, _active_listener = _active_listener, None
        _plane_hosts = None
    if listener is not None:
        try:
            listener.stop()
        except Exception:
            logger.exception("error stopping abort listener")


def handle_stale_host(hosts, current_host, stale_rank, stale_host, age_s):
    """Rank 0's decision for a stale host: with the elastic plane armed and
    its floors satisfied, a shrink to the survivors; otherwise the
    coordinated abort (exit 80), as with ``SM_ELASTIC`` unset.

    One transition at a time: a stale verdict while a reform is in flight
    is deferred, not folded in (a second proposal would reuse the
    generation with a survivor set that still holds the first dead host).
    The re-formed cluster's aggregator re-detects a host still dead.
    """
    from . import elastic

    if elastic.is_active() and elastic.pending_reform() is not None:
        logger.warning("stale host %s (rank %d) detected while a membership reform is in "
                       "flight; deferring to the re-formed cluster's aggregator", stale_host,
                       stale_rank)
        return
    survivors = elastic.propose_survivors(stale_host)
    if survivors is not None:
        elastic.coordinate_shrink(survivors, "stale_host", stale_rank=stale_rank,
                                  stale_host=stale_host, age_s=round(age_s, 1))
        return
    coordinate_abort(
        hosts, current_host, "stale_host", peer_addrs=elastic.peer_addrs(),
        stale_rank=stale_rank, stale_host=stale_host, age_s=round(age_s, 1),
    )


def coordinate_abort(
    hosts, current_host, reason, exit_code=EXIT_CLUSTER_ABORT, peer_addrs=None, **fields
):
    """Broadcast one abort frame to every peer, then abort locally.

    ``exit_code`` rides inside the frame, so every rank exits with the same
    code (80 for a stale host or a failed collective). ``peer_addrs``
    optionally maps hosts to (addr, port) pairs (loopback drills).
    """
    from ..parallel.distributed import broadcast_abort

    peers = [h for h in hosts if h != current_host]
    delivered = broadcast_abort(
        peers, reason, source=current_host, exit_code=exit_code, peer_addrs=peer_addrs
    )
    logger.error("coordinated abort (%s): notified %d/%d peers", reason, delivered, len(peers))
    request_abort(reason, exit_code, peers_notified=delivered, **fields)


def on_collective_failure(error):
    """A training-path collective raised: a peer is gone.

    With the elastic plane armed, the death shows here within a fraction of
    a second, before rank 0 can call the host stale: wait up to
    ``SM_REFORM_DRAIN_TIMEOUT_S`` for the shrink verdict and raise
    ``ReformRequested`` out of the round (its partial work is discarded).
    Without a verdict (the plane gave up, or rank 0 itself died: not
    survivable), and with the abort plane up otherwise, the coordinated
    abort (exit 80, the peers told); with no plane, ``PlatformError``, which
    fails the job. A host's worker under the elastic plane waits nothing
    here: it raises the verdict its leader relayed, else
    ``elastic.CollectiveLost``."""
    from ..telemetry.cluster import ROUND_STATE
    from ..toolkit import exceptions as exc
    from . import elastic

    if elastic.is_active() and elastic.is_relay():
        # a host's worker: unwind now, so that supervised_train tears the
        # group down (a peer blocked on this rank then fails too) before it
        # waits for the leader's verdict; one already relayed is raised
        epoch = ROUND_STATE.snapshot()["round"]
        req = elastic.await_reform(0.0, epoch=epoch)
        raise req if req is not None else elastic.CollectiveLost(epoch=epoch)
    with _listener_lock:
        plane = _plane_hosts
    if plane is not None and elastic.is_active():
        wait_s = elastic.drain_timeout_s()
        logger.warning("a collective failed (%s); waiting up to %.0fs for the shrink verdict",
                       str(error)[:200], wait_s)
        req = elastic.await_reform(wait_s, epoch=ROUND_STATE.snapshot()["round"])
        if req is not None:
            raise req
        logger.error("no shrink verdict within %.0fs; taking the coordinated abort", wait_s)
    if plane is not None:
        hosts, current_host = plane
        coordinate_abort(hosts, current_host, "collective_failed",
                         error=str(error)[:400])
        return
    from ..parallel import local

    workers = local.active_local_ranks()
    if workers is not None:
        # a leader whose peer died: its host fails as a dead peer fails it,
        # with a dead worker's error text in the failure file
        deadline = time.monotonic() + 2.0
        while not workers.failures() and time.monotonic() < deadline:
            time.sleep(0.05)
        failed = workers.failures()
        on_local_rank_failure(failed[0][0] if failed else None,
                              failed[0][1] if failed else "a collective failed: {}".format(
                                  str(error)[:400]))
        return
    raise exc.PlatformError(
        "a collective of the process group failed (a peer lost, or ranks out of step)",
        caused_by=error)


_local_failure_lock = threading.Lock()
LOCAL_FAILURE_WAIT_S = 30.0


def on_local_rank_failure(local_rank, message):
    """A local rank of this host died (``parallel/local.py``'s watcher), or
    a collective of the leader failed: the host fails as with a dead peer.
    The failure file gets the first caller's ``message`` (the worker's error
    text: the watcher and a failed collective can report one death at once,
    and the exit must not cut a second write short). Then:

    * during an elastic reform, this host exits 82 (a reform that cannot
      complete with its workers); the other survivors' reforms fail at
      their deadline;
    * under ``SM_ELASTIC`` on a host other than rank 0's, this host alone
      exits 80: rank 0 finds it stale and shrinks it away;
    * otherwise, with the abort plane up, every host is told (exit 80
      everywhere; a dead worker on rank 0's host is a dead master), else
      this host exits 80."""
    from . import elastic
    from .entry import _write_failure_file

    if not _local_failure_lock.acquire(blocking=False):
        # the first caller is taking the process down: do not race it back
        # into the job's own error path (exit 1)
        time.sleep(LOCAL_FAILURE_WAIT_S)
        return
    _write_failure_file(message)
    with _listener_lock:
        plane = _plane_hosts
    if elastic.is_active() and elastic.reform_in_flight():
        pending = elastic.pending_reform()
        request_abort("reform_failed", EXIT_REFORM_FAILED, local_rank=local_rank,
                      generation=pending["generation"] if pending else elastic.generation(),
                      error=message[:400])
        return
    if (plane is not None and elastic.is_active()
            and sorted(plane[0]).index(plane[1]) != 0):
        request_abort("local_rank_failed", EXIT_CLUSTER_ABORT, local_rank=local_rank,
                      error=message[:400])
        return
    if plane is not None:
        hosts, current_host = plane
        coordinate_abort(hosts, current_host, "local_rank_failed", local_rank=local_rank,
                         error=message[:400])
        return
    request_abort("local_rank_failed", EXIT_CLUSTER_ABORT, local_rank=local_rank,
                  error=message[:400])
