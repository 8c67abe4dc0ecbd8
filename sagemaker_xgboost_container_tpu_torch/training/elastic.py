"""Elastic shrink-to-continue: survivor re-rendezvous and resharded resume.

The port's counterpart of the JAX package's ``training/elastic.py``, over
``torch.distributed``. Without it a host that is truly gone fails the job
with the coordinated abort (exit 80), and the restarted job waits at the
rendezvous for a peer that no longer exists. With ``SM_ELASTIC=1``:

1. **Detection -> shrink decision.** When rank 0's heartbeat aggregator
   declares a host stale (``telemetry/cluster.py``), the decision hook
   (``training/watchdog.handle_stale_host``) asks this module: with the
   floors satisfied (``SM_ELASTIC_MIN_HOSTS`` survivors left, fewer than
   ``SM_ELASTIC_MAX_SHRINKS`` shrinks so far) rank 0 *proposes a survivor
   set* instead of the exit 80.
2. **Shrink fan-out.** The proposal rides the abort channel: one frame a
   member carrying ``verb: "shrink"``, the survivors and the next
   *generation*, so the listener's duplicate suppression delivers one
   reform a generation.
3. **Drain.** In the port a dead peer shows first as a failed collective
   (gloo raises when its connection closes), long before the heartbeat
   verdict: ``watchdog.on_collective_failure`` waits for the verdict and
   raises :class:`ReformRequested` out of the round, whose partial work is
   discarded. A verdict that arrives between rounds is drained at the round
   boundary by :class:`ElasticMembershipCallback`. Either way the loop
   unwinds to :func:`supervised_train`.
4. **Re-rendezvous.** Each survivor tears its heartbeat, abort and
   process-group planes down, and re-runs the bounded rendezvous handshake
   over the survivors (``parallel/distributed.reform_cluster``, fault point
   ``rendezvous.reform``). A reform that cannot complete aborts the
   survivor with ``EXIT_REFORM_FAILED`` (82) and a flight-recorder dump.
5. **Resharded resume.** The caller's re-wiring hook re-forms the process
   group over the survivors and agrees one resume point (the entry point's
   ``algorithm_train._agree_resume_point``), and its ``train_once`` rebuilds
   the callbacks and the session over the new group. ``validate_resume``
   accepts the world-size change because this module records it: an
   append-only ``membership_log`` stamped into every later checkpoint
   manifest.

With local ranks (``SM_LOCAL_RANKS``, ``parallel/local.py``) the planes
stay one a host, in its leader; a host's workers register the membership
in *relay* mode (the leader's config snapshot, no listener). A worker whose
collective fails unwinds at once with :class:`CollectiveLost` and tears its
process group down (a peer blocked on it then fails too, instead of
waiting out the collective timeout), then waits for its leader's verdict.
The leader relays the verdict over the workers' control pipes once the
survivors' rendezvous has committed; every rank then re-forms the group as
global rank new host index x L + local rank, L fixed across reforms. Each
reform runs under a deadline (``SM_REFORM_TIMEOUT_S``): a reform that
cannot complete with the workers exits 82 on every survivor.

Inert by default: ``SM_ELASTIC`` unset means no callback, no state, and
the same kill still ends in the coordinated exit 80.
"""

import logging
import threading
import time

from ..constants import EXIT_CLUSTER_ABORT, EXIT_REFORM_FAILED
from ..telemetry import REGISTRY
from ..telemetry.emit import emit_metric
from ..utils.envconfig import env_bool, env_float, env_int

logger = logging.getLogger(__name__)

ELASTIC_ENV = "SM_ELASTIC"
ELASTIC_MIN_HOSTS_ENV = "SM_ELASTIC_MIN_HOSTS"
ELASTIC_MAX_SHRINKS_ENV = "SM_ELASTIC_MAX_SHRINKS"
REFORM_TIMEOUT_ENV = "SM_REFORM_TIMEOUT_S"
REFORM_DRAIN_TIMEOUT_ENV = "SM_REFORM_DRAIN_TIMEOUT_S"


class ElasticConfig:
    """The elastic knobs, resolved once at registration
    (``register_cluster``), so that no decision reads the environment
    mid-job."""

    def __init__(self, enabled, min_hosts, max_shrinks, reform_timeout_s, drain_timeout_s):
        self.enabled = bool(enabled)
        self.min_hosts = int(min_hosts)
        self.max_shrinks = int(max_shrinks)
        self.reform_timeout_s = float(reform_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)

    def __repr__(self):
        return ("ElasticConfig(enabled={}, min_hosts={}, max_shrinks={}, "
                "reform_timeout_s={}, drain_timeout_s={})".format(
                    self.enabled, self.min_hosts, self.max_shrinks, self.reform_timeout_s,
                    self.drain_timeout_s))


def resolve_elastic_config():
    """Read the elastic knobs (clamped, warn-once via envconfig)."""
    return ElasticConfig(
        enabled=env_bool(ELASTIC_ENV, False),
        min_hosts=env_int(ELASTIC_MIN_HOSTS_ENV, 1, minimum=1),
        max_shrinks=env_int(ELASTIC_MAX_SHRINKS_ENV, 2, minimum=0, maximum=64),
        reform_timeout_s=env_float(REFORM_TIMEOUT_ENV, 60.0, minimum=1.0, maximum=3600.0),
        drain_timeout_s=env_float(REFORM_DRAIN_TIMEOUT_ENV, 300.0, minimum=1.0, maximum=7200.0),
    )


class ReformRequested(Exception):
    """Raised out of a round (``watchdog.on_collective_failure``) or at a
    round boundary (:class:`ElasticMembershipCallback`) to unwind the
    training loop for a membership reform; never escapes
    :func:`supervised_train`."""

    def __init__(self, survivors, reason, generation, epoch=None):
        self.survivors = sorted(survivors)
        self.reason = str(reason)
        self.generation = int(generation)
        self.epoch = epoch
        super(ReformRequested, self).__init__(
            "membership reform requested (generation {}, reason {}): survivors {}".format(
                generation, reason, self.survivors))


class CollectiveLost(ReformRequested):
    """Raised out of a worker's failed collective before any verdict
    (``watchdog.on_collective_failure``): :func:`supervised_train` tears
    the process group down, then waits for the leader's relayed verdict."""

    def __init__(self, epoch=None):
        super(CollectiveLost, self).__init__([], "collective_lost", 0, epoch=epoch)


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.hosts = None
        self.current_host = None
        self.config = None
        self.peer_addrs = None  # {host: (addr, port)}: loopback drills only
        self.generation = 0
        self.shrinks = 0
        self.membership_log = []
        self.pending = None
        self.draining = False  # a reform is past the drain (being executed)
        self.drain_timer = None
        self.relay = False     # a host's worker: its leader relays the verdicts
        self.reforming = False  # perform_reform is running
        self.reform_timer = None


_state = _State()


def register_cluster(hosts, current_host, config=None, peer_addrs=None, relay=False):
    """Record the membership and resolve the elastic knobs; once at
    start-up on every participant (``algorithm_train._pre_exec``). A host's
    worker registers with ``relay`` and its leader's ``config``: it decides
    nothing and takes its verdicts from its leader
    (``algorithm_train.run_local_rank``)."""
    with _state.lock:
        _state.hosts = sorted(hosts)
        _state.current_host = current_host
        _state.config = config if config is not None else resolve_elastic_config()
        _state.peer_addrs = dict(peer_addrs) if peer_addrs else None
        _state.relay = bool(relay)
        world = len(_state.hosts)
        cfg = _state.config
    REGISTRY.gauge("cluster_world_size",
                   "Hosts in the current (possibly shrunken) membership").set(world)
    if cfg.enabled:
        logger.info("elastic membership armed: world size %d, floor %d host(s), at most %d "
                    "shrink(s), reform deadline %.0fs", world, cfg.min_hosts, cfg.max_shrinks,
                    cfg.reform_timeout_s)
    return cfg


def _reset_for_tests():
    global _state
    with _state.lock:
        timers = (_state.drain_timer, _state.reform_timer)
    for timer in timers:
        if timer is not None:
            timer.cancel()
    _state = _State()


def is_active():
    with _state.lock:
        return (_state.hosts is not None and _state.config is not None
                and _state.config.enabled)


def is_relay():
    """True in a host's worker registered in relay mode."""
    with _state.lock:
        return _state.relay


def reform_in_flight():
    """True from a verdict's arrival until its reform has completed."""
    with _state.lock:
        return _state.pending is not None or _state.reforming


def current_hosts():
    with _state.lock:
        return list(_state.hosts) if _state.hosts else None


def world_size():
    with _state.lock:
        return len(_state.hosts) if _state.hosts else 0


def generation():
    with _state.lock:
        return _state.generation


def drain_timeout_s():
    """The armed config's drain deadline (``SM_REFORM_DRAIN_TIMEOUT_S``)."""
    with _state.lock:
        return _state.config.drain_timeout_s if _state.config is not None else 300.0


def membership_log():
    """The append-only transition log (copies): one entry a completed
    shrink, stamped into every later checkpoint manifest."""
    with _state.lock:
        return [dict(t) for t in _state.membership_log]


def peer_addrs():
    """{host: (addr, port)} override map of loopback drills, or None."""
    with _state.lock:
        return dict(_state.peer_addrs) if _state.peer_addrs else None


# ----------------------------------------------------------- shrink decision
def propose_survivors(stale_host):
    """Rank 0's shrink proposal for a stale host, or None where the
    coordinated abort applies. Reads only the resolved config."""
    with _state.lock:
        hosts = list(_state.hosts or [])
        cfg = _state.config
        shrinks = _state.shrinks
    if cfg is None or not cfg.enabled:
        return None
    if stale_host not in hosts:
        logger.info("elastic: stale host %s is not in the current membership %s (already "
                    "shrunk away); ignoring", stale_host, hosts)
        return None
    survivors = [h for h in hosts if h != stale_host]
    if len(survivors) < cfg.min_hosts:
        logger.warning("elastic: cannot shrink below the %d-host floor (%s survivors would "
                       "remain); falling back to the coordinated abort", cfg.min_hosts,
                       len(survivors))
        return None
    if shrinks >= cfg.max_shrinks:
        logger.warning("elastic: shrink budget exhausted (%d of %d); falling back to the "
                       "coordinated abort", shrinks, cfg.max_shrinks)
        return None
    return survivors


def coordinate_shrink(survivors, reason, epoch=None, **fields):
    """Rank 0: fan the proposal out over the abort channel, then arm the
    local reform -> the pending request.

    The frame goes to every current member but this host: survivors
    re-form, and an excluded host that is alive after all (a false stale)
    learns it was declared dead and exits 80 through
    :func:`on_shrink_frame`.
    """
    from ..parallel.distributed import broadcast_abort

    with _state.lock:
        current_host = _state.current_host
        hosts = list(_state.hosts or [])
        gen = _state.generation + 1
        addrs = dict(_state.peer_addrs or {}) or None
    extra = {"verb": "shrink", "survivors": sorted(survivors), "generation": gen}
    peers = [h for h in hosts if h != current_host]
    delivered = broadcast_abort(peers, reason, source=current_host, extra=extra,
                                peer_addrs=addrs)
    logger.warning("elastic shrink (generation %d, reason %s): notified %d/%d members; "
                   "dropping to world size %d", gen, reason, delivered, len(peers),
                   len(survivors))
    request_reform(survivors, reason, generation=gen, epoch=epoch, **fields)
    return pending_reform()


def on_shrink_frame(msg):
    """A survivor's side of the fan-out (from ``watchdog._on_abort_frame``
    for frames with the shrink verb)."""
    survivors = msg.get("survivors")
    if not isinstance(survivors, list) or not survivors:
        logger.warning("elastic: ignoring shrink frame without survivors: %r", msg)
        return
    with _state.lock:
        current_host = _state.current_host
    if current_host is not None and current_host not in survivors:
        # the proposer declared this host dead: there is no membership to
        # continue in, so exit as the coordinated abort does
        from . import watchdog

        logger.error("elastic: shrink frame excludes this host (%s not in %s); aborting "
                     "with the cluster exit code", current_host, survivors)
        watchdog.request_abort("shrunk_away", EXIT_CLUSTER_ABORT, source=msg.get("source"))
        return
    request_reform(survivors, msg.get("reason", "shrink"), generation=msg.get("generation"))


def request_reform(survivors, reason, generation=None, epoch=None, **fields):
    """Arm a pending reform; idempotent a generation (a duplicate or a past
    generation is a logged no-op). Thread-safe: the callers are rank 0's
    aggregator thread and the abort listener's thread; the training thread
    consumes it (:func:`pending_reform`)."""
    with _state.lock:
        if _state.hosts is None:
            logger.warning("elastic: reform requested but no cluster is registered; ignoring")
            return False
        gen = int(generation) if generation is not None else _state.generation + 1
        if gen <= _state.generation:
            logger.info("elastic: ignoring reform request for past generation %d (current "
                        "%d)", gen, _state.generation)
            return False
        if _state.pending is not None and _state.pending["generation"] >= gen:
            logger.info("elastic: reform already pending (generation %d); ignoring duplicate "
                        "request", _state.pending["generation"])
            return False
        _state.pending = {"survivors": sorted(survivors), "reason": str(reason),
                          "generation": gen, "epoch": epoch}
        _state.pending.update(fields)
        _state.draining = False
        drain_timeout = _state.config.drain_timeout_s if _state.config is not None else 300.0
        # the drain deadline: a survivor wedged inside a collective never
        # reaches a drain point; without this timer the elastic gate would
        # turn the fail-fast exit 80 into a hang. perform_reform disarms it
        timer = threading.Timer(drain_timeout, _drain_deadline_expired, args=(gen,))
        timer.daemon = True
        _state.drain_timer = timer
    timer.start()
    logger.warning("elastic: reform armed (generation %d, reason %s); the training loop drains "
                   "and re-rendezvous as %s (coordinated abort if the drain takes more than "
                   "%.0fs)", gen, reason, sorted(survivors), drain_timeout)
    return True


def _drain_deadline_expired(generation_armed):
    """Timer body: the reform armed at ``generation_armed`` was never
    consumed; this survivor is stuck and takes the coordinated abort, as
    with ``SM_ELASTIC`` unset."""
    with _state.lock:
        stale = (_state.pending is not None
                 and _state.pending["generation"] == generation_armed
                 and not _state.draining)
    if not stale:
        return
    from . import watchdog

    logger.error("elastic: reform (generation %d) was never drained within the deadline; "
                 "demoting the shrink to the coordinated abort", generation_armed)
    watchdog.request_abort("reform_drain_timeout", EXIT_CLUSTER_ABORT,
                           generation=generation_armed)


def pending_reform():
    with _state.lock:
        return dict(_state.pending) if _state.pending is not None else None


def await_reform(timeout_s, epoch=None, poll_s=0.05):
    """Wait up to ``timeout_s`` for a pending reform -> the
    :class:`ReformRequested` to raise, or None. The port's drain of a failed
    collective (``watchdog.on_collective_failure``): the collective fails
    within a fraction of a second of the peer's death, the shrink verdict
    comes once the heartbeats go stale. ``epoch``: the last round this rank
    committed, recorded where the verdict names none."""
    deadline = time.monotonic() + timeout_s
    while True:
        req = pending_reform()
        if req is not None:
            return ReformRequested(
                req["survivors"], req["reason"], req["generation"],
                epoch=req["epoch"] if req.get("epoch") is not None else epoch)
        if time.monotonic() >= deadline:
            return None
        time.sleep(poll_s)


# ------------------------------------------------------------ training hooks
class ElasticMembershipCallback:
    """Booster-protocol callback: the round-boundary drain point. It sits
    after the checkpoint saver, so the round that just finished lands on
    disk before the loop unwinds."""

    def after_iteration(self, model, epoch, evals_log):
        req = pending_reform()
        if req is not None:
            # a relayed verdict carries its leader's epoch
            raise ReformRequested(req["survivors"], req["reason"], req["generation"],
                                  epoch=req["epoch"] if req.get("epoch") is not None else epoch)
        return False


def maybe_elastic_callback():
    """-> an ElasticMembershipCallback when the plane is armed, else None."""
    return ElasticMembershipCallback() if is_active() else None


def drain_callbacks(callbacks):
    """Stop every thread-owning callback of a stack a reform abandoned (the
    round watchdog's monitor, the checkpoint deleter), so that the old
    generation can neither fire a stale exit 79 nor hold the checkpoint
    dir."""
    for cb in callbacks or []:
        inner = getattr(cb, "inner", cb)
        stop = getattr(inner, "stop", None)
        if callable(stop):
            try:
                stop()
            except Exception:
                logger.exception("elastic drain: error stopping %r", inner)


# ------------------------------------------------------------------- reform
def perform_reform(req, on_reform=None, master_addr=None, port=None):
    """Execute one membership reform on the training thread: the drain
    (planes and the process group torn down), the retried survivor
    re-rendezvous, the commit (membership, generation, the transition
    record, telemetry, the consensus membership), then
    ``on_reform(new_hosts, current_host)``, the caller's re-wiring (the new
    process group, the planes, the agreed resume point). Any failure aborts
    this survivor with ``EXIT_REFORM_FAILED`` (82); the re-raise covers
    tests that fake the exit."""
    from ..telemetry.tracing import trace_span

    with _state.lock:
        current_host = _state.current_host
        cfg = _state.config
        old_hosts = list(_state.hosts or [])
        relay = _state.relay
        # this rank drained and is executing the reform: disarm the
        # wedged-drain demotion, and bound the reform itself
        _state.draining = True
        _state.reforming = True
        timer, _state.drain_timer = _state.drain_timer, None
        deadline = cfg.reform_timeout_s if cfg else 60.0
        reform_timer = threading.Timer(deadline, _reform_deadline_expired,
                                       args=(req.generation, deadline))
        reform_timer.daemon = True
        _state.reform_timer = reform_timer
    if timer is not None:
        timer.cancel()
    reform_timer.start()
    reason = req.reason
    try:
        with trace_span("cluster.reform", attributes={
                "generation": req.generation, "reason": reason,
                "old_world_size": len(old_hosts), "new_world_size": len(req.survivors)}):
            with trace_span("reform.drain"):
                _teardown_planes()
            cluster = None
            if not relay:
                # a worker's leader has already met the other survivors
                with trace_span("reform.rendezvous"):
                    from ..parallel.distributed import reform_cluster

                    cluster, _membership = reform_cluster(
                        req.survivors, current_host, req.generation,
                        timeout=cfg.reform_timeout_s if cfg else 60.0,
                        master_addr=master_addr, port=port)
            transition = _commit_transition(req, old_hosts)
            if not relay:
                # one record a host, its leader's
                emit_metric("training.membership", **transition)
            REGISTRY.counter("elastic_shrink_total",
                             "Completed shrink-to-continue membership transitions",
                             {"reason": reason}).inc()
            REGISTRY.gauge("cluster_world_size",
                           "Hosts in the current (possibly shrunken) membership").set(
                               len(req.survivors))
            from . import consensus

            consensus.register_cluster(req.survivors, current_host)
            if on_reform is not None:
                on_reform(list(req.survivors), current_host)
        _end_reform()
        logger.warning("elastic: reform complete; training continues at world size %d "
                       "(generation %d)", len(req.survivors), req.generation)
        return cluster
    except Exception as e:
        _end_reform()
        logger.exception("elastic: reform FAILED at generation %d (%s); aborting this "
                         "survivor with exit %d: a restart resumes at the old membership",
                         req.generation, e, EXIT_REFORM_FAILED)
        from . import watchdog

        watchdog.request_abort("reform_failed", EXIT_REFORM_FAILED, generation=req.generation,
                               survivors=list(req.survivors), error=str(e)[:400])
        raise


def _end_reform():
    with _state.lock:
        _state.reforming = False
        timer, _state.reform_timer = _state.reform_timer, None
    if timer is not None:
        timer.cancel()


def _reform_deadline_expired(generation_armed, deadline_s):
    """Timer body: the reform of ``generation_armed`` did not complete
    within ``SM_REFORM_TIMEOUT_S`` (a survivor or a worker never joined the
    new process group, or the resume point never came): exit 82, as a
    faulted reform does."""
    with _state.lock:
        stale = _state.reforming and _state.generation <= generation_armed
    if not stale:
        return
    from . import watchdog

    logger.error("elastic: reform (generation %d) did not complete within %.0fs; aborting "
                 "this survivor with exit %d", generation_armed, deadline_s, EXIT_REFORM_FAILED)
    watchdog.request_abort("reform_failed", EXIT_REFORM_FAILED, generation=generation_armed,
                           error="the reform did not complete within {:.0f}s".format(
                               deadline_s))


def _teardown_planes():
    """Stop the control planes of the old generation before the
    re-rendezvous: the heartbeat sender and aggregator (their membership is
    the old one), the abort listener (the re-wiring hook rebinds it), the
    checkpoint deleters, and the process group (so that a survivor blocked
    on this rank in a collective fails at once and reaches the handshake)."""
    from ..telemetry.cluster import stop_cluster_telemetry

    stop_cluster_telemetry()
    from . import watchdog

    watchdog.stop_abort_plane()
    from . import checkpointing

    checkpointing.flush_checkpoints()
    from ..parallel.distributed import teardown_process_group

    teardown_process_group()


def _commit_transition(req, old_hosts):
    """Advance the membership and append the transition record."""
    surviving_ranks = [old_hosts.index(h) for h in req.survivors if h in old_hosts]
    with _state.lock:
        transition = {
            "event": "shrink",
            "generation": req.generation,
            "old_world_size": len(old_hosts),
            "new_world_size": len(req.survivors),
            "epoch": req.epoch,
            "reason": req.reason,
            "surviving_ranks": surviving_ranks,
            "hosts": list(req.survivors),
        }
        _state.membership_log.append(transition)
        _state.hosts = list(req.survivors)
        _state.generation = req.generation
        _state.shrinks += 1
        _state.pending = None
        _state.draining = False
    return dict(transition)


def _disarm_pending(why):
    """Cancel an armed but unconsumed reform (its drain timer too): a verdict
    that lands during or after the last round has no rounds to reform for,
    and its timer must not exit 80 a finished job mid-save. -> the disarmed
    request, or None."""
    with _state.lock:
        pending, _state.pending = _state.pending, None
        timer, _state.drain_timer = _state.drain_timer, None
        _state.draining = False
    if timer is not None:
        timer.cancel()
    if pending is not None:
        logger.warning("elastic: pending reform (generation %d) disarmed: %s",
                       pending["generation"], why)
    return pending


def supervised_train(train_once, on_reform=None, master_addr=None, reform_port=None):
    """Run ``train_once()`` under the reform loop -> its result.

    ``train_once`` builds a fresh callback stack and session a generation.
    On :class:`ReformRequested` the reform runs and the loop re-enters; with
    the plane inert this is a pass-through. A reform still pending when
    training returns (the verdict raced the last round) is disarmed. The
    exception is replaced by a copy without its traceback before the
    reform: the traceback's frames hold the old session and with it the old
    process group, whose connections close only once nothing references it.
    """
    while True:
        try:
            result = train_once()
        except CollectiveLost as e:
            lost_epoch, req = e.epoch, None
        except ReformRequested as e:
            req = ReformRequested(e.survivors, e.reason, e.generation, epoch=e.epoch)
        else:
            _disarm_pending("training completed before the drain point; no rounds remain")
            return result
        if req is None:
            req = _await_relayed_verdict(lost_epoch)
        logger.warning("elastic: training unwound for reform at epoch %s (generation %d, "
                       "reason %s)", req.epoch, req.generation, req.reason)
        perform_reform(req, on_reform=on_reform, master_addr=master_addr, port=reform_port)


def _await_relayed_verdict(epoch):
    """A worker whose collective failed, unwound: tear its process group
    down (its frames are gone, so its connections close and a peer blocked
    on it fails too), then wait up to ``SM_REFORM_DRAIN_TIMEOUT_S`` for its
    leader's verdict -> the request. Without one the worker fails (its
    leader, if alive, takes the host down)."""
    from ..parallel.distributed import teardown_process_group
    from ..toolkit import exceptions as exc

    teardown_process_group()
    wait_s = drain_timeout_s()
    logger.warning("a collective failed; the process group is down, waiting up to %.0fs for "
                   "the leader's verdict", wait_s)
    req = await_reform(wait_s, epoch=epoch)
    if req is None:
        raise exc.PlatformError("a collective failed and no reform verdict came from this "
                                "host's leader within {:.0f}s".format(wait_s))
    return req
