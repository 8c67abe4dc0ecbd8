"""Cross-rank consensus guard: prove that the ranks agree on the committed
trees.

The port's counterpart of the JAX package's ``training/consensus.py``.
Every rank of a data-parallel job commits the same trees by construction
(each level's histograms are reduced over the process group before the
split scan), but nothing enforced it at run time: a diverged rank (a memory
fault, a misbehaving fabric, version skew after a partial restart) would
train a forked ensemble, and rank 0 would save its fork silently.

Every ``SM_CONSENSUS_EVERY`` committed rounds, :class:`ConsensusGuard`
digests each rank's forest (``utils.integrity.forest_digest``, on the host,
after the round) and allgathers the digests over the cluster framing
(``parallel/distributed.Cluster.synchronize`` on ``SM_CONSENSUS_PORT``,
9399), not over the process group, so that the check does not ride on the
collectives it audits. A disagreement

* emits one ``training.divergence`` record with every rank's digest (the odd
  one out names the bad rank),
* counts ``consensus_divergence_total``,
* takes the job down with ``EXIT_CONSENSUS_DIVERGENCE`` (81) through the
  abort plane: rank 0 broadcasts the code to every peer and aborts; every
  other rank saw the same digests and aborts itself. The guard runs before
  the checkpoint saver, so a restart resumes from the last round that
  passed.

A reply of another world size (a rank that missed an elastic shrink) or of
another round (a misaligned exchange) is skipped, not judged. Inert by
default: ``SM_CONSENSUS_EVERY`` unset or 0 means no guard, no socket, no
digest. The ``consensus.check`` fault point perturbs one rank's digest
(the drill's stand-in for a memory fault).
"""

import logging

from ..constants import EXIT_CONSENSUS_DIVERGENCE
from ..telemetry import REGISTRY
from ..telemetry.emit import emit_metric
from ..utils.envconfig import env_float, env_int, env_port
from ..utils.faults import fault_point
from ..utils.integrity import forest_digest

logger = logging.getLogger(__name__)

CONSENSUS_EVERY_ENV = "SM_CONSENSUS_EVERY"
CONSENSUS_PORT_ENV = "SM_CONSENSUS_PORT"
CONSENSUS_TIMEOUT_ENV = "SM_CONSENSUS_TIMEOUT_S"

# NOT the rendezvous (9099), heartbeat (9199) or abort (9299) ports: the
# digest allgather must never meet a conversation there
DEFAULT_CONSENSUS_PORT = 9399

# the participating hosts (``algorithm_train._pre_exec``, and again after an
# elastic shrink); None on one host, where the guard digests locally
_hosts = None
_current_host = None


def consensus_every():
    return env_int(CONSENSUS_EVERY_ENV, 0, minimum=0)


def consensus_port():
    return env_port(CONSENSUS_PORT_ENV, DEFAULT_CONSENSUS_PORT)


def consensus_timeout_s():
    return env_float(CONSENSUS_TIMEOUT_ENV, 60.0, minimum=0.1, maximum=3600.0)


def register_cluster(hosts, current_host):
    """Record the participating hosts for the guards built later."""
    global _hosts, _current_host
    _hosts = sorted(hosts)
    _current_host = current_host


def _reset_for_tests():
    global _hosts, _current_host
    _hosts = None
    _current_host = None


def cluster_exchange(hosts, current_host, port=None, timeout=None, master_addr=None):
    """-> exchange fn (digest, round) -> rank-ordered reply list.

    One ``Cluster.synchronize`` allgather a check on the consensus port,
    with the rendezvous' deadlines, so that a wedged peer is a logged
    exchange failure, never a hang. ``master_addr`` overrides the master's
    address (loopback drills).
    """
    from ..parallel.distributed import Cluster

    def _exchange(digest, rnd):
        cluster = Cluster(hosts, current_host,
                          port=consensus_port() if port is None else port)
        if master_addr is not None:
            cluster.master_host = master_addr
        # the world size rides along, so that a rank whose membership
        # drifted (it missed an elastic shrink) is told from a divergence
        return cluster.synchronize(
            {"digest": digest, "round": rnd, "world": len(hosts)},
            timeout=consensus_timeout_s() if timeout is None else timeout)

    return _exchange


class ConsensusGuard:
    """Booster-protocol callback: digest and allgather every ``every``
    rounds. ``exchange`` and ``abort_fn`` are injectable (tests); the
    defaults are the cluster allgather and the watchdog's abort."""

    def __init__(self, every, hosts=None, current_host=None, port=None, timeout=None,
                 master_addr=None, exchange=None, abort_fn=None):
        self.every = max(1, int(every))
        self.hosts = sorted(hosts) if hosts else None
        self.current_host = current_host
        self.rank = self.hosts.index(current_host) if self.hosts else 0
        self.world_size = len(self.hosts) if self.hosts else 1
        if exchange is not None:
            self.exchange = exchange
        elif self.world_size > 1:
            self.exchange = cluster_exchange(self.hosts, current_host, port=port,
                                             timeout=timeout, master_addr=master_addr)
        else:
            self.exchange = lambda digest, rnd: [digest]
        self.abort_fn = abort_fn or self._default_abort
        self.checks = 0
        self.divergences = 0

    # ----------------------------------------------------- callback protocol
    def after_iteration(self, model, epoch, evals_log):
        if (epoch + 1) % self.every != 0:
            return False
        # SM_TRACE: the digest and the allgather as one span under the
        # round's; an exit-81 abort leaves it open in the flight recorder
        from ..telemetry.tracing import trace_span

        with trace_span("consensus.check", attributes={"round": epoch, "rank": self.rank}):
            return self._check(model, epoch)

    def _check(self, model, epoch):
        digest = forest_digest(model)
        try:
            fault_point("consensus.check", round=epoch, rank=self.rank)
        except (OSError, ConnectionError) as e:
            # the injected divergence: this rank claims a perturbed digest
            logger.error("consensus.check fault injected on rank %d: perturbing this rank's "
                         "digest (%s)", self.rank, e)
            digest = "f" * 8 + digest[8:]
        self.checks += 1
        REGISTRY.counter("consensus_checks_total",
                         "Cross-rank committed-tree digest checks performed").inc()
        try:
            replies = self.exchange(digest, epoch)
        except Exception as e:
            # an unreachable peer is the abort plane's failure domain, not a
            # divergence verdict: log it and keep training
            logger.warning("consensus digest exchange failed at round %d (%s); skipping this "
                           "check", epoch, e)
            return False
        # the cluster exchange returns the payload dicts; injected exchanges
        # may return bare digests
        if replies and isinstance(replies[0], dict):
            worlds = {int(r.get("world", self.world_size)) for r in replies}
            if worlds != {self.world_size}:
                # membership drift, not divergence: a rank that missed (or
                # has not finished) a shrink legitimately differs
                logger.warning("consensus exchange at round %d mixed world sizes %s (this "
                               "rank: %d); skipping this check as membership drift, not "
                               "divergence", epoch, sorted(worlds), self.world_size)
                return False
            rounds = {int(r.get("round", epoch)) for r in replies}
            if rounds != {epoch}:
                # a misaligned exchange (one rank skipped a timed-out check):
                # forests of different rounds differ by construction
                logger.warning("consensus exchange at round %d mixed check rounds %s; skipping "
                               "this check (ranks re-align at the next one)", epoch,
                               sorted(rounds))
                return False
            digests = [r["digest"] for r in replies]
        else:
            digests = list(replies)
        if len(set(digests)) <= 1:
            return False
        self.divergences += 1
        REGISTRY.counter("consensus_divergence_total",
                         "Consensus checks that found ranks with diverged committed "
                         "trees").inc()
        per_rank = {str(r): d for r, d in enumerate(digests)}
        emit_metric("training.divergence", round=epoch, rank=self.rank,
                    world_size=self.world_size, digests=per_rank)
        logger.error("CONSENSUS DIVERGENCE at round %d: committed trees disagree across ranks "
                     "(%s); aborting all ranks with exit code %d", epoch,
                     ", ".join("rank {}={}".format(r, d[:12])
                               for r, d in sorted(per_rank.items())),
                     EXIT_CONSENSUS_DIVERGENCE)
        self.abort_fn("consensus_divergence", EXIT_CONSENSUS_DIVERGENCE, round=epoch,
                      digests=per_rank)
        return False

    # ------------------------------------------------------------- internals
    def _default_abort(self, reason, exit_code, **fields):
        from . import watchdog

        if self.hosts and self.rank == 0:
            # rank 0 broadcasts the code first: a peer whose exchange failed
            # mid-flight is taken down too
            watchdog.coordinate_abort(self.hosts, self.current_host, reason,
                                      exit_code=exit_code, **fields)
        else:
            watchdog.request_abort(reason, exit_code, **fields)


def maybe_consensus_guard():
    """-> a ConsensusGuard when ``SM_CONSENSUS_EVERY`` > 0, else None; over
    the registered hosts, or one rank (the digest and the fault point still
    run, so the knob's cost is measurable anywhere)."""
    every = consensus_every()
    if every <= 0:
        return None
    return ConsensusGuard(every, hosts=_hosts, current_host=_current_host)
