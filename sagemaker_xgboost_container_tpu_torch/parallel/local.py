"""One training process per local GPU: the port's counterpart of the JAX
package's ``_training_mesh``, the ``("data",)`` mesh over a host's devices.

Where the JAX package traces one program over every device of a host, the
port runs one process a card (the torch idiom). The host's leader (the
process the platform started, local rank 0, on ``cuda:0``) reads the
channels once, places the host's matrices in shared memory
(``HostMatrix``) and spawns local ranks 1..L-1 (``spawn_local_ranks``);
every local rank then deals itself its rows (``shard_matrix``: contiguous
shards of ceil(n / L) rows, the JAX mesh's boundaries, or whole query
groups for a ranking objective, ``ops/ranking.assign_groups``) and joins
the process group of hosts x L ranks, global rank = host index x L + local
rank.

* ``local_world_size`` resolves L: ``SM_LOCAL_RANKS`` when set (above the
  card count only with ``SM_PROCESS_GROUP_BACKEND=gloo``, since NCCL refuses
  two ranks on one device; ranks then share cards round-robin; on the CPU
  the only way to get L > 1), else the visible cards, capped by this host's
  share of ``_num_devices`` (``_num_devices // hosts``, at least 1).
* The cuts are the host's: the leader sketches all of its host's rows and
  every local rank bins with them (``host_cuts``), which is what the JAX
  one-host mesh bins with; across hosts the hosts' sketches are merged, one
  set of candidates a host.
* A worker dies with its leader (``PR_SET_PDEATHSIG``); the leader watches
  its workers, and a worker's death aborts the host (exit 80) with the
  worker's error text in the failure file; the leader reaps its workers on
  every exit path (``stop_local_ranks``, ``kill_local_ranks``).
* Each worker holds the read end of a control pipe from its leader
  (``listen_to_leader``): the leader's verdicts, an elastic ``reform``
  (``relay_to_workers``, once the survivors' rendezvous has committed) and
  an ``abort`` with its exit code, sent before the workers are reaped. The
  heartbeat, abort, consensus and fleet planes stay one a host, in the
  leader. L is fixed for the job: an elastic reform re-forms the same L
  ranks a host over the surviving hosts (``Topology.after_shrink``) and
  spawns nothing.

L == 1 spawns nothing and leaves every path as it was.
"""

import logging
import os
import shutil
import signal
import tempfile
import threading
import time

import numpy as np

from ..toolkit import exceptions as exc

logger = logging.getLogger(__name__)

LOCAL_RANKS_ENV = "SM_LOCAL_RANKS"
# drills: "<local rank>=<SM_FAULT_SPEC>[|...]" arms a fault spec in one
# worker (local rank >= 1) of a host in place of the SM_FAULT_SPEC it
# inherits
LOCAL_FAULT_SPEC_ENV = "SM_LOCAL_FAULT_SPEC"
# how long a finished leader waits for its workers to exit
WORKER_JOIN_TIMEOUT_S = 120.0
# how long an aborting leader waits for its workers to take its exit code
# before it kills them
WORKER_ABORT_WAIT_S = 2.0


class Topology:
    """Where this process sits: ``num_hosts`` hosts of ``local_size`` ranks
    each; this is local rank ``local_rank`` of host ``host_index``."""

    def __init__(self, num_hosts, host_index, local_size, local_rank):
        self.num_hosts = int(num_hosts)
        self.host_index = int(host_index)
        self.local_size = int(local_size)
        self.local_rank = int(local_rank)

    @property
    def global_rank(self):
        return self.host_index * self.local_size + self.local_rank

    @property
    def world_size(self):
        return self.num_hosts * self.local_size

    @property
    def is_leader(self):
        return self.local_rank == 0

    def after_shrink(self, survivors, current_host):
        """This rank's place among the sorted ``survivors`` of a shrink: the
        same local rank of the same L, at its host's new index."""
        return Topology(len(survivors), sorted(survivors).index(current_host),
                        self.local_size, self.local_rank)

    def __repr__(self):
        return "Topology(hosts={}, host={}, local_size={}, local_rank={})".format(
            self.num_hosts, self.host_index, self.local_size, self.local_rank)


_topology = None


def set_topology(topo):
    """Record this process's place (None: one rank a host, as before)."""
    global _topology
    _topology = topo if topo is not None and topo.local_size > 1 else None


def topology():
    """This process's ``Topology`` while it trains with local ranks, else None."""
    return _topology


def is_worker():
    """True in a spawned local rank (not the host's leader): it prints no
    metric lines and no round records, and saves nothing."""
    return _topology is not None and not _topology.is_leader


def num_hosts_of(group):
    """Hosts spanned by ``group``: the topology's, else one rank a host."""
    if _topology is not None:
        return _topology.num_hosts
    from .collectives import world

    return world(group)[1]


def local_world_size(num_hosts, num_devices_cap=None, device=None, device_count=None):
    """L, the training ranks of this host.

    ``SM_LOCAL_RANKS`` when set. Above the card count it needs
    ``SM_PROCESS_GROUP_BACKEND=gloo`` (NCCL refuses two ranks on one
    device). Otherwise the visible cards (1 on the CPU), capped by this
    host's share of ``_num_devices``: ``_num_devices // num_hosts``, at least
    1 (the JAX package caps the devices of the whole job's mesh)."""
    from .distributed import PROCESS_GROUP_BACKEND_ENV

    is_cuda = device is not None and device.type == "cuda"
    if device_count is None:
        import torch

        device_count = torch.cuda.device_count() if is_cuda else 0
    raw = os.environ.get(LOCAL_RANKS_ENV, "").strip()
    if raw:
        try:
            n = int(raw)
        except ValueError:
            raise exc.UserError("{}={!r} is not an integer".format(LOCAL_RANKS_ENV, raw))
        if n < 1:
            raise exc.UserError("{} must be at least 1, got {}".format(LOCAL_RANKS_ENV, n))
        if (is_cuda and n > device_count
                and os.environ.get(PROCESS_GROUP_BACKEND_ENV, "") != "gloo"):
            raise exc.UserError(
                "{}={} exceeds the {} visible GPU(s): ranks that share a card need "
                "{}=gloo (NCCL refuses two ranks on one device)".format(
                    LOCAL_RANKS_ENV, n, device_count, PROCESS_GROUP_BACKEND_ENV))
        return n
    n = max(1, device_count) if is_cuda else 1
    if num_devices_cap:
        n = min(n, max(1, int(num_devices_cap) // max(1, int(num_hosts))))
    return n


def share_host_threads(local_size):
    """Give this rank its share of torch's intra-op threads (the cores, or
    ``OMP_NUM_THREADS``): L ranks each running all of them would
    oversubscribe the host."""
    import torch

    torch.set_num_threads(max(1, torch.get_num_threads() // int(local_size)))


def rank_device(device, local_rank):
    """The device of ``local_rank``: ``cuda:(local_rank % cards)`` on CUDA."""
    import torch

    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % max(1, torch.cuda.device_count()))


# ------------------------------------------------------------ the shards
def shard_bounds(n, size):
    """Contiguous [lo, hi) of each of ``size`` shards of ``n`` rows: ceil(n /
    size) rows a shard, the JAX mesh's row padding unit."""
    step = -(-int(n) // int(size))
    return [(min(r * step, n), min((r + 1) * step, n)) for r in range(size)]


def shard_rows(dm, local_rank, size):
    """The rows ``local_rank`` of ``size`` gets -> (row index array or
    slice, its query group sizes or None). A matrix with query groups
    deals them whole (``ops/ranking.assign_groups``, longest first onto the
    lightest shard, each shard's groups in their channel order)."""
    groups = getattr(dm, "groups", None)
    if groups is None:
        lo, hi = shard_bounds(dm.num_row, size)[local_rank]
        return slice(lo, hi), None
    from ..ops.ranking import assign_groups

    sizes = np.asarray(groups, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    mine = assign_groups(sizes, size)[local_rank]
    rows = (np.concatenate([np.arange(starts[g], starts[g] + sizes[g]) for g in mine])
            if mine else np.zeros(0, np.int64))
    return rows, sizes[mine]


def shard_indices(idx, topo):
    """This rank's contiguous share of the row indices ``idx`` (a k-fold
    CV fold's rows)."""
    lo, hi = shard_bounds(len(idx), topo.local_size)[topo.local_rank]
    return np.asarray(idx)[lo:hi]


def shard_matrix(dm, topo):
    """This rank's shard of the host matrix ``dm`` (a ``DataMatrix`` or a
    pre-binned ``BinnedMatrix``); a contiguous shard is a view, not a copy.
    The leader's shard carries the host's rows as ``host_rows``, for
    ``host_cuts``."""
    from ..data.binning import BinnedMatrix
    from ..data.matrix import DataMatrix

    if dm is None:
        return None
    rows, groups = shard_rows(dm, topo.local_rank, topo.local_size)

    def take(a):
        return None if a is None else a[rows]

    if isinstance(dm, BinnedMatrix):
        shard = BinnedMatrix(take(dm.bins), dm.cut_points, dm.max_bin, labels=take(dm.labels),
                             weights=take(dm.weights), groups=groups,
                             feature_names=dm.feature_names)
    else:
        shard = DataMatrix(take(dm.features), labels=take(dm.labels), weights=take(dm.weights),
                           groups=groups, feature_names=dm.feature_names)
    shard.host_rows = dm if topo.is_leader else None
    return shard


def host_cuts(dtrain, max_bin, group, device):
    """The cuts every local rank bins with: the leader's sketch of all its
    host's rows (``dtrain.host_rows``), gathered over ``group`` from each
    host's leader. On one host they are the leader's cuts as they are (the
    cuts of ``bin_matrix`` over the host's rows, as the JAX one-host mesh
    bins); across hosts the hosts' candidates merge as
    ``merged_distributed_cuts`` merges them, one set a host."""
    import torch

    from ..data.binning import compute_cut_points
    from ..models.booster import candidate_matrix, merge_cut_candidates
    from . import collectives

    topo = _topology
    d = dtrain.num_col
    cuts = [np.zeros(0, np.float32)] * d
    if topo.is_leader:
        host = dtrain.host_rows
        cuts = list(compute_cut_points(host.features, host.weights, max_bin, device=device))
        cuts += [np.zeros(0, np.float32)] * (d - len(cuts))
    longest = max((len(c) for c in cuts), default=0)
    width = int(collectives.host_all_gather(np.asarray([longest], np.int64), group, device,
                                            kind="setup").max())
    mat, counts = candidate_matrix(cuts, max(width, 1))
    mats = collectives.all_gather(torch.as_tensor(mat, device=device), group,
                                  kind="setup").cpu().numpy()
    all_counts = collectives.all_gather(torch.as_tensor(counts, device=device), group,
                                        kind="setup").cpu().numpy()
    leaders = [h * topo.local_size for h in range(topo.num_hosts)]
    if topo.num_hosts == 1:
        return [mats[0, f, :all_counts[0, f]].copy() for f in range(d)]
    return merge_cut_candidates(mats[leaders], all_counts[leaders], max_bin - 1)


# ------------------------------------------------------- shared memory
class HostMatrix:
    """A host's matrix in shared memory: the leader publishes it once and
    its local ranks attach to it, so the host holds one copy of a channel
    however many ranks train on it. ``matrix`` is the matrix over the
    shared arrays; ``descriptor`` (picklable) attaches it elsewhere."""

    _ARRAYS = {"DataMatrix": ("features", "labels", "weights"),
               "BinnedMatrix": ("bins", "labels", "weights")}

    def __init__(self, descriptor, segments, owner):
        self.descriptor = descriptor
        self._segments = segments
        self._owner = owner
        self.matrix = self._build()

    @classmethod
    def publish(cls, dm):
        """Copy ``dm``'s arrays into new shared segments (the leader)."""
        from multiprocessing import shared_memory

        kind = type(dm).__name__
        arrays, segments = {}, []
        for name in cls._ARRAYS[kind]:
            a = getattr(dm, name)
            if a is None:
                continue
            a = np.ascontiguousarray(a)
            shm = shared_memory.SharedMemory(create=True, size=max(1, a.nbytes))
            segments.append(shm)
            np.ndarray(a.shape, a.dtype, buffer=shm.buf)[...] = a
            arrays[name] = (shm.name, a.shape, a.dtype.str)
        meta = {"groups": getattr(dm, "groups", None), "feature_names": dm.feature_names}
        if kind == "BinnedMatrix":
            meta.update(cut_points=dm.cut_points, max_bin=dm.max_bin)
        return cls({"kind": kind, "arrays": arrays, "meta": meta}, segments, owner=True)

    @classmethod
    def attach(cls, descriptor):
        """Map a published matrix (a local rank)."""
        from multiprocessing import shared_memory

        segments = [shared_memory.SharedMemory(name=spec[0])
                    for spec in descriptor["arrays"].values()]
        return cls(descriptor, segments, owner=False)

    def _build(self):
        from ..data.binning import BinnedMatrix
        from ..data.matrix import DataMatrix

        views = {}
        for (name, (_seg, shape, dtype)), shm in zip(self.descriptor["arrays"].items(),
                                                     self._segments):
            views[name] = np.ndarray(tuple(shape), np.dtype(dtype), buffer=shm.buf)
        meta = self.descriptor["meta"]
        if self.descriptor["kind"] == "BinnedMatrix":
            return BinnedMatrix(views["bins"], meta["cut_points"], meta["max_bin"],
                                labels=views.get("labels"), weights=views.get("weights"),
                                groups=meta["groups"], feature_names=meta["feature_names"])
        return DataMatrix(views["features"], labels=views.get("labels"),
                          weights=views.get("weights"), groups=meta["groups"],
                          feature_names=meta["feature_names"])

    def close(self):
        """Unmap (and, the leader, unlink) the segments. A view still held
        elsewhere keeps its mapping until it is dropped."""
        self.matrix = None
        for shm in self._segments:
            try:
                shm.close()
            except BufferError:
                pass  # a view is still referenced; the mapping goes with it
            if self._owner:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
        self._segments = []


# ----------------------------------------------------------- the workers
def die_with_parent(parent_pid):
    """Have the kernel SIGKILL this process when its parent exits
    (``PR_SET_PDEATHSIG``); exit at once if the parent is already gone."""
    import ctypes

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, int(signal.SIGKILL), 0, 0, 0)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        logger.warning("PR_SET_PDEATHSIG unavailable: this worker may outlive its leader")
    if os.getppid() != parent_pid:
        os._exit(1)


def local_fault_spec(local_rank):
    """The ``SM_LOCAL_FAULT_SPEC`` entry of worker ``local_rank``, or None
    (the inherited ``SM_FAULT_SPEC`` holds)."""
    for entry in os.environ.get(LOCAL_FAULT_SPEC_ENV, "").split("|"):
        rank, _, spec = entry.partition("=")
        if rank.strip() == str(local_rank):
            return spec.strip()
    return None


class LocalRanks:
    """The leader's handle on its spawned local ranks: the processes, their
    error files and the watcher that turns a worker's death into the host's
    failure."""

    def __init__(self, procs, err_dir, on_failure, controls=None):
        self.procs = procs            # {local rank: Process}
        self.controls = controls or {}  # {local rank: write end of its control pipe}
        self.err_dir = err_dir
        self.on_failure = on_failure
        self.sigterm_hooked = False
        self._stop = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name="local-rank-watcher")
        self._watcher.start()

    def error_text(self, local_rank):
        path = os.path.join(self.err_dir, "local-rank-{}.err".format(local_rank))
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return ""

    def describe_failure(self, local_rank, exitcode):
        text = self.error_text(local_rank)
        how = ("killed by signal {}".format(-exitcode) if exitcode is not None and exitcode < 0
               else "exit code {}".format(exitcode))
        return "local rank {} failed ({}){}".format(
            local_rank, how, ": " + text if text else "")

    def failures(self):
        """[(local rank, message)] of the workers that exited non-zero."""
        return [(r, self.describe_failure(r, p.exitcode)) for r, p in sorted(self.procs.items())
                if p.exitcode not in (None, 0)]

    def _watch(self):
        from multiprocessing.connection import wait

        pending = {p.sentinel: r for r, p in self.procs.items()}
        while pending and not self._stop.is_set():
            for s in wait(list(pending), timeout=0.2):
                r = pending.pop(s)
                p = self.procs[r]
                # the sentinel closes a moment before the exit status is
                # there to reap
                p.join(10)
                if p.exitcode != 0 and not self._stop.is_set():
                    message = self.describe_failure(r, p.exitcode)
                    logger.error("%s", message)
                    self.on_failure(r, message)
                    return

    def relay(self, msg):
        """Send ``msg`` to every live worker -> the local ranks reached."""
        reached = []
        for r, conn in sorted(self.controls.items()):
            if not self.procs[r].is_alive():
                continue
            try:
                conn.send(msg)
                reached.append(r)
            except (OSError, ValueError):
                pass  # the worker is gone; its watcher reports it
        return reached

    def _close_controls(self):
        for conn in self.controls.values():
            try:
                conn.close()
            except OSError:
                pass
        self.controls = {}

    def stop(self, graceful=True, timeout=WORKER_JOIN_TIMEOUT_S):
        """Reap every worker (after ``timeout`` for them to finish when
        ``graceful``, else at once) -> the failures, as ``failures()``."""
        self._stop.set()
        deadline = time.monotonic() + (timeout if graceful else 0.0)
        for p in self.procs.values():
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs.values():
            if p.is_alive():
                p.kill()
            p.join(10)
        failed = self.failures() if graceful else []
        self._close_controls()
        shutil.rmtree(self.err_dir, ignore_errors=True)
        return failed


_active = None


def active_local_ranks():
    return _active


def spawn_local_ranks(topo, spec, target, on_failure):
    """Start local ranks 1..L-1 of ``topo`` with the ``spawn`` context, each
    running ``target(local_rank, spec, parent pid, error file)``, its spec
    holding the read end of its control pipe as ``spec["control"]``; the
    caller stays local rank 0 -> the ``LocalRanks`` handle. From the main
    thread: a worker's ``PR_SET_PDEATHSIG`` fires when the thread that
    started it exits."""
    global _active
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    err_dir = tempfile.mkdtemp(prefix="local-ranks-")
    procs, controls = {}, {}
    for r in range(1, topo.local_size):
        err = os.path.join(err_dir, "local-rank-{}.err".format(r))
        reader, writer = ctx.Pipe(duplex=False)
        p = ctx.Process(target=target, args=(r, dict(spec, control=reader), os.getpid(), err),
                        name="local-rank-{}".format(r))
        p.start()
        reader.close()
        procs[r], controls[r] = p, writer
    logger.info("spawned local ranks 1..%d of host %d (global ranks %d..%d of %d), pids %s",
                topo.local_size - 1, topo.host_index, topo.global_rank + 1,
                topo.global_rank + topo.local_size - 1, topo.world_size,
                [p.pid for p in procs.values()])
    _active = LocalRanks(procs, err_dir, on_failure, controls)
    _active.sigterm_hooked = _reap_on_sigterm()
    return _active


def relay_to_workers(msg):
    """The leader's verdict ``msg`` to its workers -> the local ranks
    reached (none without workers)."""
    handle = _active
    return handle.relay(msg) if handle is not None else []


def listen_to_leader(conn, handler):
    """A worker: call ``handler(msg)`` for each verdict on its control pipe
    ``conn``, from a daemon thread, until the pipe closes (the leader is
    gone, and this process with it)."""
    def run():
        while True:
            try:
                # graftlint: disable=socket-unbounded a multiprocessing pipe, not a
                # socket: it closes when the leader does, and the worker with it
                msg = conn.recv()
            except (EOFError, OSError):
                return
            try:
                handler(msg)
            except Exception:
                logger.exception("local rank: the leader's verdict %r failed", msg)

    t = threading.Thread(target=run, daemon=True, name="leader-verdicts")
    t.start()
    return t


def _reap_on_sigterm():
    """Where SIGTERM would kill the leader outright (the default action),
    kill and reap its workers first, then take the default action -> True
    when the handler went in."""
    if signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
        return False  # a handler of the job's (the SIGTERM model save) reaps them

    def _on_sigterm(signo, frame):
        kill_local_ranks()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    signal.signal(signal.SIGTERM, _on_sigterm)
    return True


def quiet_local_ranks():
    """The leader's training is over: a worker's exit no longer fails the
    host."""
    if _active is not None:
        _active._stop.set()


def stop_local_ranks(graceful=True):
    """Reap this leader's workers (no-op without any) -> their failures."""
    global _active
    handle, _active = _active, None
    if handle is None:
        return []
    failed = handle.stop(graceful=graceful)
    if handle.sigterm_hooked:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    return failed


def kill_local_ranks(exit_code=None):
    """Kill and reap this leader's workers: every abort path (exits 79-87)
    and SIGTERM run it before the process exits. With ``exit_code`` the
    workers are first told to exit with it (an ``abort`` verdict) and given
    ``WORKER_ABORT_WAIT_S``; the ones left are killed."""
    handle = _active
    if handle is None:
        return
    handle._stop.set()
    if exit_code is not None and handle.relay({"verb": "abort", "exit_code": int(exit_code)}):
        deadline = time.monotonic() + WORKER_ABORT_WAIT_S
        for p in handle.procs.values():
            p.join(max(0.0, deadline - time.monotonic()))
    for p in handle.procs.values():
        if p.is_alive():
            try:
                p.kill()
            except Exception:
                pass
    for p in handle.procs.values():
        try:
            p.join(5)
        except Exception:
            pass
