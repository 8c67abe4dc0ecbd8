"""Multi-host cluster lifecycle: rendezvous, membership sync, the abort
channel and the process group.

The port's counterpart of the JAX package's ``parallel/distributed.py``,
with the same wire format (``<u32 little-endian length><JSON>``), so a port
rank and a JAX rank can synchronize with each other:

* ranks are deterministic: sorted hostnames, master = rank 0;
* before training, hosts exchange "do I have data?"; hosts without data
  exit(0) and the rest train (``distributed_run``);
* every host waits for DNS with exponential backoff up to ~15 min before any
  distributed work.

The TCP exchange here is a tiny metadata-only allgather used once at
start-up, not a training-path collective. The training-path collectives
are ``torch.distributed`` calls over the process group that
``init_process_group`` brings up (coordinator = sorted hosts[0], the JAX
package's ``maybe_init_jax_distributed``), one process a rank: the
histogram all-reduce or reduce-scatter between a rank's local kernel launch
and its split scan (``ops/histogram.apply_hist_collective``).

The elastic membership reform (``training/elastic.py``, ``SM_ELASTIC``):
the survivors of a shrink re-rendezvous over ``SM_REFORM_PORT``
(``reform_cluster``), then ``reform_process_group`` tears the old process
group down (bounded) and brings a new one up over the survivors, its store
on ``SM_PROCESS_GROUP_PORT`` plus the shrink generation, so that it never
meets the old store's port.
"""

import datetime
import gc
import json
import logging
import os
import socket
import struct
import threading
import time

from ..toolkit import exceptions as exc
from ..utils.envconfig import env_float, env_port
from ..utils.faults import fault_point

logger = logging.getLogger(__name__)

DEFAULT_PORT = 9099

SYNC_RECV_TIMEOUT_ENV = "SM_SYNC_RECV_TIMEOUT_S"

ABORT_PORT_ENV = "SM_ABORT_PORT"
# NOT the rendezvous (9099) or heartbeat (9199) ports: the abort channel
# must stay reachable while both of those are mid-conversation
DEFAULT_ABORT_PORT = 9299

# an abort/rendezvous frame is small JSON; a stray HTTP client's request
# line parses as a ~500MB u32 length — reject before allocating on it
MAX_CONTROL_FRAME_BYTES = 1 << 20


def sync_recv_timeout():
    return env_float(SYNC_RECV_TIMEOUT_ENV, 30.0, minimum=0.1, maximum=600.0)


def wait_hostname_resolution(sm_hosts, max_wait_seconds=900):
    """Block until every host resolves in DNS (exponential backoff)."""
    delay = 1.0
    deadline = time.time() + max_wait_seconds
    for host in sm_hosts:
        while True:
            try:
                socket.gethostbyname(host)
                break
            except socket.gaierror:
                if time.time() > deadline:
                    raise exc.PlatformError(
                        "Could not resolve hostname {} within {}s".format(
                            host, max_wait_seconds
                        )
                    )
                time.sleep(min(delay, 30.0))
                delay *= 2


def frame_message(obj):
    """Length-prefixed JSON framing: ``<u32 little-endian length><payload>``.

    The one wire format shared by the rendezvous allgather below and the
    cluster telemetry heartbeats (telemetry/cluster.py) — a single framing
    implementation keeps the two protocols trivially interoperable and
    testable off-socket.
    """
    payload = json.dumps(obj).encode()
    return struct.pack("<I", len(payload)) + payload


def send_message(sock, obj):
    sock.sendall(frame_message(obj))


def recv_message(sock, timeout=None):
    """One framed message under a total deadline: the bounded reader with
    the rendezvous default (``SM_SYNC_RECV_TIMEOUT_S``), or ``timeout``."""
    return recv_message_bounded(
        sock, sync_recv_timeout() if timeout is None else timeout
    )


def recv_message_bounded(sock, timeout, max_bytes=MAX_CONTROL_FRAME_BYTES):
    """Read one framed message under a TOTAL deadline.

    A per-recv timeout that resets on every chunk lets a peer trickling
    one byte per timeout window hold the reader indefinitely — exactly
    the wedge this reader exists to bound (and ``recv_message`` now
    delegates here rather than risk it). Also sanity-caps the length
    prefix so a stray client can't make us block on (or allocate) a
    garbage frame. Shared by the rendezvous collect loop, the heartbeat
    aggregator, and the abort listener.
    """
    deadline = time.monotonic() + timeout

    def _read(n):
        buf = b""
        while len(buf) < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("frame read deadline exceeded")
            sock.settimeout(remaining)
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    (length,) = struct.unpack("<I", _read(4))
    if max_bytes is not None and length > max_bytes:
        raise ValueError("oversized control frame ({} bytes)".format(length))
    return json.loads(_read(length).decode())


class Cluster:
    """Deterministic-rank host group with a one-shot metadata allgather."""

    def __init__(self, hosts, current_host, port=DEFAULT_PORT):
        self.hosts = sorted(hosts)
        self.current_host = current_host
        self.port = port
        self.rank = self.hosts.index(current_host)
        self.master_host = self.hosts[0]

    @property
    def is_master(self):
        return self.rank == 0

    @property
    def num_hosts(self):
        return len(self.hosts)

    def _missing_ranks_error(self, results, timeout):
        missing = sorted(set(range(self.num_hosts)) - set(results))
        return exc.PlatformError(
            "Cluster rendezvous timed out after {}s: missing rank(s) {} "
            "(hosts {}). Those hosts are down, unreachable on port {}, or "
            "sending too slowly.".format(
                timeout,
                missing,
                [self.hosts[r] for r in missing],
                self.port,
            )
        )

    def synchronize(self, payload, timeout=300, recv_timeout=None,
                    max_frame_bytes=MAX_CONTROL_FRAME_BYTES):
        """Allgather small JSON payloads across hosts -> list in rank order.

        Master accepts one connection per worker, collects payloads, sends
        the full rank-ordered list back (the reference's synchronize,
        distributed.py:125-138). Single-host clusters short-circuit.

        Every blocking step is deadlined: ``timeout`` bounds the whole
        collect loop (accept used to be the only deadlined call — a worker
        that connected and then stalled or trickled bytes hung the master
        forever), and each connection's recv runs under ``recv_timeout``
        (``SM_SYNC_RECV_TIMEOUT_S``, default 30s) via the total-deadline
        frame reader. On expiry the master raises ``PlatformError`` naming
        the missing ranks/hosts.

        ``max_frame_bytes`` bounds each received frame; exchanges whose
        payloads legitimately exceed the 1 MiB control default (the ingest
        sketch allgather scales with features x wire cap x world size)
        pass a budget sized to what they actually send — every rank must
        pass the same value or the reply is refused on the smaller side.
        """
        if self.num_hosts == 1:
            return [payload]
        if recv_timeout is None:
            recv_timeout = sync_recv_timeout()
        if self.is_master:
            results = {0: payload}
            server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            server.bind(("0.0.0.0", self.port))
            server.listen(self.num_hosts)
            deadline = time.monotonic() + timeout
            conns = []
            try:
                while len(results) < self.num_hosts:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise self._missing_ranks_error(results, timeout)
                    server.settimeout(remaining)
                    try:
                        conn, addr = server.accept()
                    except socket.timeout:
                        raise self._missing_ranks_error(results, timeout)
                    fault_point("sync.accept", addr=addr)
                    try:
                        msg = recv_message_bounded(
                            conn, min(recv_timeout, remaining),
                            max_bytes=max_frame_bytes,
                        )
                        rank = int(msg["rank"])
                        if not 0 <= rank < self.num_hosts or rank in results:
                            raise ValueError(
                                "invalid or duplicate rank {}".format(rank)
                            )
                        payload_value = msg["payload"]
                    except (OSError, ValueError, KeyError, TypeError) as e:
                        # a wedged/trickling/garbage peer (stray client,
                        # out-of-range or already-claimed rank): drop the
                        # conn and keep collecting — a *real* rank stays
                        # missing and the overall deadline names it
                        logger.warning(
                            "rendezvous: dropping connection from %s (%s); "
                            "its rank remains outstanding", addr, e
                        )
                        conn.close()
                        continue
                    results[rank] = payload_value
                    conns.append(conn)
                ordered = [results[r] for r in range(self.num_hosts)]
                for conn in conns:
                    try:
                        # recv_message_bounded left the conn at whatever
                        # sliver of its frame deadline remained; give the
                        # reply its own full send budget
                        conn.settimeout(recv_timeout)
                        send_message(conn, ordered)
                    except OSError as e:
                        # the worker will retry its own connect loop; the
                        # allgather result is already complete for the rest
                        logger.warning("rendezvous: reply send failed: %s", e)
                    finally:
                        conn.close()
            finally:
                server.close()
            return ordered
        # worker: connect with retry (master may be slow to bind), backing
        # off from 10 ms to 1 s: an exchange a round (the consensus guard)
        # whose master binds a moment after this worker arrives must not
        # pay a whole second for it
        deadline = time.monotonic() + timeout
        last_err = None
        delay = 0.01
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection((self.master_host, self.port), timeout=10)
                try:
                    send_message(sock, {"rank": self.rank, "payload": payload})
                    return recv_message_bounded(
                        sock, max(deadline - time.monotonic(), 0.1),
                        max_bytes=max_frame_bytes,
                    )
                finally:
                    sock.close()
            except (ConnectionError, OSError) as e:
                last_err = e
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
        raise exc.PlatformError(
            "Could not synchronize with master {}".format(self.master_host),
            caused_by=last_err,
        )


# --------------------------------------------------------------- abort plane
def abort_port():
    return env_port(ABORT_PORT_ENV, DEFAULT_ABORT_PORT)


class AbortListener:
    """Per-host abort endpoint: accept one framed ``{"type": "abort"}`` JSON
    message and hand it to ``handler``.

    The listener exists because a dead peer can stall every survivor
    *inside* a collective, where no in-band channel reaches them. Rank 0's
    stale-host detector (telemetry/cluster.py) broadcasts an abort frame
    here so every rank exits cleanly (checkpoint flushed, distinct exit
    code) instead of deadlocking. Daemon thread, bounded accept timeout,
    junk frames dropped; the handler is responsible for the actual abort
    (training/watchdog.request_abort).
    """

    def __init__(self, handler, port=None, frame_timeout=5.0):
        self.handler = handler
        self.frame_timeout = frame_timeout
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", abort_port() if port is None else port))
        self._server.listen(8)
        self._server.settimeout(0.2)
        self.port = self._server.getsockname()[1]
        self._stop = threading.Event()
        # duplicate-frame suppression: two ranks detecting the same dead
        # host each broadcast the same frame; the handler must fire once
        # per distinct frame, and racing deliveries must serialize (the
        # dispatch lock) so conflicting exit codes resolve first-wins
        # rather than interleaving
        self._dispatch_lock = threading.Lock()
        self._seen_frames = set()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="abort-listener"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread.ident is not None:  # never-started listeners close clean
            self._thread.join(timeout)
        try:
            self._server.close()
        except OSError:
            pass

    def _run(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # socket closed under us
            try:
                msg = recv_message_bounded(conn, self.frame_timeout)
            except Exception as e:
                logger.debug("abort listener: dropping malformed frame: %s", e)
                continue
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
            self._dispatch(msg, addr)
        try:
            self._server.close()
        except OSError:
            pass

    def _dispatch(self, msg, addr):
        """Hand one decoded frame to the handler — idempotently.

        Two ranks detecting the same dead host broadcast frames that differ
        only in ``source``; the event key drops it, so the second delivery
        is a logged no-op instead of a double-fired abort or shrink.
        Distinct frames (a later shrink generation, a different reason)
        still pass; a ``verb: "shrink"`` frame reaches the handler like an
        abort (``training/watchdog._on_abort_frame`` tells them apart).
        Dispatch is serialized under a lock so racing deliveries can't
        interleave — the first frame's verdict (exit code, survivor set)
        settles before the next is even considered.
        """
        if not (isinstance(msg, dict) and msg.get("type") == "abort"):
            logger.warning("abort listener: ignoring non-abort frame from %s", addr)
            return False
        key = json.dumps(
            {k: v for k, v in msg.items() if k != "source"}, sort_keys=True
        )
        with self._dispatch_lock:
            if key in self._seen_frames:
                logger.info(
                    "abort listener: duplicate %s frame from %s suppressed "
                    "(already handled)",
                    msg.get("verb", "abort"),
                    msg.get("source", addr[0]),
                )
                return False
            self._seen_frames.add(key)
            logger.error(
                "%s frame received from %s (reason: %s)",
                msg.get("verb", "abort"),
                msg.get("source", addr[0]),
                msg.get("reason", "unspecified"),
            )
            try:
                self.handler(msg)
            except Exception:
                logger.exception("abort handler failed")
            return True


def broadcast_abort(
    hosts,
    reason,
    source=None,
    port=None,
    timeout=2.0,
    exit_code=None,
    extra=None,
    peer_addrs=None,
):
    """Best-effort abort fan-out: one framed message per host, bounded
    connect/send timeouts, failures logged not raised (a host that's
    already dead is exactly why we're broadcasting). Returns the number of
    hosts the frame was delivered to. ``exit_code`` (when given) rides in
    the frame so receivers exit with the broadcaster's distinguishing code
    (watchdog._frame_exit_code bounds it receiver-side). ``extra`` fields
    merge into the frame.
    ``peer_addrs`` optionally maps a host to its ``(addr, port)`` pair
    (loopback drills, where every "host" is 127.0.0.1 on a distinct port);
    without it, each host's listener port as it announced it at the
    rendezvous (``distributed_run``), else the default port."""
    default_port = abort_port() if port is None else port
    if peer_addrs is None and port is None:
        peer_addrs = announced_abort_addrs()
    frame = {"type": "abort", "reason": reason, "source": source}
    if exit_code is not None:
        frame["exit_code"] = int(exit_code)
    if extra:
        frame.update(extra)
    delivered = 0
    for host in hosts:
        addr, target_port = (peer_addrs or {}).get(host, (host, None))
        if target_port is None:
            target_port = default_port
        fault_point("abort.broadcast", host=host)
        try:
            sock = socket.create_connection((addr, target_port), timeout=timeout)
            try:
                sock.settimeout(timeout)
                sock.sendall(frame_message(frame))
                delivered += 1
            finally:
                sock.close()
        except OSError as e:
            logger.warning("abort broadcast to %s:%d failed: %s", addr, target_port, e)
    return delivered

# {host: (host, abort listener port)} as each host announced it at the
# rendezvous: several "hosts" of one box listen on distinct ports
_abort_addrs = {}


def _note_abort_ports(membership):
    global _abort_addrs
    _abort_addrs = {m["host"]: (m["host"], int(m["abort_port"])) for m in membership
                    if isinstance(m, dict) and m.get("abort_port")}


def announced_abort_addrs():
    """{host: (addr, port)} of the abort listeners announced at the
    rendezvous (empty before one)."""
    return dict(_abort_addrs)


REFORM_PORT_ENV = "SM_REFORM_PORT"
# NOT the rendezvous (9099), heartbeat (9199), abort (9299) or consensus
# (9399) ports: survivors re-rendezvous while the dead host's half-open
# conversations on those ports may still be draining
DEFAULT_REFORM_PORT = 9499


def reform_port():
    return env_port(REFORM_PORT_ENV, DEFAULT_REFORM_PORT)


def reform_cluster(survivors, current_host, generation, payload=None, port=None, timeout=60.0,
                   master_addr=None):
    """Survivor re-rendezvous: one bounded allgather over the shrunken host
    list -> (new Cluster, rank-ordered membership payloads).

    The JAX package's: every survivor runs the same retried,
    deadline-bounded ``Cluster.synchronize`` on ``SM_REFORM_PORT``,
    exchanging ``{host, generation, ...payload}``, under ``utils.retry``
    (site ``rendezvous.reform``: one port-rebind race must not turn a
    survivable shrink into exit 82) with the ``rendezvous.reform`` fault
    point inside each attempt. A reply of another generation is a hard
    error: that survivor missed (or double-counted) a membership transition,
    and the two sides would disagree on the world size. ``master_addr``
    overrides the survivor master's address (loopback drills).
    """
    cluster = Cluster(survivors, current_host, port=reform_port() if port is None else port)
    if master_addr is not None:
        cluster.master_host = master_addr
    message = {"host": current_host, "generation": int(generation)}
    message.update(payload or {})

    def _handshake():
        fault_point("rendezvous.reform", host=current_host, generation=generation,
                    survivors=len(survivors))
        return cluster.synchronize(message, timeout=timeout)

    from ..utils.retry import retry_transient

    membership = retry_transient(_handshake, site="rendezvous.reform",
                                 retry_on=(OSError, exc.PlatformError))
    generations = {int(m.get("generation", -1)) for m in membership}
    if generations != {int(generation)}:
        raise exc.PlatformError(
            "cluster reform handshake mixed shrink generations {} (expected {}): a "
            "survivor missed a membership transition; aborting reform rather than "
            "training under disagreeing world sizes".format(sorted(generations), generation))
    return cluster, membership


def distributed_run(
    exec_fun, args, include_in_training, hosts, current_host, port=DEFAULT_PORT, pre_exec=None
):
    """Membership-aware distributed execution (the reference's rabit_run).

    1. allgather {host, include_in_training};
    2. hosts without data log and exit(0) — the cluster re-forms without them;
    3. ``pre_exec(participating_hosts, current_host)`` runs on every
       participant (the process group over the re-formed cluster, and the
       planes);
    4. the rest run ``exec_fun(**args, is_master=...)`` where master is the
       first participating host in sorted order.
    """
    cluster = Cluster(hosts, current_host, port=port)
    membership = cluster.synchronize(
        {"host": current_host, "include_in_training": bool(include_in_training),
         "abort_port": abort_port()}
    )
    _note_abort_ports(membership)
    participating = sorted(
        m["host"] for m in membership if m["include_in_training"]
    )
    if not participating:
        raise exc.UserError(
            "Not a single machine in the cluster has training data; "
            "unable to train the model."
        )
    if not include_in_training:
        logger.warning(
            "Host %s does not have data, exiting from cluster.", current_host
        )
        return None
    if pre_exec is not None:
        pre_exec(participating, current_host)
    is_master = participating[0] == current_host
    args = dict(args)
    args["is_master"] = is_master
    return exec_fun(**args)


# ------------------------------------------------------------ process group
RENDEZVOUS_PORT_ENV = "SM_RENDEZVOUS_PORT"
PROCESS_GROUP_PORT_ENV = "SM_PROCESS_GROUP_PORT"
# the caller's explicit choice of backend for the entry point's process
# group (``nccl`` / ``gloo``); unset, the backend follows the device
PROCESS_GROUP_BACKEND_ENV = "SM_PROCESS_GROUP_BACKEND"
DEFAULT_PROCESS_GROUP_PORT = 12355
# how long one collective may wait for its peers (gloo's default, 30
# minutes). Not GRAFT_HEARTBEAT_TIMEOUT_S: that is the JAX package's
# heartbeat timeout, and a peer that is slow but alive keeps beating, so it
# must not bound a collective. A dead peer fails the next collective at
# once (its connection closes); a wedged one is the heartbeat and abort
# planes' (telemetry/cluster.py, training/watchdog.py)
PROCESS_GROUP_TIMEOUT_ENV = "SM_COLLECTIVE_TIMEOUT_S"
DEFAULT_COLLECTIVE_TIMEOUT_S = 1800.0


def rendezvous_port():
    return env_port(RENDEZVOUS_PORT_ENV, DEFAULT_PORT)


def process_group_port():
    return env_port(PROCESS_GROUP_PORT_ENV, DEFAULT_PROCESS_GROUP_PORT)


def process_group_timeout():
    return env_float(PROCESS_GROUP_TIMEOUT_ENV, DEFAULT_COLLECTIVE_TIMEOUT_S, minimum=1.0)


def default_backend(device):
    """``nccl`` for CUDA ranks, ``gloo`` for CPU ranks."""
    return "nccl" if device.type == "cuda" else "gloo"


def init_process_group(hosts, current_host, device, backend=None, port=None, timeout_s=None):
    """Bring up the ``torch.distributed`` process group of the participating
    ``hosts`` -> the group (``torch.distributed.group.WORLD``).

    The coordinator is sorted ``hosts[0]`` and a rank is its index in the
    sorted list, as the JAX package's ``maybe_init_jax_distributed``. One
    rank a host, on ``device``. The backend follows the device (``nccl`` for
    CUDA, ``gloo`` for the CPU) unless ``backend`` or
    ``SM_PROCESS_GROUP_BACKEND`` names one: the caller's explicit choice
    (two ranks sharing one card need ``gloo``, since NCCL refuses two ranks
    on one device). ``timeout_s`` (default ``SM_COLLECTIVE_TIMEOUT_S``,
    1800 s) bounds how long one collective waits for its peers: long, since
    a rank's host work between collectives (a sketch, a fold's setup) is
    uneven across ranks. A failure raises ``PlatformError``: a rank that
    cannot reach its peers fails the job.
    """
    import torch
    import torch.distributed as dist

    ordered = sorted(hosts)
    rank = ordered.index(current_host)
    backend = backend or os.environ.get(PROCESS_GROUP_BACKEND_ENV) or default_backend(device)
    port = process_group_port() if port is None else port
    timeout_s = process_group_timeout() if timeout_s is None else timeout_s
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        logger.warning(
            "host %s has %d GPUs; the port trains one rank a host, on %s",
            current_host, torch.cuda.device_count(), device)
    try:
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend,
            init_method="tcp://{}:{}".format(ordered[0], port),
            world_size=len(ordered),
            rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    except Exception as e:
        from ..telemetry import fleet

        fleet.note_status(backend_init_error=str(e))
        raise exc.PlatformError(
            "Failed to initialize the {} process group of {} hosts".format(
                backend, len(ordered)),
            caused_by=e,
        )
    logger.info("process group up: rank %d of %d (%s, %s)", rank, len(ordered), backend,
                device)
    return dist.group.WORLD


def destroy_process_group():
    """Tear the default process group down, if there is one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


PROCESS_GROUP_TEARDOWN_S = 30.0


def teardown_process_group(timeout_s=PROCESS_GROUP_TEARDOWN_S):
    """Tear the default process group down under a deadline -> None.

    The elastic reform's teardown: an NCCL group is aborted (its
    communicators may be stuck on the dead peer), any other destroyed, on a
    thread joined for ``timeout_s``, so that a hung teardown cannot wedge a
    survivor; it raises ``PlatformError`` instead. A gloo group closes its
    connections only once nothing references it any more, so the caller
    drops its references first; the collection here frees the rest, and a
    survivor blocked on this rank in a collective fails at once instead of
    waiting out the collective timeout.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        gc.collect()
        return
    from ..telemetry.tracing import trace_span

    def _teardown():
        c10d = dist.distributed_c10d
        abort = getattr(c10d, "_abort_process_group", None)
        if dist.get_backend() == "nccl" and abort is not None:
            abort()
        else:
            dist.destroy_process_group()

    errors = []

    def _run():
        try:
            _teardown()
        except Exception as e:  # a failed teardown of a broken group
            errors.append(e)

    with trace_span("reform.teardown"):
        worker = threading.Thread(target=_run, daemon=True, name="process-group-teardown")
        worker.start()
        worker.join(timeout_s)
        if worker.is_alive():
            raise exc.PlatformError(
                "the old process group did not tear down within {:.0f}s".format(timeout_s))
        if errors:
            logger.warning("process group teardown raised (%s); continuing", errors[0])
        gc.collect()


def reform_process_group(survivors, current_host, device, generation):
    """Re-form the default process group over the sorted ``survivors``
    (rank = index) after a shrink -> the new group.

    The old group is torn down first (``teardown_process_group``, bounded;
    a no-op when the drain already did it). The new group's store listens
    on ``SM_PROCESS_GROUP_PORT`` + ``generation``: the old store's port may
    still be in TIME_WAIT, or held by the dead peer's half-open connections.
    """
    teardown_process_group()
    return init_process_group(survivors, current_host, device,
                              port=process_group_port() + int(generation))
