"""Cluster telemetry plane: the round state the training loop publishes,
the process runtime gauges, and the multi-host heartbeats.

* ``ROUND_STATE`` (``RoundState``): ``RoundTimer`` notes every round's
  latency; a snapshot gives the round counter and p50 / p95, which the
  heartbeat sender and ``/status`` read.
* Runtime gauges: process RSS, open file descriptors, Python threads and
  the card's allocated bytes, refreshed right before each ``/metrics``
  render. The counterpart of an XLA compile is an nvcc build of the
  kernels (``_build.py``): ``compile_stats`` counts the builds this process
  ran and their seconds (a process builds once, at its first kernel
  launch), and each build is a ``xla.compile`` span when tracing is on.
* Heartbeats (``SM_HEARTBEAT_INTERVAL_S``), the JAX package's multi-host
  half: every participating host runs a **HeartbeatSender** daemon that
  each interval sends one framed JSON payload (round counter, round
  latency p50 / p95, RSS, device bytes, build totals, uptime) to rank 0's
  **HeartbeatAggregator**, in the rendezvous channel's framing
  (``parallel/distributed.py``). Sends are fire-and-forget: bounded
  timeouts, backoff, one warning an outage. Rank 0 folds them into
  per-rank ``cluster_*`` gauges and detects stragglers (a host whose
  round p50 exceeds ``SM_STRAGGLER_FACTOR`` x its peers' median) and stale
  hosts (``SM_STALE_HEARTBEATS`` missed intervals); with
  ``SM_ABORT_ON_STALE`` a stale host triggers the coordinated abort, with
  ``SM_ELASTIC`` a shrink to the survivors where the floors allow
  (``training/watchdog.py``, ``training/elastic.py``). ``SM_CLUSTER_METRICS`` serves rank 0's
  registry as Prometheus text.

With ``SM_HEARTBEAT_INTERVAL_S`` unset the heartbeat plane is inert:
``start_cluster_telemetry`` returns None having made no thread and no
socket.
"""

import collections
import logging
import os
import socket
import threading
import time

from ..parallel.distributed import frame_message
from ..utils.envconfig import env_float, env_int, env_port
from . import tracing
from .emit import emit_metric
from .registry import REGISTRY, percentile

logger = logging.getLogger(__name__)

logger = logging.getLogger(__name__)

HEARTBEAT_INTERVAL_ENV = "SM_HEARTBEAT_INTERVAL_S"
HEARTBEAT_PORT_ENV = "SM_HEARTBEAT_PORT"
HEARTBEAT_TIMEOUT_ENV = "SM_HEARTBEAT_TIMEOUT_S"
CLUSTER_METRICS_ENV = "SM_CLUSTER_METRICS"
STRAGGLER_FACTOR_ENV = "SM_STRAGGLER_FACTOR"
STALE_HEARTBEATS_ENV = "SM_STALE_HEARTBEATS"

# NOT 9100: that's node_exporter's well-known port, and a Prometheus
# scraper probing it would talk HTTP at the heartbeat framing
DEFAULT_HEARTBEAT_PORT = 9199
HEARTBEAT_VERSION = 1

# sender backoff never sleeps longer than this between attempts, so a
# recovered aggregator sees heartbeats again within a bounded delay
_MAX_BACKOFF_S = 60.0

# a heartbeat payload is <1KB of JSON; anything bigger is a stray client
# (an HTTP request line parses as a ~500MB u32 length) — reject before
# allocating or blocking on it
_MAX_FRAME_BYTES = 1 << 20


def heartbeat_interval():
    return env_float(HEARTBEAT_INTERVAL_ENV, 0.0, minimum=0.0)


def heartbeat_timeout():
    return env_float(HEARTBEAT_TIMEOUT_ENV, 2.0, minimum=0.1, maximum=30.0)


def straggler_factor():
    return env_float(STRAGGLER_FACTOR_ENV, 3.0, minimum=1.0)


def stale_heartbeats():
    return env_int(STALE_HEARTBEATS_ENV, 3, minimum=1)




# --------------------------------------------------------------- round state
class RoundState:
    """Thread-safe bridge between the training round loop and its readers.

    ``RoundTimer.after_iteration`` calls :meth:`note_round` every round (a
    deque append under a lock). Only the last ``maxlen`` round times are
    kept, so a long job costs the same bytes as a short one. The
    process-wide ``ROUND_STATE`` is last-writer-wins: sequential k-fold CV
    feeds it fold by fold.
    """

    def __init__(self, maxlen=512):
        self._lock = threading.Lock()
        self._times_ms = collections.deque(maxlen=maxlen)
        self._round = -1
        self._total = 0

    def note_round(self, round_index, elapsed_s):
        with self._lock:
            self._round = int(round_index)
            self._total += 1
            self._times_ms.append(float(elapsed_s) * 1000.0)

    def reset(self):
        with self._lock:
            self._times_ms.clear()
            self._round = -1
            self._total = 0

    def snapshot(self):
        """-> dict(round, rounds_total, last_round_ms, round_ms_p50/_p95)."""
        with self._lock:
            times = list(self._times_ms)
            rnd = self._round
            total = self._total
        if times:
            return {
                "round": rnd,
                "rounds_total": total,
                "last_round_ms": round(times[-1], 3),
                "round_ms_p50": round(percentile(times, 0.5), 3),
                "round_ms_p95": round(percentile(times, 0.95), 3),
            }
        return {
            "round": rnd,
            "rounds_total": total,
            "last_round_ms": 0.0,
            "round_ms_p50": 0.0,
            "round_ms_p95": 0.0,
        }


ROUND_STATE = RoundState()


# ------------------------------------------------------ device-runtime gauges
_runtime_lock = threading.Lock()
_compile_stats = {"count": 0, "seconds": 0.0}


def note_build(seconds):
    """One kernel build of this process (``_build.py``): count it, add its
    seconds, and record it as a span under the open one."""
    with _runtime_lock:
        _compile_stats["count"] += 1
        _compile_stats["seconds"] += float(seconds)
    REGISTRY.counter("xla_compile_total", help="Kernel builds (nvcc) run by this process").inc()
    REGISTRY.counter(
        "xla_compile_seconds_total", help="Cumulative kernel build (nvcc) time"
    ).inc(float(seconds))
    tracing.record_compile(float(seconds))


def register_runtime_gauges():
    """Prime the process gauges (idempotent; starts nothing). Call at
    training and serving start-up."""
    refresh_runtime_gauges()


def compile_stats():
    with _runtime_lock:
        return dict(_compile_stats)


def _rss_bytes():
    try:
        import psutil

        return int(psutil.Process().memory_info().rss)
    except Exception:
        pass
    try:
        import resource

        # ru_maxrss is KB on Linux: the high-water mark, not the current
        # size, but an honest upper bound when psutil is missing
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return 0


def _open_fds():
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        try:
            import psutil

            return int(psutil.Process().num_fds())
        except Exception:
            return 0


def _device_live_bytes():
    """The card's allocated bytes, through ``telemetry/device.py``'s cached
    sampler (0 on the CPU, where torch keeps no allocator tally)."""
    try:
        from . import device

        return int(device.sample_device_memory()["total_bytes_in_use"])
    except Exception:
        return 0


def runtime_snapshot():
    """-> dict of host and device runtime stats."""
    comp = compile_stats()
    return {
        "rss_bytes": _rss_bytes(),
        "open_fds": _open_fds(),
        "threads": threading.active_count(),
        "device_bytes": _device_live_bytes(),
        "compile_count": comp["count"],
        "compile_seconds": round(comp["seconds"], 3),
    }


def refresh_runtime_gauges(registry=None):
    """Write the current runtime snapshot into the process gauges; the
    ``/metrics`` route calls it before each render. Safe to call anytime."""
    reg = registry or REGISTRY
    snap = runtime_snapshot()
    reg.gauge("process_rss_bytes", help="Resident set size").set(snap["rss_bytes"])
    reg.gauge("process_open_fds", help="Open file descriptors").set(snap["open_fds"])
    reg.gauge("process_threads", help="Live Python threads").set(snap["threads"])
    reg.gauge(
        "device_live_bytes", help="Live device buffer bytes (allocator or live arrays)"
    ).set(snap["device_bytes"])
    return snap


# ------------------------------------------------------------------- sender
class HeartbeatSender:
    """Per-host heartbeat daemon: one framed JSON payload per interval to
    the rank-0 aggregator. Fire-and-forget — bounded connect/send timeouts,
    exponential backoff while the aggregator is unreachable, one warning
    per outage episode — so a dead aggregator costs warnings, never rounds.
    """

    def __init__(
        self,
        rank,
        host,
        aggregator_addr,
        interval,
        timeout=None,
        round_state=None,
        registry=None,
    ):
        self.rank = rank
        self.host = host
        self.aggregator_addr = aggregator_addr
        self.interval = float(interval)
        self.timeout = timeout if timeout is not None else heartbeat_timeout()
        self.round_state = round_state or ROUND_STATE
        self._reg = registry or REGISTRY
        self._started_at = time.monotonic()
        self._stop = threading.Event()
        self._delay = self.interval
        self._outage = False
        labels = {"rank": str(rank)}
        self._m_sent = self._reg.counter(
            "cluster_heartbeats_sent_total", "Heartbeats delivered to rank 0", labels
        )
        self._m_failed = self._reg.counter(
            "cluster_heartbeat_failures_total",
            "Heartbeat sends that failed (aggregator unreachable)",
            labels,
        )
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="cluster-heartbeat-send"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        self._thread.join(timeout)

    def build_payload(self, runtime=None):
        payload = {
            "type": "heartbeat",
            "v": HEARTBEAT_VERSION,
            "rank": self.rank,
            "host": self.host,
            "uptime_s": round(time.monotonic() - self._started_at, 1),
        }
        payload.update(self.round_state.snapshot())
        payload.update(runtime if runtime is not None else runtime_snapshot())
        return payload

    def send_once(self):
        """One bounded-timeout delivery attempt; returns True on success.
        Never raises — delivery failure is an expected, counted condition."""
        # one runtime sweep per interval, shared by the local gauges and the
        # payload
        runtime = refresh_runtime_gauges(self._reg)
        try:
            sock = socket.create_connection(self.aggregator_addr, timeout=self.timeout)
            try:
                sock.settimeout(self.timeout)
                sock.sendall(frame_message(self.build_payload(runtime)))
            finally:
                sock.close()
        except OSError as e:
            self._m_failed.inc()
            if not self._outage:
                self._outage = True
                logger.warning(
                    "heartbeat to %s:%s failed (%s); backing off — training "
                    "continues, further failures counted in "
                    "cluster_heartbeat_failures_total",
                    self.aggregator_addr[0],
                    self.aggregator_addr[1],
                    e,
                )
            # cap backoff below the default stale cutoff (3x interval): a
            # transient send failure must never silence a healthy host long
            # enough for rank 0 to declare it stale
            self._delay = min(
                max(self._delay * 2, self.interval),
                2.0 * self.interval,
                _MAX_BACKOFF_S,
            )
            return False
        self._m_sent.inc()
        if self._outage:
            self._outage = False
            logger.info("heartbeat delivery to rank 0 recovered")
        self._delay = self.interval
        return True

    def _run(self):
        while not self._stop.wait(self._delay):
            self.send_once()


def _recv_frame_bounded(sock, timeout):
    """One frame under a TOTAL deadline (trickle-proof) with the heartbeat
    size cap. The deadline machinery lives in ``recv_message_bounded``
    (parallel/distributed.py) — one implementation for every control-plane
    reader (rendezvous, heartbeats, abort frames)."""
    from ..parallel.distributed import recv_message_bounded

    return recv_message_bounded(sock, timeout, max_bytes=_MAX_FRAME_BYTES)


# --------------------------------------------------------------- aggregator
class HeartbeatAggregator:
    """Rank-0 side: accept heartbeats, fold them into per-rank ``cluster_*``
    gauges, and once per interval evaluate straggler/stale conditions and
    emit one ``cluster.heartbeat`` structured record."""

    def __init__(
        self,
        num_hosts,
        interval,
        port=0,
        registry=None,
        factor=None,
        stale_after=None,
        hosts=None,
        on_stale=None,
    ):
        self.num_hosts = num_hosts
        self.interval = float(interval)
        self.factor = factor if factor is not None else straggler_factor()
        self.stale_after = stale_after if stale_after is not None else stale_heartbeats()
        # detection -> action hook: called once per stale episode with
        # (rank, host, age_s). The supervision layer (training/watchdog.py)
        # plugs the coordinated abort in here; None observes and warns only.
        self.on_stale = on_stale
        self._reg = registry or REGISTRY
        self._stop = threading.Event()
        self._lock = threading.Lock()
        now = time.monotonic()
        # every expected rank starts "seen now": a host that never reports
        # goes stale after the same grace period as one that died mid-run
        self._hosts = {
            r: {
                "host": (hosts[r] if hosts and r < len(hosts) else None),
                "last_seen": now,
                "count": 0,
                "payload": None,
                "straggling": False,
                "stale": False,
            }
            for r in range(num_hosts)
        }
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", port))
        self._server.listen(max(num_hosts, 8))
        self._server.settimeout(min(0.2, self.interval / 4 or 0.2))
        self.port = self._server.getsockname()[1]
        self._reg.gauge("cluster_expected_hosts", "Hosts in the training cluster").set(
            num_hosts
        )
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="cluster-heartbeat-agg"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        self._thread.join(timeout)
        try:
            self._server.close()
        except OSError:
            pass

    # ------------------------------------------------------------ fold path
    def _gauge(self, name, help_text, rank):
        return self._reg.gauge(name, help_text, {"rank": str(rank)})

    def fold(self, payload):
        """Fold one heartbeat payload into the registry; junk is dropped."""
        if not isinstance(payload, dict) or payload.get("type") != "heartbeat":
            return False
        try:
            rank = int(payload["rank"])
        except (KeyError, TypeError, ValueError):
            return False
        if not 0 <= rank < self.num_hosts:
            logger.warning("dropping heartbeat from unknown rank %r", rank)
            return False
        with self._lock:
            entry = self._hosts[rank]
            entry["last_seen"] = time.monotonic()
            entry["count"] += 1
            entry["payload"] = payload
            if payload.get("host"):
                entry["host"] = payload["host"]
        self._reg.counter(
            "cluster_heartbeats_received_total",
            "Heartbeats folded in by rank 0",
            {"rank": str(rank)},
        ).inc()
        for name, help_text, key in (
            ("cluster_round", "Last boosting round reported by the host", "round"),
            ("cluster_last_round_ms", "Host's most recent round latency", "last_round_ms"),
            ("cluster_round_ms_p50", "Host's rolling round latency p50", "round_ms_p50"),
            ("cluster_round_ms_p95", "Host's rolling round latency p95", "round_ms_p95"),
            ("cluster_rss_bytes", "Host resident set size", "rss_bytes"),
            ("cluster_device_bytes", "Host live device buffer bytes", "device_bytes"),
            ("cluster_open_fds", "Host open file descriptors", "open_fds"),
            ("cluster_threads", "Host live Python threads", "threads"),
            ("cluster_compile_count", "Host kernel builds so far", "compile_count"),
            ("cluster_compile_seconds", "Host cumulative kernel build time", "compile_seconds"),
            ("cluster_uptime_seconds", "Host heartbeat-daemon uptime", "uptime_s"),
        ):
            value = payload.get(key)
            if isinstance(value, (int, float)):
                self._gauge(name, help_text, rank).set(value)
        return True

    # ------------------------------------------------------- detection path
    def evaluate(self):
        """One detection tick: heartbeat ages, stale hosts, stragglers, and
        the per-interval ``cluster.heartbeat`` record."""
        now = time.monotonic()
        stale_cutoff = self.stale_after * self.interval
        with self._lock:
            entries = {r: dict(e) for r, e in self._hosts.items()}
        latencies = {}
        reporting = 0
        rounds = {}
        for rank, entry in entries.items():
            age = now - entry["last_seen"]
            self._gauge(
                "cluster_heartbeat_age_seconds",
                "Seconds since the host's last heartbeat",
                rank,
            ).set(round(age, 3))
            payload = entry["payload"]
            is_stale = age > stale_cutoff
            if not is_stale and payload is not None:
                reporting += 1
            if payload is not None:
                rounds[str(rank)] = payload.get("round", -1)
                # compare rolling p50s, not single rounds: one GC-paused
                # round must not flag a healthy host (especially at n=2,
                # where the comparison is against a single peer); a real
                # straggler drags its p50 within ~half a state window
                p50_ms = payload.get("round_ms_p50") or 0.0
                last_ms = payload.get("last_round_ms") or 0.0
                candidate = float(p50_ms if p50_ms > 0 else last_ms)
                if not is_stale and candidate > 0:
                    latencies[rank] = candidate
            self._set_episode(rank, entry, "stale", is_stale, now=now, age=age)
        median_ms = percentile(list(latencies.values()), 0.5) if latencies else 0.0
        if len(latencies) >= 2:
            for rank, cand_ms in latencies.items():
                # median of the PEERS, excluding the candidate: an
                # all-ranks median contains the straggler's own latency,
                # which at n=2 makes the trigger algebraically impossible
                # (b > factor*(a+b)/2 has no solution for factor >= 2)
                peer_median = percentile(
                    [v for r, v in latencies.items() if r != rank], 0.5
                )
                is_straggler = peer_median > 0 and cand_ms > self.factor * peer_median
                self._set_episode(
                    rank,
                    entries[rank],
                    "straggling",
                    is_straggler,
                    round_ms=cand_ms,
                    median_ms=peer_median,
                )
        else:
            # a 1-host "cluster" (or nobody reporting) has no peers to
            # compare against; clear any leftover episode flags
            for rank in latencies:
                self._set_episode(rank, entries[rank], "straggling", False)
        self._reg.gauge(
            "cluster_reporting_hosts", "Hosts with a fresh heartbeat"
        ).set(reporting)
        emit_metric(
            "cluster.heartbeat",
            hosts=self.num_hosts,
            reporting=reporting,
            median_round_ms=round(median_ms, 3),
            rounds=rounds,
        )

    def _set_episode(self, rank, entry, kind, active, **fields):
        """Edge-triggered episode bookkeeping: warn + emit once when a rank
        enters a bad state, log recovery once when it leaves."""
        with self._lock:
            was = self._hosts[rank][kind]
            self._hosts[rank][kind] = active
        if active == was:
            return
        host = entry.get("host") or "rank-{}".format(rank)
        if kind == "stale":
            counter = self._reg.counter(
                "cluster_stale_episodes_total",
                "Times a host went stale (missed heartbeats)",
                {"rank": str(rank)},
            )
            if active:
                counter.inc()
                age = fields.get("age", 0.0)
                logger.warning(
                    "host %s (rank %d) is stale: no heartbeat for %.1fs "
                    "(threshold %.1fs) — wedged host or network partition",
                    host,
                    rank,
                    age,
                    self.stale_after * self.interval,
                )
                emit_metric(
                    "cluster.host_stale",
                    rank=rank,
                    host=host,
                    age_s=round(age, 1),
                    threshold_s=round(self.stale_after * self.interval, 1),
                )
                if self.on_stale is not None:
                    try:
                        self.on_stale(rank, host, age)
                    except Exception:
                        logger.exception("on_stale hook failed; detection continues")
            else:
                logger.info("host %s (rank %d) heartbeats resumed", host, rank)
        else:
            counter = self._reg.counter(
                "cluster_straggler_episodes_total",
                "Times a host entered a straggler episode",
                {"rank": str(rank)},
            )
            if active:
                counter.inc()
                round_ms = fields.get("round_ms", 0.0)
                median_ms = fields.get("median_ms", 0.0)
                logger.warning(
                    "host %s (rank %d) is straggling: round latency p50 "
                    "%.1f ms vs peer median %.1f ms (factor %.1fx > %.1fx "
                    "threshold)",
                    host,
                    rank,
                    round_ms,
                    median_ms,
                    round_ms / median_ms if median_ms else float("inf"),
                    self.factor,
                )
                emit_metric(
                    "cluster.straggler",
                    rank=rank,
                    host=host,
                    round_ms=round(round_ms, 3),
                    median_round_ms=round(median_ms, 3),
                    factor=round(round_ms / median_ms, 2) if median_ms else 0.0,
                )
            else:
                logger.info("host %s (rank %d) caught back up", host, rank)

    # -------------------------------------------------------------- accept
    def _run(self):
        next_eval = time.monotonic() + self.interval
        while not self._stop.is_set():
            try:
                conn, _addr = self._server.accept()
            except socket.timeout:
                pass
            except OSError:
                break  # socket closed under us
            else:
                try:
                    self.fold(_recv_frame_bounded(conn, heartbeat_timeout()))
                except Exception as e:
                    logger.debug("dropping malformed heartbeat: %s", e)
                finally:
                    try:
                        conn.close()
                    except OSError:
                        pass
            if time.monotonic() >= next_eval:
                try:
                    self.evaluate()
                except Exception:
                    logger.exception("cluster evaluation failed; continuing")
                next_eval = time.monotonic() + self.interval
        try:
            self._server.close()
        except OSError:
            pass


# -------------------------------------------------------- metrics exposition
class ClusterMetricsServer:
    """Tiny Prometheus endpoint on the ``SM_CLUSTER_METRICS`` port (rank 0).

    The serving stack's ``GET /metrics`` rides the inference port and its
    WSGI middleware; training jobs have no HTTP surface at all, so the
    cluster plane brings its own single-purpose server rendering the same
    registry exposition.
    """

    def __init__(self, port, registry=None):
        from wsgiref.simple_server import WSGIRequestHandler, make_server

        from .prometheus import exposition_response

        reg = registry or REGISTRY

        def app(environ, start_response):
            if environ.get("PATH_INFO") in ("/", "/metrics"):
                status, headers, body = exposition_response(
                    reg, refresh_runtime_gauges
                )
                start_response(status, headers)
                return [body]
            body = b"not found"
            start_response(
                "404 Not Found",
                [("Content-Type", "text/plain"), ("Content-Length", str(len(body)))],
            )
            return [body]

        class _Quiet(WSGIRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("%s - %s", self.address_string(), fmt % args)

        self._httpd = make_server("0.0.0.0", port, app, handler_class=_Quiet)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="cluster-metrics-http"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._httpd.shutdown()
        self._thread.join(timeout)
        self._httpd.server_close()


# ---------------------------------------------------------------- lifecycle
class ClusterTelemetry:
    """Handle bundling this host's cluster-plane components."""

    def __init__(self, rank, sender=None, aggregator=None, metrics_server=None):
        self.rank = rank
        self.sender = sender
        self.aggregator = aggregator
        self.metrics_server = metrics_server

    def stop(self, timeout=5.0):
        global _active_plane
        for part in (self.sender, self.metrics_server, self.aggregator):
            if part is not None:
                try:
                    part.stop(timeout)
                except Exception:
                    logger.exception("error stopping cluster telemetry component")
        with _plane_lock:
            if _active_plane is self:
                _active_plane = None


_plane_lock = threading.Lock()
_active_plane = None


def stop_cluster_telemetry():
    """Stop the active cluster plane (if any): teardown and test cleanup.
    Safe to call when inert."""
    global _active_plane
    with _plane_lock:
        plane, _active_plane = _active_plane, None
    if plane is not None:
        plane.stop()


def start_cluster_telemetry(hosts, current_host, registry=None):
    """Bring up this host's share of the cluster plane; the single wiring
    entrypoint called from the distributed-training path.

    Inert unless ``SM_HEARTBEAT_INTERVAL_S`` is set > 0: returns ``None``
    having created no thread, no socket, and no registry series. Rank 0
    gets the aggregator (and, when ``SM_CLUSTER_METRICS`` names a port, the
    Prometheus endpoint); every rank — including 0, over loopback, for one
    uniform code path — gets a sender.

    One plane per process: a second call (in-process retry, test harness)
    stops the previous instance first, so the heartbeat port re-binds
    cleanly and the same rank never heartbeats twice.
    """
    global _active_plane
    interval = heartbeat_interval()
    if interval <= 0:
        return None
    with _plane_lock:
        prev, _active_plane = _active_plane, None
    if prev is not None:
        logger.info("restarting cluster telemetry (previous plane stopped)")
        prev.stop()
    register_runtime_gauges()
    ordered = sorted(hosts)
    rank = ordered.index(current_host)
    port = env_port(HEARTBEAT_PORT_ENV, DEFAULT_HEARTBEAT_PORT)
    aggregator = None
    metrics_server = None
    if rank == 0:
        on_stale = None
        from ..training.elastic import is_active as elastic_active
        from ..training.watchdog import abort_on_stale_enabled

        if abort_on_stale_enabled() or elastic_active():
            # promote detection into action, once per stale episode: a
            # shrink (SM_ELASTIC) or the coordinated abort, as the watchdog
            # decides. The lazy import inside the hook keeps the telemetry
            # package free of import cycles.
            def on_stale(stale_rank, stale_host, age_s):
                from ..training.watchdog import handle_stale_host

                handle_stale_host(
                    ordered, current_host, stale_rank, stale_host, age_s
                )

        try:
            aggregator = HeartbeatAggregator(
                num_hosts=len(ordered),
                interval=interval,
                port=port,
                registry=registry,
                hosts=ordered,
                on_stale=on_stale,
            ).start()
        except OSError as e:
            logger.warning(
                "cluster aggregator could not bind port %d (%s); heartbeats "
                "from workers will be dropped but training continues",
                port,
                e,
            )
        metrics_port = env_int(CLUSTER_METRICS_ENV, 0, minimum=0, maximum=65535)
        if metrics_port:
            try:
                metrics_server = ClusterMetricsServer(metrics_port, registry=registry).start()
                logger.info(
                    "cluster Prometheus exposition on port %d", metrics_server.port
                )
            except OSError as e:
                logger.warning("cluster metrics port %d unavailable: %s", metrics_port, e)
    target_host = "127.0.0.1" if rank == 0 else ordered[0]
    sender = HeartbeatSender(
        rank=rank,
        host=current_host,
        aggregator_addr=(target_host, port),
        interval=interval,
        registry=registry,
    ).start()
    logger.info(
        "cluster telemetry up: rank %d/%d, heartbeat every %.1fs to %s:%d%s",
        rank,
        len(ordered),
        interval,
        target_host,
        port,
        " (aggregating)" if aggregator else "",
    )
    plane = ClusterTelemetry(
        rank=rank, sender=sender, aggregator=aggregator, metrics_server=metrics_server
    )
    with _plane_lock:
        _active_plane = plane
    return plane
