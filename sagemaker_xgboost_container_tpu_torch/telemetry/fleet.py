"""Fleet observability plane: cross-rank trace aggregation, span-level
straggler attribution, and the rank-0 live status endpoint.

The port's counterpart of the JAX package's ``telemetry/fleet.py``. Every
rank has a flight recorder and a per-rank Chrome-trace export
(``telemetry/tracing.py``), and rank 0 a heartbeat straggler verdict
(``telemetry/cluster.py``); this module shows the *fleet*, in three pieces:

* **Span shipping** (``SM_FLEET_TRACE``): every rank runs a
  :class:`SpanShipper` daemon (the heartbeat sender's pattern:
  ``Event.wait`` loop, bounded connect/send timeouts, backoff, warn-once
  per outage) that drains newly finished spans from the flight recorder
  and ships them as framed JSON (``parallel/distributed.py`` framing) to
  rank 0's :class:`FleetCollector`. Unset: zero threads, zero sockets,
  zero spans shipped.
* **Merged trace + skew fold**: the collector keeps a bounded per-rank
  span buffer and writes one ``trace-fleet.json`` with pid=rank lanes next
  to the per-rank exports (one Perfetto load shows every rank's round N
  stacked). As round root spans arrive it folds each round's per-rank
  ``host_dispatch`` / ``device_sync`` / ``collective.dispatch`` durations
  into a per-round skew report: the ``round_skew_ms`` gauge and a
  ``training.skew`` record naming the critical rank and the phase that
  made it critical (host, device, collective or wire).
* **Live introspection** (``SM_STATUS_PORT``): a rank-0 HTTP endpoint
  serving ``/status`` (round progress and ETA, rolling attribution, recent
  skew, last checkpoint, backend init error, serving SLO), ``/debug/flight``
  (the live span snapshot: the flight recorder without the abort) and
  ``/debug/profile`` (a bounded ``torch.profiler`` capture). The SIGQUIT
  handler (:func:`install_sigquit_handler`) dumps the same view to disk on
  ``kill -3`` without killing the job.

Timestamp caveat: span clocks are each host's Unix clock
(telemetry/tracing.py ``now_ns``, the profiler's), so lanes in the merged
trace share an epoch only as far as the hosts' clocks agree — read
within-lane structure and cross-lane *durations*, not cross-lane offsets.
The skew fold compares durations only, so it is immune.
"""

import collections
import json
import logging
import os
import signal
import socket
import threading
import time

from ..parallel.distributed import frame_message, recv_message_bounded
from ..utils.envconfig import env_bool, env_float, env_int, env_port
from . import tracing
from .cluster import ROUND_STATE
from .emit import emit_metric
from .registry import REGISTRY, percentile

logger = logging.getLogger(__name__)

FLEET_TRACE_ENV = "SM_FLEET_TRACE"
FLEET_TRACE_PORT_ENV = "SM_FLEET_TRACE_PORT"
FLEET_FLUSH_ENV = "SM_FLEET_FLUSH_S"
STATUS_PORT_ENV = "SM_STATUS_PORT"

# the control-plane port ladder, the JAX package's: 9099 rendezvous, 9199
# heartbeat, 9299 abort, 9399 consensus, 9499 reform, 9599 ingest; the
# process group's store listens on SM_PROCESS_GROUP_PORT (12355), and after
# the g-th elastic shrink on SM_PROCESS_GROUP_PORT + g
DEFAULT_FLEET_PORT = 9699
DEFAULT_FLUSH_S = 2.0
FLEET_VERSION = 1

# span batches are bigger than heartbeats (hundreds of spans per flush on a
# busy rank) but still bounded: cap the frame well below anything that
# could stall the collector, and chunk batches to stay under it
_MAX_FLEET_FRAME_BYTES = 8 << 20
_BATCH_SPANS = 512

# shipper-side retry queue bound: an unreachable collector must cost
# bounded memory, never an OOM (oldest spans drop first, counted)
_MAX_PENDING_SPANS = 8192

# per-rank collector buffer and skew-report history bounds
_SKEW_HISTORY = 64
_MAX_OPEN_ROUNDS = 128

_MAX_BACKOFF_S = 60.0

#: a rank holding > this factor x the median live device memory is memory-skewed
_MEMORY_SKEW_FACTOR = 1.5

#: /debug/profile bounds: capture length cap and the busy lock (one capture
#: at a time: a profiler session is process-global)
_PROFILE_MAX_MS = 10000
_profile_lock = threading.Lock()
_profile_seq = [0]

_HTTP_STATUS = {
    200: "200 OK",
    400: "400 Bad Request",
    404: "404 Not Found",
    409: "409 Conflict",
    500: "500 Internal Server Error",
}

#: child-span name -> attribution component (the round root's remainder is
#: "wire": time the critical rank spent that no instrumented phase explains)
_PHASE_SPANS = {
    "host_dispatch": "host",
    "device_sync": "device",
    "collective.dispatch": "collective",
}
_COMPONENTS = ("host", "device", "collective")


def fleet_enabled():
    return env_bool(FLEET_TRACE_ENV, False)


def fleet_flush_interval():
    return env_float(FLEET_FLUSH_ENV, DEFAULT_FLUSH_S, minimum=0.1, maximum=60.0)


def _fleet_timeout():
    # reuse the heartbeat plane's bounded-send knob semantics: one knob for
    # every control-plane timeout would be ideal, and it already exists
    from .cluster import heartbeat_timeout

    return heartbeat_timeout()


# ------------------------------------------------------------- status state
# Facts the trainer publishes for the /status endpoint and the SIGQUIT dump:
# planned rounds (ETA), the rolling attribution record, the last checkpoint
# written, and a backend init error when distributed startup failed.
_status_lock = threading.Lock()
_status = {}
_started_at = time.monotonic()

# /status document shape version. Bump when sections are added/renamed so
# dashboards and the fleet smoke drill can detect shape changes instead of
# KeyError-ing on them. v2 = schema_version itself + the model-telemetry
# ``learning``/``drift`` sections (SM_MODEL_TELEMETRY).
STATUS_SCHEMA_VERSION = 2


def _model_doc():
    """The model-telemetry sections shared by ``/status`` and the SIGQUIT
    dump: ``learning`` (per-round stats + curve summary) and ``drift``
    (serving PSI window). {} when SM_MODEL_TELEMETRY is unarmed — the
    sections simply don't render."""
    doc = {}
    try:
        from . import model as model_telemetry

        learning = model_telemetry.learning_status()
        if learning:
            doc["learning"] = learning
        drift = model_telemetry.drift_status()
        if drift:
            doc["drift"] = drift
    except Exception:
        logger.debug("model telemetry status unavailable", exc_info=True)
    return doc


def note_status(**fields):
    """Merge ``fields`` into the process status dict (None removes a key).
    Cheap and lock-bounded — safe from any thread, inert when nothing ever
    reads it (the dict is only rendered by /status and the SIGQUIT dump)."""
    with _status_lock:
        for key, value in fields.items():
            if value is None:
                _status.pop(key, None)
            else:
                _status[key] = value


def note_attribution(fields):
    """Publish the latest (rolling or final) training.attribution shape —
    wired from RoundTimer so /status carries mid-job attribution."""
    note_status(attribution=dict(fields))


def status_snapshot():
    with _status_lock:
        return dict(_status)


def _memory_doc(collector=None):
    """The memory section shared by ``/status`` and the SIGQUIT dump:
    this rank's device-plane view (current sample, watermark, compiled
    peak) plus, on rank 0, the per-rank watermarks the shipper delivered
    and the memory-skew verdict. {} when the device plane is unarmed and
    no rank ever shipped a watermark — the section simply doesn't render."""
    doc = {}
    try:
        from . import device

        local = device.memory_status()
        if local:
            doc["local"] = local
    except Exception:
        logger.debug("local memory status unavailable", exc_info=True)
    if collector is not None:
        snap = collector.memory_snapshot()
        if snap.get("ranks"):
            doc["ranks"] = snap["ranks"]
            if "memory_skew" in snap:
                doc["memory_skew"] = snap["memory_skew"]
    return doc


# ------------------------------------------------------------------ shipper
class SpanShipper:
    """Per-rank span shipper daemon: drains newly finished spans from the
    tracing flight recorder every ``SM_FLEET_FLUSH_S`` and ships them to
    rank 0 as framed JSON batches. Fire-and-forget like the heartbeat
    sender: bounded timeouts, capped backoff, one warning per outage, a
    bounded retry queue — an absent collector costs warnings, never rounds.

    ``span_source`` (tests, drills) overrides the recorder drain with a
    callable returning wire dicts (see ``tracing.span_to_wire``).
    """

    def __init__(
        self,
        rank,
        host,
        collector_addr,
        interval=None,
        timeout=None,
        span_source=None,
        registry=None,
    ):
        self.rank = int(rank)
        self.host = host
        self.collector_addr = collector_addr
        self.interval = float(interval if interval is not None else fleet_flush_interval())
        self.timeout = timeout if timeout is not None else _fleet_timeout()
        self._span_source = span_source
        self._last_seq = 0
        self._pending = collections.deque()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._delay = self.interval
        self._outage = False
        reg = registry or REGISTRY
        labels = {"rank": str(rank)}
        self._m_shipped = reg.counter(
            "fleet_spans_shipped_total", "Spans delivered to the rank-0 collector", labels
        )
        self._m_failed = reg.counter(
            "fleet_ship_failures_total",
            "Span batch sends that failed (collector unreachable)",
            labels,
        )
        self._m_dropped = reg.counter(
            "fleet_spans_dropped_total",
            "Spans dropped from the bounded retry queue during an outage",
            labels,
        )
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-span-ship"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout)

    def _drain(self):
        """New wire spans since the last drain (recorder-seq watermark)."""
        if self._span_source is not None:
            return list(self._span_source())
        fresh = []
        last = self._last_seq
        for span in tracing.snapshot_spans():
            if span.seq is not None and span.seq > last:
                fresh.append(tracing.span_to_wire(span))
                if span.seq > self._last_seq:
                    self._last_seq = span.seq
        return fresh

    def _memory_wire(self):
        """The device plane's latest device-memory watermark (None when unarmed or
        never sampled) — rides the next span frame so rank 0 can fold a
        per-rank memory view without a second control-plane socket."""
        try:
            from . import device

            return device.watermark_wire()
        except Exception:
            return None

    def send_once(self):
        """One bounded flush attempt; returns True when nothing remains
        pending. Never raises — delivery failure is counted, backed off,
        and retried with the batch intact (bounded)."""
        with self._lock:
            self._pending.extend(self._drain())
            dropped = len(self._pending) - _MAX_PENDING_SPANS
            if dropped > 0:
                for _ in range(dropped):
                    self._pending.popleft()
                self._m_dropped.inc(dropped)
                logger.debug("fleet retry queue full; dropped %d spans", dropped)
            batch = list(self._pending)
        memory = self._memory_wire()
        if not batch and memory is None:
            return True
        sent = 0
        try:
            # a watermark with no spans still ships: one frame with an
            # empty span list carries it (the collector folds both)
            chunks = [
                batch[start : start + _BATCH_SPANS]
                for start in range(0, len(batch), _BATCH_SPANS)
            ] or [[]]
            for index, chunk in enumerate(chunks):
                payload = {
                    "type": "spans",
                    "v": FLEET_VERSION,
                    "rank": self.rank,
                    "host": self.host,
                    "spans": chunk,
                }
                if index == 0 and memory is not None:
                    payload["memory"] = memory
                sock = socket.create_connection(self.collector_addr, timeout=self.timeout)
                try:
                    sock.settimeout(self.timeout)
                    sock.sendall(frame_message(payload))
                finally:
                    sock.close()
                sent += len(chunk)
        except OSError as e:
            self._m_failed.inc()
            if not self._outage:
                self._outage = True
                logger.warning(
                    "fleet span shipping to %s:%s failed (%s); backing off — "
                    "training continues, failures counted in "
                    "fleet_ship_failures_total",
                    self.collector_addr[0],
                    self.collector_addr[1],
                    e,
                )
            self._delay = min(
                max(self._delay * 2, self.interval),
                2.0 * self.interval,
                _MAX_BACKOFF_S,
            )
        else:
            if self._outage:
                self._outage = False
                logger.info("fleet span shipping to rank 0 recovered")
            self._delay = self.interval
        if sent:
            self._m_shipped.inc(sent)
            with self._lock:
                for _ in range(min(sent, len(self._pending))):
                    self._pending.popleft()
        with self._lock:
            return not self._pending

    def flush(self):
        """Best-effort final delivery (end of training, SIGQUIT dump)."""
        return self.send_once()

    def _run(self):
        while not self._stop.wait(self._delay):
            self.send_once()


# ---------------------------------------------------------------- collector
class FleetCollector:
    """Rank-0 side: accept span batches, keep a bounded per-rank buffer for
    the merged trace, and fold per-round per-rank phase durations into skew
    reports (``round_skew_ms`` + ``training.skew``)."""

    def __init__(self, num_ranks, port=0, timeout=None, registry=None, hosts=None):
        self.num_ranks = int(num_ranks)
        self.timeout = timeout if timeout is not None else _fleet_timeout()
        self._reg = registry or REGISTRY
        self._hosts = list(hosts) if hosts else []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        buffer_spans = env_int(
            tracing.TRACE_BUFFER_ENV, tracing.DEFAULT_BUFFER_SPANS, minimum=16
        )
        self._spans = {
            r: collections.deque(maxlen=buffer_spans) for r in range(self.num_ranks)
        }
        # per-rank running phase totals since that rank's last round root;
        # round roots close after their children, and batches preserve
        # recorder order, so attributing the running totals to the next
        # "round" span that arrives is exact
        self._running = {r: dict.fromkeys(_COMPONENTS, 0.0) for r in range(self.num_ranks)}
        self._rounds = {}  # round index -> {rank: per-rank entry}
        self._skew = collections.deque(maxlen=_SKEW_HISTORY)
        self._memory = {}  # rank -> latest device-memory watermark (device plane)
        self._m_received = {
            r: self._reg.counter(
                "fleet_spans_received_total",
                "Spans folded in by the rank-0 collector",
                {"rank": str(r)},
            )
            for r in range(self.num_ranks)
        }
        self._m_skew = self._reg.gauge(
            "round_skew_ms", "Critical-rank minus median round latency, last folded round"
        )
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", port))
        self._server.listen(max(self.num_ranks, 8))
        self._server.settimeout(0.2)
        self.port = self._server.getsockname()[1]
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-span-collect"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout)
        try:
            self._server.close()
        except OSError:
            pass

    # ------------------------------------------------------------ fold path
    def fold(self, payload):
        """Fold one span batch into the buffers; junk is dropped."""
        if not isinstance(payload, dict) or payload.get("type") != "spans":
            return False
        try:
            rank = int(payload["rank"])
        except (KeyError, TypeError, ValueError):
            return False
        if not 0 <= rank < self.num_ranks:
            logger.warning("dropping span batch from unknown rank %r", rank)
            return False
        memory = payload.get("memory")
        if isinstance(memory, dict):
            entry = dict(memory)
            entry["host"] = payload.get("host")
            with self._lock:
                self._memory[rank] = entry
        spans = payload.get("spans")
        if not isinstance(spans, list):
            return False
        reports = []
        with self._lock:
            for wire in spans:
                if not isinstance(wire, dict):
                    continue
                self._spans[rank].append(wire)
                report = self._fold_span_locked(rank, wire)
                if report is not None:
                    reports.append(report)
        self._m_received[rank].inc(len(spans))
        for report in reports:
            self._publish_skew(report)
        return True

    def _fold_span_locked(self, rank, wire):
        name = wire.get("name")
        dur_ms = float(wire.get("dur_us") or 0.0) / 1000.0
        component = _PHASE_SPANS.get(name)
        if component is not None:
            self._running[rank][component] += dur_ms
            return None
        if name != "round":
            return None
        attrs = wire.get("attributes") or {}
        round_index = attrs.get("round")
        running, self._running[rank] = (
            self._running[rank],
            dict.fromkeys(_COMPONENTS, 0.0),
        )
        if not isinstance(round_index, int):
            return None  # the post-training tail span has no round index
        entry = {"total": dur_ms}
        entry.update(running)
        per_rank = self._rounds.setdefault(round_index, {})
        per_rank[rank] = entry
        if len(per_rank) >= self.num_ranks:
            del self._rounds[round_index]
            return self._fold_round_locked(round_index, per_rank)
        # bound the outstanding-round map: a rank that stopped shipping must
        # not grow it forever — oldest incomplete rounds are abandoned
        while len(self._rounds) > _MAX_OPEN_ROUNDS:
            del self._rounds[min(self._rounds)]
        return None

    def _fold_round_locked(self, round_index, per_rank):
        """-> one skew report for a fully reported round (>= 2 ranks)."""
        if len(per_rank) < 2:
            return None
        totals = {r: e["total"] for r, e in per_rank.items()}
        critical = max(totals, key=totals.get)
        median_ms = percentile(list(totals.values()), 0.5)
        skew_ms = totals[critical] - median_ms
        # phase attribution: per component, how much MORE the critical rank
        # spent there than the median rank; the remainder of the round not
        # explained by any instrumented phase is "wire"
        deltas = {}
        for comp in _COMPONENTS:
            values = [e[comp] for e in per_rank.values()]
            deltas[comp] = per_rank[critical][comp] - percentile(values, 0.5)
        residuals = {
            r: e["total"] - sum(e[c] for c in _COMPONENTS) for r, e in per_rank.items()
        }
        deltas["wire"] = residuals[critical] - percentile(list(residuals.values()), 0.5)
        phase = max(deltas, key=deltas.get)
        report = {
            "round": round_index,
            "critical_rank": critical,
            "phase": phase,
            "skew_ms": round(max(skew_ms, 0.0), 3),
            "round_ms": round(totals[critical], 3),
            "median_ms": round(median_ms, 3),
            "phase_excess_ms": round(max(deltas[phase], 0.0), 3),
            "ranks": len(per_rank),
        }
        for comp in _COMPONENTS:
            report["{}_ms".format(comp)] = round(per_rank[critical][comp], 3)
        report["wire_ms"] = round(max(residuals[critical], 0.0), 3)
        if self._hosts and critical < len(self._hosts):
            report["host"] = self._hosts[critical]
        self._skew.append(report)
        return report

    def _publish_skew(self, report):
        self._m_skew.set(report["skew_ms"])
        emit_metric("training.skew", **report)

    # ----------------------------------------------------------- read paths
    def skew_snapshot(self, last=None):
        with self._lock:
            reports = list(self._skew)
        return reports[-last:] if last else reports

    def span_counts(self):
        with self._lock:
            return {r: len(buf) for r, buf in self._spans.items()}

    def memory_snapshot(self):
        """Per-rank device-memory watermarks + a memory-skew verdict: the rank whose
        live bytes exceed 1.5x the cross-rank median (>= 2 reporting ranks)
        is named, so skew attribution can say *memory*-skewed, not just
        slow. Empty ``ranks`` when the device plane never shipped."""
        with self._lock:
            per_rank = {r: dict(m) for r, m in self._memory.items()}
        doc = {"ranks": per_rank}
        values = {
            r: m.get("bytes_in_use", 0)
            for r, m in per_rank.items()
            if isinstance(m.get("bytes_in_use"), (int, float))
        }
        if len(values) >= 2:
            median = percentile(list(values.values()), 0.5)
            worst = max(values, key=values.get)
            if median > 0 and values[worst] > _MEMORY_SKEW_FACTOR * median:
                doc["memory_skew"] = {
                    "rank": worst,
                    "host": per_rank[worst].get("host"),
                    "bytes_in_use": int(values[worst]),
                    "median_bytes": int(median),
                    "ratio": round(values[worst] / median, 2),
                }
        return doc

    def merged_doc(self, extra_metadata=None):
        """-> the merged Chrome-trace dict: one pid=rank lane per rank that
        shipped spans, built by the same event builder as the per-rank
        exports."""
        with self._lock:
            per_rank = {r: list(buf) for r, buf in self._spans.items() if buf}
        events = []
        for rank in sorted(per_rank):
            label = "rank {}".format(rank)
            if self._hosts and rank < len(self._hosts):
                label += " ({})".format(self._hosts[rank])
            events.extend(
                tracing.events_from_wire(per_rank[rank], pid=rank, process_label=label)
            )
        metadata = {
            "merged": True,
            "ranks": sorted(per_rank),
            "spans": sum(len(v) for v in per_rank.values()),
            "clock_note": "per-rank perf_counter bases; compare durations, "
            "not cross-lane offsets",
        }
        if extra_metadata:
            metadata.update(extra_metadata)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": metadata,
        }

    def write_fleet_trace(self, directory, filename="trace-fleet.json"):
        """Write the merged trace next to the per-rank exports and emit one
        ``training.fleet_export`` record. Returns the path (None when no
        rank shipped anything — no empty artifacts)."""
        doc = self.merged_doc()
        if not doc["otherData"]["ranks"]:
            logger.info("no fleet spans collected; skipping merged trace export")
            return None
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, filename)
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        emit_metric(
            "training.fleet_export",
            path=path,
            spans=doc["otherData"]["spans"],
            ranks=doc["otherData"]["ranks"],
        )
        logger.info(
            "exported merged fleet trace (%d spans, ranks %s) to %s",
            doc["otherData"]["spans"],
            doc["otherData"]["ranks"],
            path,
        )
        return path

    # -------------------------------------------------------------- accept
    def _run(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # socket closed under us
            try:
                self.fold(
                    recv_message_bounded(
                        conn, self.timeout, max_bytes=_MAX_FLEET_FRAME_BYTES
                    )
                )
            except Exception as e:
                logger.debug("dropping malformed span batch: %s", e)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
        try:
            self._server.close()
        except OSError:
            pass


# ------------------------------------------------------------ status server
class StatusServer:
    """Rank-0 live introspection endpoint (``SM_STATUS_PORT``): the
    ClusterMetricsServer plumbing serving JSON instead of exposition.

    * ``GET /status`` — round progress + ETA, rolling attribution, recent
      skew reports, last checkpoint, backend init
      error, serving SLO snapshot when armed.
    * ``GET /debug/flight`` — the live span snapshot (finished ring buffer
      + in-flight spans), i.e. the flight recorder without the abort.
    * ``GET /debug/profile?ms=N`` — a bounded on-demand ``torch.profiler``
      capture into ``SM_PROFILER_TRACE_DIR`` (404 while unarmed), so a
      live wedged job can be profiled without restarting it.
    """

    def __init__(self, port, collector=None):
        from wsgiref.simple_server import WSGIRequestHandler, make_server

        self._collector = collector

        def app(environ, start_response):
            path = environ.get("PATH_INFO", "/")
            status = _HTTP_STATUS[200]
            if path in ("/", "/status"):
                body = json.dumps(self.status_doc()).encode("utf-8")
            elif path == "/debug/flight":
                body = json.dumps(self.flight_doc()).encode("utf-8")
            elif path == "/debug/profile":
                code, doc = self.profile_doc(environ.get("QUERY_STRING", ""))
                status = _HTTP_STATUS[code]
                body = json.dumps(doc).encode("utf-8")
            else:
                body = b"not found"
                start_response(
                    "404 Not Found",
                    [
                        ("Content-Type", "text/plain"),
                        ("Content-Length", str(len(body))),
                    ],
                )
                return [body]
            start_response(
                status,
                [
                    ("Content-Type", "application/json"),
                    ("Content-Length", str(len(body))),
                ],
            )
            return [body]

        class _Quiet(WSGIRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("%s - %s", self.address_string(), fmt % args)

        self._httpd = make_server("0.0.0.0", port, app, handler_class=_Quiet)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="fleet-status-http"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._httpd.shutdown()
        self._thread.join(timeout)
        self._httpd.server_close()

    def status_doc(self):
        doc = {
            "schema_version": STATUS_SCHEMA_VERSION,
            "uptime_s": round(time.monotonic() - _started_at, 1),
        }
        doc.update(status_snapshot())
        snap = ROUND_STATE.snapshot()
        doc["round"] = snap
        planned = doc.get("rounds_planned")
        if planned and snap["round_ms_p50"] > 0:
            remaining = max(int(planned) - (snap["round"] + 1), 0)
            doc["eta_s"] = round(remaining * snap["round_ms_p50"] / 1000.0, 1)
        if self._collector is not None:
            doc["skew"] = self._collector.skew_snapshot(last=5)
            doc["fleet_spans"] = self._collector.span_counts()
        # the elastic membership log: one entry a shrink (empty while the
        # membership never changed)
        from ..training.elastic import membership_log

        doc["membership_log"] = membership_log()
        from .slo import active_window

        window = active_window()
        if window is not None:
            doc["slo"] = window.snapshot()
        memory = _memory_doc(self._collector)
        if memory:
            doc["memory"] = memory
        doc.update(_model_doc())
        return doc

    def profile_doc(self, query):
        """``GET /debug/profile?ms=N`` -> (http code, doc): a bounded
        programmatic ``torch.profiler`` capture (CPU, and CUDA where there
        is a card) into ``SM_PROFILER_TRACE_DIR``
        so a live wedged job can be profiled without restarting it. 404
        when the trace dir isn't armed (indistinguishable from an unknown
        path, like the /metrics gate), 409 while another capture runs,
        capture length capped at ``_PROFILE_MAX_MS``."""
        from ..training.profiling import TRACE_DIR_ENV
        from urllib.parse import parse_qs

        trace_dir = os.environ.get(TRACE_DIR_ENV)
        if not trace_dir:
            return 404, {
                "error": "profiling unarmed: set {} to enable on-demand "
                "captures".format(TRACE_DIR_ENV)
            }
        try:
            ms = int(parse_qs(query or "").get("ms", ["1000"])[0])
        except (ValueError, IndexError):
            return 400, {"error": "ms must be an integer"}
        ms = max(1, min(ms, _PROFILE_MAX_MS))
        if not _profile_lock.acquire(blocking=False):
            return 409, {"error": "a profile capture is already running"}
        try:
            import torch

            with _status_lock:
                _profile_seq[0] += 1
                seq = _profile_seq[0]
            out_dir = os.path.join(trace_dir, "ondemand-{}".format(seq))
            os.makedirs(out_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            try:
                time.sleep(ms / 1000.0)
            finally:
                prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        except Exception as e:
            logger.warning("on-demand profile capture failed: %s", e)
            return 500, {"error": str(e)[:400]}
        finally:
            _profile_lock.release()
        emit_metric("training.profile_capture", path=out_dir, ms=ms)
        logger.info("on-demand profile (%d ms) captured to %s", ms, out_dir)
        return 200, {"path": out_dir, "ms": ms}

    def flight_doc(self):
        spans = [
            tracing.span_to_wire(span)
            for span in tracing.snapshot_spans(include_open=True)
        ]
        return {
            "rank": tracing.get_rank(),
            "count": len(spans),
            "spans": spans,
        }


# ---------------------------------------------------------------- lifecycle
class FleetPlane:
    """Handle bundling this host's fleet-observability components."""

    def __init__(self, rank, num_ranks, shipper=None, collector=None, status_server=None):
        self.rank = rank
        self.num_ranks = num_ranks
        self.shipper = shipper
        self.collector = collector
        self.status_server = status_server

    def stop(self, timeout=5.0):
        global _active_plane
        for part in (self.shipper, self.status_server, self.collector):
            if part is not None:
                try:
                    part.stop(timeout)
                except Exception:
                    logger.exception("error stopping fleet plane component")
        with _plane_lock:
            if _active_plane is self:
                _active_plane = None


_plane_lock = threading.Lock()
_active_plane = None


def active_plane():
    return _active_plane


def stop_fleet_plane():
    """Stop the active fleet plane (teardown and test
    cleanup). Safe to call when inert."""
    global _active_plane
    with _plane_lock:
        plane, _active_plane = _active_plane, None
    if plane is not None:
        plane.stop()


def start_fleet_plane(hosts, current_host, registry=None):
    """Bring up this host's share of the fleet plane; wired from the same
    pre-exec path as the cluster heartbeat plane.

    Inert unless ``SM_FLEET_TRACE`` is truthy (shipper on every rank,
    collector on rank 0) or ``SM_STATUS_PORT`` names a port (rank-0 status
    endpoint): with both unset it returns ``None`` having created no
    thread, no socket, and no registry series. One plane per process: a
    second call stops the previous instance first, so the ports re-bind."""
    global _active_plane
    trace_on = fleet_enabled()
    status_port = env_int(STATUS_PORT_ENV, 0, minimum=0, maximum=65535)
    if not trace_on and not status_port:
        return None
    with _plane_lock:
        prev, _active_plane = _active_plane, None
    if prev is not None:
        logger.info("restarting fleet plane (previous plane stopped)")
        prev.stop()
    ordered = sorted(hosts)
    rank = ordered.index(current_host)
    shipper = None
    collector = None
    status_server = None
    if trace_on:
        if not tracing.enabled():
            logger.warning(
                "%s is set but %s is not: no spans exist to ship — enable "
                "SM_TRACE for the fleet view",
                FLEET_TRACE_ENV,
                tracing.TRACE_ENV,
            )
        port = env_port(FLEET_TRACE_PORT_ENV, DEFAULT_FLEET_PORT)
        interval = fleet_flush_interval()
        if rank == 0:
            try:
                collector = FleetCollector(
                    num_ranks=len(ordered),
                    port=port,
                    registry=registry,
                    hosts=ordered,
                ).start()
            except OSError as e:
                logger.warning(
                    "fleet collector could not bind port %d (%s); span "
                    "batches will be dropped but training continues",
                    port,
                    e,
                )
        target_host = "127.0.0.1" if rank == 0 else ordered[0]
        shipper = SpanShipper(
            rank=rank,
            host=current_host,
            collector_addr=(target_host, port),
            interval=interval,
            registry=registry,
        ).start()
        logger.info(
            "fleet trace plane up: rank %d/%d, shipping spans every %.1fs "
            "to %s:%d%s",
            rank,
            len(ordered),
            interval,
            target_host,
            port,
            " (collecting)" if collector else "",
        )
    if status_port and rank == 0:
        try:
            status_server = StatusServer(status_port, collector=collector).start()
            logger.info(
                "status endpoint on port %d (/status, /debug/flight, "
                "/debug/profile)",
                status_server.port,
            )
        except OSError as e:
            logger.warning("status port %d unavailable: %s", status_port, e)
    plane = FleetPlane(
        rank=rank,
        num_ranks=len(ordered),
        shipper=shipper,
        collector=collector,
        status_server=status_server,
    )
    with _plane_lock:
        _active_plane = plane
    return plane


def export_fleet_trace(default_dir=None):
    """End-of-run merge: flush this rank's shipper, then (rank 0) write
    ``trace-fleet.json`` next to the per-rank exports. Best-effort and
    bounded — peers flush concurrently from their own train end, so rank 0
    grants one flush interval of grace before merging whatever arrived.
    Returns the merged path, or None (inert plane / nothing collected /
    not rank 0)."""
    plane = _active_plane
    if plane is None:
        return None
    if plane.shipper is not None:
        plane.shipper.flush()
    if plane.collector is None:
        return None
    if plane.num_ranks > 1:
        # grace for the other ranks' final flush; bounded and best-effort —
        # a dead peer costs this sleep, never a hang
        time.sleep(min(fleet_flush_interval(), 2.0))
    directory = os.environ.get(tracing.TRACE_EXPORT_DIR_ENV) or default_dir
    if not directory:
        return None
    return plane.collector.write_fleet_trace(directory)


# ------------------------------------------------------------- SIGQUIT dump
def _sigquit_dump(default_dir):
    """The kill -3 inspection dump: flight recorder + fleet/status snapshot
    to disk, WITHOUT aborting (exits 79–85 own the abort-path dump). Never
    raises — it runs on a throwaway thread next to a live job."""
    try:
        trace_path = tracing.dump_flight_recorder(
            default_dir=default_dir, reason="sigquit"
        )
        directory = (
            os.environ.get(tracing.TRACE_EXPORT_DIR_ENV) or default_dir or "."
        )
        # build the same /status view without needing a server instance
        doc = {
            "schema_version": STATUS_SCHEMA_VERSION,
            "uptime_s": round(time.monotonic() - _started_at, 1),
        }
        doc.update(status_snapshot())
        doc["round"] = ROUND_STATE.snapshot()
        plane = _active_plane
        if plane is not None and plane.collector is not None:
            doc["skew"] = plane.collector.skew_snapshot()
            doc["fleet_spans"] = plane.collector.span_counts()
        memory = _memory_doc(plane.collector if plane is not None else None)
        if memory:
            doc["memory"] = memory
        doc.update(_model_doc())
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, "fleet-status-rank{}.json".format(tracing.get_rank())
        )
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        emit_metric(
            "training.sigquit_dump",
            status_path=path,
            flight_path=trace_path or "",
        )
        logger.warning(
            "SIGQUIT inspection dump: status %s, flight recorder %s "
            "(job continues)",
            path,
            trace_path,
        )
    except Exception:
        logger.exception("SIGQUIT dump failed; job unaffected")


def install_sigquit_handler(default_dir=None):
    """Arm ``kill -3`` as a live inspection dump (flight recorder + fleet
    skew/status snapshot) that does NOT abort — a wedged-but-alive job can
    be inspected in place. Returns False (and stays inert) off the main
    thread or on platforms without SIGQUIT."""
    if not hasattr(signal, "SIGQUIT"):
        return False

    def _handler(signo, frame):
        # the dump takes locks and touches disk: hand it to a short-lived
        # thread so the handler itself stays async-signal-trivial
        threading.Thread(
            target=_sigquit_dump,
            args=(default_dir,),
            daemon=True,
            name="sigquit-dump",
        ).start()

    try:
        signal.signal(signal.SIGQUIT, _handler)
    except (ValueError, OSError):  # non-main thread / exotic platform
        return False
    return True


def _reset_for_tests():
    """Drop the active plane and the status dict."""
    stop_fleet_plane()
    with _status_lock:
        _status.clear()
