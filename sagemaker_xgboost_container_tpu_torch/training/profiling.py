"""Training profiling: per-round records, attribution and the profiler
trace.

The port's counterpart of the JAX package's ``training/profiling.py``:

* ``RoundTimer``: per-round wall time and throughput. Every round emits one
  structured stdout record (``training.round``, the CloudWatch-regex
  contract) with the round latency and a per-phase breakdown (the span
  recorder drains into it; while the tracer records, the round's device
  stages as ``device.gradient`` ... ``device.margins``, ``ops/stamps``), and
  observes the ``training_round_seconds`` histogram. Human-readable lines
  stay opt-in (``SM_ROUND_TIMING``); the end of the run emits
  ``training.summary``, ``training.attribution`` and, with the device plane
  armed, ``training.roofline``. Device time comes from the stage stamps,
  else from the ``SM_TRACE_DEVICE_SYNC`` fences, else it is not measured:
  attribution's ``device_ms`` reads 0.0 and no roofline is emitted.
* ``torch_trace`` (alias ``xla_trace``, the JAX name, so the training
  entry point reads the same): a ``torch.profiler`` trace of CPU and CUDA
  activity around training when ``SM_PROFILER_TRACE_DIR`` is set, written
  there as a Chrome trace, whose ``baseTimeNanoseconds`` the tracer's own
  export then subtracts too (``tracing.set_chrome_base_ns``).
* the span API (``telemetry.span``): ``algorithm_train`` times data
  ingest, the boosting loop and the model save as named phases.
"""

import contextlib
import logging
import os
import time

from ..telemetry import (
    REGISTRY,
    ROUND_STATE,
    compile_stats,
    emit_metric,
    get_round_fields,
    pop_recorder,
    push_recorder,
    tracing,
)
from ..telemetry import percentile
from ..telemetry import device as device_telemetry
from ..utils.envconfig import env_int
from ..utils.faults import fault_point

logger = logging.getLogger(__name__)

TRACE_DIR_ENV = "SM_PROFILER_TRACE_DIR"

#: emit a rolling ``training.attribution`` record every N rounds (0 = only
#: the final one at after_training) — a week-long job surfaces attribution
#: mid-flight instead of only at the end, and /status reads the same data
ATTRIBUTION_EVERY_ENV = "SM_ATTRIBUTION_EVERY"

ROUND_HISTOGRAM = "training_round_seconds"


class RoundTimer:
    """Per-round timing callback; rides the standard booster protocol.

    ``emit_structured`` controls the per-round ``training.round`` stdout
    record (default on; SM_STRUCTURED_METRICS=false silences it globally).
    ``log_every=0`` disables the human-readable per-round log lines while
    keeping the structured emission and the end-of-run summary.
    ``fold`` tags every record in k-fold CV runs (each fold trains its own
    callback stack, so per-epoch records from different folds must stay
    distinguishable for the CloudWatch regexes).
    """

    # it drains the round's phases and rotates the round's root span: the
    # booster's ``session.callbacks`` leaf ends before it (``_after_iteration``)
    closes_round = True

    def __init__(self, num_rows=None, log_every=10, emit_structured=True, fold=None):
        self.num_rows = num_rows
        self.log_every = log_every
        self.emit_structured = emit_structured
        self.fold = fold
        self._attr_every = env_int(ATTRIBUTION_EVERY_ENV, 0, minimum=0)
        # HBM watermark cadence (SM_DEVICE_TELEMETRY + SM_HBM_SAMPLE_EVERY):
        # 0 when the device plane is unarmed — resolved once here so the
        # per-round path never reads env
        self._hbm_every = device_telemetry.sample_cadence()
        self._last = None
        self._times = []
        self._recorder = None
        self._round_span = None
        self._compile_base = None
        self._compile_total_s = 0.0
        self._phase_totals = {}
        # the rounds whose phases carry stamped device stages, and their wall
        # seconds: a profiler window stamps only some of a run's rounds
        self._stamped_rounds = 0
        self._stamped_s = 0.0

    def before_training(self, model):
        self._last = time.perf_counter()
        # collect span phases (checkpoint saves, eval monitor, ...) per round;
        # popped in after_training. Thread-local, so parallel fold loops on
        # other threads never cross-talk.
        self._recorder = push_recorder()
        # per-round build accounting: a kernel build (nvcc, _build.py feeds
        # compile_stats) completed during a round becomes a `compile` phase
        # key instead of silently inflating build_eval
        self._compile_base = compile_stats()["seconds"]
        self._compile_total_s = 0.0
        self._phase_totals = {}
        self._stamped_rounds = 0
        self._stamped_s = 0.0
        if tracing.enabled():
            # per-round ROOT span: stays open for the whole round, so the
            # phase spans (checkpoint, consensus, eval_monitor, ...) and the
            # booster's dispatch/collective/compile spans nest under it
            # not a profiler range: it encloses the session's leaf spans,
            # which name the trace's idle gaps
            self._round_span = tracing.start_span("round", annotate=False)
        return model

    def after_iteration(self, model, epoch, evals_log):
        # chaos hook: the one per-round fault point every training run owns
        # (RoundTimer is always in the stack) — lets drills stall a round
        # (watchdog tests) or deliver SIGTERM mid-training deterministically
        fault_point("training.round_end", round=epoch)
        now = time.perf_counter()
        if self._last is not None:
            elapsed = now - self._last
            self._times.append(elapsed)
            REGISTRY.histogram(
                ROUND_HISTOGRAM, help="Boosting round wall time"
            ).observe(elapsed)
            # feed the cluster heartbeat's round state (telemetry/cluster.py):
            # a deque append under a lock — negligible, so always on
            ROUND_STATE.note_round(epoch, elapsed)
            if self._hbm_every and epoch % self._hbm_every == 0:
                # per-round device-memory watermark (the cached sampler the
                # runtime gauges share)
                device_telemetry.sample_watermark(epoch)
            phases = self._recorder.drain() if self._recorder is not None else {}
            compile_now = compile_stats()["seconds"]
            compile_delta = (
                max(compile_now - self._compile_base, 0.0)
                if self._compile_base is not None
                else 0.0
            )
            self._compile_base = compile_now
            self._compile_total_s += compile_delta
            # NOTE: a build that completes inside a fenced round is already
            # subtracted from the host_dispatch phase at the source
            # (booster._TrainingSession.run_round measures the overlap),
            # so compile + host_dispatch + build_eval sum without double
            # counting; values only clamp here against float noise
            for name, seconds in phases.items():
                self._phase_totals[name] = (
                    self._phase_totals.get(name, 0.0) + seconds
                )
            if any(name.startswith("device.") for name in phases):
                self._stamped_rounds += 1
                self._stamped_s += elapsed
            if self.emit_structured:
                # callback work is measured by its spans; kernel builds that
                # completed this round get their own key; the remainder is
                # device compute: binning (first round), tree build, eval.
                # One record per round — the CloudWatch-regex contract.
                # The device stages ran on the card, beside the host's time.
                overhead = sum(v for k, v in phases.items() if not k.startswith("device."))
                phases_ms = {
                    k: round(max(v, 0.0) * 1000, 3)
                    for k, v in sorted(phases.items())
                }
                if compile_delta > 0:
                    phases_ms["compile"] = round(compile_delta * 1000, 3)
                phases_ms["build_eval"] = round(
                    max(elapsed - overhead - compile_delta, 0.0) * 1000, 3
                )
                fields = {
                    "round": epoch,
                    "round_ms": round(elapsed * 1000, 3),
                    "phases_ms": phases_ms,
                }
                # session-owned extras (set_round_fields)
                fields.update(get_round_fields())
                if self.fold is not None:
                    fields["fold"] = self.fold
                if self.num_rows and elapsed > 0:
                    fields["rows_per_sec"] = round(self.num_rows / elapsed, 1)
                emit_metric("training.round", **fields)
            if (
                self.emit_structured
                and self._attr_every
                and (epoch + 1) % self._attr_every == 0
            ):
                self._emit_attribution(
                    sum(self._times), rolling=True, round_index=epoch
                )
            if self.log_every and (epoch + 1) % self.log_every == 0:
                recent = self._times[-self.log_every :]
                mean = sum(recent) / len(recent)
                msg = "round {}: {:.1f} ms/round".format(epoch, mean * 1000)
                if self.num_rows and mean > 0:
                    msg += " ({:.2f}M rows/sec)".format(
                        self.num_rows / mean / 1e6
                    )
                logger.info(msg)
        if self._round_span is not None:
            # RoundTimer is last in the callback stack, so every phase span
            # of round `epoch` has already closed under this span; rotate
            tracing.finish_span(self._round_span, round=epoch)
            self._round_span = tracing.start_span("round", annotate=False)
        self._last = now
        return False

    def after_training(self, model):
        if self._round_span is not None:
            # the span opened after the last round covers post-training
            # callback work (final checkpoint flush, early-stopping trim)
            tracing.finish_span(self._round_span, tail=True)
            self._round_span = None
        if self._recorder is not None:
            pop_recorder(self._recorder)
            self._recorder = None
        if self._times:
            total = sum(self._times)
            p50 = percentile(self._times, 0.5)
            p95 = percentile(self._times, 0.95)
            # guard: a ~0 total (trivial data, coarse clocks) must not divide
            rate = len(self._times) / total if total > 0 else float("inf")
            logger.info(
                "trained %d rounds in %.2fs (%.2f rounds/sec, "
                "p50 %.1f ms, p95 %.1f ms)",
                len(self._times),
                total,
                rate,
                p50 * 1000,
                p95 * 1000,
            )
            if self.emit_structured:
                fields = {
                    "rounds": len(self._times),
                    "total_s": round(total, 3),
                    "p50_ms": round(p50 * 1000, 3),
                    "p95_ms": round(p95 * 1000, 3),
                }
                if self.fold is not None:
                    fields["fold"] = self.fold
                emit_metric("training.summary", **fields)
                self._emit_attribution(total)
                # roofline record (device plane): the measured device time
                # of the counted kernels against their counted work — one
                # record per training run
                _device_ms, kernel_ms, source, rounds, _wall_s = self._device_window_ms()
                extra = {"fold": self.fold} if self.fold is not None else None
                device_telemetry.maybe_roofline(
                    kernel_ms, rounds, source, emit=True, extra=extra
                )
        return model

    def _device_window_ms(self):
        """-> (device ms, ms of the kernels ``histogram.WORK`` counts,
        source, the rounds those cover, their wall seconds): the stamped
        rounds' stages (``"stamps"``: their sum and the ``histogram``
        stage's, over the rounds that carried stamps, which under a
        profiler's window are only some of the run's), else the fenced
        ``device_sync`` spans (``"device_sync"``, SM_TRACE_DEVICE_SYNC: the
        fence's wait, both, over every round), else (0.0, 0.0, None, 0,
        0.0): the device was not measured, and the host's remainder is no
        measurement of it."""
        stamped = sum(v for k, v in self._phase_totals.items() if k.startswith("device."))
        if self._stamped_rounds and stamped > 0:
            return (stamped * 1000.0, self._phase_totals.get("device.histogram", 0.0) * 1000.0,
                    "stamps", self._stamped_rounds, self._stamped_s)
        device_s = self._phase_totals.get("device_sync", 0.0)
        if device_s > 0:
            return (device_s * 1000.0, device_s * 1000.0, "device_sync", len(self._times),
                    sum(self._times))
        return 0.0, 0.0, None, 0, 0.0

    def _emit_attribution(self, total_s, rolling=False, round_index=None):
        """One ``training.attribution`` record: where the run's wall time
        went: kernel builds (compile_stats), host dispatch (the
        SM_TRACE_DEVICE_SYNC fences), device compute (the stage stamps, else
        the fences; ``device_time_source`` says which, absent when neither
        measured it; stamped, ``device_pct`` is over the ``device_rounds``
        rounds that carried stamps) and the histogram collectives (0.0 on
        one host; across ranks also by kind, ``collective_ms_by_kind``).
        Fields are 0.0 when the matching instrumentation wasn't armed, so
        the record shape is stable.

        ``rolling=True`` marks the SM_ATTRIBUTION_EVERY mid-job emissions
        (cumulative since the start of training — same shape, plus the
        round index) so CloudWatch regexes can tell them from the final
        after_training record."""
        comm_per_round = get_round_fields().get("hist_comm_ms") or 0.0
        device_ms, kernel_ms, source, device_rounds, device_wall_s = self._device_window_ms()
        fields = attribution_fields(
            total_ms=total_s * 1000.0,
            compile_ms=self._compile_total_s * 1000.0,
            host_ms=max(self._phase_totals.get("host_dispatch", 0.0), 0.0)
            * 1000.0,
            device_ms=device_ms,
            collective_ms=float(comm_per_round) * len(self._times),
        )
        if source is not None:
            fields["device_time_source"] = source
        if source == "stamps":
            # the stamped rounds' device time against those rounds' wall
            # time, not the run's: the rest of the run was not stamped
            fields["device_rounds"] = device_rounds
            fields["device_pct"] = (round(device_ms / (device_wall_s * 1000.0) * 100.0, 1)
                                    if device_wall_s > 0 else 0.0)
        fields["rounds"] = len(self._times)
        kinds = get_round_fields().get("hist_comm_kinds")
        if kinds:
            # the collective share by kind: the histograms' ("hist",
            # "totals") apart from a grid's split merge and routing
            fields["collective_ms_by_kind"] = {
                kind: round(float(v["ms"]) * len(self._times), 3) for kind, v in kinds.items()}
        # mirror the roofline verdict (device plane; None when unarmed or
        # nothing introspected) so attribution says WHY the device share is
        # what it is, not just how big it is
        roofline = device_telemetry.maybe_roofline(
            kernel_ms, device_rounds, source
        )
        if roofline is not None:
            fields["roofline"] = {
                "binding": roofline["binding"],
                "achieved_flops_per_sec": roofline["achieved_flops_per_sec"],
                "achieved_bytes_per_sec": roofline["achieved_bytes_per_sec"],
                "operational_intensity": roofline["operational_intensity"],
            }
        if rolling:
            fields["rolling"] = True
        if round_index is not None:
            fields["round"] = round_index
        if self.fold is not None:
            fields["fold"] = self.fold
        emit_metric("training.attribution", **fields)
        from ..telemetry import fleet

        fleet.note_attribution(fields)


def attribution_fields(total_ms, compile_ms, host_ms, device_ms, collective_ms):
    """The shared compile/host/device/collective attribution shape — stable
    keys for CloudWatch regexes, used by both the ``training.attribution``
    record. Percentages are shares of
    ``total_ms`` (0.0 when the window is empty)."""

    def pct(ms):
        return round(ms / total_ms * 100.0, 1) if total_ms > 0 else 0.0

    return {
        "total_ms": round(total_ms, 3),
        "compile_ms": round(compile_ms, 3),
        "host_ms": round(host_ms, 3),
        "device_ms": round(device_ms, 3),
        "collective_ms": round(collective_ms, 3),
        "compile_pct": pct(compile_ms),
        "host_pct": pct(host_ms),
        "device_pct": pct(device_ms),
        "collective_pct": pct(collective_ms),
    }


def _trace_activities():
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


@contextlib.contextmanager
def torch_trace():
    """Capture a ``torch.profiler`` trace (CPU and CUDA activity) around
    the block when ``SM_PROFILER_TRACE_DIR`` is set, and write it there as
    a Chrome trace, ``torch-trace-rank<r>.json``.

    The trace is diagnostics, never a correctness dependency: the directory
    is created when missing, and a profiler that will not start (one is
    already active, the volume is not writable) or stop logs a warning and
    training goes on. A written trace emits one ``training.trace`` record
    naming its path.
    """
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield
        return
    import torch

    prof = None
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=_trace_activities())
        prof.__enter__()
    except Exception as e:
        prof = None
        logger.warning("could not start the torch profiler trace in %s (%s); training "
                       "continues untraced", trace_dir, e)
    try:
        yield
    finally:
        if prof is not None:
            path = os.path.join(trace_dir, "torch-trace-rank{}.json".format(tracing.get_rank()))
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(path)
            except Exception as e:
                logger.warning("torch profiler trace failed to stop or export (%s); the trace "
                               "in %s may be incomplete", e, trace_dir)
            else:
                logger.info("Wrote torch profiler trace to %s", path)
                emit_metric("training.trace", trace_dir=trace_dir, path=path)
                tracing.set_chrome_base_ns(_chrome_base_ns(path))


def _chrome_base_ns(path, tail=1 << 16):
    """The ``baseTimeNanoseconds`` a profiler's Chrome export subtracted from
    its timestamps (written at its end), or 0 where it wrote none."""
    import re

    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(f.tell() - tail, 0))
        found = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read())
    return int(found.group(1)) if found else 0


# the JAX package's name for the same context manager
xla_trace = torch_trace
