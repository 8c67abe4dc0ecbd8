#!/usr/bin/env python3
"""Read what the stage stamps and the session spans show in one traced run
of a benchmark cell, on one GPU.

    python3 scripts/torch_stage_report.py --workload <cell> --seed <n>
    python3 scripts/torch_stage_report.py --resolution

from the root of a checkout. The first runs ``benchmark/run.py``'s traced
run of the cell (``harness.run`` with ``trace=True``) and prints one JSON
line, also written to ``--out`` (default ``build/stage_report/``) as
``<cell>.<seed>.json``, with, beside its result's metrics:

- ``stages_over_busy``: the five ``round.*_ms`` summed, over the window's
  device-busy ms a round (1000 x busy_s / rounds); ``short_gaps_ms``: the
  window's idle gaps under 50 us a round (the launch gaps between a
  graph's kernels, which the stages count and busy time does not), and
  ``stages_over_busy_and_short_gaps``;
- ``hist_over_kernels``: ``round.histogram_ms`` over the ``hist_*`` /
  ``totals_*`` kernels' device ms a round;
- ``idle_under_session``: the share of the window's idle time that lies
  under a ``session.*`` profiler range, and the five longest gaps, named
  as the harness names them;
- ``kernels_ms``: the 15 kernels of the window that took most device time;
- ``stamp_offset_us``: for each traced round, its first stamp mapped onto
  the tracer's clock (the ``round.gradient`` span's start) less the nearest
  ``stage_stamp_kernel`` start in the profiler's trace: the largest
  distance and the median, and in the file each dispatch's median;
- ``outside_dispatch``: a second witness for that offset. A dispatch's
  device work lies between its host enqueue's start and its copy's end
  (``session.enqueue``, ``session.copy_out``), so a stamp seen outside
  every such interval was placed wrong. For the mapped stage spans (against
  the tracer's host spans) and for the profiler's ``stage_stamp_kernel``
  events (against its own host events): how many of how many lie outside,
  and the farthest, in us;
- ``stamp_timeline_ms``: what the stamps cost the card's timeline a round:
  for each run of stamp kernels between two other kernels of the window,
  the gap it fills less the median gap between two other kernels that
  follow each other closely (under 50 us), summed over the window's rounds;
- ``launch_to_first_stamp_us``: a third witness. A dispatch's first
  replay starts no earlier than its ``cudaGraphLaunch`` call on the host:
  for each traced dispatch, its first mapped stamp (``mapped``) and the
  profiler's nearest ``stage_stamp_kernel`` start (``profiler``) less the
  start of the first ``cudaGraphLaunch`` after its ``session.enqueue``
  opened, in us (negative: placed before it could have run);
- ``offset_drift_us``: the session's offset measured again after training,
  less the one it used (the two clocks' drift over the run);
- ``range_offset_us``: each ``session.*`` range's start in the profiler's
  trace less the nearest start of a tracer span of its name (the two host
  clocks' agreement).

``--resolution`` reads ``%globaltimer`` through 4,000 begin and end stamp
pairs and prints the greatest common divisor of their differences (the
timer's tick, in ns) and the least nonzero difference.

Exits with code 2, printing no result, without a CUDA device.
"""

import argparse
import bisect
import json
import math
import os
import statistics
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STAGES = ("gradient", "histogram", "split", "partition", "margins")


def _union_ns(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _nearest(sorted_values, t):
    """``t`` less the nearest of ``sorted_values``, or None."""
    i = bisect.bisect_left(sorted_values, t)
    near = [sorted_values[j] for j in (i - 1, i) if 0 <= j < len(sorted_values)]
    return min((t - v for v in near), key=abs) if near else None


def _outside(points, intervals):
    """-> [how many of ``points`` lie in no interval, of how many, the
    farthest one's distance in us]."""
    intervals = sorted(intervals)
    starts = [a for a, _b in intervals]
    far, n = 0.0, 0
    for t in points:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= intervals[i][1]:
            continue
        d = [t - intervals[i][1]] if i >= 0 else []
        if i + 1 < len(intervals):
            d.append(intervals[i + 1][0] - t)
        n += 1
        far = max(far, min(d) / 1e3 if d else math.inf)
    return [n, len(points), far]


def resolution(torch):
    from sagemaker_xgboost_container_tpu_torch.ops.stamps import MARGINS, StageClock

    clock = StageClock(torch.device("cuda", 0), 4000)
    for _ in range(4000):
        clock.begin()
        clock.end()
    steps = [int(v) for v in clock.read(4000)[:, MARGINS].cpu().tolist()]
    tick = 0
    for d in steps:
        tick = math.gcd(tick, d)
    return {"globaltimer_tick_ns": tick, "least_nonzero_step_ns": min(d for d in steps if d > 0),
            "median_step_ns": statistics.median(steps), "stamps": 2 * len(steps)}


def report(torch, workload, seed, out_dir):
    from benchmark import harness, profiling
    from sagemaker_xgboost_container_tpu_torch.ops import stamps
    from sagemaker_xgboost_container_tpu_torch.telemetry import tracing

    kept = {"clocks": []}

    class KeptTrace(profiling.Trace):
        """The harness's window, and what it does not keep: the stamp
        kernels and the session ranges, each (start, end) in ns."""

        def __init__(self, prof):
            super().__init__(prof)
            kept["trace"] = self
            events = prof.profiler.kineto_results.events()
            cuda = torch.autograd.DeviceType.CUDA
            self.stamps = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                                 if "stage_stamp_kernel" in e.name())
            self.ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                                 for e in events
                                 if e.name().startswith("session.") and e.device_type() != cuda)
            marks = [e for e in events if e.name() == profiling.WINDOW and e.device_type() != cuda]
            w0 = marks[0].start_ns()
            w1 = w0 + marks[0].duration_ns()
            self.graph_launches = sorted(e.start_ns() for e in events
                                         if e.name() in ("cudaGraphLaunch", "cuGraphLaunch"))
            self.kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                                   "stage_stamp_kernel" in e.name()) for e in events
                                  if profiling._kind(e) == "kernel" and w0 <= e.start_ns() < w1)

    class KeptContext(harness.Context):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept["ctx"] = self

    measure = stamps.StageClock.measure_offset

    def kept_measure(clock):
        if clock not in kept["clocks"]:
            kept["clocks"].append(clock)
        return measure(clock)

    harness.Trace, harness.Context = KeptTrace, KeptContext
    stamps.StageClock.measure_offset = kept_measure
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), workload, ROOT)
    result = harness.run(cell, seed, 30.0, True, torch.device("cuda", 0), T_START)
    trace, rounds = kept["trace"], kept["ctx"].rounds
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    suffix = next((k[len("round.gradient_ms"):] for k in metrics
                   if k.startswith("round.gradient_ms")), "")
    kernels = sorted(trace.kernel_s.items(), key=lambda kv: -kv[1])[:15]
    line = {"workload": workload, "seed": seed, "correct": result["correct"],
            "device": result["device"], "metrics": metrics,
            "idle_gaps": result["breakdown"]["idle_gaps"][:5],
            "kernels_ms": [[profiling._short(n), round(s * 1e3, 4)] for n, s in kernels]}
    stage = [metrics.get("round.{}_ms{}".format(s, suffix)) for s in STAGES]
    busy_ms = 1000.0 * trace.busy_s / rounds
    hist_ms = 1000.0 * trace.hist_seconds() / rounds
    if None not in stage:
        line["stages_ms"] = dict(zip(STAGES, stage))
        line["stages_over_busy"] = sum(stage) / busy_ms if busy_ms > 0 else None
        line["hist_over_kernels"] = stage[1] / hist_ms if hist_ms > 0 else None
    line["busy_ms_per_round"], line["hist_kernels_ms_per_round"] = busy_ms, hist_ms
    session = [(a, b) for a, b, _n in trace.ranges]
    idle = sum(b - a for a, b in trace.gaps)
    covered = sum(_union_ns([(max(a, g0), min(b, g1)) for a, b in session
                             if min(b, g1) > max(a, g0)]) for g0, g1 in trace.gaps)
    line["idle_s"], line["idle_under_session"] = idle / 1e9, covered / idle if idle else None
    short = sum(b - a for a, b in trace.gaps if b - a < 50_000) / 1e6 / rounds
    line["short_gaps_ms"] = short
    if None not in stage:
        line["stages_over_busy_and_short_gaps"] = sum(stage) / (busy_ms + short)

    spans = tracing.snapshot_spans()
    device = [s for s in spans if s.attributes.get("clock") == "device"]
    firsts = {s.attributes["round"]: (s.start_us * 1e3, s.trace_id) for s in device
              if s.name == "round.gradient"}
    starts = [a for a, _b in trace.stamps]
    by_dispatch = {}
    for r in sorted(firsts)[-rounds:]:
        d = _nearest(starts, firsts[r][0])
        if d is not None:
            by_dispatch.setdefault(firsts[r][1], []).append(d / 1e3)
    offsets = [d for ds in by_dispatch.values() for d in ds]
    if offsets:
        line["stamp_offset_us"] = {"max": max(abs(d) for d in offsets),
                                   "median": statistics.median(offsets),
                                   "rounds": len(offsets), "stamp_kernels": len(starts)}
    # the second witness: each stamp against its dispatch's host interval

    def dispatches(pairs):
        enq = sorted(a for a, _b, n in pairs if n == "session.enqueue")
        out = sorted(b for _a, b, n in pairs if n == "session.copy_out")
        return [(a, out[bisect.bisect_left(out, a)]) for a in enq
                if bisect.bisect_left(out, a) < len(out)]

    def outside(points, intervals):
        # from the first enqueue on: the offset's own stamps come before it
        start = intervals[0][0] if intervals else 0
        return _outside([t for t in points if t >= start], intervals)

    ours = dispatches([(s.start_us * 1e3, (s.start_us + s.dur_us) * 1e3, s.name) for s in spans
                       if s.name.startswith("session.")])
    line["outside_dispatch"] = {
        "mapped_stages": outside([t for s in device for t in (s.start_us * 1e3,
                                                              (s.start_us + s.dur_us) * 1e3)],
                                 ours),
        "profiler_stamps": outside([t for a, b in trace.stamps for t in (a, b)],
                                   dispatches(trace.ranges))}
    gaps, costs, prev, inside = [], [], None, False
    for a, b, stamp in trace.kernels:
        if stamp:
            inside = inside or prev is not None
            continue
        if prev is not None:
            (costs if inside else gaps).append(a - prev)
        prev, inside = b, False
    close = sorted(g for g in gaps if g < 50_000)
    if close and costs:
        base = statistics.median(close)
        line["stamp_timeline_ms"] = sum(c - base for c in costs if c < 1_000_000) / 1e6 / rounds
    enqueues = [a for a, _b, n in trace.ranges if n == "session.enqueue"]
    launch = {"mapped": [], "profiler": []}
    for tid in by_dispatch:
        first = min(t for t, i in firsts.values() if i == tid)
        before = [a for a in enqueues if a <= first]
        i = bisect.bisect_left(trace.graph_launches, before[-1]) if before else None
        if i is None or i >= len(trace.graph_launches):
            continue
        graph_launch = trace.graph_launches[i]
        launch["mapped"].append((first - graph_launch) / 1e3)
        d = _nearest(starts, first)
        launch["profiler"].append((first - d - graph_launch) / 1e3)
    line["launch_to_first_stamp_us"] = launch
    if kept["clocks"]:
        clock = kept["clocks"][-1]
        used, clock.offset_ns = clock.offset_ns, None
        line["offset_drift_us"] = (measure(clock) - used) / 1e3
    mine = {}
    for s in spans:
        if s.name.startswith("session."):
            mine.setdefault(s.name, []).append(s.start_us * 1e3)
    for v in mine.values():
        v.sort()
    host = [d / 1e3 for a, _b, n in trace.ranges
            for d in [_nearest(mine.get(n, []), a)] if d is not None]
    if host:
        line["range_offset_us"] = {"min": min(host), "median": statistics.median(host),
                                   "max": max(host), "ranges": len(host)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "{}.{}.json".format(workload, seed)), "w") as f:
        json.dump(dict(line, offset_by_dispatch_us=[
            statistics.median(ds) for ds in by_dispatch.values()]), f)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--resolution", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "stage_report"))
    args = ap.parse_args(argv)
    for var, sub in (("GRAFT_COMPILE_CACHE_DIR", "compile"), ("TORCH_EXTENSIONS_DIR", "torch")):
        os.environ.setdefault(var, os.path.join(ROOT, "benchmark", ".cache", sub))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    line = resolution(torch) if args.resolution else report(torch, args.workload, args.seed,
                                                            args.out)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
