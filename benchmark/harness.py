"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the check of what the window produced, and the result line.

The window drives the port's ``models.booster.train`` with the job's
parameters (``_rounds_per_dispatch`` K = 8, as the train entry point sets
it without a checkpoint directory). A dispatch builds K rounds, so a
dispatch ends at every K-th round; there the callback synchronizes the
device and stamps the host clock, and it stops training at such a
boundary, so the rate is the rounds between the window's first and last
boundary over the seconds between them.

What is judged is what the program hands out: the cuts and bins that the
port's ``bin_matrix`` returns, and the forest that ``train`` returns (its
trees, and its predictions on the validation rows and on a sample of the
training rows). These are copied to the host and the program's state is
freed before the reference runs.
"""

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from . import inputs as inputs_mod
from . import judge
from . import work
from .profiling import WINDOW, Trace
from .reference import slot_depths

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "sagemaker_xgboost_container_tpu")


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    limits, each read from its own file."""

    def __init__(self, manifest, name, root):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError("no workload {!r} in BENCHMARK.json".format(name))
        self.name = name
        w = cells[name]
        self.chips = int(w["chips"])
        conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        self.config = _load(os.path.join(root, conf["file"]))
        self.traffic = _load(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        self.limits = _load(os.path.join(HERE, "limits", name + ".json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"] if name in m.get("workloads", [name])]

    @property
    def params(self):
        p = dict(self.config["params"])
        p.update(self.traffic["params"])
        return p


def _load(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Window:
    """``train``'s callback: warm-up dispatches, then the window. A
    dispatch of ``per_dispatch`` rounds ends at every round r with r + 1 a
    multiple of it."""

    def __init__(self, seconds, warmup, trace_dispatches, per_dispatch, device, trace):
        self.seconds, self.warmup = seconds, warmup
        self.trace_dispatches, self.per_dispatch = trace_dispatches, per_dispatch
        self.device, self.trace = device, trace
        self.boundaries = []
        self.opened = self.closed = None      # (round, host clock)
        self.prof = self._mark = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def after_iteration(self, forest, rnd, evals_log):
        if (rnd + 1) % self.per_dispatch:
            return False
        self._sync()
        now = time.perf_counter()
        self.boundaries.append((rnd + 1, now))
        b = len(self.boundaries)
        if not self.trace:
            if b == self.warmup:
                self.opened = (rnd + 1, now)
            elif b > self.warmup and now - self.opened[1] >= self.seconds:
                self.closed = (rnd + 1, now)
                return True
            return False
        if b == self.warmup:
            # the profiler's first start in a process takes seconds: the
            # traced window opens at the next boundary
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        elif b == self.warmup + 1:
            self._sync()
            self.opened = (rnd + 1, time.perf_counter())
            self._mark = torch.autograd.profiler.record_function(WINDOW)
            self._mark.__enter__()
        elif b == self.warmup + 1 + self.trace_dispatches:
            self._mark.__exit__(None, None, None)
            self.closed = (rnd + 1, now)
            self.prof.stop()
            return True
        return False


class BinningClock:
    """Host seconds inside the port's ``bin_matrix`` (training and
    validation rows), a span around a call into the program, and what each
    call returned: the port's cuts and bins of the matrix it was given."""

    def __init__(self, booster):
        self.booster, self.inner, self.seconds = booster, booster.bin_matrix, 0.0
        self.binned = []

    def __enter__(self):
        def timed(dmatrix, *a, **k):
            t0 = time.perf_counter()
            try:
                out = self.inner(dmatrix, *a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
            self.binned.append((dmatrix, out))
            return out
        self.booster.bin_matrix = timed
        return self

    def __exit__(self, *exc):
        self.booster.bin_matrix = self.inner

    def of(self, dmatrix):
        """The cuts and host bins the port made of ``dmatrix``."""
        for src, out in self.binned:
            if src is dmatrix:
                bins = out.bins.cpu().numpy() if torch.is_tensor(out.bins) else np.asarray(
                    out.bins)
                return [np.asarray(c, np.float32) for c in out.cut_points], bins
        raise RuntimeError("the port did not bin this matrix through bin_matrix")


def forest_margins(forest, x, rows=None, block=1 << 17):
    """The forest's own margins (``Forest.predict_margin``, on its device)
    of the rows ``rows`` of ``x`` (all where None), in blocks of rows."""
    n = x.shape[0] if rows is None else len(rows)
    out = np.empty(n, np.float32)
    for lo in range(0, n, block):
        part = x[lo:lo + block] if rows is None else x[rows[lo:lo + block]]
        out[lo:lo + len(part)] = np.asarray(forest.predict_margin(part), np.float32)
    forest.release()
    return out


def rate(opened, closed):
    """Rounds a second between two dispatch boundaries (round, host clock)."""
    return (closed[0] - opened[0]) / (closed[1] - opened[1])


def judged_rounds(seed, opened, closed, total, sampled):
    """The first three rounds, ``sampled`` rounds of the window drawn from
    the seed, and the last round."""
    rng = np.random.RandomState(seed % (1 << 32))
    window = np.arange(opened, closed)
    picks = rng.choice(window, size=min(sampled, len(window)), replace=False) if len(
        window) else []
    return sorted({0, 1, 2, total - 1, *[int(r) for r in picks]})


def run(cell, seed, seconds, trace, device, t_start, log=sys.stderr):
    """One run -> the result dict (the last line's object)."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models import booster

    cfg, traffic = cell.config, cell.traffic
    data = inputs_mod.make(cfg, seed, device)
    dtrain = DataMatrix(data.x_train, data.y_train, groups=data.groups_train)
    dvalid = DataMatrix(data.x_valid, data.y_valid, groups=data.groups_valid)
    params = cell.params
    window = Window(seconds, traffic["warmup_dispatches"], traffic["trace_dispatches"],
                    int(params["_rounds_per_dispatch"]), device, trace)
    clock = BinningClock(booster)
    t_train = time.perf_counter()
    with clock:
        forest = booster.train(params, dtrain, num_boost_round=traffic["max_rounds"],
                               evals=[(dvalid, "validation")], device=device,
                               callbacks=[window], verbose_eval=False)
    if window.closed is None:
        raise RuntimeError("training ended before the window closed")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    (cuts, bins), (_cuts, valid_bins) = clock.of(dtrain), clock.of(dvalid)
    clock.binned = []
    del dtrain, dvalid
    sampled = judge.train_sample(seed, data.x_train.shape[0])
    margins = forest_margins(forest, data.x_train, sampled)
    valid_margins = forest_margins(forest, data.x_valid)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    (r_open, t_open), (r_close, _t_close) = window.opened, window.closed
    first_boundary = window.boundaries[0][1]
    result = {"metrics": {}}
    R = judge.Reference(data, params, device)
    prog = judge.Program(cuts, bins, valid_bins, [judge.forest_tree(t, R.cuts)
                                                  for t in forest.trees],
                         margins, valid_margins, sampled)
    forest = None
    judged = judged_rounds(seed, r_open, r_close, len(prog.trees),
                           traffic["judge_sampled_rounds"])
    traced = range(r_open, r_close) if trace else ()
    numbers, counts, judged = judge.check(R, prog, judged, traced)
    correct, failed, rows = judge.verdict(numbers, cell.limits)

    if trace:
        tr = Trace(window.prof)
        window.prof = None
        ctx = Context(cell, tr, counts, prog, R, data, {
            "binning_s": clock.seconds,
            "first_dispatch_s": first_boundary - t_train - clock.seconds})
        for m in cell.per_layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
        busy, window_s = tr.busy_s, tr.window_s
    else:
        # every cell's rate is rounds a second; the ranking and the
        # leaf-wise cells' carry names (and bounds) of their own
        for m in cell.end_to_end:
            value = t_open - t_start if m["name"] == "setup_s" else rate(window.opened,
                                                                         window.closed)
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}

    print("run: {} seed {} trace {}: window rounds {}..{} ({} rounds committed), judged rounds "
          "{}".format(cell.name, seed, int(trace), r_open, r_close, len(prog.trees), judged),
          file=log, flush=True)
    marks = [t for r, t in window.boundaries if r_open <= r <= r_close]
    steps = np.diff(marks)
    if len(steps):
        print("window dispatches: {} of {:.4f} s median, {:.4f} min, {:.4f} max, set-up {:.3f} s "
              "(train() from {:.3f} s)".format(len(steps), float(np.median(steps)),
                                              float(steps.min()), float(steps.max()),
                                              t_open - t_start, t_train - t_start),
              file=log, flush=True)
    found = forbidden_modules()
    if found:
        raise SystemExit("loaded after the window: {}".format(", ".join(found)))
    result.update({
        "correct": bool(correct), "attempted": len(rows), "failed": failed,
        "device": device_entry(device, peak)})
    if trace:
        result["device"].update(busy_s=busy, window_s=window_s)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        print("check {} = {!r} (limit {!r})".format(name, value, limit), file=log, flush=True)
    return result


def device_entry(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}


class Context:
    """What a per-layer metric's reader may read: the trace of the window's
    whole dispatches, the least work of each traced round, the set-up spans
    and the peaks table."""

    def __init__(self, cell, trace, counts, prog, R, data, spans):
        self.trace, self.spans = trace, spans
        self.rounds = len(counts)
        self.peaks = _load(os.path.join(HERE, "peaks.json"))
        p, obj = R.p, cell.params["objective"]
        pairs = (work.ranking_pairs(data.y_train, data.groups_train)
                 if obj == "rank:ndcg" else 0)
        self.work = []
        for r, (c, vc) in sorted(counts.items()):
            tree = prog.trees[r]
            self.work.append(work.round_work(tree, slot_depths(tree), c, vc, p,
                                             R.bins.shape[1], R.num_bins, obj, pairs))


def read_metric(name, ctx):
    """The reader of a per-layer metric: ``metrics/<name>.py``'s ``read``."""
    import importlib.util

    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)
