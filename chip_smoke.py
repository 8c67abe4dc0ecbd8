#!/usr/bin/env python3
"""Drive the PyTorch port (sagemaker_xgboost_container_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. build the CUDA kernels from csrc/ with nvcc (into build/torch_kernels/),
   printing the build time, the -Xptxas -v report of the hist_* and totals_*
   kernels and the atomic instructions they compiled to (the totals_*
   kernels must have none);
2. hist_kernel (the hist_* kernels behind level_histogram) against its plain
   PyTorch version: timed at 1M x 28 uint16 bins, B=257, with nodes drawn
   from [-1, W) at W=1 and W=64 and with level 7's left children (half the
   rows at -1, W=64); untimed with every row in one node, half the nodes
   empty, no row active, fewer rows than hist_kernel CTAs, W=130, n=0, an
   unaligned n and uint8 bins with B=256;
3. totals_kernel (totals_partial and totals_reduce behind node_totals)
   against its plain version, and two calls against each other bitwise:
   timed at n=1M, W=256 with nodes drawn from [-1, W) (CUDA events around
   the wrapper, and the kernels' device time from torch.profiler over a
   second run of the timed loop); untimed at W=1, W=4096, with every row in
   one node, no row active, n=100 and n=0;
4. the slice: train 5 rounds of binary:logistic, max_depth=8, max_bin=256 on
   1M x 28 synthetic rows with 100k validation rows, checking the launch
   counts and a falling validation logloss; save the model, load it back and
   predict 10k rows on the GPU against the CPU predict of the same model;
5. a small training run on the GPU against the same run on the CPU;
6. where a round's time goes: the main path again for 9 rounds, rounds 2-5
   timed on the host clock and rounds 6-9 under torch.profiler (device
   activity), giving device time per kernel, the histogram's (every hist_*
   kernel) and the totals' (every totals_* kernel) per round and the
   device's busy share.

The second line from the end is the kernels JSON line, the last line the
device JSON line. Needs one CUDA GPU; exits 2 without one.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
REPLACES = {
    "hist_kernel": "sagemaker_xgboost_container_tpu/ops/histogram.py:784",
    "totals_kernel": "sagemaker_xgboost_container_tpu/ops/histogram.py:505",
}
# main-path sizes (bench.py's binary workload)
N_TRAIN, N_VAL, N_FEATURES, N_SERVE, ROUNDS = 1_000_000, 100_000, 28, 10_000, 5
SMALL = (20_000, 12)
HIST_CASES = (  # n, d, W, B, bin dtype, node distribution, timed
    (1_000_000, 28, 1, 257, np.uint16, "random", True),
    (1_000_000, 28, 64, 257, np.uint16, "random", True),
    (1_000_000, 28, 64, 257, np.uint16, "left", True),
    (1_000_000, 28, 64, 257, np.uint16, "one", False),
    (1_000_000, 28, 64, 257, np.uint16, "half_empty", False),
    (1_000_000, 28, 64, 257, np.uint16, "none", False),
    (100, 28, 8, 257, np.uint16, "random", False),
    (1_000_000, 28, 130, 257, np.uint16, "random", False),
    (0, 28, 4, 257, np.uint16, "random", False),
    (12_345, 5, 3, 33, np.uint16, "random", False),
    (1_000_003, 28, 128, 256, np.uint8, "random", False),
)
# the timed hist case whose numbers go into the kernels line
HIST_MAIN = "hist W=64 left"
TOTALS_CASES = (  # n, W, node distribution, timed
    (1_000_000, 256, "random", True),
    (1_000_000, 1, "random", False),
    (1_000_000, 4096, "random", False),
    (1_000_000, 256, "one", False),
    (1_000_000, 256, "none", False),
    (100, 256, "random", False),
    (0, 256, "random", False),
)
MAIN_PARAMS = {"objective": "binary:logistic", "max_depth": 8, "max_bin": 256,
               "eta": 0.2, "tree_method": "hist"}
SOURCES = {
    "hist_kernel": "sagemaker_xgboost_container_tpu_torch/csrc/hist_kernel.cu",
    "totals_kernel": "sagemaker_xgboost_container_tpu_torch/csrc/totals_kernel.cu",
}


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_tag():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log, prefix):
    """The -Xptxas -v lines (registers, shared memory, spills) of the kernels
    whose names hold `prefix`, one line per kernel."""
    out, name, facts = [], None, []

    def flush():
        if name is not None:
            out.append("ptxas {}: {}".format(name, "; ".join(facts)))

    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            flush()
            # the last match: the mangled name holds the file's name first
            found = re.findall(prefix + r"[a-z]+(?:I[a-z]E)?", m.group(1))
            name, facts = (found[-1] if found else None), []
        elif name is not None and ("Used" in line or "spill" in line):
            facts.append(line.split(":", 1)[-1].strip() if "ptxas" in line else line.strip())
    flush()
    return out


def sass_atomics(lib_path, prefix):
    """The shared- and global-memory atomic instructions (ATOM*, RED*: SASS
    opcodes with their counts) of each kernel whose name holds `prefix`,
    from cuobjdump, as {kernel: {opcode: count}}; None without cuobjdump.
    f32 atomicAdd on shared memory shows up as a compare-and-swap loop."""
    from torch.utils.cpp_extension import CUDA_HOME

    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.findall(prefix + r"[a-z]+(?:I[a-z]E)?", line)
            name = found[-1] if found else None
            if name is not None:
                ops.setdefault(name, {})
        elif name is not None and "*/" in line:
            op = [t for t in line.split("*/", 1)[1].split() if not t.startswith("@")]
            # REDUX is a warp reduction in registers, not an atomic
            if op and re.match(r"(ATOM|RED(?!UX))", op[0]):
                ops[name][op[0]] = ops[name].get(op[0], 0) + 1
    return ops


def report_kernels(k, prefix, atomic_free):
    """Print the ptxas and SASS lines of the kernels whose names hold
    `prefix`; with atomic_free, fail unless SASS shows them without any
    atomic instruction."""
    for line in ptxas_report(k.build_log, prefix):
        print("  " + line, flush=True)
    ops = sass_atomics(k.path, prefix)
    if ops is None:
        print("  cuobjdump not found: atomics not reported", flush=True)
        return
    for name, found in ops.items():
        print("  sass {}: {}".format(name, found or "no atomic instructions"), flush=True)
    if atomic_free:
        check(ops, "no {}* kernel found in the SASS".format(prefix))
        check(not any(ops.values()),
              "{}* kernels compiled to atomics: {}".format(prefix, ops))


def make_data(n, d, seed=0):
    """The synthetic binary task of bench.py (same formula)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    logit = X[:, 0] * 0.8 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3]) - 0.2
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    return X, y


def node_distribution(rng, kind, n, W):
    """node_local of a hist case: "random" draws from [-1, W); "left" is a
    subtracted level's left children (children of 2W nodes, the right half
    at -1); "one" puts every row in one node; "half_empty" only in even
    nodes; "none" leaves no row active (-1, or W and beyond)."""
    if kind == "random":
        return rng.randint(-1, W, n).astype(np.int32)
    if kind == "left":
        child = rng.randint(0, 2 * W, n)
        return np.where(child % 2 == 0, child // 2, -1).astype(np.int32)
    if kind == "one":
        return np.full(n, W // 2, dtype=np.int32)
    if kind == "half_empty":
        return (2 * rng.randint(0, (W + 1) // 2, n)).astype(np.int32)
    if kind == "none":
        return np.where(rng.rand(n) < 0.5, -1, W + rng.randint(0, 3, n)).astype(np.int32)
    raise ValueError(kind)


def hist_case(torch, hist, n, d, W, B, np_dtype, kind, seed, timed, tag):
    """One hist_kernel check; returns the measurement dict when timed."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    bins = torch.as_tensor(rng.randint(0, B, (n, d)).astype(np_dtype), device=dev)
    grad = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    hess = torch.as_tensor((rng.rand(n) + 0.1).astype(np.float32), device=dev)
    node = torch.as_tensor(node_distribution(rng, kind, n, W), device=dev)

    G, H = hist.level_histogram(bins, grad, hess, node, W, B)
    Gp, Hp = hist._hist_plain(bins, grad, hess, node, W, B)
    torch.cuda.synchronize()
    err = max(float((G - Gp).abs().max()), float((H - Hp).abs().max())) if G.numel() else 0.0
    # f32 atomics sum in a varying order: allow 1e-4 of the largest cell
    scale = max(1.0, float(Gp.abs().max()) if G.numel() else 0.0,
                float(Hp.abs().max()) if G.numel() else 0.0)
    tol = 1e-4 * scale
    # integer-valued weights sum exactly in f32: the cells must match bitwise
    ones = torch.ones_like(grad)
    ints = torch.as_tensor(rng.randint(0, 4, n).astype(np.float32), device=dev)
    Ge, He = hist.level_histogram(bins, ones, ints, node, W, B)
    Gq, Hq = hist._hist_plain(bins, ones, ints, node, W, B)
    exact = bool(torch.equal(Ge, Gq) and torch.equal(He, Hq))
    label = "hist_kernel n={} d={} {} B={} W={} nodes={}".format(n, d, bins.dtype, B, W, kind)
    print("{} | {}: max_abs_err={:.3e} tol={:.3e} exact_integer_check={}".format(
        tag, label, err, tol, exact), flush=True)
    check(err <= tol, "{} disagrees with its plain version".format(label))
    check(exact, "{} integer histogram differs from its plain version".format(label))
    if not timed:
        return None

    active = (node >= 0) & (node < W)
    rows = torch.nonzero(active).squeeze(1)
    ids = ((node[rows].long()[:, None] * d + torch.arange(d, device=dev)) * B
           + hist.widen_rows(bins, rows)).reshape(-1)
    g_rep = grad[rows][:, None].expand(-1, d).reshape(-1).contiguous()
    h_rep = hess[rows][:, None].expand(-1, d).reshape(-1).contiguous()
    size = W * d * B
    kernel = time_ms(torch, lambda: hist.level_histogram(bins, grad, hess, node, W, B))
    plain = time_ms(torch, lambda: hist._hist_plain(bins, grad, hess, node, W, B))
    library = time_ms(torch, lambda: (torch.bincount(ids, g_rep, minlength=size),
                                      torch.bincount(ids, h_rep, minlength=size)))
    # node read for every row; bins, grad and hess only for the active ones
    n_active = int(rows.numel())
    nbytes = n * 4 + n_active * (d * bins.element_size() + 8) + 2 * size * 4
    b_ms, b_by = bound_ms(nbytes, 2 * n_active * d)
    print("{} | {}: kernel_ms={:.4f} plain_ms={:.4f} library_ms={:.4f} "
          "(torch.bincount with weights, G and H) bound_ms={:.4f} ({})".format(
              tag, label, kernel, plain, library, b_ms, b_by), flush=True)
    return {"max_abs_err": err, "ms": kernel, "plain_ms": plain,
            "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
            "shape": label}


def device_ms(torch, fn, prefix, iters=20):
    """Device time per call of each kernel whose name holds `prefix`, from
    torch.profiler (device activity) over `iters` calls of fn."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.key_averages():
        us = _kernel_time_us(torch, evt)
        found = re.findall(prefix + r"[a-z]+", evt.key)
        if us > 0 and found:
            per[found[-1]] = per.get(found[-1], 0.0) + us / 1e3 / iters
    return per


def totals_case(torch, hist, n, W, kind, seed, timed, tag):
    """One totals_kernel check; returns the measurement dict when timed."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    grad = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    hess = torch.as_tensor((rng.rand(n) + 0.1).astype(np.float32), device=dev)
    node = torch.as_tensor(node_distribution(rng, kind, n, W), device=dev)
    g, h = hist.node_totals(grad, hess, node, W)
    gp, hp = hist._totals_plain(grad, hess, node, W)
    # the order of additions is fixed by the shapes: a second call on the
    # same f32 inputs must be bitwise equal
    g2, h2 = hist.node_totals(grad, hess, node, W)
    torch.cuda.synchronize()
    err = max(float((g - gp).abs().max()), float((h - hp).abs().max()))
    tol = 1e-4 * max(1.0, float(gp.abs().max()), float(hp.abs().max()))
    same = bool(torch.equal(g, g2) and torch.equal(h, h2))
    ones = torch.ones_like(grad)
    ints = torch.as_tensor(rng.randint(0, 4, n).astype(np.float32), device=dev)
    ge, he = hist.node_totals(ones, ints, node, W)
    gq, hq = hist._totals_plain(ones, ints, node, W)
    exact = bool(torch.equal(ge, gq) and torch.equal(he, hq))
    label = "totals_kernel n={} W={} nodes={}".format(n, W, kind)
    print("{} | {}: max_abs_err={:.3e} tol={:.3e} exact_integer_check={} "
          "bitwise_equal_second_call={}".format(tag, label, err, tol, exact, same), flush=True)
    check(err <= tol, "{} disagrees with its plain version".format(label))
    check(exact, "{} integer totals differ from its plain version".format(label))
    check(same, "{} differs between two calls".format(label))
    if not timed:
        return None

    valid = torch.nonzero((node >= 0) & (node < W)).squeeze(1)
    ids, gv, hv = node[valid].long(), grad[valid], hess[valid]
    call = lambda: hist.node_totals(grad, hess, node, W)  # noqa: E731
    kernel = time_ms(torch, call)
    per = device_ms(torch, call, "totals_")
    check(set(per) == {"totals_partial", "totals_reduce"},
          "{}: profiled kernels {}, expected totals_partial and totals_reduce".format(label, per))
    dev_ms = sum(per.values())
    plain = time_ms(torch, lambda: hist._totals_plain(grad, hess, node, W))
    library = time_ms(torch, lambda: (torch.bincount(ids, gv, minlength=W),
                                      torch.bincount(ids, hv, minlength=W)))
    b_ms, b_by = bound_ms(n * 12 + 2 * W * 4, 2 * int(valid.numel()))
    print("{} | {}: kernel_ms={:.4f} (CUDA events around the wrapper) device_ms={:.4f} "
          "(torch.profiler: totals_partial {:.4f} + totals_reduce {:.4f}) plain_ms={:.4f} "
          "library_ms={:.4f} (torch.bincount with weights, g and h) bound_ms={:.4f} ({})".format(
              tag, label, kernel, dev_ms, per["totals_partial"], per["totals_reduce"],
              plain, library, b_ms, b_by), flush=True)
    return {"max_abs_err": err, "ms": kernel, "device_ms": dev_ms, "plain_ms": plain,
            "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
            "shape": label}


class _RoundLog:
    """Callback: wall time at the start of training and after each round."""

    def __init__(self, torch):
        self.torch = torch
        self.times = []
        self.logloss = []

    def before_training(self, forest):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        return forest

    def after_iteration(self, forest, rnd, evals_log):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        self.logloss = list(evals_log["validation"]["logloss"])
        return False


def run_slice(torch, hist, pkg, tag):
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    n, n_val, d, rounds = N_TRAIN, N_VAL, N_FEATURES, ROUNDS
    X, y = make_data(n + n_val, d, seed=0)
    dtrain = DataMatrix(X[:n], y[:n])
    dval = DataMatrix(X[n:], y[n:])
    log = _RoundLog(torch)
    hist.reset_launch_counts()
    t0 = time.perf_counter()
    forest = pkg.train(MAIN_PARAMS, dtrain, rounds, evals=[(dval, "validation")],
                       device=DEVICE, callbacks=[log])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(hist.LAUNCHES)
    setup_s = log.times[0] - t0
    round_s = np.diff(log.times)
    print("{} | slice train: setup (binning, upload) {:.3f} s; per-round s {}; "
          "rounds/s (all 5) {:.3f}; rounds/s (rounds 2-5) {:.3f}; total {:.3f} s".format(
              tag, setup_s, [round(float(s), 4) for s in round_s],
              rounds / float(round_s.sum()), (rounds - 1) / float(round_s[1:].sum()),
              total_s), flush=True)
    print("slice launches: {}".format(json.dumps(launches)), flush=True)
    check(launches["hist_kernel"] == 8 * rounds,
          "hist_kernel launched {} times, expected {}".format(launches["hist_kernel"], 8 * rounds))
    check(launches["totals_kernel"] == rounds,
          "totals_kernel launched {} times, expected {}".format(launches["totals_kernel"], rounds))
    ll = log.logloss
    check(len(ll) == rounds and all(np.isfinite(ll)), "validation logloss missing: {}".format(ll))
    check(all(b < a for a, b in zip(ll, ll[1:])), "validation logloss did not fall: {}".format(ll))
    check(len(forest.trees) == rounds, "expected {} trees".format(rounds))

    x_serve = X[n:n + N_SERVE]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xgboost-model")
        forest.save_model(path)
        served = Forest.load_model(path, device=DEVICE)
        on_cpu = Forest.load_model(path, device="cpu")
    pred = served.predict(x_serve)
    ref = on_cpu.predict(x_serve)
    lat = []
    for _ in range(10):
        t = time.perf_counter()
        served.predict(x_serve)
        lat.append((time.perf_counter() - t) * 1e3)
    err = float(np.abs(pred - ref).max())
    print("{} | serve: {} rows, GPU vs CPU predict max_abs_err={:.3e}; "
          "predict latency median {:.3f} ms (min {:.3f} ms, numpy in, numpy out)".format(
              tag, len(x_serve), err, float(np.median(lat)), float(np.min(lat))), flush=True)
    check(pred.shape == (len(x_serve),) and np.all(np.isfinite(pred)), "bad served predictions")
    check(err <= 1e-5, "GPU predict differs from CPU predict by {}".format(err))
    return launches, dtrain, dval


def run_small_parity(torch, pkg, tag):
    """The whole path on the GPU against the same path on the CPU (plain
    versions of the kernels) on a small problem. At deep, small nodes several
    splits can cut the rows identically, with gains equal in exact arithmetic;
    the kernels' f32 atomics may then pick another of them, so the check is
    on predictions, and the share of identical splits is reported."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    X, y = make_data(*SMALL, seed=1)
    X[np.random.RandomState(2).rand(*X.shape) < 0.05] = np.nan
    params = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 64, "eta": 0.3}
    fg = pkg.train(params, DataMatrix(X, y), 3, device=DEVICE, verbose_eval=False)
    fc = pkg.train(params, DataMatrix(X, y), 3, device="cpu", verbose_eval=False)
    same = sum(
        int(np.sum((a.feature == b.feature) & (a.threshold == b.threshold)))
        for a, b in zip(fg.trees, fc.trees) if a.num_nodes == b.num_nodes
    )
    total = sum(b.num_nodes for b in fc.trees)
    err = float(np.abs(fg.predict(X) - fc.predict(X)).max())
    print("{} | small parity ({} x {}, depth 6, 3 rounds): identical nodes {}/{}; "
          "GPU vs CPU predict max_abs_err={:.3e}".format(
              tag, X.shape[0], X.shape[1], same, total, err), flush=True)
    check(err <= 1e-4, "GPU training differs from CPU training by {}".format(err))


def _kernel_time_us(torch, evt):
    """Device time of a kernel event; 0 for host-side ops, whose rows only
    repeat the time of the kernels they launched."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def run_profile(torch, pkg, dtrain, dval, tag):
    """Rounds 2-5 unprofiled give the host clock per round; rounds 6-9 under
    torch.profiler give the device time per kernel. Tracing slows every
    launch, so the busy share is profiled device time per round over the
    unprofiled round time."""
    # device activity only: tracing host-side ops too would slow every
    # launch further without adding device time
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    marks = []

    class Window:
        def after_iteration(self, forest, rnd, evals_log):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if rnd == 4:
                # the profiler's set-up takes seconds: keep it out of both
                # windows by restarting the clock once it is running
                prof.start()
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            return False

    pkg.train(MAIN_PARAMS, dtrain, 9, evals=[(dval, "validation")], device=DEVICE,
              callbacks=[Window()], verbose_eval=False)
    torch.cuda.synchronize()
    prof.stop()
    rounds = 4
    plain_round_ms = (marks[4] - marks[0]) * 1e3 / rounds
    profiled_round_ms = (marks[9] - marks[5]) * 1e3 / rounds
    rows = []
    for evt in prof.key_averages():
        dev_us = _kernel_time_us(torch, evt)
        if dev_us > 0:
            # kernel names run to kilobytes of template arguments
            rows.append({"name": evt.key[:100], "calls": int(evt.count),
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows) / rounds
    launches = sum(r["calls"] for r in rows) / rounds

    def kernel_ms(name):
        return sum(r["device_ms"] for r in rows if name in r["name"]) / rounds

    def kernel_calls(name):
        return sum(r["calls"] for r in rows if name in r["name"]) / rounds

    for r in rows[:15]:
        print("  {:9.3f} ms {:6d} calls  {}".format(r["device_ms"], r["calls"], r["name"]))
    for name in ("hist_count", "hist_scan", "hist_scatter", "hist_kernel", "hist_reduce",
                 "totals_partial", "totals_reduce"):
        print("  {}: {:.4f} ms/round, {:.0f} launches/round".format(
            name, kernel_ms(name), kernel_calls(name)), flush=True)
    # the histogram is every hist_* kernel level_histogram enqueues, the
    # totals every totals_* kernel node_totals enqueues
    print("{} | profile: rounds 2-5 {:.3f} ms/round host clock; rounds 6-9 profiled "
          "{:.3f} ms/round, {:.0f} kernel launches/round, device {:.3f} ms/round "
          "(histogram, all hist_* kernels, {:.3f} in {:.0f} launches; totals, all "
          "totals_* kernels, {:.4f} in {:.0f} launches); device busy {:.1%} of an "
          "unprofiled round".format(
              tag, plain_round_ms, profiled_round_ms, launches, busy_ms,
              kernel_ms("hist_"), kernel_calls("hist_"), kernel_ms("totals_"),
              kernel_calls("totals_"), busy_ms / plain_round_ms), flush=True)


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    try:
        import sagemaker_xgboost_container_tpu_torch as pkg
        from sagemaker_xgboost_container_tpu_torch import _build
        from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist
    except ImportError as e:
        print("run chip_smoke.py from a checkout of the repository: {}".format(e),
              file=sys.stderr)
        return 1

    tag = card_tag()
    print("python {} torch {} cuda {}".format(
        sys.version.split()[0], torch.__version__, torch.version.cuda), flush=True)
    try:
        t = time.perf_counter()
        k = _build.kernels()
        print("{} | build: {:.1f} s ({}, nvcc {:.1f} s)".format(
            tag, time.perf_counter() - t, k.route, k.build_s), flush=True)
        report_kernels(k, "hist_", atomic_free=False)
        report_kernels(k, "totals_", atomic_free=True)

        results = {}
        for n, d, W, B, dt, kind, timed in HIST_CASES:
            r = hist_case(torch, hist, n, d, W, B, dt, kind, 10 + W, timed, tag)
            if r is not None:
                results["hist W={} {}".format(W, kind)] = r
        for n, W, kind, timed in TOTALS_CASES:
            r = totals_case(torch, hist, n, W, kind, 3 + W, timed, tag)
            if r is not None:
                results["totals"] = r

        launches, dtrain, dval = run_slice(torch, hist, pkg, tag)
        run_small_parity(torch, pkg, tag)
        run_profile(torch, pkg, dtrain, dval, tag)
    except Exception as e:  # every phase failure ends the run non-zero
        print("FAILED: {}: {}".format(type(e).__name__, e), file=sys.stderr, flush=True)
        raise

    kernels = []
    for name, key in (("hist_kernel", HIST_MAIN), ("totals_kernel", "totals")):
        r = results[key]
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[name]}
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "shape")})
        if "device_ms" in r:
            entry["device_ms"] = r["device_ms"]
        kernels.append(entry)
    print(tag)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
