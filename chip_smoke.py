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
   device's busy share;
7. the serve entry point: train 100 rounds of the main path's parameters on
   200k x 28 rows (best_iteration 79), save it as xgboost JSON and as
   UBJSON, start `serving_entrypoint(port=0, block=False)` and check over
   HTTP /ping, /execution-parameters, 10k rows as csv, libsvm and
   recordio-protobuf against every accept (within 1e-5 of the CPU predict
   of rounds 0-79), selectable inference, the UBJSON model and the
   204/415/406/400 answers; then p50/p95/p99 latency and requests/s of
   1-row and 100-row csv requests from 16 client threads and of 10k-row
   requests one after another, the clients in a child process (and the
   1-row load again from threads of the server's own process, which share
   its interpreter lock), each beside the in-process predict time,
   the device predict's H2D/traversal/D2H split (CUDA events), the
   batcher's counts and the host/device predict counts, and the 100-row
   load once more under torch.profiler for the device's busy share and
   kernel launches per device predict; then SIGTERM with a request in
   flight, which must still be answered before the listener closes. Last,
   the csv decode and the host predict path timed in two child processes
   at once, one with OMP_NUM_THREADS=1 and one without. The serve path
   launches neither kernel; its launch counts are printed.

The second line from the end is the kernels JSON line, the last line the
device JSON line. Needs one CUDA GPU; exits 2 without one.
"""

import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

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
# the served model: up to 511 nodes a tree, 80 of its 100 rounds served
SERVE_TRAIN_ROWS, SERVE_ROUNDS, SERVE_BEST_ITERATION = 200_000, 100, 79
SERVE_LOADS = ((1, 16, 50), (100, 16, 20), (10_000, 1, 10))  # rows, threads, requests each
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


def _csv_body(x):
    # %.9g round-trips float32, so the server decodes the exact values
    return "\n".join(",".join("%.9g" % v for v in row) for row in x).encode()


def _libsvm_body(x):
    return "\n".join(" ".join("%d:%.9g" % (j + 1, v) for j, v in enumerate(row)
                              if not np.isnan(v)) for row in x).encode()


class _Client:
    """HTTP calls with a timeout, keeping every status seen: the phase fails
    on any 5xx it did not provoke."""

    def __init__(self, base):
        self.base = base
        self.statuses = []
        self.lock = threading.Lock()

    def call(self, path, body=None, content_type="text/csv", accept=None):
        headers = {"Content-Type": content_type}
        if accept:
            headers["Accept"] = accept
        req = urllib.request.Request(self.base + path, data=body, headers=headers,
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status, out = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, out = e.code, e.read()
        with self.lock:
            self.statuses.append(status)
        return status, out


def _decode_scores(body, accept):
    if accept == "text/csv":
        return np.asarray([float(v) for v in body.decode().split("\n")])
    if accept == "application/json":
        return np.asarray([p["score"] for p in json.loads(body)["predictions"]])
    if accept == "application/jsonlines":
        return np.asarray([json.loads(line)["score"] for line in body.decode().splitlines()])
    from sagemaker_xgboost_container_tpu_torch.data.recordio import read_recordio_protobuf

    return read_recordio_protobuf(body)[0][:, 0]


def _percentiles(lat_ms):
    p50, p95, p99 = np.percentile(lat_ms, [50, 95, 99])
    return "p50 {:.3f} ms, p95 {:.3f} ms, p99 {:.3f} ms".format(p50, p95, p99)


def _load(base, body, want, threads, per_thread):
    """`threads` clients each POST `body` (csv) `per_thread` times and check
    every answer against `want`. -> (latencies ms, wall s, failed statuses,
    every status)."""
    client = _Client(base)
    # urllib builds its opener and imports lazily on the first call, which
    # takes ~100 ms when the threads race for it: once before the clock
    client.call("/ping")
    lat, errs = [], []

    def worker():
        for _ in range(per_thread):
            t = time.perf_counter()
            status, out = client.call("/invocations", body, "text/csv", "text/csv")
            lat.append((time.perf_counter() - t) * 1e3)
            if status != 200 or np.abs(_decode_scores(out, "text/csv") - want).max() > 1e-5:
                errs.append(status)

    t = time.perf_counter()
    pool = [threading.Thread(target=worker) for _ in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(300)
        check(not th.is_alive(), "a client thread did not finish")
    return lat, time.perf_counter() - t, errs, client.statuses


def load_child(base, body_path, want_path, threads, per_thread):
    """`chip_smoke.py --load URL BODY WANT THREADS PER_THREAD`: the serve
    phase's load from a process of its own, so that the clients do not share
    the server's interpreter lock; prints one JSON line."""
    with open(body_path, "rb") as f:
        body = f.read()
    lat, wall, errs, statuses = _load(base, body, np.load(want_path), int(threads),
                                      int(per_thread))
    print(json.dumps({"lat_ms": lat, "wall_s": wall, "failed": errs, "statuses": statuses}))
    return 0


def _child_load(base, tmp, x, want, threads, per_thread):
    """`_load` run by `chip_smoke.py --load` in a child process."""
    body_path, want_path = os.path.join(tmp, "body.csv"), os.path.join(tmp, "want.npy")
    with open(body_path, "wb") as f:
        f.write(_csv_body(x))
    np.save(want_path, want)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--load", base, body_path, want_path,
         str(threads), str(per_thread)], capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, "load client failed: {}".format(out.stderr[-2000:]))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return res["lat_ms"], res["wall_s"], res["failed"], res["statuses"]


def _device_split(torch, forest, x, rounds, reps=20):
    """Median (H2D, traversal, D2H, host total) ms of the device predict's
    steps, CUDA events between them."""
    from sagemaker_xgboost_container_tpu_torch.ops.predict import forest_predict_margin

    _, dev = forest._stack(0, forest.iteration_indptr[rounds])
    base = forest.objective().base_margin(forest.base_score)
    rows = []
    for _ in range(reps + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev[0].record()
        xt = torch.as_tensor(x, dtype=torch.float32, device=DEVICE)
        ev[1].record()
        margin = forest_predict_margin(dev, xt, base_margin=base)
        ev[2].record()
        margin.cpu().numpy()
        ev[3].record()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)] + [total])
    return np.median(np.asarray(rows[2:]), axis=0)


def host_probe(model_path):
    """`chip_smoke.py --host-probe MODEL`: time the request decode and the
    host predict path on the CPU in this process, print one JSON line. Run
    twice by the serve phase, with and without OMP_NUM_THREADS=1 set before
    torch is imported."""
    import torch

    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.serving import serve_utils

    forest = Forest.load_model(model_path, device="cpu")
    x, _ = make_data(10_000, N_FEATURES, seed=5)
    out = {"omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
           "torch_threads": torch.get_num_threads()}
    for n, reps in ((1, 200), (100, 50), (10_000, 3)):
        body = _csv_body(x[:n])
        t = time.perf_counter()
        for _ in range(reps):
            serve_utils.parse_content_data(body, "text/csv")
        out["decode_csv_{}_ms".format(n)] = (time.perf_counter() - t) * 1e3 / reps
    rng = serve_utils.best_iteration_range(forest)
    for n in (1, 32):
        t = time.perf_counter()
        for _ in range(100):
            forest.predict(x[:n], iteration_range=rng)
        out["host_predict_{}_ms".format(n)] = (time.perf_counter() - t) * 10
    print(json.dumps(out))
    return 0


def run_serve(torch, pkg, hist, tag):
    """Phase 7: the serve entry point on the card (see the module docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        _serve(torch, pkg, hist, tag, tmp)
    print("{} | serve phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _serve(torch, pkg, hist, tag, tmp):
    from wsgiref.simple_server import make_server

    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.data.recordio import write_recordio_protobuf
    from sagemaker_xgboost_container_tpu_torch.models import compat
    from sagemaker_xgboost_container_tpu_torch.models import forest as forest_mod
    from sagemaker_xgboost_container_tpu_torch.serving import app as app_mod
    from sagemaker_xgboost_container_tpu_torch.serving import server

    t0 = time.perf_counter()
    X, y = make_data(SERVE_TRAIN_ROWS, N_FEATURES, seed=3)
    forest = pkg.train(MAIN_PARAMS, DataMatrix(X, y), SERVE_ROUNDS, device=DEVICE,
                       verbose_eval=False)
    torch.cuda.synchronize()
    forest.set_attr(best_iteration=SERVE_BEST_ITERATION)
    rounds = SERVE_BEST_ITERATION + 1
    json_dir, ubj_dir = os.path.join(tmp, "json"), os.path.join(tmp, "ubjson")
    os.makedirs(json_dir)
    os.makedirs(ubj_dir)
    path = os.path.join(json_dir, "xgboost-model")
    forest.save_model(path)
    with open(os.path.join(ubj_dir, "xgboost-model"), "wb") as f:
        f.write(compat.encode_ubjson(json.loads(forest.save_json())))
    nodes = max(t.num_nodes for t in forest.trees)
    print("{} | serve model: {} rounds of depth-8 binary:logistic on {} x {} rows in {:.3f} s "
          "(up to {} nodes a tree), best_iteration {}".format(
              tag, SERVE_ROUNDS, SERVE_TRAIN_ROWS, N_FEATURES, time.perf_counter() - t0,
              nodes, SERVE_BEST_ITERATION), flush=True)

    x_all, _ = make_data(N_SERVE, N_FEATURES, seed=4)
    x_all[np.random.RandomState(5).rand(*x_all.shape) < 0.02] = np.nan
    on_cpu = forest_mod.Forest.load_model(path, device="cpu")
    ref = on_cpu.predict(x_all, iteration_range=(0, rounds))

    os.environ["SM_MODEL_DIR"] = json_dir
    hist.reset_launch_counts()
    forest_mod.reset_predict_counts()
    httpd = server.serving_entrypoint(port=0, block=False, device=DEVICE)
    loop = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    client = _Client("http://127.0.0.1:{}".format(httpd.server_port))
    service = httpd.get_app().service
    ubj_httpd = None
    try:
        t = time.perf_counter()
        status, _ = client.call("/ping")
        check(status == 200, "/ping answered {}".format(status))
        check(service.warmup.join(60) is None and not service.warmup.is_alive(),
              "warmup did not finish")
        first_s = time.perf_counter() - t
        status, body = client.call("/execution-parameters")
        params = json.loads(body)
        check(status == 200 and params["BatchStrategy"] == "MULTI_RECORD",
              "/execution-parameters answered {} {}".format(status, body[:100]))
        print("{} | serve: /ping 200 (model load + warmup {:.3f} s), /execution-parameters {}"
              .format(tag, first_s, params), flush=True)

        # ---- correctness: every content type x every accept, 10k rows
        t_check = time.perf_counter()
        bodies = {"text/csv": _csv_body(x_all), "text/libsvm": _libsvm_body(x_all),
                  "application/x-recordio-protobuf": write_recordio_protobuf(x_all)}
        worst = 0.0
        for ctype, body in bodies.items():
            for accept in ("text/csv", "application/json", "application/jsonlines",
                           "application/x-recordio-protobuf"):
                status, out = client.call("/invocations", body, ctype, accept)
                check(status == 200, "{} -> {} answered {}".format(ctype, accept, status))
                got = _decode_scores(out, accept)
                check(got.shape == ref.shape and np.all(np.isfinite(got)),
                      "{} -> {}: bad answer shape {}".format(ctype, accept, got.shape))
                err = float(np.abs(got - ref).max())
                worst = max(worst, err)
                check(err <= 1e-5, "{} -> {}: max_abs_err {} against the CPU predict".format(
                    ctype, accept, err))
        os.environ["SAGEMAKER_INFERENCE_OUTPUT"] = "predicted_label,probability"
        try:
            status, out = client.call("/invocations", bodies["text/csv"], "text/csv",
                                      "application/json")
        finally:
            del os.environ["SAGEMAKER_INFERENCE_OUTPUT"]
        check(status == 200, "selectable inference answered {}".format(status))
        sel = json.loads(out)["predictions"]
        prob = np.asarray([p["probability"] for p in sel])
        check(np.abs(prob - ref).max() <= 1e-5
              and [p["predicted_label"] for p in sel] == [int(v > 0.5) for v in ref],
              "selectable inference disagrees with the CPU predict")
        # the UBJSON copy of the model, served by a second server
        ubj_app = app_mod.make_app(app_mod.ScoringService(ubj_dir, device=DEVICE))
        ubj_httpd = make_server("127.0.0.1", 0, ubj_app, server_class=server._ThreadedWSGIServer,
                                handler_class=server._QuietHandler)
        threading.Thread(target=ubj_httpd.serve_forever, daemon=True).start()
        ubj_client = _Client("http://127.0.0.1:{}".format(ubj_httpd.server_port))
        status, out = ubj_client.call("/invocations", bodies["application/x-recordio-protobuf"],
                                      "application/x-recordio-protobuf", "text/csv")
        ubj_err = float(np.abs(_decode_scores(out, "text/csv") - ref).max())
        check(status == 200 and ubj_err <= 1e-5, "UBJSON model: {} err {}".format(status, ubj_err))
        ubj_httpd.stop()
        ubj_httpd = None
        client.statuses.extend(ubj_client.statuses)
        # provoked errors: 204, 415, 406, 400
        wide = _csv_body(np.hstack([x_all[:5], x_all[:5, :2]]))
        provoked = [client.call("/invocations", b"", "text/csv")[0],
                    client.call("/invocations", b"<x/>", "application/xml")[0],
                    client.call("/invocations", bodies["text/csv"][:200].rsplit(b"\n", 1)[0],
                                "text/csv", "text/html")[0],
                    client.call("/invocations", wide, "text/csv")[0]]
        check(provoked == [204, 415, 406, 400], "error codes {}".format(provoked))
        print("{} | serve correctness: {} rows x (csv, libsvm, recordio-protobuf) x (csv, "
              "json, jsonlines, recordio-protobuf) max_abs_err {:.3e} against the CPU predict "
              "(iteration_range (0, {})); selectable inference ok; UBJSON model max_abs_err "
              "{:.3e}; errors 204/415/406/400 as expected ({:.1f} s)".format(
                  tag, len(x_all), worst, rounds, ubj_err, time.perf_counter() - t_check),
              flush=True)

        # ---- latency and throughput, end to end over HTTP, the clients in a
        # process of their own; 1-row requests again from threads of this
        # process, which share the server's interpreter lock
        served = service.model
        loads = [(n, threads, per_thread, "child process")
                 for n, threads, per_thread in SERVE_LOADS]
        loads.append((1, 16, 20, "threads of the server's process"))
        for n, threads, per_thread, where in loads:
            x = x_all[:n]
            before = service.batcher.stats()
            forest_mod.reset_predict_counts()
            if where == "child process":
                lat, wall, errs, statuses = _child_load(client.base, tmp, x, ref[:n], threads,
                                                        per_thread)
            else:
                lat, wall, errs, statuses = _load(client.base, _csv_body(x), ref[:n], threads,
                                                  per_thread)
            client.statuses.extend(statuses)
            check(len(lat) == threads * per_thread and not errs,
                  "{} wrong or failed answers at {} rows: {}".format(len(errs), n, errs[:5]))
            counts = dict(forest_mod.PREDICTS)
            after = service.batcher.stats()
            delta = {k: after[k] - before[k] for k in after}
            inproc = []
            for _ in range(20 if n < 10_000 else 10):
                t = time.perf_counter()
                served.predict(x, iteration_range=(0, rounds))
                inproc.append((time.perf_counter() - t) * 1e3)
            split = ("H2D {:.4f} + traversal {:.4f} + D2H {:.4f} ms (CUDA events), "
                     "{:.4f} ms host clock".format(*_device_split(torch, served, x, rounds))
                     if n > forest_mod.HOST_PREDICT_ROWS else "host path (numpy), no transfer")
            print("{} | serve {} rows, {} client thread(s) x {} requests ({}): {}; {:.1f} "
                  "requests/s; in-process Forest.predict median {:.3f} ms; device predict "
                  "split: {}; batcher requests {} inline {} dispatches {} coalesced {}; "
                  "predicts host {} device {}".format(
                      tag, n, threads, per_thread, where, _percentiles(lat), len(lat) / wall,
                      float(np.median(inproc)), split, delta["requests"], delta["inline"],
                      delta["dispatches"], delta["coalesced"], counts["host"],
                      counts["device"]), flush=True)
            if n == 100:
                check(counts["device"] > 0, "the 100-row traffic made no device predict")

        # ---- the device's share of the 100-row load, under torch.profiler
        # (device activity); its set-up takes seconds, so the clock starts
        # once it runs
        forest_mod.reset_predict_counts()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        t = time.perf_counter()
        lat, wall, errs, statuses = _child_load(client.base, tmp, x_all[:100], ref[:100], 16, 10)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t
        prof.stop()
        client.statuses.extend(statuses)
        check(not errs, "wrong or failed answers in the profiled load: {}".format(errs[:5]))
        events = [e for e in prof.key_averages() if _kernel_time_us(torch, e) > 0]
        busy_ms = sum(_kernel_time_us(torch, e) for e in events) / 1e3
        kernels = sum(int(e.count) for e in events)
        device = forest_mod.PREDICTS["device"]
        print("{} | serve 100 rows, 16 client threads x 10 requests (child process) under "
              "torch.profiler: {:.1f} requests/s; {} device predicts, {} kernel launches "
              "({:.0f} a predict), device busy {:.3f} ms ({:.4f} ms a predict), {:.2%} of the "
              "load's {:.3f} s".format(
                  tag, len(lat) / wall, device, kernels, kernels / max(device, 1), busy_ms,
                  busy_ms / max(device, 1), busy_ms / 1e3 / elapsed, elapsed), flush=True)

        # ---- shutdown: SIGTERM with a request in flight
        inflight = {}

        def late():
            inflight["answer"] = client.call("/invocations", bodies["text/csv"], "text/csv",
                                             "text/csv")

        req = threading.Thread(target=late)
        req.start()
        time.sleep(0.2)
        t = time.perf_counter()
        os.kill(os.getpid(), signal.SIGTERM)
        check(httpd.stopped.wait(60), "the server did not stop after SIGTERM")
        stop_s = time.perf_counter() - t
        req.join(60)
        status, out = inflight.get("answer", (None, b""))
        check(status == 200 and np.abs(_decode_scores(out, "text/csv") - ref).max() <= 1e-5,
              "the request in flight at SIGTERM lost its answer: {}".format(status))
        loop.join(10)
        check(not loop.is_alive(), "the serve loop did not end")
        refused = False
        try:
            client.call("/ping")
        except OSError:
            refused = True
        check(refused, "the listener still answers after SIGTERM")
        launches = dict(hist.LAUNCHES)
        print("{} | serve shutdown: SIGTERM -> stopped in {:.3f} s, the in-flight {}-row "
              "request answered 200 and right, listener closed; serve launches {}".format(
                  tag, stop_s, len(x_all), json.dumps(launches)), flush=True)
        fives = [s for s in client.statuses if s >= 500]
        check(not fives, "unprovoked 5xx answers: {}".format(fives))
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        if not httpd.stopped.is_set():
            httpd.stop()
        if ubj_httpd is not None:
            ubj_httpd.stop()
        os.environ.pop("SM_MODEL_DIR", None)

    # OMP_NUM_THREADS=1 (set by the entry point) against unset, each set
    # before torch is imported, on the host path and the decode; the two
    # child processes run at the same time, so neither has the other's turn
    t = time.perf_counter()
    procs = {}
    for label, omp in (("OMP_NUM_THREADS=1", "1"), ("unset", None)):
        env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
        if omp:
            env["OMP_NUM_THREADS"] = omp
        procs[label] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--host-probe", path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for label, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        check(proc.returncode == 0, "host probe failed: {}".format(err[-2000:]))
        print("{} | serve host probe ({}, both child processes together {:.1f} s): {}".format(
            tag, label, time.perf_counter() - t, out.strip().splitlines()[-1]), flush=True)


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
        run_serve(torch, pkg, hist, tag)
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
    if sys.argv[1:2] == ["--host-probe"]:
        sys.exit(host_probe(sys.argv[2]))
    if sys.argv[1:2] == ["--load"]:
        sys.exit(load_child(*sys.argv[2:7]))
    sys.exit(main())
