#!/usr/bin/env python3
"""Time the PyTorch port's level_histogram of one checkout on one GPU.

    python3 scripts/torch_hist_ab.py [ROOT]

Imports sagemaker_xgboost_container_tpu_torch from ROOT (a checkout of the
repository; default: the one holding this script), builds its kernels, and
at chip_smoke.py phase 2's timed single-class shapes (1M x 28 uint16 bins,
B=257; nodes drawn from [-1, W) at W=1 and W=64, and level 7's left
children at W=64, seeds as there) prints one JSON line with, per shape:

- wrapper_ms: CUDA events around 20 back-to-back level_histogram calls, per
  call, repeated 5 times;
- device_ms: the device time per call of every hist_* kernel those calls
  enqueue, from torch.profiler over 20 more calls, by kernel name, and
  their sum.

To compare two checkouts on one card, run it in turns in one command:
A, B, B, A. Needs one CUDA GPU.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np

N, D, B, ITERS, REPEATS = 1_000_000, 28, 257, 20, 5
SHAPES = (("W=1", 1, "random"), ("W=64", 64, "random"), ("W=64 left", 64, "left"))


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), os.pardir))
    sys.path.insert(0, root)
    import torch
    from sagemaker_xgboost_container_tpu_torch import _build
    from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.kernels()
    dev = torch.device("cuda")
    out = {"root": root, "card": card}
    for label, W, kind in SHAPES:
        rng = np.random.RandomState(10 + W)
        bins = torch.as_tensor(rng.randint(0, B, (N, D)).astype(np.uint16), device=dev)
        grad = torch.as_tensor(rng.randn(N).astype(np.float32), device=dev)
        hess = torch.as_tensor((rng.rand(N) + 0.1).astype(np.float32), device=dev)
        if kind == "random":
            node = rng.randint(-1, W, N)
        else:
            child = rng.randint(0, 2 * W, N)
            node = np.where(child % 2 == 0, child // 2, -1)
        node = torch.as_tensor(node.astype(np.int32), device=dev)

        def call():
            return hist.level_histogram(bins, grad, hess, node, W, B)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        wrapper = []
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                call()
            end.record()
            torch.cuda.synchronize()
            wrapper.append(start.elapsed_time(end) / ITERS)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                call()
            torch.cuda.synchronize()
        per = {}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            found = re.findall(r"hist_[a-z]+", evt.key)
            if us > 0 and found:
                per[found[-1]] = per.get(found[-1], 0.0) + us / 1e3 / ITERS
        out[label] = {"wrapper_ms": wrapper, "device_ms": per,
                      "device_ms_total": sum(per.values())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
