#!/usr/bin/env python3
"""Time the PyTorch port's node_totals of one checkout on one GPU.

    python3 scripts/torch_totals_ab.py [ROOT]

Imports sagemaker_xgboost_container_tpu_torch from ROOT (a checkout of the
repository; default: the one holding this script), builds its kernels, and
at the main path's last level (n=1M rows, W=256 nodes drawn from [-1, W),
seed 3) prints one JSON line:

- wrapper_ms: CUDA events around 20 back-to-back node_totals calls, per
  call, repeated 5 times;
- device_ms: the device time per call of every kernel those calls enqueue
  (the output's fill included, where there is one), from torch.profiler
  over 20 more calls, by kernel name, and their sum.

To compare two checkouts on one card, run it in turns in one command:
A, B, B, A. Needs one CUDA GPU.
"""

import json
import os
import subprocess
import sys

import numpy as np

N, W, SEED, ITERS, REPEATS = 1_000_000, 256, 3, 20, 5


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
    rng = np.random.RandomState(SEED)
    grad = torch.as_tensor(rng.randn(N).astype(np.float32), device=dev)
    hess = torch.as_tensor((rng.rand(N) + 0.1).astype(np.float32), device=dev)
    node = torch.as_tensor(rng.randint(-1, W, N).astype(np.int32), device=dev)

    def call():
        return hist.node_totals(grad, hess, node, W)

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
        if us > 0:
            per[evt.key[:80]] = float(us) / 1e3 / ITERS
    print(json.dumps({"root": sys.argv[1] if len(sys.argv) > 1 else ".", "card": card,
                      "n": N, "W": W, "wrapper_ms": wrapper,
                      "device_ms": sum(per.values()), "device_ms_by_kernel": per}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
