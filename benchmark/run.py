"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers that decided ``correct`` are its last key
and the last lines of standard error. With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` window of whole dispatches.

It needs as many CUDA devices as the cell asks for, and exits with code 2,
printing no result, where there are fewer: it never falls back to the CPU.
Every cache the port builds (its CUDA kernels, the native data plane) goes
under ``benchmark/.cache/`` of the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _pin_caches():
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("GRAFT_COMPILE_CACHE_DIR", "compile"), ("TORCH_EXTENSIONS_DIR", "torch"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(cache, sub)


def _card_line(torch):
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        power = out[0] if out else "power limit not read"
    except (OSError, subprocess.SubprocessError):
        power = "power limit not read"
    return "device: {} x{} ({})".format(torch.cuda.get_device_name(0), torch.cuda.device_count(),
                                        power)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _pin_caches()
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = harness.Cell(manifest, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("{} needs {} CUDA device(s); this machine has {}".format(
            cell.name, cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    print(_card_line(torch), file=sys.stderr, flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
