"""Readings that the limits of ``limits/<cell>.json`` are set from: the
control and the planted faults at a cell's own size, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 [--rounds 3]
        [--skip control_bf16 ...]

For each seed it makes the cell's rows, works out the reference, and prints
one JSON line of the judge's numbers for each of: the reference builder in
float32 (a sound run of the reference's own arithmetic), the control (the
reference in bfloat16) and the float32 reference with each planted fault
(``judge.FAULTS``); for the float32 builder also its ``split_gap`` with
float32's error bound taken 0, 8 and 128 times (``judge.ERR_SCALE`` is what
the benchmark takes). The program's own readings come from the benchmark's
runs (``run.py``), which print the same numbers. The benchmark's runs never
run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0] = os.path.dirname(HERE)

import torch  # noqa: E402

from benchmark import harness, inputs, judge  # noqa: E402


def readings(cell, seed, rounds, device, skip=()):
    data = inputs.make(cell.config, seed, device)
    R = judge.Reference(data, cell.params, device)
    variants = [("reference_f32", torch.float32, None), ("control_bf16", torch.bfloat16, None)]
    variants += [("fault_" + f, torch.float32, f) for f in judge.FAULTS]
    for name, dtype, fault in variants:
        if name in skip:
            continue
        t0 = time.perf_counter()
        prog = judge.control(R, data, rounds, dtype=dtype, fault=fault)
        numbers, _counts, judged = judge.check(R, prog, range(rounds))
        correct, _failed, _rows = judge.verdict(numbers, cell.limits)
        row = dict(cell=cell.name, seed=seed, variant=name, correct=correct, rounds=judged,
                   seconds=time.perf_counter() - t0, **numbers)
        if name == "reference_f32":
            row["split_gap_by_err_scale"] = {
                scale: judge.check(R, prog, range(rounds), err_scale=scale)[0]["split_gap"]
                for scale in (0.0, 8.0, 128.0)}
        yield row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--skip", nargs="*", default=(), help="variants not to run")
    args = ap.parse_args()
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), args.workload, os.path.dirname(HERE))
    if not torch.cuda.is_available():
        sys.exit("calibrate.py runs on a CUDA device")
    for seed in args.seeds:
        for row in readings(cell, seed, args.rounds, torch.device("cuda", 0), args.skip):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
