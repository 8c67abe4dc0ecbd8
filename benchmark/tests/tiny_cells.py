"""The benchmark's cells cut to a size the CPU tests can run: the same
files, with the row counts, query counts and leaves made small."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(name):
    cell = harness.Cell(manifest(), name, ROOT)
    if cell.config["generator"] == "higgs":
        cell.config.update(rows_train=12000, rows_valid=2000)
    else:
        cell.config.update(queries_train=90, queries_valid=30, features=12, docs_max=300)
    if cell.traffic["params"].get("grow_policy") == "lossguide":
        cell.traffic["params"]["max_leaves"] = 15
    else:
        cell.traffic["params"]["max_depth"] = 5
    cell.traffic["params"]["_rounds_per_dispatch"] = 4
    cell.traffic["trace_dispatches"] = 1
    return cell
