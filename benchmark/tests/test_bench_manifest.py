"""BENCHMARK.json resolves: every cell's configuration, traffic, limits and
per-layer reader is a file of its own, and the manifest keeps the shapes
the driver reads."""

import os
import re

import pytest

from tiny_cells import ROOT, manifest

from benchmark import harness, judge

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert M["command"][1] == "benchmark/run.py"
    assert 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_resolves(cell):
    c = harness.Cell(M, cell, ROOT)
    assert c.chips == 1
    assert set(judge.NUMBERS) <= set(c.limits)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) == 2
    assert all(n == "setup_s" or n.endswith("rounds_per_s") for n in names)
    for m in c.per_layer:
        assert m["moves"] in names
    assert c.per_layer, "a cell reports at least one per-layer metric"
    for m in c.per_layer:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("benchmark/")
    cfg = harness._load(os.path.join(ROOT, conf["file"]))
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]


def test_names_units_and_sources():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in M["end_to_end"] + M["per_layer"])) == len(
        M["end_to_end"] + M["per_layer"])
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= {w["name"] for w in M["workloads"]}
