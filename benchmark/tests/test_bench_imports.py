"""Neither the harness nor the reference loads JAX or the JAX package (by
whole top-level module name; the port's name begins with the JAX
package's), and the reference loads nothing of the port. Each check runs
in a fresh interpreter."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tiny_cells import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sagemaker_xgboost_container_tpu"}
PORT = "sagemaker_xgboost_container_tpu_torch"


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    top = _loaded("import benchmark.reference, benchmark.judge, benchmark.inputs, "
                  "benchmark.work")
    assert not top & FORBIDDEN
    assert PORT not in top


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests')\n"
            "import time, torch\nfrom tiny_cells import tiny_cell\nfrom benchmark import harness\n"
            "harness.run(tiny_cell('higgs.depthwise'), 1, 0.3, False, torch.device('cpu'), "
            "time.perf_counter())")
    top = _loaded(code)
    assert not top & FORBIDDEN
    assert PORT in top


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "higgs.depthwise",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if "needs 1 CUDA device" not in out.stderr:
        pytest.skip("this machine has a CUDA device")
    assert out.returncode != 0 and out.stdout == ""


def test_bare_checkout_has_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "higgs.depthwise",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""
