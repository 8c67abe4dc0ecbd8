"""The port's lint gate (``sagemaker_xgboost_container_tpu_torch.toolkit.graftlint``).

Each rule on a fixture tree in ``tmp_path``, flagged where it should be and
not where it should not: the capture pass (env reads, host syncs and graph
captures inside the functions ``models/round_graph.CAPTURED_ROOTS`` names,
and the functions they reach), the concurrency and I/O rules, contract
drift against the shared docs and the README's port tables, the legacy
gates, suppressions, the baseline and the command line; then the gate over
the port's own package, which must exit 0 with an empty baseline.
"""

import json
import os
import subprocess
import sys
import textwrap

from sagemaker_xgboost_container_tpu_torch.toolkit.graftlint import core
from sagemaker_xgboost_container_tpu_torch.toolkit.graftlint.__main__ import (
    main as graftlint_main,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = core.PACKAGE


def make_tree(tmp_path, files, docs=None):
    """A repo root in ``tmp_path``: ``files`` under the package directory,
    ``docs`` (README.md, docs/...) under the root. -> the root."""
    pkg = tmp_path / PKG
    pkg.mkdir(exist_ok=True)
    for rel, src in files.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    for rel, text in (docs or {}).items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return str(tmp_path)


def run_rules(root, *rules, **kwargs):
    report = core.run(root, select=list(rules) or None,
                      use_baseline=kwargs.pop("use_baseline", False), **kwargs)
    assert not report.errors, report.errors
    return report


def rule_set(report):
    return {f.rule for f in report.findings}


def roots(*names):
    """A fixture's ``models/round_graph.py`` naming the captured roots."""
    return {"models/round_graph.py": "CAPTURED_ROOTS = {!r}\n".format(tuple(names))}


# ------------------------------------------------------------- capture safety


CAPTURED_BODY = """\
    import os
    import torch


    class Session:
        def body(self, x):
            {line}
            return x


    def outside(x):
        {line}
        return x
    """


def _one_line_tree(tmp_path, line):
    return make_tree(tmp_path, dict(roots("mod:Session.body"), **{
        "mod.py": CAPTURED_BODY.format(line=line)}))


def test_capture_flags_an_item_in_a_captured_root_and_not_outside(tmp_path):
    root = _one_line_tree(tmp_path, "n = x.sum().item()")
    report = run_rules(root, "capture-host-sync")
    assert [(f.rule, f.line) for f in report.findings] == [("capture-host-sync", 7)]
    assert "Session.body" in report.findings[0].message


def test_capture_flags_an_env_read_in_a_captured_root_and_not_outside(tmp_path):
    root = _one_line_tree(tmp_path, 'k = os.environ.get("GRAFT_CHUNK", "1")')
    report = run_rules(root, "capture-env-read")
    assert [(f.rule, f.line) for f in report.findings] == [("capture-env-read", 7)]
    assert "GRAFT_CHUNK" in report.findings[0].message


def test_capture_flags_a_graph_captured_per_call_and_not_outside(tmp_path):
    root = _one_line_tree(tmp_path, "g = torch.cuda.CUDAGraph()")
    report = run_rules(root, "capture-uncached-graph")
    assert [(f.rule, f.line) for f in report.findings] == [("capture-uncached-graph", 7)]


def test_capture_host_syncs_of_every_kind(tmp_path):
    root = make_tree(tmp_path, dict(roots("mod:body"), **{"mod.py": """\
        import numpy as np
        import torch


        def body(x, n):
            a = x.cpu()
            b = x.tolist()
            torch.cuda.synchronize()
            c = torch.nonzero(x)
            d = torch.as_tensor([1.0], device=x.device)
            e = np.asarray(x)
            print(x)
            f = int(n)
            return a, b, c, d, e, f
        """}))
    report = run_rules(root, "capture-host-sync")
    assert [f.line for f in report.findings] == [6, 7, 8, 9, 10, 11, 12, 13]


def test_capture_follows_the_call_graph_and_spares_the_session_setup(tmp_path):
    root = make_tree(tmp_path, dict(roots("mod:body"), **{"mod.py": """\
        import os


        def helper():
            return os.environ.get("GRAFT_DEEP")


        def body(x):
            return x + helper()


        def session_setup():
            # on the host, once a session: the right place for a knob
            return os.environ.get("GRAFT_SESSION_KNOB", "a")
        """}))
    report = run_rules(root, "capture-env-read")
    assert len(report.findings) == 1
    assert "GRAFT_DEEP" in report.findings[0].message


def test_capture_reaches_helpers_through_comprehensions_and_closures(tmp_path):
    root = make_tree(tmp_path, dict(roots("ops.tree:build_tree"), **{"ops/tree.py": """\
        import os


        def apply_collective(g):
            return g * int(os.environ.get("GRAFT_COMM_KNOB", "1"))


        def scan_batch(g):
            return g.item()


        def build_tree(gs):
            batches = [apply_collective(g) for g in gs]

            def _batch(g):
                return scan_batch(g)

            return [_batch(g) for g in batches]
        """}))
    report = run_rules(root, "capture-env-read", "capture-host-sync")
    assert rule_set(report) == {"capture-env-read", "capture-host-sync"}


def test_capture_reaches_methods_and_relative_imports(tmp_path):
    root = make_tree(tmp_path, dict(roots("models.booster:Session.round"), **{
        "ops/grad.py": """\
            def grad(x):
                return x.item()
            """,
        "models/booster.py": """\
            from ..ops.grad import grad


            class Session:
                def round(self, x):
                    return self.step(x)

                def step(self, x):
                    return grad(x)
            """}))
    report = run_rules(root, "capture-host-sync")
    assert [f.path for f in report.findings] == [PKG + "/ops/grad.py"]


def test_capture_envconfig_helper_definition_is_exempt(tmp_path):
    root = make_tree(tmp_path, dict(roots("mod:body"), **{
        "utils/envconfig.py": """\
            import os

            def env_int(name, default):
                raw = os.getenv(name)
                return int(raw) if raw else default
            """,
        "mod.py": """\
            from .utils.envconfig import env_int

            def body(x):
                return x * env_int("GRAFT_SCALE", 1)
            """,
    }))
    report = run_rules(root, "capture-env-read")
    assert [(f.path, f.rule) for f in report.findings] == [(PKG + "/mod.py", "capture-env-read")]
    assert "GRAFT_SCALE" in report.findings[0].message


def test_capture_resolves_absolute_imports_when_the_root_is_the_package(tmp_path):
    make_tree(tmp_path, dict(roots("mod:body"), **{
        "helper.py": """\
            import os

            def leaky():
                return os.environ.get("GRAFT_X")
            """,
        "mod.py": """\
            from {}.helper import leaky

            def body(x):
                return leaky()
            """.format(PKG),
    }))
    report = run_rules(str(tmp_path / PKG), "capture-env-read")
    assert rule_set(report) == {"capture-env-read"}
    assert report.findings[0].path == "helper.py"


def test_capture_without_roots_finds_nothing(tmp_path):
    root = make_tree(tmp_path, {"mod.py": "def body(x):\n    return x.item()\n"})
    assert not run_rules(root, "capture-host-sync").findings


def test_capture_roots_are_the_ports_round_body():
    from sagemaker_xgboost_container_tpu_torch.models import booster, round_graph

    for spec in round_graph.CAPTURED_ROOTS:
        module, _, qual = spec.partition(":")
        assert module == "models.booster"
        obj = booster
        for part in qual.split("."):
            obj = getattr(obj, part)
        assert callable(obj)


# ------------------------------------------------------ concurrency discipline


def test_socket_unbounded_recv_loop(tmp_path):
    root = make_tree(tmp_path, {"net.py": """\
        def recv_exact(sock, n):
            buf = b""
            while len(buf) < n:
                chunk = sock.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("peer closed")
                buf += chunk
            return buf
        """})
    report = run_rules(root, "socket-unbounded")
    assert [f.rule for f in report.findings] == ["socket-unbounded"]


def test_socket_with_timeout_in_scope_is_clean(tmp_path):
    root = make_tree(tmp_path, {"net.py": """\
        def recv_bounded(sock, n, timeout):
            sock.settimeout(timeout)
            return sock.recv(n)
        """})
    assert not run_rules(root, "socket-unbounded").findings


def test_socket_member_timeout_set_elsewhere_in_class_is_clean(tmp_path):
    root = make_tree(tmp_path, {"net.py": """\
        class Listener:
            def start(self):
                self._sock.settimeout(5.0)

            def poll(self):
                return self._sock.accept()
        """})
    assert not run_rules(root, "socket-unbounded").findings


def test_thread_daemon_missing(tmp_path):
    root = make_tree(tmp_path, {"mod.py": """\
        import threading

        def spawn(fn):
            good = threading.Thread(target=fn, daemon=True)
            also_good = threading.Thread(
                target=fn,
                daemon=False)
            bad = threading.Thread(target=fn)
            return good, also_good, bad
        """})
    report = run_rules(root, "thread-daemon-missing")
    assert [(f.rule, f.line) for f in report.findings] == [("thread-daemon-missing", 8)]


def test_shared_state_unlocked(tmp_path):
    root = make_tree(tmp_path, {"worker.py": """\
        import threading

        class Batcher:
            def __init__(self):
                self._lock = threading.Lock()
                self._carry = None
                self._t = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                while True:
                    self._carry = 1

            def poll(self):
                with self._lock:
                    self._carry = None
        """})
    report = run_rules(root, "shared-state-unlocked")
    assert len(report.findings) == 1
    assert "_carry" in report.findings[0].message


def test_shared_state_all_locked_is_clean(tmp_path):
    root = make_tree(tmp_path, {"worker.py": """\
        import threading

        class Batcher:
            def __init__(self):
                self._lock = threading.Lock()
                self._carry = None
                self._t = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                while True:
                    with self._lock:
                        self._carry = 1

            def poll(self):
                with self._lock:
                    self._carry = None
        """})
    assert not run_rules(root, "shared-state-unlocked").findings


# ------------------------------------------------------------- contract drift

# the JAX package's docs: shared names are documented there, and their
# tables are not the port's to keep (no orphan finding from them)
SHARED_DOCS = {
    "docs/observability.md": """\
        # Observability

        | Env var | Default | Effect |
        | --- | --- | --- |
        | `GRAFT_SHARED_KNOB` | `1` | shared by both packages |
        | `GRAFT_JAX_ONLY_KNOB` | `1` | the JAX package's alone |

        | Metric | Type | Meaning |
        | --- | --- | --- |
        | `widget_spins_total` | counter | shared |
        """,
    "docs/robustness.md": """\
        # Robustness

        | Code | Meaning | Source |
        | --- | --- | --- |
        | `85` | shared exit code | constants.py |
        | `86` | the JAX package's alone | elsewhere |

        | Fault point | Fires in |
        | --- | --- |
        | `data.read` | readers |
        """,
}
README = """\
    # The container

    | Knob | Default | Effect |
    | --- | --- | --- |
    | `GRAFT_OUTSIDE_PORT_SECTION` | 1 | another section: not the port's table |

    ## PyTorch/CUDA port (`{pkg}/`)

    | Knob | Default | Effect |
    | --- | --- | --- |
    | `GRAFT_PORT_KNOB` | `1` | the port's own, read in code |
    | `GRAFT_PORT_GHOST` | `1` | the port's own, gone from code |
    | `port_ghost_total` | counter | gone from code |
    | `ghost.point` | nowhere | gone from code |
    | `97` | a port exit code with no constant | nowhere |

    ## Another section

    | `GRAFT_AFTER_PORT_SECTION` | 1 | not the port's table |
    """.format(pkg=PKG)
CONTRACT_CODE = {
    "constants.py": """\
        SM_HOSTS = "SM_HOSTS"
        EXIT_DOCUMENTED = 85
        EXIT_UNDOCUMENTED = 88
        """,
    "app.py": """\
        import os
        from .utils.faults import fault_point
        from .telemetry import REGISTRY

        def configure():
            a = os.environ.get("GRAFT_SHARED_KNOB")
            b = os.environ.get("GRAFT_PORT_KNOB")
            c = os.environ.get("GRAFT_UNDOC_KNOB")
            d = os.environ.get("SM_HOSTS")
            REGISTRY.counter("widget_spins_total").inc()
            REGISTRY.counter("widget_undoc_total").inc()
            fault_point("data.read")
            fault_point("secret.site")
            return a, b, c, d
        """,
}


def test_contract_drift_both_directions(tmp_path):
    docs = dict(SHARED_DOCS, **{"README.md": README})
    root = make_tree(tmp_path, CONTRACT_CODE, docs=docs)
    report = core.run(root, use_baseline=False)
    by_rule = {}
    for f in report.findings:
        by_rule.setdefault(f.rule, []).append((f.path, f.line, f.message))
    msgs = {rule: "\n".join(m for _, _, m in v) for rule, v in by_rule.items()}
    assert "GRAFT_UNDOC_KNOB" in msgs["contract-env-undocumented"]
    assert "widget_undoc_total" in msgs["contract-metric-undocumented"]
    assert "secret.site" in msgs["contract-fault-undocumented"]
    assert "EXIT_UNDOCUMENTED" in msgs["contract-exit-undocumented"]
    # the orphans come from the port's tables only, at the README's lines
    assert msgs["contract-env-orphaned"].count("GRAFT_") == 1
    assert "GRAFT_PORT_GHOST" in msgs["contract-env-orphaned"]
    (path, line, _), = by_rule["contract-env-orphaned"]
    assert path == "README.md" and line == 12
    assert "port_ghost_total" in msgs["contract-metric-orphaned"]
    assert "ghost.point" in msgs["contract-fault-orphaned"]
    assert "97" in msgs["contract-exit-orphaned"]
    flat = "\n".join(msgs.values())
    for clean in ("GRAFT_SHARED_KNOB", "GRAFT_PORT_KNOB", "GRAFT_JAX_ONLY_KNOB",
                  "GRAFT_OUTSIDE_PORT_SECTION", "GRAFT_AFTER_PORT_SECTION",
                  "widget_spins_total", "data.read", "SM_HOSTS", " 86 ",
                  "EXIT_DOCUMENTED"):
        assert clean not in flat, clean


def test_contract_pass_skips_fixture_trees_without_docs(tmp_path):
    root = make_tree(tmp_path, {"app.py": """\
        import os

        def configure():
            return os.environ.get("GRAFT_UNDOC_KNOB")
        """})
    report = core.run(root, select=[r for r in core.known_rules()
                                    if r.startswith("contract-")], use_baseline=False)
    assert not report.findings


# --------------------------------------------------------------- legacy gates


def test_no_print_rule_and_allowlist(tmp_path):
    root = make_tree(tmp_path, {
        "leaky.py": "def f():\n    print('leak')\n",
        "version_contract.py": "def f():\n    print('verdict')\n",
        "models/booster.py": "def f():\n    print('[0]\\tvalidation-rmse:1')\n",
    })
    report = run_rules(root, "no-print")
    assert [f.path for f in report.findings] == [PKG + "/leaky.py"]


def test_no_bare_except_rule(tmp_path):
    root = make_tree(tmp_path, {"handler.py": """\
        def f():
            try:
                return 1
            except:
                return 2
        """})
    report = run_rules(root, "no-bare-except")
    assert [f.rule for f in report.findings] == ["no-bare-except"]


# ---------------------------------------------------- suppressions, baseline


def test_suppression_same_line_and_line_above(tmp_path):
    root = make_tree(tmp_path, {"mod.py": """\
        def f():
            print('a')  # graftlint: disable=no-print stdout contract of the drill
            # graftlint: disable=no-print covers the next code line
            print('b')
            print('c')
        """})
    report = run_rules(root, "no-print")
    assert [f.line for f in report.findings] == [5]
    assert len(report.suppressed) == 2


def test_suppression_of_a_capture_finding(tmp_path):
    root = _one_line_tree(
        tmp_path, "n = x.item()  # graftlint: disable=capture-host-sync once a session")
    report = run_rules(root, "capture-host-sync")
    assert not report.findings and len(report.suppressed) == 1


def test_reasonless_suppression_is_itself_reported(tmp_path):
    root = make_tree(tmp_path, {"mod.py": """\
        def f():
            print('a')  # graftlint: disable=no-print
        """})
    assert rule_set(core.run(root, use_baseline=False)) == {"suppression-missing-reason"}


def test_baseline_keeps_findings_by_content_not_line_number(tmp_path):
    root = make_tree(tmp_path, {"mod.py": "def f():\n    print('x')\n"})
    baseline = os.path.join(root, "baseline.json")
    report = core.run(root, use_baseline=False)
    core.write_baseline(baseline, report.project, report.findings)
    clean = core.run(root, baseline_path=baseline)
    assert not clean.findings and len(clean.baselined) == 1
    (tmp_path / PKG / "mod.py").write_text("import sys\n\n\ndef f():\n    print('x')\n")
    shifted = core.run(root, baseline_path=baseline)
    assert not shifted.findings and len(shifted.baselined) == 1
    (tmp_path / PKG / "mod.py").write_text(
        "def f():\n    print('x')\n\n\ndef g():\n    print('y')\n")
    dirty = core.run(root, baseline_path=baseline)
    assert len(dirty.findings) == 1 and len(dirty.baselined) == 1


def test_default_baseline_lives_in_the_port_package():
    assert core.DEFAULT_BASELINE.startswith(PKG + "/")
    assert os.path.isfile(os.path.join(REPO_ROOT, core.DEFAULT_BASELINE))


# --------------------------------------------------------------------- the CLI


def test_cli_exits_nonzero_on_every_rule_family(tmp_path, capsys):
    root = make_tree(tmp_path, dict(roots("capture_bad:body"), **{
        "capture_bad.py": """\
            import os
            import torch

            def body(x):
                g = torch.cuda.CUDAGraph()
                return g, os.environ.get("GRAFT_BAD"), x.item()
            """,
        "net_bad.py": """\
            import threading

            def reader(sock):
                t = threading.Thread(target=reader)
                return sock.recv(4)
            """,
        "legacy_bad.py": """\
            def f():
                try:
                    print('x')
                except:
                    pass
            """,
        "constants.py": "EXIT_NEW = 95\n",
        "knob.py": "import os\nK = os.environ.get('GRAFT_CLI_UNDOC')\n",
    }), docs={"docs/observability.md": "# no tables\n",
              "README.md": "## PyTorch/CUDA port\n\nno tables\n"})
    rc = graftlint_main(["--root", root, "--format", "json"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    rules_hit = {f["rule"] for f in payload["findings"]}
    assert {"capture-env-read", "capture-uncached-graph", "capture-host-sync",
            "socket-unbounded", "thread-daemon-missing", "contract-env-undocumented",
            "contract-exit-undocumented", "no-print", "no-bare-except"} <= rules_hit
    assert payload["stats"]["no-print"]["live"] == 1


def test_cli_clean_tree_exits_zero(tmp_path, capsys):
    root = make_tree(tmp_path, {"ok.py": "X = 1\n"})
    assert graftlint_main(["--root", root]) == 0
    assert "graftlint: OK" in capsys.readouterr().err


def test_cli_unparseable_file_exits_two(tmp_path):
    root = make_tree(tmp_path, {"broken.py": "def f(:\n"})
    assert graftlint_main(["--root", root]) == 2


def test_cli_stats_and_list_rules(tmp_path, capsys):
    root = make_tree(tmp_path, {"mod.py": "def f():\n    print('x')\n"})
    rc = graftlint_main(["--root", root, "--stats"])
    err = capsys.readouterr().err
    assert rc == 1 and "rule hit counts" in err and "no-print" in err
    assert graftlint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("capture-env-read", "capture-host-sync", "capture-uncached-graph",
                 "socket-unbounded", "contract-env-undocumented", "no-print",
                 "suppression-missing-reason"):
        assert rule in out
    assert "trace-" not in out


def test_cli_select_and_disable(tmp_path):
    root = make_tree(tmp_path, {"mod.py": """\
        def f():
            try:
                print('x')
            except:
                pass
        """})
    assert graftlint_main(["--root", root, "--select", "no-bare-except"]) == 1
    assert graftlint_main(["--root", root, "--disable", "no-print,no-bare-except"]) == 0


def test_cli_write_baseline_roundtrip_and_carry_over(tmp_path):
    root = make_tree(tmp_path, {"mod.py": """\
        def f():
            try:
                print('x')
            except:
                pass
        """})
    baseline = os.path.join(root, "bl.json")
    assert graftlint_main(["--root", root, "--baseline", baseline, "--write-baseline"]) == 0
    assert graftlint_main(["--root", root, "--baseline", baseline]) == 0
    assert graftlint_main(["--root", root, "--no-baseline"]) == 1
    # a regeneration narrowed to one rule carries the other rule's entry
    assert graftlint_main(["--root", root, "--baseline", baseline, "--select", "no-print",
                           "--write-baseline"]) == 0
    with open(baseline) as f:
        assert {e["rule"] for e in json.load(f)["entries"]} == {"no-print", "no-bare-except"}
    # and drops an entry whose finding was fixed
    (tmp_path / PKG / "mod.py").write_text(
        "def f():\n    try:\n        pass\n    except:\n        pass\n")
    assert graftlint_main(["--root", root, "--baseline", baseline, "--select", "no-print",
                           "--write-baseline"]) == 0
    with open(baseline) as f:
        assert {e["rule"] for e in json.load(f)["entries"]} == {"no-bare-except"}


# ------------------------------------------------------------------ the port


def test_the_port_passes_its_gate_with_an_empty_baseline():
    out = subprocess.run(
        [sys.executable, "-m", "sagemaker_xgboost_container_tpu_torch.toolkit.graftlint",
         "--stats"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert out.returncode == 0, out.stderr
    assert "graftlint: OK" in out.stderr
    report = core.run(REPO_ROOT, use_baseline=False)
    assert not report.errors and not report.findings
    assert all(s.reason for _, s in report.suppressed)
    with open(os.path.join(REPO_ROOT, core.DEFAULT_BASELINE)) as f:
        assert json.load(f)["entries"] == []


def test_the_gate_imports_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "from sagemaker_xgboost_container_tpu_torch.toolkit.graftlint import core\n"
        "core.run(sys.argv[1])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sagemaker_xgboost_container_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code, REPO_ROOT], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert out.returncode == 0, out.stderr
