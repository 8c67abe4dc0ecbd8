"""The legacy gates, as the JAX package keeps them: no-print and
no-bare-except.

* ``no-print``: output goes through the telemetry registry, the logger or
  ``emit_metric``; a stray ``print`` joins the stdout that SageMaker HPO
  scrapes for metric lines. ``PRINT_ALLOWLIST`` names the files whose
  prints are that stdout contract.
* ``no-bare-except``: a bare ``except:`` also catches KeyboardInterrupt and
  SystemExit, the control flow of the supervision exits.
"""

import ast

from ..core import Finding

#: files whose print() calls are a stdout contract (the HPO metric lines of
#: the booster loops and the CV summary, the version-contract verdict, the
#: emit sink), relative to the package root
PRINT_ALLOWLIST = {
    "models/booster.py",
    "training/callbacks.py",
    "training/algorithm_train.py",
    "version_contract.py",
    "telemetry/emit.py",
}


def _print_linenos(tree):
    return sorted(
        node.lineno
        for node in ast.walk(tree)
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "print"
    )


def _bare_except_linenos(tree):
    return sorted(
        node.lineno
        for node in ast.walk(tree)
        if isinstance(node, ast.ExceptHandler) and node.type is None
    )


class LegacyGatesPass(object):
    rules = {
        "no-print": "print() outside the stdout-contract allowlist",
        "no-bare-except": "bare except: clause (names no exception type)",
    }

    def run(self, project):
        for sf in project.files:
            if sf.tree is None:
                continue
            if project._package_rel(sf.relpath) not in PRINT_ALLOWLIST:
                for lineno in _print_linenos(sf.tree):
                    yield Finding(
                        "no-print", sf.relpath, lineno,
                        "print() outside allowlist (route output through "
                        "telemetry.emit_metric or a logger)")
            for lineno in _bare_except_linenos(sf.tree):
                yield Finding(
                    "no-bare-except", sf.relpath, lineno,
                    "bare except (name the exception type: 'except Exception:' at "
                    "minimum)")
