"""graftlint: the port's lint gate, a multi-pass static analyzer.

The counterpart of the JAX package's ``toolkit/graftlint``, over this
package. Four pass families:

* **capture** (``passes/capture.py``, in place of the JAX package's
  ``trace`` pass): the functions a CUDA graph records
  (``models/round_graph.CAPTURED_ROOTS``) and every function they reach must
  not read env knobs, sync with the host, or capture a graph of their own.
* **concurrency and I/O**: sockets read, accept and connect under a
  timeout; threads say ``daemon=``; state shared with a daemon thread's
  entry point is written under its lock.
* **contract drift**: every ``SM_*`` / ``GRAFT_*`` knob, registry metric,
  fault point and supervision exit code the port uses is documented (in the
  JAX package's docs, which the port shares, or in the README's port
  tables), and every row of the port's own tables names something the port
  still has.
* **legacy gates**: no ``print`` outside the stdout-contract files, no bare
  ``except:``.

Run it from the repository root::

    python -m sagemaker_xgboost_container_tpu_torch.toolkit.graftlint \\
        [--format text|json] [--select r1,r2] [--stats] [paths...]

Exit 0 clean, 1 findings, 2 an unparseable file or an internal error.
Suppress one line with ``# graftlint: disable=<rule>[,<rule>] <reason>``;
the baseline (``baseline.json`` beside this file) keeps findings by rule,
path and line text, and is kept empty. Standard library only (``ast``,
``re``): the gate imports nothing of the code it checks.
"""

from .core import Finding, Project, run  # noqa: F401

__all__ = ["Finding", "Project", "run"]
