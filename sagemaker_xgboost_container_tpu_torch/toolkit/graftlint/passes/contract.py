"""Contract drift: the port's operational surface against its documents.

The port reads the JAX package's knobs, registers its metrics, arms its
fault points and exits with its codes, and adds knobs of its own. Both
directions are checked:

* ``contract-*-undocumented``: a name the port uses that no document
  mentions: neither the JAX package's curated docs (``core.SHARED_DOCS``,
  which document what the two packages share; they are read, never
  edited) nor the README's port section (``core.PORT_SECTION``).
* ``contract-*-orphaned``: a row of the port's own tables (the README's
  port section) naming something the port no longer has. The JAX package's
  tables are its own gate's to keep.

Inventories:

* **env knobs**: ``SM_*`` / ``GRAFT_*`` names read through ``os.environ`` /
  ``os.getenv`` / the ``envconfig`` helpers (a literal or a module-level
  constant). The SageMaker platform's names (constants in ``constants.py``
  whose value is their own name, such as ``SM_HOSTS``) are exempt.
* **metrics**: literal names passed to the registry's ``counter`` /
  ``gauge`` / ``histogram`` (the orphan direction matches any string
  literal of the package, so that table-driven loops count).
* **fault points**: literal first arguments of ``fault_point(...)``.
* **exit codes**: ``EXIT_*`` int constants in ``constants.py`` against the
  exit-code tables (the shared robustness doc's and the port's); the
  supervision range 79-99 in the orphan direction.

A tree without any of these documents skips the pass.
"""

import ast
import re

from ..core import Finding
from ..astutil import (
    dotted_name,
    module_int_constants,
    module_str_constants,
    str_const,
)

_ENV_PATTERN = re.compile(r"^(SM|GRAFT)_[A-Z0-9_]+$")
_METRIC_PATTERN = re.compile(r"^[a-z][a-z0-9_]*_[a-z0-9_]+$")
_FAULT_PATTERN = re.compile(r"^[a-z_]+\.[a-z_]+$")
_BACKTICK = re.compile(r"`([^`\s][^`]*)`")
_TABLE_CELL = re.compile(r"^\|\s*`([^`]+)`")
_ENV_READERS = {"os.getenv", "os.environ.get", "environ.get", "getenv",
                "os.environ.setdefault", "environ.setdefault"}
_ENVCONFIG_HELPERS = {"env_int", "env_float", "env_bool", "env_port"}
_REGISTRY_METHODS = {"counter", "gauge", "histogram"}


class ContractDriftPass(object):
    rules = {
        "contract-env-undocumented": "SM_*/GRAFT_* knob read in code but absent from the docs",
        "contract-env-orphaned": "a port table documents an env knob no code reads",
        "contract-metric-undocumented": "registry metric absent from the docs",
        "contract-metric-orphaned": "a port table documents a metric not in code",
        "contract-fault-undocumented": "fault point absent from the docs",
        "contract-fault-orphaned": "a port table documents a fault point not in code",
        "contract-exit-undocumented": "EXIT_* code absent from every exit-code table",
        "contract-exit-orphaned": "a port table's exit-code row with no EXIT_* constant",
    }

    def run(self, project):
        table_docs = project.doc_table_files()
        if not project.docs:
            return

        env_uses, metric_uses, fault_uses, exit_codes, platform_env, literals = \
            self._code_inventory(project)
        documented = self._documented_tokens(project)
        doc_env, doc_metrics, doc_faults, doc_exits = self._doc_tables(table_docs)
        known_exits = set(doc_exits) | set(
            self._doc_tables(project.shared_exit_docs())[3])

        # ---- code -> docs
        for name, (path, line) in sorted(env_uses.items()):
            if name in platform_env or not _ENV_PATTERN.match(name):
                continue
            if name not in documented:
                yield Finding(
                    "contract-env-undocumented", path, line,
                    "env knob {} is read here but documented nowhere: add a row to "
                    "a knob table of the README's port section".format(name),
                )
        for name, (path, line) in sorted(metric_uses.items()):
            if name not in documented:
                yield Finding(
                    "contract-metric-undocumented", path, line,
                    "metric {} is registered here but documented nowhere: add it to "
                    "the README's port section".format(name),
                )
        for name, (path, line) in sorted(fault_uses.items()):
            if name not in documented:
                yield Finding(
                    "contract-fault-undocumented", path, line,
                    "fault point {} is armed here but documented nowhere: add it to "
                    "the README's port section".format(name),
                )
        for name, (value, path, line) in sorted(exit_codes.items()):
            if value not in known_exits:
                yield Finding(
                    "contract-exit-undocumented", path, line,
                    "exit code {} ({}) is in no exit-code table".format(value, name),
                )

        # ---- the port's tables -> code
        code_exit_values = {v for v, _, _ in exit_codes.values()}
        for name, (path, line) in sorted(doc_env.items()):
            if name not in literals:
                yield Finding(
                    "contract-env-orphaned", path, line,
                    "documented env knob {} no longer appears anywhere in "
                    "the package: delete the row or restore the knob".format(name),
                )
        for name, (path, line) in sorted(doc_metrics.items()):
            if name not in literals:
                yield Finding(
                    "contract-metric-orphaned", path, line,
                    "documented metric {} no longer appears anywhere in the "
                    "package: delete the row or restore the metric".format(name),
                )
        for name, (path, line) in sorted(doc_faults.items()):
            if name not in fault_uses and name not in literals:
                yield Finding(
                    "contract-fault-orphaned", path, line,
                    "documented fault point {} has no fault_point() site in "
                    "the package".format(name),
                )
        for value, (path, line) in sorted(doc_exits.items()):
            if 79 <= value <= 99 and value not in code_exit_values:
                yield Finding(
                    "contract-exit-orphaned", path, line,
                    "documented exit code {} has no EXIT_* constant in "
                    "constants.py".format(value),
                )

    # ------------------------------------------------------- code inventory
    def _code_inventory(self, project):
        env_uses = {}
        metric_uses = {}
        fault_uses = {}
        exit_codes = {}
        platform_env = set()
        literals = set()

        for sf in project.files:
            if sf.tree is None:
                continue
            constants = module_str_constants(sf.tree)
            pkg_rel = project._package_rel(sf.relpath)
            if pkg_rel == "constants.py":
                for cname, value in constants.items():
                    if cname == value and _ENV_PATTERN.match(value):
                        platform_env.add(value)
                for cname, value in module_int_constants(sf.tree).items():
                    if cname.startswith("EXIT_"):
                        exit_codes[cname] = (value, sf.relpath, 1)

            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Constant) and isinstance(node.value, str):
                    literals.add(node.value)
                if not isinstance(node, ast.Call):
                    continue
                callee = dotted_name(node.func) or ""
                leaf = callee.rsplit(".", 1)[-1]
                first = self._first_str(node, constants)
                if callee in _ENV_READERS or callee in _ENVCONFIG_HELPERS:
                    if first and _ENV_PATTERN.match(first):
                        env_uses.setdefault(first, (sf.relpath, node.lineno))
                elif leaf in _REGISTRY_METHODS and isinstance(node.func, ast.Attribute):
                    if first and _METRIC_PATTERN.match(first):
                        metric_uses.setdefault(first, (sf.relpath, node.lineno))
                elif leaf == "fault_point":
                    if first and _FAULT_PATTERN.match(first):
                        fault_uses.setdefault(first, (sf.relpath, node.lineno))
            # os.environ["X"] subscripts
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Subscript):
                    base = dotted_name(node.value) or ""
                    if base in ("os.environ", "environ"):
                        key = str_const(node.slice)
                        if key is None and isinstance(node.slice, ast.Name):
                            key = constants.get(node.slice.id)
                        if key and _ENV_PATTERN.match(key):
                            env_uses.setdefault(key, (sf.relpath, node.lineno))
        return env_uses, metric_uses, fault_uses, exit_codes, platform_env, literals

    def _first_str(self, call, constants):
        if not call.args:
            return None
        lit = str_const(call.args[0])
        if lit is not None:
            return lit
        if isinstance(call.args[0], ast.Name):
            return constants.get(call.args[0].id)
        return None

    # -------------------------------------------------------- doc inventory
    def _documented_tokens(self, project):
        tokens = set()
        for doc in project.docs:
            for m in _BACKTICK.finditer(doc.text):
                tokens.add(self._normalize(m.group(1)))
            # env names also count when they appear in prose/code fences
            for m in re.finditer(r"\b(?:SM|GRAFT)_[A-Z0-9_]+\b", doc.text):
                tokens.add(m.group(0))
        return tokens

    def _normalize(self, token):
        token = token.strip()
        if "{" in token:
            token = token.split("{", 1)[0]
        return token.strip("`= ")

    def _doc_tables(self, table_docs):
        doc_env = {}
        doc_metrics = {}
        doc_faults = {}
        doc_exits = {}
        for doc in table_docs:
            for lineno, line in enumerate(doc.lines, start=doc.first_line):
                m = _TABLE_CELL.match(line.strip())
                if not m:
                    continue
                raw = m.group(1)
                name = self._normalize(raw)
                if _ENV_PATTERN.match(name):
                    doc_env.setdefault(name, (doc.relpath, lineno))
                elif _FAULT_PATTERN.match(name):
                    doc_faults.setdefault(name, (doc.relpath, lineno))
                elif name.isdigit():
                    doc_exits.setdefault(int(name), (doc.relpath, lineno))
                elif _METRIC_PATTERN.match(name):
                    doc_metrics.setdefault(name, (doc.relpath, lineno))
        return doc_env, doc_metrics, doc_faults, doc_exits
