"""graftlint core: file model, suppressions, baseline, pass runner.

The analysis unit is a :class:`Project`: a repo root, the port's ``*.py``
files parsed once into ASTs, and the documents the contract pass reads.
Passes are stateless objects with a ``rules`` dict (rule id -> one-line
description) and ``run(project) -> [Finding]``; whatever crosses files (call
graphs, the contract inventories) each pass builds from ``project.files``.

Suppressions are per line, in the JAX package's syntax: ``# graftlint:
disable=<rule>[,<rule>] <reason>`` on the offending line, or on a
comment-only line directly above it. The reason is required: a suppression
without one still suppresses, and is reported as
``suppression-missing-reason``.

The baseline, inside the port's package (``DEFAULT_BASELINE``), keeps
findings by (rule, path, stripped source line): the line's text, not its
number, so that edits above a kept finding do not bring it back.

Documents: the port shares most of its knobs, metrics, fault points and exit
codes with the JAX package, whose curated docs (``SHARED_DOCS``, read, never
written) document them; the port's own knobs are the tables of the README's
port section (``PORT_SECTION``). A name is documented when either mentions
it; a table row is orphaned only in the port's own tables.
"""

import ast
import json
import os
import re

PACKAGE = "sagemaker_xgboost_container_tpu_torch"

# relative to the repo root
DEFAULT_BASELINE = PACKAGE + "/toolkit/graftlint/baseline.json"

#: the JAX package's curated docs: what they document, the port documents
#: too (they are read only; their tables are not the port's to keep)
SHARED_DOCS = (
    "docs/observability.md",
    "docs/robustness.md",
    "docs/DESIGN.md",
    "docs/MIGRATION.md",
    "docs/static-analysis.md",
)
#: the shared doc whose exit-code table the port's exit codes follow
SHARED_EXIT_DOC = "docs/robustness.md"

#: the port's own tables: this section of the README, from its heading to
#: the next heading of the same level (both directions of the contract)
PORT_SECTION = ("README.md", "## PyTorch/CUDA port")

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([a-z0-9*\-]+(?:\s*,\s*[a-z0-9*\-]+)*)\s*(.*)$"
)


class Finding(object):
    """One rule violation at a file:line."""

    __slots__ = ("rule", "path", "line", "message")

    def __init__(self, rule, path, line, message):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message

    def as_dict(self):
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }

    def __repr__(self):
        return "Finding({}:{} {})".format(self.path, self.line, self.rule)


class Suppression(object):
    __slots__ = ("rules", "reason", "line", "used")

    def __init__(self, rules, reason, line):
        self.rules = rules
        self.reason = reason
        self.line = line
        self.used = False

    def covers(self, rule):
        return "*" in self.rules or rule in self.rules


class SourceFile(object):
    """One parsed python file: AST + per-line suppressions."""

    def __init__(self, abspath, relpath, text):
        self.abspath = abspath
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.error = None
        try:
            self.tree = ast.parse(text, filename=relpath)
        except SyntaxError as e:
            self.tree = None
            self.error = "cannot parse {}: {}".format(relpath, e)
        # module dotted path (for import resolution), when under the package
        parts = relpath[:-3].replace(os.sep, "/").split("/")
        self.module = ".".join(parts)
        self._suppressions = self._parse_suppressions()

    def _parse_suppressions(self):
        by_line = {}
        pending = None  # suppression from a comment-only line -> next line
        for lineno, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            stripped = line.strip()
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                sup = Suppression(rules, m.group(2).strip(), lineno)
                by_line.setdefault(lineno, []).append(sup)
                if stripped.startswith("#"):
                    pending = sup  # applies to the next code line too
                continue
            if pending is not None and stripped and not stripped.startswith("#"):
                by_line.setdefault(lineno, []).append(pending)
                pending = None
        return by_line

    def suppression_for(self, line, rule):
        for sup in self._suppressions.get(line, ()):
            if sup.covers(rule):
                return sup
        return None

    def all_suppressions(self):
        seen = set()
        for sups in self._suppressions.values():
            for sup in sups:
                if id(sup) not in seen:
                    seen.add(id(sup))
                    yield sup

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


class DocFile(object):
    """A document, or the section of one the port keeps: ``lines`` start at
    the file's line ``first_line`` (1-based), so findings name file lines."""

    __slots__ = ("abspath", "relpath", "text", "lines", "first_line")

    def __init__(self, abspath, relpath, text, first_line=1):
        self.abspath = abspath
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.first_line = first_line


def read_section(abspath, relpath, heading):
    """The section of a markdown file under the first heading that starts
    with ``heading`` (to the next heading of its level) as a DocFile, or
    None where the file or the heading is missing."""
    if not os.path.isfile(abspath):
        return None
    with open(abspath, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    level = heading.split(" ", 1)[0]
    start = None
    for i, line in enumerate(lines):
        if start is None:
            if line.strip().startswith(heading):
                start = i
        elif line.startswith(level + " "):
            return DocFile(abspath, relpath, "\n".join(lines[start:i]), start + 1)
    if start is None:
        return None
    return DocFile(abspath, relpath, "\n".join(lines[start:]), start + 1)


class Project(object):
    """Repo root + parsed package sources + contract docs."""

    def __init__(self, root, paths=None):
        self.root = os.path.abspath(root)
        self.files = []
        self.errors = []
        for path in self._py_paths(paths):
            rel = os.path.relpath(path, self.root).replace(os.sep, "/")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    text = f.read()
            except OSError as e:
                self.errors.append("cannot read {}: {}".format(rel, e))
                continue
            sf = SourceFile(path, rel, text)
            if sf.error:
                self.errors.append(sf.error)
            self.files.append(sf)
        self.docs = []
        for rel in SHARED_DOCS:
            abspath = os.path.join(self.root, rel)
            if not os.path.isfile(abspath):
                continue
            with open(abspath, "r", encoding="utf-8") as f:
                self.docs.append(DocFile(abspath, rel, f.read()))
        rel, heading = PORT_SECTION
        self.port_doc = read_section(os.path.join(self.root, rel), rel, heading)
        if self.port_doc is not None:
            self.docs.append(self.port_doc)

    def _py_paths(self, paths):
        if not paths:
            pkg = os.path.join(self.root, PACKAGE)
            paths = [pkg if os.path.isdir(pkg) else self.root]
        out = []
        for p in paths:
            p = os.path.join(self.root, p) if not os.path.isabs(p) else p
            if os.path.isfile(p):
                out.append(p)
                continue
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                ]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        return out

    def _package_rel(self, rel):
        prefix = PACKAGE + "/"
        if rel.startswith(prefix):
            return rel[len(prefix):]
        # a fixture tree may hold the package one directory down
        idx = rel.find("/" + prefix)
        if idx >= 0:
            return rel[idx + 1 + len(prefix):]
        return rel

    def file_by_rel(self, relpath):
        for sf in self.files:
            if sf.relpath == relpath:
                return sf
        return None

    def doc_table_files(self):
        """The port's own tables (both directions of the contract)."""
        return [self.port_doc] if self.port_doc is not None else []

    def shared_exit_docs(self):
        """The shared doc whose exit-code table documents the port's codes."""
        return [d for d in self.docs if d.relpath == SHARED_EXIT_DOC]


class Report(object):
    def __init__(self):
        self.findings = []      # live findings (post suppression + baseline)
        self.baselined = []     # matched against the baseline file
        self.suppressed = []    # (finding, suppression) pairs
        self.errors = []

    def stats(self):
        counts = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return counts

    def all_stats(self):
        """Rule hit counts, suppressed and baselined findings included (the
        ``--stats`` view)."""
        counts = {}
        for f in self.findings:
            counts.setdefault(f.rule, [0, 0, 0])[0] += 1
        for f, _ in self.suppressed:
            counts.setdefault(f.rule, [0, 0, 0])[1] += 1
        for f in self.baselined:
            counts.setdefault(f.rule, [0, 0, 0])[2] += 1
        return counts


def _baseline_key(project, finding):
    sf = project.file_by_rel(finding.path)
    context = sf.line_text(finding.line) if sf is not None else ""
    return "{}|{}|{}".format(finding.rule, finding.path, context)


def load_baseline_entries(path):
    """The raw entry dicts (rule/path/context) of a baseline file."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("entries", []))


def load_baseline(path):
    entries = {}
    for entry in load_baseline_entries(path):
        key = "{}|{}|{}".format(
            entry.get("rule", ""), entry.get("path", ""), entry.get("context", "")
        )
        entries[key] = entries.get(key, 0) + 1
    return entries


def write_baseline(path, project, findings, comment=None, extra_entries=None):
    """Write ``findings`` (plus ``extra_entries`` dicts: the CLI's
    carry-over of entries a narrowed run could not match again) as the
    baseline at ``path``."""
    entries = []
    for f in findings:
        sf = project.file_by_rel(f.path)
        entries.append(
            {
                "rule": f.rule,
                "path": f.path,
                "context": sf.line_text(f.line) if sf is not None else "",
            }
        )
    entries.extend(extra_entries or ())
    entries.sort(
        key=lambda e: (e.get("path", ""), e.get("rule", ""), e.get("context", ""))
    )
    data = {
        "comment": comment
        or "graftlint findings kept in the port's baseline. Keep it empty: "
        "fix a finding or suppress it inline with a reason.",
        "entries": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def all_passes():
    from .passes import ALL_PASSES

    return [cls() for cls in ALL_PASSES]


def known_rules():
    rules = {"suppression-missing-reason": "a suppression comment lacks a reason string"}
    for p in all_passes():
        rules.update(p.rules)
    return rules


def run(
    root,
    paths=None,
    select=None,
    disable=None,
    baseline_path=None,
    use_baseline=True,
):
    """Run every (selected) pass over ``root`` -> :class:`Report`.

    ``select``/``disable`` are rule-id collections. ``baseline_path`` None
    means the checked-in default (when present).
    """
    project = Project(root, paths=paths)
    report = Report()
    report.errors.extend(project.errors)

    selected = set(select) if select else None
    disabled = set(disable) if disable else set()

    raw = []
    for p in all_passes():
        pass_rules = {
            r for r in p.rules
            if (selected is None or r in selected) and r not in disabled
        }
        if not pass_rules:
            continue
        try:
            for finding in p.run(project):
                if finding.rule in pass_rules:
                    raw.append(finding)
        except Exception as e:  # a broken pass fails the gate, it never passes it
            report.errors.append("pass {} crashed: {!r}".format(type(p).__name__, e))

    # 1. suppressions
    unsuppressed = []
    for f in raw:
        sf = project.file_by_rel(f.path)
        sup = sf.suppression_for(f.line, f.rule) if sf is not None else None
        if sup is not None:
            sup.used = True
            report.suppressed.append((f, sup))
        else:
            unsuppressed.append(f)

    # a suppression that fired without a reason is itself a finding
    meta_rule = "suppression-missing-reason"
    if (selected is None or meta_rule in selected) and meta_rule not in disabled:
        for sf in project.files:
            for sup in sf.all_suppressions():
                if sup.used and not sup.reason:
                    unsuppressed.append(
                        Finding(
                            meta_rule,
                            sf.relpath,
                            sup.line,
                            "suppression without a reason string — say why "
                            "this finding is intentionally kept",
                        )
                    )

    # 2. baseline
    baseline = {}
    if use_baseline:
        candidate = baseline_path or os.path.join(project.root, DEFAULT_BASELINE)
        if os.path.isfile(candidate):
            try:
                baseline = load_baseline(candidate)
            except (OSError, ValueError) as e:
                report.errors.append("cannot load baseline {}: {}".format(candidate, e))
    remaining = dict(baseline)
    for f in unsuppressed:
        key = _baseline_key(project, f)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            report.baselined.append(f)
        else:
            report.findings.append(f)

    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    report.project = project
    return report
