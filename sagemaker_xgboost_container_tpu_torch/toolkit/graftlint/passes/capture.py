"""Capture safety: what must never happen inside a region a CUDA graph records.

The port's counterpart of the JAX package's ``trace`` pass. There the
round program is a ``jax.jit`` closure; here it is the round body that
``models/round_graph.py`` captures once a session and replays every round.
A capture records the kernels the body enqueues, not its Python: a host
value read while capturing is baked into every replay, a host sync inside
the capture fails it (or, eagerly, serializes the round), and a graph
captured inside the body would be captured again every round.

**Roots.** ``CAPTURED_ROOTS`` in ``models/round_graph.py``: a tuple of
``"module:qualname"`` strings under the package (``models.booster:
_TrainingSession._round_body``). From them a name-based call graph follows
direct calls, ``self.method`` calls, imported names (absolute and
relative), module attribute calls and bare references to functions (a
function passed along may be called). Nested functions resolve through
their lexical scopes. The graph over-approximates on purpose: a function
that might run under capture is held to its rules. A tree without that
constant has no roots, and the pass finds nothing.

Rules, for every function reachable from a root:

* ``capture-env-read``: ``os.environ`` / ``os.getenv`` / ``env_int``-family
  reads. A knob is resolved once at session build and passed in (the
  ``GRAFT_HIST_COMM`` pattern); a read under capture is frozen into the
  graph. The ``env_int``-family definitions in an ``envconfig`` module are
  exempt: their call sites are the findings.
* ``capture-host-sync``: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize``),
  ``nonzero`` / ``unique`` / ``masked_select`` (their output's size is on
  the device), ``torch.tensor`` / ``torch.as_tensor`` / ``torch.from_numpy``
  (a copy from the host), ``np.asarray`` / ``np.array``, ``print``, and
  ``float()`` / ``int()`` / ``bool()`` of a root's own argument.
* ``capture-uncached-graph``: ``torch.cuda.CUDAGraph()``,
  ``torch.cuda.graph(...)`` or ``torch.cuda.make_graphed_callables(...)``
  inside a reachable function: a capture that the round itself begins runs
  again every round. A session captures once, outside its round body.
"""

import ast

from ..core import Finding, PACKAGE
from ..astutil import (
    ImportMap,
    dotted_name,
    iter_own_nodes,
    module_str_constants,
    str_const,
)

#: where the roots are named, relative to the package root, and the constant
ROOTS_FILE = "models/round_graph.py"
ROOTS_CONSTANT = "CAPTURED_ROOTS"

_WRAPPER_LEAVES = {"partial"}
_ENV_CALLS = {"os.getenv", "os.environ.get", "environ.get", "getenv"}
_ENVCONFIG_HELPERS = {"env_int", "env_float", "env_bool", "env_port"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SIZE_ON_DEVICE = {"nonzero", "unique", "masked_select"}
_HOST_COPIES = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
_NUMPY_SYNC_LEAVES = {"asarray", "array", "ascontiguousarray"}
_GRAPH_LEAVES = {"CUDAGraph", "graph", "make_graphed_callables"}


class FuncInfo(object):
    __slots__ = ("qual", "node", "sf", "parent", "class_name", "assigns", "own_defs",
                 "params")

    def __init__(self, qual, node, sf, parent, class_name):
        self.qual = qual
        self.node = node
        self.sf = sf
        self.parent = parent
        self.class_name = class_name
        self.assigns = {}
        self.own_defs = {}
        args = node.args
        self.params = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


class _ModuleIndex(object):
    def __init__(self, sf):
        self.sf = sf
        self.imports = ImportMap(sf.tree, sf.module)
        self.funcs = {}          # id(node) -> FuncInfo
        self.by_qual = {}        # qualname -> FuncInfo
        self.toplevel = {}       # name -> FuncInfo
        self.methods = {}        # (class, name) -> FuncInfo
        self.module_assigns = {}
        self.constants = module_str_constants(sf.tree)
        self._collect(sf.tree, parent=None, class_name=None, prefix="")
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    self.module_assigns.setdefault(t.id, []).append(node.value)

    def _collect(self, node, parent, class_name, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + child.name
                info = FuncInfo(qual, child, self.sf, parent, class_name)
                self.funcs[id(child)] = info
                self.by_qual.setdefault(qual, info)
                if parent is None and class_name is None:
                    self.toplevel[child.name] = info
                if class_name is not None and parent is None:
                    self.methods[(class_name, child.name)] = info
                if parent is not None:
                    parent.own_defs[child.name] = info
                self._collect(child, info, class_name, qual + ".")
                for n in iter_own_nodes(child):
                    if isinstance(n, ast.Assign):
                        for t in n.targets:
                            if isinstance(t, ast.Name):
                                info.assigns.setdefault(t.id, []).append(n.value)
            elif isinstance(child, ast.ClassDef):
                self._collect(child, None, child.name, prefix + child.name + ".")
            else:
                self._collect(child, parent, class_name, prefix)


def root_names(project):
    """The ``module:qualname`` strings of ``CAPTURED_ROOTS``, or []."""
    for sf in project.files:
        if sf.tree is None or project._package_rel(sf.relpath) != ROOTS_FILE:
            continue
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == ROOTS_CONSTANT
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                return [v for v in (str_const(e) for e in node.value.elts) if v]
    return []


class CaptureSafetyPass(object):
    rules = {
        "capture-env-read": "env knob read inside a function a CUDA graph captures",
        "capture-host-sync": "host sync inside a function a CUDA graph captures",
        "capture-uncached-graph": "a CUDA graph captured inside a captured function",
    }

    # ------------------------------------------------------------ resolution
    def _lookup(self, mod):
        """Module index of a dotted path, with or without the package
        prefix (module names follow the scan root)."""
        hit = self._indices.get(mod)
        if hit is not None:
            return hit
        prefix = PACKAGE + "."
        if mod.startswith(prefix):
            return self._indices.get(mod[len(prefix):])
        return self._indices.get(prefix + mod)

    def _resolve_name(self, name, info, index, _visited=None):
        if _visited is None:
            _visited = set()
        key = (id(info), id(index), name)
        if key in _visited:
            return []
        _visited.add(key)
        cur = info
        while cur is not None:
            if name in cur.own_defs:
                return [cur.own_defs[name]]
            if name in cur.assigns:
                out = []
                for expr in cur.assigns[name]:
                    out.extend(self._resolve_callable(expr, cur, index, 0, _visited))
                if out:
                    return out
            cur = cur.parent
        if name in index.toplevel:
            return [index.toplevel[name]]
        if name in index.module_assigns:
            out = []
            for expr in index.module_assigns[name]:
                out.extend(self._resolve_callable(expr, None, index, 0, _visited))
            if out:
                return out
        if name in index.imports.names:
            mod, orig = index.imports.names[name]
            target = self._lookup(mod)
            if target is not None and orig in target.toplevel:
                return [target.toplevel[orig]]
        return []

    def _resolve_attr(self, expr, info, index):
        """self.x / module.attr -> [FuncInfo]."""
        name = dotted_name(expr)
        if not name:
            return []
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2 and info is not None:
            cls, cur = info.class_name, info
            while cls is None and cur is not None:
                cls, cur = cur.class_name, cur.parent
            hit = index.methods.get((cls, parts[1]))
            return [hit] if hit else []
        if len(parts) == 2:
            base, attr = parts
            mod_path = None
            if base in index.imports.modules:
                mod_path = index.imports.modules[base]
            elif base in index.imports.names:
                src, orig = index.imports.names[base]
                mod_path = src + "." + orig
            if mod_path:
                target = self._lookup(mod_path)
                if target is not None and attr in target.toplevel:
                    return [target.toplevel[attr]]
        return []

    def _resolve_callable(self, expr, info, index, depth, _visited=None):
        if depth > 6:
            return []
        if isinstance(expr, ast.Name):
            return self._resolve_name(expr.id, info, index, _visited)
        if isinstance(expr, ast.Attribute):
            return self._resolve_attr(expr, info, index)
        if isinstance(expr, ast.IfExp):
            return (self._resolve_callable(expr.body, info, index, depth + 1, _visited)
                    + self._resolve_callable(expr.orelse, info, index, depth + 1, _visited))
        if isinstance(expr, ast.Call):
            leaf = (dotted_name(expr.func) or "").rsplit(".", 1)[-1]
            if leaf in _WRAPPER_LEAVES and expr.args:
                return self._resolve_callable(expr.args[0], info, index, depth + 1, _visited)
        if isinstance(expr, ast.Lambda):
            out = []
            for n in ast.walk(expr.body):
                if isinstance(n, ast.Name):
                    out.extend(self._resolve_name(n.id, info, index, _visited))
            return out
        return []

    # --------------------------------------------------------------- graph
    def _build(self, project):
        self._indices = {}
        for sf in project.files:
            if sf.tree is not None:
                self._indices[sf.module] = _ModuleIndex(sf)
        roots = set()
        for spec in root_names(project):
            mod, _, qual = spec.partition(":")
            index = self._lookup(mod)
            info = index.by_qual.get(qual) if index is not None else None
            if info is not None:
                roots.add(id(info.node))
        edges = {}
        for index in self._indices.values():
            for fid, info in index.funcs.items():
                targets = edges.setdefault(fid, set())
                for n in iter_own_nodes(info.node):
                    cands = []
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                        cands = self._resolve_name(n.id, info, index)
                    elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
                        cands = self._resolve_attr(n.func, info, index)
                    for cand in cands:
                        if id(cand.node) != fid:
                            targets.add(id(cand.node))
                # nested functions run where their parent runs them
                for child in info.own_defs.values():
                    targets.add(id(child.node))
        reachable = set(roots)
        frontier = list(roots)
        while frontier:
            for nxt in edges.get(frontier.pop(), ()):
                if nxt not in reachable:
                    reachable.add(nxt)
                    frontier.append(nxt)
        return roots, reachable

    # ----------------------------------------------------------------- run
    def run(self, project):
        roots, reachable = self._build(project)
        for index in self._indices.values():
            sf = index.sf
            numpy_aliases = {alias for alias, target in index.imports.modules.items()
                             if target == "numpy"}
            for fid, info in index.funcs.items():
                if fid not in reachable:
                    continue
                for finding in self._check(sf, info, index, fid in roots, numpy_aliases):
                    yield finding

    def _env_name_of(self, call, index):
        if call.args:
            lit = str_const(call.args[0])
            if lit:
                return lit
            if isinstance(call.args[0], ast.Name):
                return index.constants.get(call.args[0].id)
        return None

    def _check(self, sf, info, index, is_root, numpy_aliases):
        helper_def = (info.qual in _ENVCONFIG_HELPERS
                      and sf.module.rsplit(".", 1)[-1] == "envconfig")
        for n in iter_own_nodes(info.node):
            if isinstance(n, ast.Subscript) and not helper_def:
                base = dotted_name(n.value) or ""
                if base in ("os.environ", "environ"):
                    yield self._env_finding(sf, n, str_const(n.slice) or "<dynamic>", info)
                continue
            if not isinstance(n, ast.Call):
                continue
            callee = dotted_name(n.func) or ""
            leaf = callee.rsplit(".", 1)[-1]
            if callee in _ENV_CALLS or callee in _ENVCONFIG_HELPERS:
                if not helper_def:
                    yield self._env_finding(sf, n, self._env_name_of(n, index) or "<dynamic>",
                                            info)
                continue
            if leaf in _GRAPH_LEAVES and (callee.startswith("torch.cuda.")
                                          or callee == "CUDAGraph"):
                yield Finding(
                    "capture-uncached-graph", sf.relpath, n.lineno,
                    "{}() inside captured '{}': a graph captured by the round is "
                    "captured again every round; capture once a session, outside "
                    "the captured body".format(callee, info.qual))
                continue
            reason = None
            if isinstance(n.func, ast.Attribute) and (
                    (n.func.attr in _SYNC_METHODS and not n.args)
                    or n.func.attr in _SIZE_ON_DEVICE or n.func.attr == "synchronize"):
                if n.func.attr in _SIZE_ON_DEVICE:
                    reason = ".{}() sizes its output on the host".format(n.func.attr)
                else:
                    reason = ".{}() waits for the device".format(n.func.attr)
            elif callee in _HOST_COPIES:
                reason = "{} copies host data to the device".format(callee)
            elif leaf in _NUMPY_SYNC_LEAVES and "." in callee and (
                    callee.split(".")[0] in numpy_aliases):
                reason = "{} brings a device value to the host".format(callee)
            elif callee == "print":
                reason = "print() runs at capture only"
            elif (is_root and callee in ("float", "int", "bool") and len(n.args) == 1
                  and isinstance(n.args[0], ast.Name) and n.args[0].id in info.params):
                reason = "{}() of the captured argument '{}' reads it on the host".format(
                    callee, n.args[0].id)
            if reason:
                yield Finding(
                    "capture-host-sync", sf.relpath, n.lineno,
                    "{} inside captured '{}': keep the captured round on the "
                    "device".format(reason, info.qual))

    def _env_finding(self, sf, node, name, info):
        return Finding(
            "capture-env-read", sf.relpath, node.lineno,
            "env read ({}) inside captured '{}': a replay keeps the value read at "
            "capture; resolve the knob at session build and pass it in".format(
                name, info.qual))
