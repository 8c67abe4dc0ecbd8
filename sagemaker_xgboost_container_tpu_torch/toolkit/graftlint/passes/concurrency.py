"""Concurrency and I/O discipline, the JAX package's pass over the port.

The control planes (heartbeats, the rendezvous, abort frames, the batcher,
the elastic reform, the local ranks' relay) are daemon threads and small
TCP protocols. The rules:

* ``socket-unbounded``: ``recv`` / ``accept`` / ``connect`` run under a
  deadline: a ``settimeout`` / ``setblocking`` in the same function, a
  ``create_connection(..., timeout=...)``, or, for a ``self._sock``-style
  member, a ``settimeout`` on that member anywhere in the class. A peer that
  connects and then sends one byte a timeout must never hold a reader.
* ``thread-daemon-missing``: every ``threading.Thread(...)`` states
  ``daemon=`` on its call. A thread that is silently not a daemon keeps the
  process alive past a supervision exit, and the exit code is lost.
* ``shared-state-unlocked``: instance attributes touched from a daemon
  thread's entry point (``Thread(target=self._run)``) and from other
  methods are written under a ``with <lock>`` (a name holding lock, cond or
  mutex). ``__init__`` is exempt. A helper that writes while its caller
  holds the lock takes an inline suppression naming that caller.
"""

import ast

from ..core import Finding
from ..astutil import dotted_name, keyword_arg

_RECV_METHODS = {"recv", "recv_into", "recvfrom", "recvfrom_into", "accept", "connect"}
_LOCKISH = ("lock", "cond", "mutex")


def _is_thread_ctor(call, import_map):
    name = dotted_name(call.func)
    if name == "threading.Thread":
        return True
    if name == "Thread" and import_map.names.get("Thread", ("", ""))[0] == "threading":
        return True
    return False


def _lockish_name(expr):
    name = dotted_name(expr) or ""
    leaf = name.rsplit(".", 1)[-1].lower()
    return any(token in leaf for token in _LOCKISH)


def _under_lock(node, parents):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    expr = expr.func
                if _lockish_name(expr):
                    return True
        cur = parents.get(cur)
    return False


def _self_attr(expr):
    """self.X (possibly through subscripts: self.X[...] ) -> "X"."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


class _FuncCtx(object):
    __slots__ = ("node", "class_node", "parents")

    def __init__(self, node, class_node, parents):
        self.node = node
        self.class_node = class_node
        self.parents = parents


class ConcurrencyPass(object):
    rules = {
        "socket-unbounded": "socket recv/accept/connect without a timeout in scope",
        "thread-daemon-missing": "threading.Thread without an explicit daemon=",
        "shared-state-unlocked": "write to daemon-thread-shared state outside its lock",
    }

    def run(self, project):
        from ..astutil import ImportMap, enclosing_map

        for sf in project.files:
            if sf.tree is None:
                continue
            import_map = ImportMap(sf.tree, sf.module)
            parents = enclosing_map(sf.tree)

            for finding in self._check_threads(sf, import_map):
                yield finding
            for finding in self._check_sockets(sf, import_map, parents):
                yield finding
            for finding in self._check_shared_state(sf, import_map, parents):
                yield finding

    # ------------------------------------------------------------- threads
    def _check_threads(self, sf, import_map):
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and _is_thread_ctor(node, import_map):
                if keyword_arg(node, "daemon") is None:
                    yield Finding(
                        "thread-daemon-missing",
                        sf.relpath,
                        node.lineno,
                        "threading.Thread without explicit daemon=: a thread "
                        "that is not a daemon by accident outlives the "
                        "supervision exits",
                    )

    # ------------------------------------------------------------- sockets
    def _enclosing_func(self, node, parents):
        cur = parents.get(node)
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            cur = parents.get(cur)
        return cur

    def _enclosing_class(self, node, parents):
        cur = parents.get(node)
        while cur is not None and not isinstance(cur, ast.ClassDef):
            cur = parents.get(cur)
        return cur

    def _has_timeout_evidence(self, func_node):
        for node in ast.walk(func_node):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("settimeout", "setblocking", "setdefaulttimeout"):
                return True
            if leaf == "create_connection" and (
                keyword_arg(node, "timeout") is not None or len(node.args) >= 2
            ):
                return True
        return False

    def _class_sets_timeout_on(self, class_node, attr):
        target = "self.{}.settimeout".format(attr)
        for node in ast.walk(class_node):
            if isinstance(node, ast.Call) and dotted_name(node.func) == target:
                return True
        return False

    def _check_sockets(self, sf, import_map, parents):
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute
            ):
                continue
            if node.func.attr not in _RECV_METHODS:
                continue
            receiver = node.func.value
            # module-level functions named connect/... (sqlite3.connect) are
            # not sockets
            if isinstance(receiver, ast.Name) and receiver.id in import_map.modules:
                continue
            func = self._enclosing_func(node, parents)
            if func is None:
                continue
            if self._has_timeout_evidence(func):
                continue
            attr = _self_attr(receiver)
            if attr is not None:
                cls = self._enclosing_class(node, parents)
                if cls is not None and self._class_sets_timeout_on(cls, attr):
                    continue
            yield Finding(
                "socket-unbounded",
                sf.relpath,
                node.lineno,
                "socket .{}() with no timeout in scope: use "
                "recv_message_bounded / settimeout / create_connection("
                "timeout=...) so that a trickling peer cannot wedge this "
                "reader".format(node.func.attr),
            )

    # -------------------------------------------------------- shared state
    def _check_shared_state(self, sf, import_map, parents):
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name: n
                for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            if not methods:
                continue
            # nested defs inside methods, addressable as "method.inner"
            nested = {}
            for mname, mnode in methods.items():
                for inner in ast.walk(mnode):
                    if inner is not mnode and isinstance(
                        inner, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        nested["{}.{}".format(mname, inner.name)] = inner

            entries = self._thread_entries(cls, methods, nested, import_map, parents)
            if not entries:
                continue

            # intra-class reachability from the thread entrypoints
            def callees(fnode):
                out = set()
                for n in ast.walk(fnode):
                    if isinstance(n, ast.Call):
                        name = dotted_name(n.func) or ""
                        if name.startswith("self.") and name.count(".") == 1:
                            out.add(name.split(".", 1)[1])
                return out

            reach = set(entries)
            frontier = list(entries)
            while frontier:
                cur = frontier.pop()
                fnode = methods.get(cur) or nested.get(cur)
                if fnode is None:
                    continue
                for callee in callees(fnode):
                    if callee in methods and callee not in reach:
                        reach.add(callee)
                        frontier.append(callee)

            def touches(fnode):
                out = set()
                for n in ast.walk(fnode):
                    attr = _self_attr(n) if isinstance(n, (ast.Attribute, ast.Subscript)) else None
                    if attr:
                        out.add(attr)
                return out

            def resolve(name):
                return methods.get(name) or nested.get(name)

            entry_touched = set()
            for name in reach:
                fnode = resolve(name)
                if fnode is not None:
                    entry_touched |= touches(fnode)
            # nested entry functions live inside a method body; their touches
            # are already counted via the enclosing method only if reachable —
            # make sure the nested nodes themselves are included
            for name in entries:
                fnode = resolve(name)
                if fnode is not None:
                    entry_touched |= touches(fnode)

            outside_touched = set()
            for mname, mnode in methods.items():
                if mname in reach or mname == "__init__":
                    continue
                outside_touched |= touches(mnode)
            shared = entry_touched & outside_touched
            if not shared:
                continue

            for mname, mnode in list(methods.items()) + list(nested.items()):
                if mname == "__init__":
                    continue
                for n in ast.walk(mnode):
                    targets = []
                    if isinstance(n, ast.Assign):
                        targets = n.targets
                    elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                        targets = [n.target]
                    for t in targets:
                        elts = t.elts if isinstance(t, ast.Tuple) else [t]
                        for elt in elts:
                            attr = _self_attr(elt)
                            if attr in shared and not _under_lock(elt, parents):
                                yield Finding(
                                    "shared-state-unlocked",
                                    sf.relpath,
                                    n.lineno,
                                    "write to self.{} outside a lock: it is "
                                    "shared with the daemon-thread entrypoint "
                                    "({}); hold the owning lock in a with "
                                    "block (or suppress naming the caller "
                                    "that holds it)".format(
                                        attr, "/".join(sorted(entries))
                                    ),
                                )

    def _thread_entries(self, cls, methods, nested, import_map, parents):
        entries = set()
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Call) and _is_thread_ctor(node, import_map)):
                continue
            target = keyword_arg(node, "target")
            if target is None:
                continue
            name = dotted_name(target)
            if not name:
                continue
            if name.startswith("self.") and name.count(".") == 1:
                mname = name.split(".", 1)[1]
                if mname in methods:
                    entries.add(mname)
            else:
                # a nested function defined in the same method
                owner = self._enclosing_func(node, parents)
                if owner is not None:
                    qual = "{}.{}".format(owner.name, name)
                    if qual in nested:
                        entries.add(qual)
        return entries
