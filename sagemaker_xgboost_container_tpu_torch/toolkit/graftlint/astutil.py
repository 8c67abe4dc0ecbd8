"""Shared AST helpers: import maps, dotted names, module constants.

Resolution is by name, not by type: the analyzer never imports the code it
checks (a gate that ran the package could not check a tree that does not
import). Its heuristics would rather miss an exotic alias than flag a
working idiom.
"""

import ast


def dotted_name(node):
    """`a.b.c` attribute/name chain -> "a.b.c", else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call):
    """The dotted callee name of a Call node (None for e.g. ``f()()``)."""
    return dotted_name(call.func)


def str_const(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def int_const(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def keyword_arg(call, name):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def resolve_relative(module, target, level):
    """PEP 328 relative import: ``from <level dots><target> import ...``
    inside ``module`` -> absolute dotted module path."""
    if level == 0:
        return target or ""
    base = module.split(".")
    # one dot = the current package (strip the module leaf), each extra dot
    # strips one more package
    base = base[: len(base) - level]
    if target:
        base = base + target.split(".")
    return ".".join(base)


class ImportMap(object):
    """local name -> what it refers to.

    ``modules``: alias -> dotted module path (``import x.y as z``)
    ``names``:   alias -> (dotted module path, original name)
    """

    def __init__(self, tree, module):
        self.modules = {}
        self.names = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    self.modules[local] = target
            elif isinstance(node, ast.ImportFrom):
                src = resolve_relative(module, node.module, node.level)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.names[local] = (src, alias.name)


def module_str_constants(tree):
    """Top-level ``NAME = "literal"`` assignments -> {NAME: value}."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            value = str_const(node.value)
            if isinstance(target, ast.Name) and value is not None:
                out[target.id] = value
    return out


def module_int_constants(tree):
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            value = int_const(node.value)
            if isinstance(target, ast.Name) and value is not None:
                out[target.id] = value
    return out


def enclosing_map(tree):
    """node -> parent for every node in the tree."""
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def iter_own_nodes(func_node):
    """Walk a function's body WITHOUT descending into nested function /
    class definitions (their bodies belong to their own FuncInfo).
    Lambdas stay in: they run where the enclosing function runs."""
    stack = list(ast.iter_child_nodes(func_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def decorator_names(func_node):
    out = []
    for dec in func_node.decorator_list:
        name = dotted_name(dec if not isinstance(dec, ast.Call) else dec.func)
        if name:
            out.append(name)
        if isinstance(dec, ast.Call):
            # @partial(f, ...) / @functools.partial(f, ...)
            base = dotted_name(dec.func)
            if base in ("partial", "functools.partial") and dec.args:
                inner = dotted_name(dec.args[0])
                if inner:
                    out.append(inner)
    return out
