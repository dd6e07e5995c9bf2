"""Small AST helpers shared by the lint rules."""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

__all__ = [
    "dotted_name",
    "call_name",
    "walk_functions",
    "names_in",
    "keyword_names",
]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted name of the callee, e.g. ``np.random.rand``."""
    return dotted_name(call.func)


def walk_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node  # type: ignore[misc]


def names_in(node: ast.AST) -> Set[str]:
    """All Name identifiers referenced anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def keyword_names(call: ast.Call) -> Tuple[Tuple[str, ast.keyword], ...]:
    """(name, keyword) pairs for explicit keywords (skips ``**splat``)."""
    return tuple((kw.arg, kw) for kw in call.keywords if kw.arg is not None)


def has_kwsplat(call: ast.Call) -> bool:
    return any(kw.arg is None for kw in call.keywords)


def param_names(fn: ast.FunctionDef) -> Tuple[str, ...]:
    a = fn.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return tuple(params)
