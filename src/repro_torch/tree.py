"""Nested dictionaries, lists and tuples of tensors ("trees"), flattened in
the order ``jax.tree.flatten`` gives: dictionary keys sorted, lists and
tuples in order, ``None`` an empty subtree.

The port's parameter and optimizer trees keep the JAX package's layout, so
the clip scale, the checkpoint leaves (``leaf_<i>``) and the tests'
comparisons all see the leaves in the same order as the JAX side.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["tree_leaves", "tree_map", "tree_flatten", "tree_unflatten", "flatten_up_to",
           "tree_paths", "tree_map_with_path"]


def _walk(node: Any, leaves: List[Any]) -> Any:
    if isinstance(node, dict):
        return ("dict", [(key, _walk(node[key], leaves)) for key in sorted(node)])
    if isinstance(node, (list, tuple)):
        return (type(node), [_walk(val, leaves) for val in node])
    if node is None:
        return ("none", None)
    leaves.append(node)
    return ("leaf", None)


def _build(spec: Any, it: Iterator[Any]) -> Any:
    kind, children = spec
    if kind == "dict":
        return {key: _build(child, it) for key, child in children}
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    return kind(_build(child, it) for child in children)


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, structure)``; :func:`tree_unflatten` inverts it.  (The
    walk is a module-level function: a nested one that calls itself would
    be a reference cycle holding ``leaves``, so a step's gradients would
    live until the garbage collector ran.)"""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = _build(structure, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _up_to(spec: Any, node: Any, out: List[Any]) -> None:
    kind, children = spec
    if kind == "leaf":
        out.append(node)
    elif kind == "dict":
        for key, child in children:
            _up_to(child, node[key], out)
    elif kind != "none":
        for child, val in zip(children, node):
            _up_to(child, val, out)


def flatten_up_to(structure: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of ``structure`` (from
    :func:`tree_flatten`), in leaf order: ``treedef.flatten_up_to``.  An
    optimizer state that keeps a dictionary for each parameter is read
    leaf by leaf this way."""
    out: List[Any] = []
    _up_to(structure, tree, out)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which have the same structure."""
    leaves, structure = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("trees differ in structure")
    return tree_unflatten(structure, [fn(*args) for args in zip(leaves, *others)])


def _paths(node: Any, prefix: str, out: List[str]) -> None:
    if isinstance(node, dict):
        for key in sorted(node):
            _paths(node[key], f"{prefix}{key}/", out)
    elif isinstance(node, (list, tuple)):
        for i, val in enumerate(node):
            _paths(val, f"{prefix}{i}/", out)
    elif node is not None:
        out.append(prefix[:-1])


def tree_paths(tree: Any) -> List[str]:
    """The path of every leaf, in leaf order: dictionary keys and sequence
    indices joined by ``/`` (``"segments/0/attn/wq/w"``), the string the
    JAX package's sharding rules make of a ``jax.tree_util`` key path."""
    out: List[str] = []
    _paths(tree, "", out)
    return out


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` applied leaf by leaf, ``path`` as :func:`tree_paths`
    gives it."""
    leaves, structure = tree_flatten(tree)
    return tree_unflatten(structure, [fn(p, x) for p, x in zip(tree_paths(tree), leaves)])
