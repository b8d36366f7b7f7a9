"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, as the
training path holds params, gradients and optimizer state.

They are walked in the reference's order (dict keys sorted, as jax
flattens a dict), and :func:`leaves_with_paths` writes each leaf's path
as jax's ``tree_flatten_with_path`` keys print (``['params']/[0]/.m``),
so that a checkpoint names its leaves as the reference's does.  ``None``
and ``()`` hold no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a node in order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    if tree is None:
        return []
    return None


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf with its path, in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += leaves_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), as a tree of ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(tree, values: List[Any]):
    """``tree``'s structure with its leaves replaced, in the order of
    :func:`leaves`, by ``values``."""
    it = iter(values)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(c) for _, c in kids))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for _, c in kids)
        return None

    out = build(tree)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more values than leaves")
    return out
