"""Trees of tensors: nested dicts, lists and tuples, as the reference's
pytrees are.  Leaves are anything else (tensors, arrays, None)."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """Leaves in tree order (dicts in insertion order)."""
    out: list[Any] = []
    tree_map(out.append, tree)
    return out
