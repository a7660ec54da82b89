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


def tree_flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in tree order; a path holds the dict keys and
    sequence indices from the root (``jax.tree_util.tree_flatten_with_path``
    without the treedef)."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_flatten_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def keystr(path: tuple) -> str:
    """A path as ``jax.tree_util.keystr`` renders it: ``[0]['x']``."""
    return "".join(f"[{k!r}]" for k in path)
