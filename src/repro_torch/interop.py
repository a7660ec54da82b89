"""Carry the reference's constants into the port.

``from_reference`` turns a constants tree of the JAX package, given as
numpy arrays (``{"params": ..., "books": {"books", "shifts", "roles"}}``
for NVSA), into the port's tensors on a device.  It is exact: it converts
dtype and layout only.  The one layout change is the conv weight: a 4-D
leaf under the key ``"w"`` is an HWIO kernel and becomes OIHW.  Other 4-D
leaves (LVRF's rule codebook, (A, R, B, d); an LM's stacked ``wq`` / ``wk``
/ ``wv`` / ``wo``) keep their layout, and an LM's stacked dense ``w`` leaves
are 3-D, so LM trees carry over with their dtype the only change.

``save_npz`` / ``load_npz`` keep such a tree in one ``.npz`` file, its
leaves under ``/``-joined keys (``books/books/0``; an all-digit part is a
list index), so that a script without JAX (``chip_smoke.py``) can read
constants the reference drew.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_map


def _leaf(x, device: torch.device, conv: bool):
    if x is None:
        return None
    t = torch.from_numpy(np.array(x, copy=True))
    if conv and t.dim() == 4:  # HWIO -> OIHW
        t = t.permute(3, 2, 0, 1).contiguous()
    return t.to(device)


def _convert(tree, device: torch.device, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    return _leaf(tree, device, conv=key == "w")


def from_reference(tree, device=None):
    """Reference constants (numpy leaves, lists and dicts) -> port tensors
    on ``device`` (None = ``"cuda"``)."""
    return _convert(tree, registry.resolve_device(device))


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def save_npz(path, tree) -> None:
    """Write a tree of arrays (dicts, lists, numpy or tensor leaves; None
    leaves are dropped) to ``path`` under ``/``-joined keys."""
    flat = _flatten(tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else x, tree), "", {})
    np.savez(path, **flat)


def load_npz(path) -> dict:
    """The tree ``save_npz`` wrote, with numpy leaves (pass it to
    ``from_reference`` for tensors on a device)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = root
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return _lists(root)


def to_device(tree, device=None):
    """Move a tree of port tensors to ``device`` (None = ``"cuda"``);
    non-tensor leaves pass through."""
    dev = registry.resolve_device(device)
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x,
                    tree)
