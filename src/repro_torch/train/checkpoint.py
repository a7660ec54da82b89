"""Atomic, step-tagged checkpoints of a tree of tensors.

The port of ``repro.train.checkpoint``, in its layout, so that each package
restores the other's checkpoints:

    <dir>/step_<n>/
        index.json      step, leaf paths, shapes, dtypes, leaf count
        a_<i>.npy       one file per leaf, gathered on the host
    <dir>/LATEST        the newest complete step

- **Atomic**: a step is written to ``step_<n>.tmp`` and renamed;
  ``LATEST`` is updated last, so a crash mid-save never corrupts the
  restore point (``_fail_after_files`` injects one), and ``latest_step``
  falls back to the newest complete step.
- **The reference's leaf order**: leaves are numbered in JAX's flatten
  order, which sorts dict keys (``tree_leaves`` walks dicts in insertion
  order), and ``paths`` holds JAX's ``keystr`` of each leaf
  (``['opt']['mu']['embed']['table']['m']``, ``[0]`` for a list item).
- **bf16**: the reference's ``np.save`` writes a bfloat16 leaf as two raw
  bytes an element (``'<V2'``, numpy has no bf16); the port reads and
  writes the same bytes, without ``ml_dtypes``.
- ``restore`` fills a template and puts each leaf on ``device``.  With
  ``shardings=`` (the reference's elastic remesh) it cuts each leaf for
  one rank of a mesh on the host before moving the cut there: a
  checkpoint written on one mesh restores onto any other, since leaves are
  stored whole.  A ``SKIP`` spec checks a leaf against the index and
  loads nothing, so a rank that wants the parameters of a ``Trainer``
  checkpoint never reads its moments.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.backend import registry

_BF16 = np.dtype("V2")

#: a spec of ``restore(shardings=)``, in place of a leaf's or a subtree's:
#: check the leaves' paths, shapes and dtypes against the index, load
#: nothing, and give None for each
SKIP = "skip"


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) in JAX's flatten order; None is no leaf."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _flatten(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(tree)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor, copy: bool) -> np.ndarray:
    """``t`` on the host; ``copy`` also copies a CPU tensor's storage."""
    t = t.detach().cpu()
    arr = (t.view(torch.int16).numpy().view(_BF16) if t.dtype == torch.bfloat16
           else t.numpy())
    return arr.copy() if copy else arr


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _host_tree(tree, copy: bool = False):
    """(path, (numpy array, dtype name)) of every leaf, on the host."""
    return [(path, (_to_numpy(x, copy), _dtype_name(x)) if isinstance(x, torch.Tensor)
             else (np.array(x), str(np.asarray(x).dtype)))
            for path, x in _flatten(tree)]


def _write(ckpt_dir, step: int, host, fail_after: int | None) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    index = {"step": step, "paths": [p for p, _ in host],
             "shapes": [list(a.shape) for _, (a, _) in host],
             "dtypes": [d for _, (_, d) in host], "n_leaves": len(host)}
    for i, (_, (arr, _)) in enumerate(host):
        if fail_after is not None and i >= fail_after:
            raise RuntimeError("injected checkpoint failure")
        np.save(tmp / f"a_{i}.npy", arr)
    (tmp / "index.json").write_text(json.dumps(index))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic on POSIX
    (ckpt_dir / "LATEST.tmp").write_text(str(step))
    (ckpt_dir / "LATEST.tmp").rename(ckpt_dir / "LATEST")
    return final


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any,
         *, _fail_after_files: int | None = None) -> pathlib.Path:
    """Write one checkpoint of ``tree`` (tensors, numpy arrays or scalars
    in dicts and lists).  ``_fail_after_files`` injects a mid-write crash
    (fault-tolerance tests only)."""
    return _write(ckpt_dir, step, _host_tree(tree), _fail_after_files)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    """The step ``LATEST`` names or, if that save is incomplete, the newest
    complete one; None without any."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    p = ckpt_dir / "LATEST"
    if not p.exists():
        return None
    step = int(p.read_text().strip())
    if not (ckpt_dir / f"step_{step:08d}" / "index.json").exists():
        steps = sorted(int(d.name.split("_")[1]) for d in ckpt_dir.glob("step_*")
                       if (d / "index.json").exists())
        return steps[-1] if steps else None
    return step


def _leaf_specs(template, shardings) -> list:
    """The spec of each leaf of ``template`` in ``_flatten``'s order, read
    from ``shardings`` at the same place; None or ``SKIP`` in place of a
    subtree is that for each of its leaves."""
    whole = shardings is None or (isinstance(shardings, str) and shardings == SKIP)
    if isinstance(template, dict):
        return [s for k in sorted(template)
                for s in _leaf_specs(template[k], shardings if whole else shardings[k])]
    if isinstance(template, (list, tuple)):
        return [s for i, v in enumerate(template)
                for s in _leaf_specs(v, shardings if whole else shardings[i])]
    return [] if template is None else [shardings]


def restore(ckpt_dir: str | os.PathLike, template: Any, step: int | None = None,
            device=None, shardings: Any = None, rank: int = 0,
            mesh=None) -> tuple[Any, int]:
    """Restore into the structure of ``template`` (its leaves give the
    shapes and dtypes the checkpoint must have; ``meta`` tensors will do);
    each leaf a tensor on ``device`` (None = ``"cuda"``).  Returns (tree,
    step).

    ``shardings`` (the elastic remesh) is a tree of the port's plain-tuple
    specs matched to ``template`` (``sharding_rules.param_shardings``
    gives one): each leaf is checked whole, cut on the host for ``rank`` of
    ``mesh`` by ``sharding_rules.shard_leaf`` (which records ``tp_dim``
    and refuses a cut along any axis but ``model``), then moved to
    ``device``.  A None spec, or None in place of a subtree, leaves those
    leaves whole on the host, as the reference leaves a leaf without a
    sharding a host array.  A ``SKIP`` spec (or subtree) checks those
    leaves' shapes and dtypes against the index, reads no file of theirs
    and gives None in their place."""
    dev = registry.resolve_device(device)
    if shardings is not None and mesh is None:
        raise ValueError("restore(shardings=) needs the mesh the specs name (mesh=)")
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    index = json.loads((d / "index.json").read_text())
    leaves = _flatten(template)
    if len(leaves) != index["n_leaves"]:
        raise ValueError(f"leaf count mismatch: template {len(leaves)} vs "
                         f"checkpoint {index['n_leaves']}")
    paths = [p for p, _ in leaves]
    if paths != index["paths"]:
        bad = next(i for i, (a, b) in enumerate(zip(paths, index["paths"])) if a != b)
        raise ValueError(f"leaf {bad}: template path {paths[bad]}, checkpoint "
                         f"{index['paths'][bad]}")
    specs = None if shardings is None else _leaf_specs(template, shardings)
    out = []
    for i, (path, tmpl) in enumerate(leaves):
        if specs is not None and isinstance(specs[i], str) and specs[i] == SKIP:
            shape, dtype = tuple(index["shapes"][i]), index["dtypes"][i]
            if shape != tuple(tmpl.shape) or dtype != _dtype_name(tmpl):
                raise ValueError(f"leaf {i} {path}: checkpoint {shape} {dtype}, "
                                 f"template {tuple(tmpl.shape)} {tmpl.dtype}")
            out.append(None)
            continue
        arr = np.load(d / f"a_{i}.npy")
        t = _from_numpy(arr, index["dtypes"][i])
        if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
            raise ValueError(f"leaf {i} {path}: checkpoint {tuple(t.shape)} "
                             f"{t.dtype}, template {tuple(tmpl.shape)} {tmpl.dtype}")
        if specs is None:
            out.append(t.to(dev))
        elif specs[i] is None:
            out.append(t)
        else:
            out.append(_cut_to(t, specs[i], rank, mesh, dev))
    return _unflatten(template, out), step


def _cut_to(t: torch.Tensor, spec: tuple, rank: int, mesh, dev) -> torch.Tensor:
    """Rank ``rank``'s cut of the whole host leaf ``t`` on ``dev``, its cut
    dim (``tp_dim``) kept."""
    from repro_torch.distributed import sharding_rules as sr

    part = sr.shard_leaf(t, tuple(spec), rank, mesh)
    out = part.to(dev)
    if hasattr(part, "tp_dim"):
        out.tp_dim = part.tp_dim
    return out


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight).  The tree
    is copied to the host before the writer thread starts, so the caller
    may update its tensors in place at once."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None

    def save(self, step: int, tree) -> None:
        self.wait()
        host = _host_tree(tree, copy=True)

        def run():
            try:
                _write(self.ckpt_dir, step, host, None)
            except BaseException as e:  # raised by the next wait()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
