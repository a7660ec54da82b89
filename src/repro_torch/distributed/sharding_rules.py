"""Logical-axis -> mesh-axis sharding rules (TP / FSDP / EP / SP).

The port of ``repro.distributed.sharding_rules``, with its rules and its
decisions: every parameter spec carries logical axis names
(``repro_torch.nn.init.P``), and these rules map them onto a mesh's axes.
Megatron-style TP over ``model`` with optional FSDP of the remaining dim
over ``data``, experts EP-sharded over ``model``.

The reference returns ``PartitionSpec`` / ``NamedSharding`` trees that
GSPMD places.  Here a spec is a plain tuple, one mesh axis (or a tuple of
axes, or None) per dim, trailing Nones dropped, as ``PartitionSpec``
prints; ``param_shardings`` maps it over a spec tree.  The cut itself is
``cut_leaf`` (``param_shards`` over a tree): each rank of a ``(data=1,
model=tp)`` world keeps its slice of every leaf, and the layers
(``distributed.constraints``) read where each leaf was cut.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.common.tree import tree_map
from repro_torch.launch.mesh import Mesh
from repro_torch.nn.init import P

# logical axis -> mesh axis (None = replicate)
TP_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "experts": "model",
    "heads_flat": "model",
    "conv_out": None,
    "conv_in": None,
    "embed": None,
    "embed2": None,
    "qlora": None,
    "kvlora": None,
    "hd": None,
    "layers": None,
}

FSDP_RULES = dict(TP_RULES, embed="data")


def _axis_size(mesh: Mesh, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _divisible(dim: int, mesh: Mesh, axis) -> bool:
    if axis is None:
        return False
    size = _axis_size(mesh, axis)
    return dim % size == 0 and dim >= size


#: logical axes eligible as a TP fallback when the preferred axis does not
#: divide the mesh (e.g. llama's 24 heads on a 16-way model axis -> shard
#: the embed dim instead: row-parallel with a reduce the block already pays).
FALLBACK_TP_AXES = ("embed", "mlp", "heads_flat", "embed2", "qlora", "kvlora",
                    "hd", "vocab")

_MIN_SHARD_ELEMS = 1 << 20  # don't bother re-sharding small tensors


@functools.lru_cache(maxsize=4096)
def _spec(axes: tuple, shape: tuple, mesh: Mesh, rules_items: tuple,
          min_shard_elems: int) -> tuple:
    rules = dict(rules_items)
    assigned: list = []
    used = set()
    for ax_name, dim in zip(axes, shape):
        mesh_axis = rules.get(ax_name)
        if mesh_axis is not None and mesh_axis not in used and \
                _divisible(dim, mesh, mesh_axis):
            assigned.append(mesh_axis)
            used.add(mesh_axis)
        else:
            assigned.append(None)
    if "model" not in used and math.prod(shape) >= min_shard_elems:
        for i, (ax_name, dim) in enumerate(zip(axes, shape)):
            if assigned[i] is None and ax_name in FALLBACK_TP_AXES and \
                    _divisible(dim, mesh, "model"):
                assigned[i] = "model"
                break
    while assigned and assigned[-1] is None:
        assigned.pop()
    return tuple(assigned)


def spec_to_pspec(axes: tuple, shape: tuple, mesh: Mesh, rules: dict,
                  min_shard_elems: int | None = None) -> tuple:
    """The spec of one leaf, dropping assignments that do not divide; if
    the preferred TP axis does not divide, fall back to another large dim.

    ``min_shard_elems`` gates only the *fallback* (preferred-axis sharding
    has no size floor): tensors smaller than it stay replicated rather
    than re-sharded over a non-preferred axis.  None = the production
    default; serving-path callers pass 0 so smoke-scale params still
    exercise the FALLBACK_TP_AXES path."""
    if min_shard_elems is None:
        min_shard_elems = _MIN_SHARD_ELEMS
    return _spec(tuple(axes), tuple(shape), mesh, tuple(rules.items()),
                 int(min_shard_elems))


def param_shardings(spec_tree, mesh: Mesh, fsdp: bool = False,
                    min_shard_elems: int | None = None):
    """Spec tree -> tree of specs (same structure).

    ``min_shard_elems`` forwards to :func:`spec_to_pspec` (the fallback
    re-shard size floor; None = production default)."""
    rules = FSDP_RULES if fsdp else TP_RULES
    return tree_map(lambda p: spec_to_pspec(p.axes, p.shape, mesh, rules,
                                            min_shard_elems), spec_tree)


def data_axes(mesh: Mesh) -> tuple:
    """Mesh axes that carry the batch dimension (pod folds into data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def cache_pspec(shape: tuple, mesh: Mesh, kv_axis: int | None = None,
                seq_axis: int | None = None, batch_axis: int = 0) -> tuple:
    """KV-cache sharding policy (SP):

    - batch over the data axes when divisible,
    - kv-heads over ``model`` when divisible, else the *sequence* dim over
      ``model`` (sequence parallelism — the long_500k/batch-1 case),
    - otherwise replicate.

    The port executes the batch and kv-head arms; a tensor-parallel world
    keeps the kv heads its query heads read where the kv heads do not
    divide (``nn/attention.py``), and sequence-sharded caches wait (ROADMAP
    Queue 1 #6 item 6)."""
    spec: list = [None] * len(shape)
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes)
    if shape[batch_axis] % dsize == 0 and shape[batch_axis] >= dsize:
        # one axis stands alone, as PartitionSpec canonicalises it
        spec[batch_axis] = daxes if len(daxes) > 1 else daxes[0]
    msize = mesh.shape["model"]
    if kv_axis is not None and shape[kv_axis] % msize == 0 and shape[kv_axis] >= msize:
        spec[kv_axis] = "model"
    elif seq_axis is not None and shape[seq_axis] % msize == 0:
        spec[seq_axis] = "model"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def tree_cache_shardings(shapes_tree, mesh: Mesh):
    """Heuristic cache sharding: identify (B, S, KV, hd) / (B, S, r) /
    (B, H, hd, hd) / stacked (L, ...) variants by rank and shard per
    policy.  ``shapes_tree`` holds tensors (``meta`` ones do)."""

    def one(s):
        shape = tuple(s.shape)
        off = 0
        # stacked layer dim heuristic: leading dim small & others large
        if len(shape) >= 4 and shape[0] <= 128 and shape[1] <= 4096:
            off = 1
        rank = len(shape) - off
        if rank == 4:   # (B, S, KV, hd)
            return cache_pspec(shape, mesh, kv_axis=off + 2, seq_axis=off + 1,
                               batch_axis=off)
        if rank == 3:   # (B, S, r) MLA or (B, H, hd*) partial
            return cache_pspec(shape, mesh, kv_axis=None, seq_axis=off + 1,
                               batch_axis=off)
        return cache_pspec(shape, mesh, batch_axis=off)

    return tree_map(one, shapes_tree)


# ---------------------------------------------------------------------------
# the cut: each rank's local tensors
# ---------------------------------------------------------------------------


def model_coord(rank: int, mesh: Mesh) -> int:
    """The rank's index along the ``model`` axis (ranks run model-fastest)."""
    return rank % mesh.shape["model"]


def shard_leaf(t: torch.Tensor, spec: tuple, rank: int, mesh: Mesh) -> torch.Tensor:
    """Rank ``rank``'s slice of the whole leaf ``t`` under ``spec``: a copy
    (the whole leaf can be freed), with the cut dim recorded on it as
    ``tp_dim`` (absent for a replicated leaf), which the layers read.  Only
    the ``model`` axis cuts: a world's ``data`` axis has size 1."""
    if any(a not in (None, "model") and _axis_size(mesh, a) > 1 for a in spec):
        raise NotImplementedError(
            f"spec {spec}: only the model axis is cut (data-parallel shards of "
            "a leaf wait for ROADMAP Queue 1 #6 item 8)")
    if "model" not in spec:
        return t
    dim = spec.index("model")
    n = t.shape[dim] // mesh.shape["model"]
    out = t.narrow(dim, model_coord(rank, mesh) * n, n).clone()
    out.tp_dim = dim
    return out


def world_pspec(p: P, mesh: Mesh) -> tuple:
    """The spec a tensor-parallel world cuts leaf ``p`` by: the TP rules
    with no size floor, as ``lm_engine(tp=)`` binds them (smoke-scale
    leaves take the fallback too).  The one place that decides a cut:
    ``cut_leaf`` cuts by it and ``cut_dim`` reads it."""
    return spec_to_pspec(p.axes, p.shape, mesh, TP_RULES, 0)


def cut_dim(p: P, mesh: Mesh) -> int | None:
    """The dim a world cuts leaf ``p`` along (None: replicated)."""
    spec = world_pspec(p, mesh)
    return spec.index("model") if "model" in spec else None


#: the axes of a bias over heads, which the layers read whole
_HEAD_AXES = frozenset({"heads", "kv", "hd"})


def reads_whole(p: P) -> bool:
    """Whether the layers read leaf ``p`` whole (``cut_leaf`` keeps its
    whole beside its cut):

    - a vector of a layer (one axis besides ``layers``: a norm scale, a q/k
      norm, a bias);
    - a bias over heads (axes among ``heads``, ``kv``, ``hd``);
    - a per-channel table whose only named axis is ``embed``, which the
      fallback cuts on the model width: rwkv's token-shift mixes (``mu``
      (5, embed), ``shift_a``, ``shift_b``) feed the head-cut projections
      whole; the decay LoRA and a temporal conv's taps are small beside
      them.

    Weight matrices are read cut, MLA's up-projections (a LoRA rank and
    heads) among them."""
    named = [a for a in p.axes if a not in (None, "layers")]
    return (sum(a != "layers" for a in p.axes) <= 1 or set(named) <= _HEAD_AXES
            or named == ["embed"])


def cut_leaf(p: P, t: torch.Tensor, rank: int, mesh: Mesh) -> torch.Tensor:
    """Rank ``rank``'s cut of the whole leaf ``t`` of spec ``p``.  A cut
    leaf the layers read whole keeps a copy of the whole beside its cut,
    as ``tp_whole``: those are a few vectors of the model width a layer,
    and no forward pays a collective for them.  Both are made here from
    new weights.  Under grad the kept whole's gradient reaches the cut (its
    slice, ``constraints.whole``), and after each optimizer step
    ``optimizer.apply_updates`` makes every kept whole the whole of the
    updated cut again, gathered exactly in one collective a dtype, so the
    cut stays the slice of its whole bit for bit."""
    out = shard_leaf(t, world_pspec(p, mesh), rank, mesh)
    if out is not t and reads_whole(p):
        out.tp_whole = t.clone()
    return out


def param_shards(params, spec_tree, rank: int, mesh: Mesh):
    """Rank ``rank``'s local tree of the whole ``params``: every leaf cut
    by ``cut_leaf`` under its spec (``spec_tree``'s ``P``)."""
    return tree_map(lambda p, t: cut_leaf(p, t, rank, mesh), spec_tree, params)
