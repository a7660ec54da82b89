"""Small shared utilities used across the port.

The port of ``repro.common.util``: ``cdiv``, ``pad_to_multiple``,
``tree_count``, ``tree_bytes``, ``human_bytes``, ``human_flops`` and
``round_up_pow2``, on tensors (``meta`` tensors included: they carry shape
and dtype, which is all ``tree_count`` and ``tree_bytes`` read).

The reference's ``mesh_context`` and ``shard_map_unreplicated`` have no
torch meaning: they set JAX's ambient mesh and wrap ``shard_map``.  Their
counterpart is ``repro_torch.distributed.constraints.tp_group``, the
context that holds a tensor-parallel world's process group and rank, and
the per-rank code paths of the layers.  ``split_key`` has none either: the
port draws from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.tree import tree_leaves


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to the next multiple of ``multiple``."""
    axis = axis % x.dim()
    size = x.shape[axis]
    target = cdiv(size, multiple) * multiple
    if target == size:
        return x
    # F.pad lists (low, high) pairs from the last dim backwards
    pads = [0, 0] * (x.dim() - axis)
    pads[-1] = target - size
    return F.pad(x, pads)


def tree_count(tree) -> int:
    """Total number of elements of the tensors in a tree."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree) if hasattr(x, "shape"))


def tree_bytes(tree) -> int:
    """Total byte size of the tensors (``meta`` ones included) in a tree."""
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def human_bytes(n: float) -> str:
    for unit in ["B", "KiB", "MiB", "GiB", "TiB"]:
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"


def human_flops(n: float) -> str:
    for unit in ["FLOP", "KFLOP", "MFLOP", "GFLOP", "TFLOP", "PFLOP"]:
        if abs(n) < 1000.0:
            return f"{n:.2f} {unit}"
        n /= 1000.0
    return f"{n:.2f} EFLOP"


def round_up_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, n))))
