"""Parameter spec system: declare a tree of :class:`P` specs once, draw it.

The port's counterpart of ``repro.nn.init``, with the same init rules
(``normal`` with std ``scale`` or 1/sqrt(fan_in), ``uniform``, ``zeros``,
``ones``, ``constant``), drawn with an explicit ``torch.Generator``.  The
numbers differ from ``jax.random``'s, so parity tests never draw here:
they carry the reference's constants across with ``repro_torch.interop``.
This is for standalone use and ``chip_smoke.py``.  Leaves are drawn on the
generator's device, so a ``torch.Generator("cuda")`` draws a full-width LM
on the card without a host copy.

``shapes`` (``meta`` tensors: shape and dtype, no storage),
``param_count`` and ``param_bytes`` read a spec tree without drawing it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class P:
    """A single parameter spec: shape, one logical axis name (or None) per
    dim, and its initializer."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | uniform | constant
    scale: float | None = None  # stddev override for normal init
    dtype: Any = torch.float32
    constant: float = 0.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank mismatch")


def _fan_in(shape: Sequence[int]) -> int:
    # last axis is the output axis by convention (x @ W)
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1]))


def _materialize_one(spec: P, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "constant":
        return torch.full(spec.shape, spec.constant, dtype=spec.dtype, device=dev)
    if spec.init == "uniform":
        lim = spec.scale if spec.scale is not None \
            else 1.0 / math.sqrt(_fan_in(spec.shape))
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=dev)
        return (u * (2 * lim) - lim).to(spec.dtype)
    if spec.init == "normal":
        std = spec.scale if spec.scale is not None \
            else 1.0 / math.sqrt(max(1, _fan_in(spec.shape)))
        z = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=dev)
        return z.mul_(std).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init}")


def materialize(spec_tree, generator: torch.Generator):
    """Draw real parameters from a spec tree on ``generator``'s device,
    leaf by leaf in tree order from one generator."""
    return tree_map(lambda p: _materialize_one(p, generator), spec_tree)


def _specs(spec_tree) -> list[P]:
    return [p for p in tree_leaves(spec_tree) if isinstance(p, P)]


def shapes(spec_tree):
    """The tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
                    spec_tree)


def param_count(spec_tree) -> int:
    return sum(math.prod(p.shape) for p in _specs(spec_tree))


def param_bytes(spec_tree) -> int:
    return sum(math.prod(p.shape) * p.dtype.itemsize for p in _specs(spec_tree))
