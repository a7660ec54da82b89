"""Operation-graph IR — the unit the NSFlow frontend operates on.

Node kinds mirror the paper's workload taxonomy (Sec II):
  nn    — matmul / convolution (MXU / combined sub-array work)
  vsa   — blockwise circular convolution / correlation (symbolic binding)
  simd  — element-wise, reductions, softmax, similarity chains (SIMD unit)
  mem   — data movement only (reshape/transpose/gather)

Dims convention:
  nn   : m, n, k        (output m×n, contraction k) — paper's d1, d2, d3
  vsa  : nvec, d        (vector quantity n_j and dimension d_j)
  simd : elems
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass
class OpNode:
    name: str
    kind: str                      # nn | vsa | simd | mem
    dims: dict
    deps: list[str] = dataclasses.field(default_factory=list)
    out_bytes: int = 0
    in_bytes: int = 0
    param_bytes: int = 0           # stationary operand (weights / codebook)
    flops: int = 0
    label: str = ""                # human-readable (primitive name)

    # dataflow-graph annotations (filled by repro_torch.core.dataflow)
    depth: int = -1
    on_critical_path: bool = False
    attached_to: str | None = None  # critical-path node this runs parallel to


@dataclasses.dataclass
class OpGraph:
    nodes: dict[str, OpNode] = dataclasses.field(default_factory=dict)
    order: list[str] = dataclasses.field(default_factory=list)  # topo order

    def add(self, node: OpNode) -> OpNode:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        self.nodes[node.name] = node
        self.order.append(node.name)
        return node

    def __iter__(self) -> Iterable[OpNode]:
        return (self.nodes[n] for n in self.order)

    def __len__(self) -> int:
        return len(self.order)

    def nn_nodes(self) -> list[OpNode]:
        return [n for n in self if n.kind == "nn"]

    def vsa_nodes(self) -> list[OpNode]:
        return [n for n in self if n.kind == "vsa"]

    def simd_nodes(self) -> list[OpNode]:
        return [n for n in self if n.kind == "simd"]

    def consumers(self) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {k: [] for k in self.nodes}
        for n in self:
            for d in n.deps:
                if d in out:
                    out[d].append(n.name)
        return out

    def total_bytes(self, kind: str | None = None) -> int:
        return sum(n.out_bytes + n.param_bytes for n in self
                   if kind is None or n.kind == kind)

    def total_flops(self, kind: str | None = None) -> int:
        return sum(n.flops for n in self if kind is None or n.kind == kind)


def format_trace(graph: OpGraph, max_nodes: int = 0) -> str:
    """Listing-1-style program trace rendering."""
    lines = []
    names = graph.order[:max_nodes] if max_nodes else graph.order
    for name in names:
        n = graph.nodes[name]
        shape = n.dims.get("out_shape", "")
        args = ", ".join(f"%{d}" for d in n.deps) or "-"
        lines.append(f"%{n.name}{list(shape) if shape != '' else ''} : "
                     f"{n.kind}[{n.label}](args = ({args}))")
    return "\n".join(lines)
