"""Analytical runtime models — paper Sec V-C, Eqs. (1)-(5), verbatim.

Cycle counts for nodes mapped onto the AdArray (H × W sub-arrays, N of
them). ``d1, d2, d3`` are the NN layer's m, n, k; ``nvec, d`` are a VSA
node's vector quantity and dimension. These models are SCALE-Sim-style
(refs [29], [31]) and are what the paper's own evaluation uses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.opgraph import OpGraph, OpNode


def cdiv(a: float, b: float) -> int:
    return int(math.ceil(a / b))


# --- Eq. (1): NN layer on N_l[i] combined sub-arrays (row-partition scale-out)
def t_layer(H: int, W: int, n_l: int, d1: int, d2: int, d3: int) -> int:
    if n_l <= 0:
        return 1 << 60  # unmapped — infinite
    return (2 * H + W + d1 - 2) * cdiv(cdiv(d2, n_l), H) * cdiv(d3, W)


# --- Eq. (2): total NN runtime over layer set R_l
def t_nn(H: int, W: int, n_ls: Sequence[int], layers: Sequence[OpNode]) -> int:
    return sum(
        t_layer(H, W, n_l, n.dims["m"], n.dims["n"], n.dims["k"])
        * n.dims.get("repeat", 1)
        for n_l, n in zip(n_ls, layers)
    )


# --- Eq. (3)/(4): VSA node under spatial / temporal mapping
def t_vsa_spatial(H: int, W: int, n_v: int, nvec: int, d: int) -> int:
    if n_v <= 0:
        return 1 << 60
    T = 3 * H + d - 1
    return nvec * cdiv(d, W * H * n_v) * T


def t_vsa_temporal(H: int, W: int, n_v: int, nvec: int, d: int) -> int:
    if n_v <= 0:
        return 1 << 60
    T = 3 * H + d - 1
    return cdiv(nvec, W) * cdiv(d, H * n_v) * T


# --- Eq. (5): total VSA runtime (best of the two mappings, per whole set)
def t_vsa(H: int, W: int, n_vs: Sequence[int], vnodes: Sequence[OpNode]) -> int:
    temp = sum(
        t_vsa_temporal(H, W, n_v, n.dims["nvec"], n.dims["d"])
        * n.dims.get("repeat", 1)
        for n_v, n in zip(n_vs, vnodes)
    )
    spat = sum(
        t_vsa_spatial(H, W, n_v, n.dims["nvec"], n.dims["d"])
        * n.dims.get("repeat", 1)
        for n_v, n in zip(n_vs, vnodes)
    )
    return min(temp, spat)


def t_vsa_node(H: int, W: int, n_v: int, node: OpNode) -> int:
    """Best-mapping runtime of a single VSA node."""
    nvec, d = node.dims["nvec"], node.dims["d"]
    r = node.dims.get("repeat", 1)
    return min(t_vsa_spatial(H, W, n_v, nvec, d),
               t_vsa_temporal(H, W, n_v, nvec, d)) * r


def t_simd(lanes: int, simd_nodes: Sequence[OpNode]) -> int:
    """SIMD-unit runtime: one element per lane per cycle."""
    return sum(cdiv(n.dims.get("elems", 1), lanes) * n.dims.get("repeat", 1)
               for n in simd_nodes)


# ---------------------------------------------------------------------------
# Memory sizing (Sec V-C "Memory and SIMD unit", Sec IV-C)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    mem_a1: int   # max NN filter (stationary) bytes
    mem_a2: int   # max VSA node bytes
    mem_b: int    # max NN ifmap bytes
    mem_c: int    # max output bytes
    cache: int    # 2 × (A + B + C)
    simd_lanes: int

    @property
    def mem_a(self) -> int:
        return self.mem_a1 + self.mem_a2

    @property
    def total(self) -> int:
        return self.mem_a + self.mem_b + self.mem_c + self.cache


def memory_plan(graph: OpGraph, t_parallel: int, lane_candidates=(16, 32, 64, 128, 256)) -> MemoryPlan:
    nn = graph.nn_nodes()
    vs = graph.vsa_nodes()
    sd = graph.simd_nodes()
    mem_a1 = max((n.param_bytes for n in nn), default=0)
    mem_a2 = max((n.in_bytes for n in vs), default=0)
    mem_b = max((n.in_bytes - n.param_bytes for n in nn), default=0)
    mem_c = max((n.out_bytes for n in graph if n.kind in ("nn", "vsa", "simd")),
                default=0)
    # smallest SIMD such that elem-wise work hides under the parallel runtime
    lanes = lane_candidates[-1]
    for cand in lane_candidates:
        if t_simd(cand, sd) <= max(1, t_parallel):
            lanes = cand
            break
    cache = 2 * (mem_a1 + mem_a2 + mem_b + mem_c)
    return MemoryPlan(mem_a1, mem_a2, mem_b, mem_c, cache, lanes)
