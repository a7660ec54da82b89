"""Memory plan -> kernel tile budgets (paper Sec IV-C on the card).

The port of ``repro.core.memplan``, with its arithmetic.  The FPGA's
re-organisable BRAM partition (Mem_A1 weights / Mem_A2 vectors / Mem_B
ifmap / Mem_C outputs) maps onto the on-chip buffer a kernel plans
against, here an SM's shared memory per thread block
(``launch/mesh.py:HW["vmem_bytes"]``, 227 KiB): the DAG's memory plan
decides how much of it each kernel operand class may claim, and this
module turns those budgets into tile shapes.  "Merging A1/A2" (paper ①)
happens when a kernel runs without a concurrent sibling stream: it
receives the combined budget.

A planning function, as in the reference, where nothing reads it: the
port's kernels size their own tiles (``kernels/*/ops.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.analytical import MemoryPlan
from repro_torch.launch.mesh import HW


@dataclasses.dataclass(frozen=True)
class KernelTiles:
    circ_elem_tile_n: int      # rows per circulant tile (Mem_A2 budget)
    circ_dict_tile_n: int      # query rows per dict tile
    qmm_bm: int
    qmm_bn: int
    qmm_bk: int
    vmem_budget: int


def plan_tiles(mem: MemoryPlan, d: int = 256, vmem: int | None = None,
               concurrent: bool = True) -> KernelTiles:
    """Kernel tiles from a workload memory plan.

    ``concurrent=True`` is folded execution: the VSA kernels get the Mem_A2
    share of the buffer and the NN kernels Mem_A1 + Mem_B; otherwise each
    kernel class may claim the merged budget (the paper's runtime
    re-partition)."""
    vmem = vmem or int(HW["vmem_bytes"])
    total_plan = max(1, mem.mem_a + mem.mem_b)
    if concurrent:
        vsa_budget = max(vmem // 8, int(vmem * mem.mem_a2 / total_plan))
        nn_budget = max(vmem // 8, vmem - vsa_budget)
    else:
        vsa_budget = nn_budget = vmem
    # circ_elem: per-row f32 circulant d*d*4 (double-buffered)
    per_row = d * d * 4 * 2
    tile_n = max(1, min(64, vsa_budget // per_row))
    # circ_dict: one circulant + query tile
    dict_tile = max(8, min(512, (vsa_budget - d * d * 4) // (d * 4 * 2)))
    # qmatmul: bm*bk + bk*bn int8 + bm*bn int32 acc within the nn budget,
    # in multiples of 128
    b = 128
    while (b * b * 2 + b * b * 4) * 2 < nn_budget and b < 1024:
        b *= 2
    b = max(128, b // 2)
    return KernelTiles(tile_n, dict_tile, b, b, b, vmem)
