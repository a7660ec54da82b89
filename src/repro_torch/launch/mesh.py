"""Device meshes and the hardware table of the card.

The port of ``repro.launch.mesh``.  A ``Mesh`` here is a record of a
factorisation, not a placement: ``shape`` maps each axis name to its size
(``{"data": d, "model": m}``) and ``axis_names`` orders them, which is all
``distributed.sharding_rules`` and ``core.meshdse`` read.  Placing ranks on
devices is ``distributed.world``'s job: rank r of a ``(data=1, model=tp)``
mesh holds model shard r on ``devices[r]``.

``HW`` keeps the reference's keys, which ``core.meshdse`` reads, with the
figures of the part the port runs on: NVIDIA H100 80GB HBM3 (SXM5, 700 W),
from its datasheet.  ``ici_*`` name the chip-to-chip links, NVLink 4 here:
18 links of 25 GB/s per direction.  ``vmem_bytes`` is the on-chip buffer a
kernel plans against: the SM's 227 KiB of shared memory per thread block.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh factorisation: axis names in order and their sizes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} / sizes {self.sizes} mismatch")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production factorisations: (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small (data, model) mesh (tests, examples, a tensor-parallel
    world of ``model`` ranks)."""
    return Mesh(("data", "model"), (data, model))


HW = {
    # NVIDIA H100 80GB HBM3, 700 W (SXM5 datasheet), per card
    "peak_flops_bf16": 989e12,   # dense, tensor cores
    "hbm_bw": 3.35e12,           # bytes/s
    "ici_bw_per_link": 25e9,     # NVLink 4: bytes/s per link per direction
    "ici_links": 18,
    "hbm_bytes": 80e9,
    "vmem_bytes": 227 * 2 ** 10,  # shared memory per thread block (per SM)
}
