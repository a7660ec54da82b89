"""Schedule compilation: a workload's stage list as an executable pipeline.

The port of ``repro.serve.schedule``.  ``compile_schedule`` takes a stage
list (callables on tensors with declared stream tags nn / vsa / simd) and
emits a :class:`StagedSchedule`:

  - the ordered stage callables; the stage boundaries are the points where
    ``serve.reason.ReasonEngine`` may time, drain or overlap;
  - a **fused** callable: the composed stages called once per group.  Both
    lowerings of a stage list run the same kernels, so ``fused_ok`` holds;
  - the **inter-stage buffer specs** (shapes, dtypes, bytes), found by
    running the stages on ``meta`` tensors, which carry shapes and compute
    nothing (the kernel wrappers take their plain path on ``meta``);
  - the compiled batch-size buckets.

There is no jaxpr graph tracing and no lowering-plan negotiation: the
tensor's device selects each kernel (``backend.registry``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.tree import tree_leaves, tree_map

STREAMS = ("nn", "vsa", "simd")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: ``fn(consts, bufs) -> bufs`` with a stream tag.

    ``consts`` is the workload's constant tree (params / codebooks),
    ``bufs`` the previous stage's output tree (stage 0 receives the staged
    request batch)."""

    name: str
    stream: str        # nn | vsa | simd
    fn: Callable[[Any, Any], Any]

    def __post_init__(self):
        if self.stream not in STREAMS:
            raise ValueError(f"stage {self.name!r}: unknown stream "
                             f"{self.stream!r} (want one of {STREAMS})")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one buffer leaf."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """Inter-stage buffer: tree of TensorSpecs + total bytes."""

    shapes: Any
    nbytes: int

    @staticmethod
    def from_tree(tree) -> "BufferSpec":
        specs = tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)
        return BufferSpec(shapes=specs,
                          nbytes=sum(s.nbytes for s in tree_leaves(specs)))


@dataclasses.dataclass
class StagedSchedule:
    """An executable pipeline.  ``buffers[0]`` describes the staged input
    batch of the largest bucket and ``buffers[i + 1]`` the output of stage
    ``i``; empty when the schedule was compiled without input specs or
    constants.  ``device`` is where the engine stages inputs and runs."""

    workload: str
    variant: str
    stages: tuple[StageSpec, ...]
    ingest: Callable                      # fn(request) -> tree of np arrays
    collect: Callable                     # fn(host_out, i) -> result fields
    device: torch.device
    fused_fn: Callable                    # the composed stages
    buffers: tuple[BufferSpec, ...] = ()
    # compiled batch-size buckets, ascending; () = the engine's batch_size.
    # A partial admission group pads to the smallest covering bucket.
    batch_buckets: tuple[int, ...] = ()

    @property
    def fused_ok(self) -> bool:
        """The fused callable runs the same kernels as the staged stages,
        so the executor may always substitute it."""
        return True

    def covering_bucket(self, n: int) -> int:
        """Smallest compiled batch bucket that fits ``n`` requests."""
        if not self.batch_buckets:
            return n
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"{self.workload}/{self.variant}: admission group of {n} "
            f"exceeds the largest compiled bucket {self.batch_buckets[-1]}")

    def describe(self) -> str:
        """One-line pipeline rendering: name[stream] --bytes--> name[stream]."""
        parts = []
        for i, s in enumerate(self.stages):
            buf = ""
            if i < len(self.stages) - 1:
                buf = f" --{self.buffers[i + 1].nbytes}B--> " \
                    if self.buffers else " -> "
            parts.append(f"{s.name}[{s.stream}]{buf}")
        return "".join(parts)


def compose_stages(stages: tuple[StageSpec, ...]) -> Callable:
    """The whole pipeline as one callable (the fused schedule)."""

    def composed(consts, bufs):
        for s in stages:
            bufs = s.fn(consts, bufs)
        return bufs

    return composed


def _to_meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def buffer_specs(stages: tuple[StageSpec, ...], consts, input_specs
                 ) -> tuple[BufferSpec, ...]:
    """Shapes of the input batch and of every stage output, from running
    the stages on ``meta`` tensors (no device work, no kernel launch)."""
    bufs = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    input_specs)
    consts = tree_map(_to_meta, consts)
    out = [BufferSpec.from_tree(bufs)]
    for s in stages:
        bufs = s.fn(consts, bufs)
        out.append(BufferSpec.from_tree(bufs))
    return tuple(out)


def compile_schedule(workload: str, stages: tuple[StageSpec, ...] | list,
                     ingest: Callable, collect: Callable, *,
                     device: torch.device, variant: str = "default",
                     consts=None, input_specs=None,
                     batch_buckets: tuple[int, ...] = ()) -> StagedSchedule:
    """Lower a stage list to a StagedSchedule on ``device``.

    ``input_specs``: tree of :class:`TensorSpec` for one staged batch of
    the largest bucket; with ``consts`` it yields the buffer specs.
    ``batch_buckets``: ascending compiled batch sizes."""
    stages = tuple(stages)
    if not stages:
        raise ValueError("schedule needs at least one stage")
    names = [s.name for s in stages]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate stage names: {names}")
    batch_buckets = tuple(batch_buckets)
    if batch_buckets and (list(batch_buckets) != sorted(set(batch_buckets))
                          or batch_buckets[0] < 1):
        raise ValueError(f"batch_buckets must be ascending positive "
                         f"sizes, got {batch_buckets}")
    buffers = ()
    if input_specs is not None and consts is not None:
        buffers = buffer_specs(stages, consts, input_specs)
    return StagedSchedule(
        workload=workload, variant=variant, stages=stages, ingest=ingest,
        collect=collect, device=device, fused_fn=compose_stages(stages),
        buffers=buffers, batch_buckets=batch_buckets)
