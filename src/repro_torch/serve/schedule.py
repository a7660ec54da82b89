"""Schedule compilation: a workload's stage list as an executable pipeline.

The port of ``repro.serve.schedule``.  ``compile_schedule`` takes a stage
list (callables on tensors with declared stream tags nn / vsa / simd) and
emits a :class:`StagedSchedule`:

  - the ordered stage callables; the stage boundaries are the points where
    ``serve.reason.ReasonEngine`` may time, drain or overlap;
  - a **fused** callable: the composed stages, or an alternate fused stage
    list (MIMONet's unbind + classify collapsed into the ``unbind_classify``
    kernel), called once per group.  It is *negotiated* against the staged
    list: both run on ``meta`` inside ``registry.record_kernels()``, their
    output specs must agree, and the kernels they reach are diffed.  Equal
    records, or differences confined to exact gather routes, make the class
    ``exact``; a differing kernel route makes it ``epsilon`` at that
    kernel's registry epsilon.  The executor substitutes the fused callable
    only when ``fused_ok``: exact, or forced with ``fused=True``;
  - the **inter-stage buffer specs** (shapes, dtypes, bytes), from the same
    ``meta`` run (kernel wrappers take their plain path on ``meta`` and
    compute nothing);
  - the compiled batch-size buckets.

There is no jaxpr graph tracing and no lowering plan: the tensor's device
selects each kernel (``backend.registry``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.backend import registry
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
    constants.  ``device`` is where the engine stages inputs and runs.

    ``fused_equivalence`` is the negotiated class of the fused stage list
    against the staged one (``exact`` | ``epsilon`` | None when no fused
    callable was compiled), ``fused_epsilon`` the largest registry epsilon
    among the differing kernels and ``fused_lowering_diff`` their names."""

    workload: str
    variant: str
    stages: tuple[StageSpec, ...]
    ingest: Callable                      # fn(request) -> tree of np arrays
    collect: Callable                     # fn(host_out, i) -> result fields
    device: torch.device
    fused_fn: Callable | None = None      # the fused stage list, composed
    buffers: tuple[BufferSpec, ...] = ()
    # compiled batch-size buckets, ascending; () = the engine's batch_size.
    # A partial admission group pads to the smallest covering bucket.
    batch_buckets: tuple[int, ...] = ()
    fused_stages: tuple[StageSpec, ...] = ()
    fused_forced: bool = False
    fused_equivalence: str | None = None  # exact | epsilon | None
    fused_epsilon: float = 0.0
    fused_lowering_diff: tuple[str, ...] = ()

    @property
    def fused_ok(self) -> bool:
        """May the executor substitute the fused callable for the staged
        stages?  When one was compiled and it is negotiated exact, or
        forced with ``compile_schedule(fused=True)``."""
        return self.fused_fn is not None and (
            self.fused_forced or self.fused_equivalence == "exact")

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


def meta_run(stages: tuple[StageSpec, ...], consts, input_specs
             ) -> tuple[tuple[BufferSpec, ...], list]:
    """Run the stages on ``meta`` tensors (no device work, no kernel
    launch).  Returns the buffer specs of the input batch and of every
    stage output, and the ``registry.record_kernels`` record of the run."""
    bufs = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    input_specs)
    consts = tree_map(_to_meta, consts)
    out = [BufferSpec.from_tree(bufs)]
    with registry.record_kernels() as rec:
        for s in stages:
            bufs = s.fn(consts, bufs)
            out.append(BufferSpec.from_tree(bufs))
    return tuple(out), rec


def fused_conformance(staged: list, fused: list
                      ) -> tuple[str, float, tuple[str, ...]]:
    """The fused stage list's class against the staged one, from their
    ``(kernel, route)`` records: the kernels whose sets of routes differ,
    ``exact`` when each of those differs only in exact gather routes, else
    ``epsilon`` at the largest registry epsilon among them (the reference's
    ``_fused_conformance`` rule, with the gather route in the place of its
    exact ``xla`` lowering)."""
    routes: tuple[dict, dict] = ({}, {})
    for side, rec in zip(routes, (staged, fused)):
        for kernel, route in rec:
            side.setdefault(kernel, set()).add(route)
    diff = sorted(k for k in set(routes[0]) | set(routes[1])
                  if routes[0].get(k, set()) != routes[1].get(k, set()))
    approx = [k for k in diff
              if "kernel" in routes[0].get(k, set()) | routes[1].get(k, set())]
    eps = max((registry.KERNELS[k].epsilon for k in approx), default=0.0)
    return ("epsilon" if approx else "exact"), eps, tuple(diff)


def compile_schedule(workload: str, stages: tuple[StageSpec, ...] | list,
                     ingest: Callable, collect: Callable, *,
                     device: torch.device, variant: str = "default",
                     consts=None, input_specs=None,
                     batch_buckets: tuple[int, ...] = (),
                     fused: bool | str = "auto",
                     fused_stages: tuple[StageSpec, ...] | list | None = None
                     ) -> StagedSchedule:
    """Lower a stage list to a StagedSchedule on ``device``.

    ``input_specs``: tree of :class:`TensorSpec` for one staged batch of
    the largest bucket; with ``consts`` it yields the buffer specs and the
    fused negotiation.  ``batch_buckets``: ascending compiled batch sizes.

    ``fused``: ``"auto"`` compiles the fused callable and negotiates its
    class (the executor substitutes it only when exact); ``True`` forces
    the substitution whatever the class; ``False`` compiles none.
    ``fused_stages``: an alternate stage list for the fused callable; it
    needs ``input_specs`` and ``consts`` to prove its output spec equal to
    the staged pipeline's."""
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
    if fused not in (True, False, "auto"):
        raise ValueError(f"fused must be True, False or 'auto', got {fused!r}")
    specs_known = input_specs is not None and consts is not None
    if fused_stages is not None and not specs_known:
        raise ValueError(
            f"{workload}/{variant}: an alternate fused stage list needs "
            "input_specs and consts to prove its output spec matches the "
            "staged pipeline's")
    buffers, staged_rec = (), []
    if specs_known:
        buffers, staged_rec = meta_run(stages, consts, input_specs)

    fused_fn, fused_specs = None, ()
    equivalence, eps, diff = None, 0.0, ()
    if fused:
        fused_specs = stages if fused_stages is None else tuple(fused_stages)
        fused_fn = compose_stages(fused_specs)
        if specs_known:
            fused_bufs, fused_rec = meta_run(fused_specs, consts, input_specs)
            if fused_bufs[-1].shapes != buffers[-1].shapes:
                raise ValueError(
                    f"{workload}/{variant}: fused pipeline output spec does "
                    "not match the staged pipeline's")
            equivalence, eps, diff = fused_conformance(staged_rec, fused_rec)
        else:
            # the same stage fns composed: trivially exact
            equivalence = "exact"
    return StagedSchedule(
        workload=workload, variant=variant, stages=stages, ingest=ingest,
        collect=collect, device=device, fused_fn=fused_fn,
        buffers=buffers, batch_buckets=batch_buckets,
        fused_stages=fused_specs, fused_forced=fused is True,
        fused_equivalence=equivalence, fused_epsilon=eps,
        fused_lowering_diff=diff)
