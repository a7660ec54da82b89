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

The traced :class:`~repro_torch.core.dataflow.DataflowGraph` of the
composed pipeline and the per-stage op statistics (``stage_costs``, the
stream-tag audit) come from one more ``meta`` run under ``core.trace``
(steps ①–③ of the paper's Sec V-B: critical path, depth assignment,
inter-loop overlap).  It runs on first use, once per schedule:
``ensure_graph`` (what ``serve.deploy`` hands to ``core.dse.explore``),
``predicted_overlap`` and ``describe``.  There is no lowering plan: the tensor's device selects each kernel
(``backend.registry``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import dataflow as dfl
from repro_torch.core import trace as trace_mod
from repro_torch.core.opgraph import OpGraph

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

    ``stage_costs[i]`` holds stage ``i``'s traced op statistics and
    ``graph`` the composed pipeline's DataflowGraph, both empty until
    ``ensure_graph`` traces them (``source`` is then ``trace``);
    ``input_specs`` / ``consts_spec`` keep the abstract inputs for it.

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
    stage_costs: tuple[dict, ...] = ()    # per-stage traced op statistics
    graph: dfl.DataflowGraph | None = None
    source: str = "declared"              # declared | trace
    # kept for lazy tracing: the input TensorSpec tree and the constants'
    # TensorSpec tree (abstract: the constants themselves are not kept)
    input_specs: Any = None
    consts_spec: Any = None

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
        """One-line pipeline rendering: name[stream] --bytes--> name[stream],
        followed by the traced graph's summary where the schedule has
        input specs (traced on first use)."""
        parts = []
        for i, s in enumerate(self.stages):
            buf = ""
            if i < len(self.stages) - 1:
                buf = f" --{_fmt_bytes(self.buffers[i + 1].nbytes)}--> " \
                    if self.buffers else " -> "
            parts.append(f"{s.name}[{s.stream}]{buf}")
        line = "".join(parts)
        if self.input_specs is not None:
            g = ensure_graph(self).graph
            kinds = " ".join(f"{k} {sum(1 for n in g if n.kind == k)}"
                             for k in STREAMS + ("mem",))
            line += (f" | graph ({self.source}): {len(g)} nodes [{kinds}], "
                     f"critical path {len(self.graph.critical_path)}")
        return line


def _fmt_bytes(n: int) -> str:
    # 1023.95 threshold: anything that would render as "1024.0" after the
    # one-decimal rounding is promoted to the next unit (1048575 bytes is
    # "1.0MB", not "1024.0KB")
    x = float(n)
    for unit in ("B", "KB", "MB"):
        if x < (1024 if unit == "B" else 1023.95):
            return f"{x:.0f}B" if unit == "B" else f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}GB"


def _graph_stats(g: OpGraph) -> dict:
    """Summarize a traced stage subgraph for the stream-tag audit."""
    flops = {k: g.total_flops(k) for k in STREAMS}
    total = sum(flops.values())
    dominant = max(flops, key=flops.get) if total else "simd"
    # kernel / fft vsa nodes prove a symbolic stream even where the gather
    # route hides the flops inside a matmul
    has_vsa = any(n.kind == "vsa" for n in g)
    return {
        "nodes": len(g), "flops": flops, "bytes": g.total_bytes(),
        "dominant": dominant, "has_vsa_nodes": has_vsa,
    }


def compose_stages(stages: tuple[StageSpec, ...]) -> Callable:
    """The whole pipeline as one callable (the fused schedule)."""

    def composed(consts, bufs):
        for s in stages:
            bufs = s.fn(consts, bufs)
        return bufs

    return composed


def _to_meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


@dataclasses.dataclass
class MetaRun:
    """What one ``meta`` run of a stage list shows: the buffer specs of the
    input batch and of every stage output, the ``registry.record_kernels``
    record, and, when traced, the composed pipeline's OpGraph and each
    stage's own."""

    buffers: tuple[BufferSpec, ...]
    kernels: list
    graph: OpGraph | None = None
    stage_graphs: tuple[OpGraph, ...] = ()


def _empty(spec: TensorSpec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def meta_run(stages: tuple[StageSpec, ...], consts, input_specs,
             trace: bool = False) -> MetaRun:
    """Run the stages on ``meta`` tensors (no device work, no kernel
    launch).  ``consts`` may be tensors or TensorSpecs.  With ``trace``
    the run goes through ``core.trace``, and the nodes each stage added
    form its own graph (the same nodes the reference gets by tracing the
    stage alone)."""
    bufs = tree_map(_empty, input_specs)
    consts = tree_map(lambda x: _empty(x) if isinstance(x, TensorSpec)
                      else _to_meta(x), consts)
    out = [BufferSpec.from_tree(bufs)]
    tracer = trace_mod.Tracer() if trace else None
    stage_graphs = []
    with registry.record_kernels() as rec, \
            (tracer or contextlib.nullcontext()), \
            (torch.no_grad() if trace else contextlib.nullcontext()):
        for s in stages:
            start = len(tracer.graph) if trace else 0
            bufs = s.fn(consts, bufs)
            out.append(BufferSpec.from_tree(bufs))
            if trace:
                g = OpGraph()
                for name in tracer.graph.order[start:]:
                    g.add(tracer.graph.nodes[name])
                stage_graphs.append(g)
    if not trace:
        return MetaRun(tuple(out), rec)
    return MetaRun(tuple(out), rec, tracer.graph, tuple(stage_graphs))


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
    the largest bucket; with ``consts`` (tensors or TensorSpecs) it yields
    the buffer specs and the fused negotiation.  ``batch_buckets``:
    ascending compiled batch sizes.

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
        run = meta_run(stages, consts, input_specs)
        buffers, staged_rec = run.buffers, run.kernels

    fused_fn, fused_specs = None, ()
    equivalence, eps, diff = None, 0.0, ()
    if fused:
        fused_specs = stages if fused_stages is None else tuple(fused_stages)
        fused_fn = compose_stages(fused_specs)
        if specs_known:
            fused_run = meta_run(fused_specs, consts, input_specs)
            if fused_run.buffers[-1].shapes != buffers[-1].shapes:
                raise ValueError(
                    f"{workload}/{variant}: fused pipeline output spec does "
                    "not match the staged pipeline's")
            equivalence, eps, diff = fused_conformance(staged_rec,
                                                       fused_run.kernels)
        else:
            # the same stage fns composed: trivially exact
            equivalence = "exact"
    return StagedSchedule(
        workload=workload, variant=variant, stages=stages, ingest=ingest,
        collect=collect, device=device, fused_fn=fused_fn,
        buffers=buffers, batch_buckets=batch_buckets,
        fused_stages=fused_specs, fused_forced=fused is True,
        fused_equivalence=equivalence, fused_epsilon=eps,
        fused_lowering_diff=diff,
        input_specs=input_specs if specs_known else None,
        consts_spec=_abstract(consts) if specs_known else None)


def _abstract(tree):
    """TensorSpec skeleton of a tree (non-tensor leaves pass through)."""
    return tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype)
                    if isinstance(x, torch.Tensor) else x, tree)


def trace_pipeline(stages: tuple[StageSpec, ...], consts, input_specs
                   ) -> dfl.DataflowGraph:
    """The composed pipeline traced into a DataflowGraph (steps ①–③): the
    graph the DSE consumes, from the computation the schedule executes."""
    return dfl.build(meta_run(stages, consts, input_specs, trace=True).graph)


def ensure_graph(schedule: StagedSchedule) -> dfl.DataflowGraph:
    """The schedule's DataflowGraph, traced with its per-stage costs on
    first use (memoized on the schedule): what ``serve.deploy`` hands to
    ``core.dse.explore``."""
    if schedule.graph is None:
        if schedule.input_specs is None:
            raise ValueError(
                f"{schedule.workload}/{schedule.variant}: schedule was "
                "compiled without input_specs and consts: no graph to trace")
        run = meta_run(schedule.stages, schedule.consts_spec,
                       schedule.input_specs, trace=True)
        schedule.stage_costs = tuple(_graph_stats(g)
                                     for g in run.stage_graphs)
        schedule.graph = dfl.build(run.graph)
        schedule.source = "trace"
    return schedule.graph


def predicted_overlap(schedule: StagedSchedule, n_batches: int = 2) -> dict:
    """Analytical overlap prediction for the compiled schedule: the traced
    per-stage flops split into the nn-stream prefix and the symbolic tail,
    through ``core.dataflow.interloop_overlap`` (the DSE's step-③ model)."""
    graph = ensure_graph(schedule)
    t_nn = sum(sum(c["flops"].values()) for s, c in
               zip(schedule.stages, schedule.stage_costs) if s.stream == "nn")
    t_sy = sum(sum(c["flops"].values()) for s, c in
               zip(schedule.stages, schedule.stage_costs) if s.stream != "nn")
    return dfl.interloop_overlap(graph, max(1, t_nn), max(1, t_sy),
                                 n_loops=n_batches)
