"""Per-stage op checks over compiled StagedSchedules (NSF001-NSF003).

The port of ``repro.analyze.artifacts``.  A
:class:`~repro_torch.serve.schedule.StagedSchedule` keeps what a
deployment serves: the abstract input and constant specs and the stage
callables.  :func:`stage_traces` runs each stage on ``meta`` tensors
through ``serve.schedule.meta_run`` (no device works, nothing compiles:
the counterpart of the reference's ``make_jaxpr``) under an
:class:`OpRecorder`, a ``TorchDispatchMode`` that sees every aten op below
autograd, and chains each stage's output specs into the next stage.  Each
:class:`OpRecord` keeps the op's name, its inputs' and outputs' dtypes,
shapes and devices, its non-tensor arguments and the identities of its
tensors.  A kernel wrapper runs its plain version on ``meta``, so the ops
inside it are recorded too; the wrapper's own arguments reach the
recorder as they reach a trace (``registry.TRACE``, see
``backend.registry.kernel_call``).

* **NSF001 precision flow**: an op whose output is float64 is an error
  (the stack is f32/bf16/int: a silent upcast doubles every buffer and
  leaves every kernel's dtype), and so is a kernel wrapper handed a
  float64 operand.  A float32 -> bfloat16/float16 conversion (``_to_copy``
  or ``copy_``), or a half-precision wrapper operand, inside a ``vsa`` /
  ``simd`` stage whose config declares an int8/int4 ``symb_precision``,
  or an ``nn`` stage under an int ``nn_precision``, is an error too: the
  fake-quant int emulation is defined in f32.
* **NSF002 fake_quant axis consistency**: ``fake_quant`` is an ``abs``
  feeding an ``amax`` (or ``max``); two such reductions of equal input
  rank over different dims in one stage mean one tensor quantizes per
  problem and a same-shaped one globally (a request's numerics would
  depend on its admission group): a warning.
* **NSF003 host syncs**: ``aten._local_scalar_dense`` (``.item()``,
  ``bool(t)``, ``int(t)``), a ``_to_copy`` / ``copy_`` to another device
  than its input's, and the ops whose output shape depends on the data
  (``nonzero``, ``masked_select``, ``unique*``), each of which waits for
  the device on CUDA.  On ``meta`` these would raise, so the recorder
  notes the finding first and then hands back a placeholder (a zero
  scalar, or a ``meta`` tensor of the copy's shape); an op of
  data-dependent shape ends the stage's trace, and so does any error
  raised after a sync was noted.  The stages after it are not traced.

**NSF004 (donation) has no counterpart.**  The reference checks that its
jitted fused pipeline donates the inter-stage buffer off the CPU.  The
port's ``StagedSchedule`` has no jitted fused callable and donates
nothing: ``fused_fn`` composes the stages in one Python call
(``serve.schedule.compose_stages``), and every stage allocates its
outputs.  The rule keeps its ID in ``RULES`` and is never emitted;
``coverage["fused_donation"]`` is reported as 0.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analyze.findings import AnalysisReport, finding
from repro_torch.backend import registry
from repro_torch.serve import schedule as sch

_ADDR = re.compile(r"0x[0-9a-f]+")
_HALF = (torch.bfloat16, torch.float16)
_DEVICE_COPIES = ("_to_copy", "copy_")
# ops whose output shape depends on the data: a device sync on CUDA
_DATA_SHAPED = {"nonzero", "masked_select", "unique", "_unique", "_unique2",
                "unique_dim", "unique_consecutive"}


class TraceEnded(RuntimeError):
    """Raised inside a stage at an op of data-dependent shape, after the
    recorder noted its NSF003 finding: the trace cannot go on."""


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op of a stage.  ``args`` holds the op's non-tensor
    arguments in order, with ``None`` in place of each tensor (kwargs
    last, as ``(name, value)`` pairs); ``in_ids`` / ``out_ids`` are the
    identities of its tensors, stable within one stage's trace."""

    name: str
    in_dtypes: tuple
    in_shapes: tuple
    in_devices: tuple
    out_dtypes: tuple
    out_shapes: tuple
    out_devices: tuple
    args: tuple
    in_ids: tuple
    out_ids: tuple

    @property
    def base(self) -> str:
        """``aten.amax.default`` -> ``amax``."""
        return self.name.split(".")[1]

    def signature(self) -> tuple:
        """What a retrace must reproduce: name, shapes, dtypes and the
        non-tensor arguments, object addresses masked."""
        return (self.name, self.in_shapes, self.in_dtypes, self.out_shapes,
                self.out_dtypes, _ADDR.sub("0x", repr(self.args)))


def _strip(x, found: list):
    """``x`` with each tensor replaced by None (appended to ``found``)."""
    if isinstance(x, torch.Tensor):
        found.append(x)
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v, found) for v in x) \
            if type(x) in (list, tuple) else tuple(_strip(v, found) for v in x)
    return x


@functools.lru_cache(maxsize=None)
def _base_name(func) -> str:
    """``aten.amax.default`` -> ``amax`` (one lookup per op overload)."""
    return func.overloadpacket.__name__


class OpRecorder(TorchDispatchMode):
    """Records every aten op run while it is open, and the kernel wrappers'
    calls (as ``registry.TRACE``: ``calls`` holds ``(kernel, {argument:
    dtype})`` for their tensor arguments).  ``syncs`` holds the index in
    ``ops`` and the kind of each host sync (NSF003)."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []
        self.calls: list[tuple[str, dict]] = []
        self.syncs: list[tuple[int, str]] = []
        self._keep: list[torch.Tensor] = []   # pin tensors: ids stay unique

    # -- the registry's trace interface (``registry.kernel_call``) ----------

    def kernel(self, kernel: str, out, args: dict) -> None:
        self.calls.append((kernel, {k: v.dtype for k, v in args.items()
                                    if isinstance(v, torch.Tensor)}))

    def __enter__(self):
        if registry.TRACE is not None:
            raise RuntimeError("a trace is already open")
        registry.TRACE = self
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            registry.TRACE = None

    # -- the ops -------------------------------------------------------------

    def _record(self, func, args, kwargs, out) -> OpRecord:
        ins: list[torch.Tensor] = []
        outs: list[torch.Tensor] = []
        flat = _strip(tuple(args), ins) + _strip(tuple(sorted(
            kwargs.items())), ins)
        _strip(out, outs)
        self._keep.extend(ins)
        self._keep.extend(outs)
        rec = OpRecord(
            name=str(func),
            in_dtypes=tuple(t.dtype for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_devices=tuple(t.device.type for t in ins),
            out_dtypes=tuple(t.dtype for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_devices=tuple(t.device.type for t in outs),
            args=flat, in_ids=tuple(map(id, ins)),
            out_ids=tuple(map(id, outs)))
        self.ops.append(rec)
        return rec

    def _sync(self, func, args, kwargs, kind: str, out=()) -> None:
        self._record(func, args, kwargs, out)
        self.syncs.append((len(self.ops) - 1, kind))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        base = _base_name(func)
        if base == "_local_scalar_dense":
            self._sync(func, args, kwargs, ".item() / bool() / int()")
            return {torch.bool: False}.get(
                args[0].dtype, 0.0 if args[0].dtype.is_floating_point else 0)
        if base in _DATA_SHAPED:
            self._sync(func, args, kwargs, "data-dependent shape")
            raise TraceEnded(f"{func}: output shape depends on the data")
        if base in _DEVICE_COPIES:
            src = args[1] if base == "copy_" else args[0]
            dst = args[0].device if base == "copy_" else kwargs.get("device")
            if dst is not None and torch.device(dst) != src.device:
                dtype = args[0].dtype if base == "copy_" \
                    else kwargs.get("dtype") or src.dtype
                out = torch.empty(src.shape, dtype=dtype, device=src.device)
                self._sync(func, args, kwargs,
                           f"copy {src.device} -> {torch.device(dst)}", out)
                return args[0] if base == "copy_" else out
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out


@dataclasses.dataclass
class StageTrace:
    """One stage's recorded run: its ops, the ``registry.record_kernels``
    list, the wrappers' calls, its host syncs and its output specs (None
    where the trace ended at a host sync)."""

    stage: Any
    ops: list[OpRecord]
    kernels: list
    calls: list
    syncs: list
    out_specs: Any


def trace_stage(stage, consts_spec, input_specs) -> StageTrace:
    """Run ``stage`` once on ``meta`` (``serve.schedule.meta_run``) under an
    :class:`OpRecorder`."""
    rec = OpRecorder()

    def recorded(consts, bufs):
        with rec:
            return stage.fn(consts, bufs)

    try:
        run = sch.meta_run((sch.StageSpec(stage.name, stage.stream, recorded),),
                           consts_spec, input_specs)
    except Exception:  # noqa: BLE001 - after a noted sync the trace just ends
        if not rec.syncs:
            raise
        return StageTrace(stage, rec.ops, [], rec.calls, rec.syncs, None)
    return StageTrace(stage, rec.ops, run.kernels, rec.calls, rec.syncs,
                      run.buffers[-1].shapes)


def stage_traces(sched) -> Iterator[StageTrace]:
    """Yield each stage's :class:`StageTrace`, chaining abstract specs:
    stage ``i``'s input spec is stage ``i-1``'s output spec (stage 0 takes
    the staged batch).  Stops after a stage whose trace ended."""
    if sched.input_specs is None or sched.consts_spec is None:
        return
    specs = sched.input_specs
    for stage in sched.stages:
        tr = trace_stage(stage, sched.consts_spec, specs)
        yield tr
        if tr.out_specs is None:
            return
        specs = tr.out_specs


def _declared_precision(cfg, stream: str) -> str | None:
    """The config's declared precision class for a stage's stream."""
    attr = "nn_precision" if stream == "nn" else "symb_precision"
    return getattr(cfg, attr, None)


def _downcast(op: OpRecord) -> tuple[str, str] | None:
    """(old, new) dtype of a float32 -> half conversion op, else None."""
    if op.base == "_to_copy" and op.in_dtypes and op.out_dtypes:
        old, new = op.in_dtypes[0], op.out_dtypes[0]
    elif op.base == "copy_" and len(op.in_dtypes) >= 2:
        new, old = op.in_dtypes[:2]
    else:
        return None
    if old == torch.float32 and new in _HALF:
        return old, new
    return None


def _check_stage_precision(tr: StageTrace, cfg, where) -> list:
    out = []
    stage = tr.stage
    declared = _declared_precision(cfg, stage.stream) if cfg is not None \
        else None
    wide = [op for op in tr.ops if torch.float64 in op.out_dtypes]
    if wide:
        more = f" (and {len(wide) - 1} more ops)" if len(wide) > 1 else ""
        out.append(finding(
            "NSF001", where,
            f"stage {stage.name!r}: {wide[0].name} produces float64{more}: "
            "silent f64 upcast in a hot stage body (doubles the buffer, "
            "leaves every kernel's dtype)"))
    for kernel, dtypes in tr.calls:
        for arg, dtype in dtypes.items():
            if dtype == torch.float64:
                out.append(finding(
                    "NSF001", where,
                    f"stage {stage.name!r}: kernel {kernel!r} is handed a "
                    f"float64 {arg!r}"))
            elif declared in ("int8", "int4") and dtype in _HALF:
                out.append(finding(
                    "NSF001", where,
                    f"stage {stage.name!r} ({stage.stream} stream): kernel "
                    f"{kernel!r} is handed {dtype} {arg!r} while the config "
                    f"declares {stage.stream}-stream precision {declared!r}"))
    if declared in ("int8", "int4"):
        for op in tr.ops:
            cast = _downcast(op)
            if cast is not None:
                out.append(finding(
                    "NSF001", where,
                    f"stage {stage.name!r} ({stage.stream} stream) downcasts "
                    f"{cast[0]} -> {cast[1]} ({op.name}) while the config "
                    f"declares {stage.stream}-stream precision {declared!r}: "
                    "fake-quant int emulation is defined in f32; this cast "
                    "drops below the declared class"))
    return out


def _reduced_dims(op: OpRecord) -> tuple[int, ...] | None:
    """The dims an ``amax`` / ``max`` reduces, normalised (all dims for a
    global reduction), or None for another op."""
    rank = len(op.in_shapes[0]) if op.in_shapes else 0
    if op.name in ("aten.amax.default", "aten.max.dim"):
        dims = op.args[1] if len(op.args) > 1 else ()
        dims = (dims,) if isinstance(dims, int) else tuple(dims)
        if not dims and op.base == "amax":
            dims = tuple(range(rank))
    elif op.name == "aten.max.default":
        dims = tuple(range(rank))
    else:
        return None
    return tuple(sorted(d % max(rank, 1) for d in dims))


def _check_stage_fake_quant(tr: StageTrace, where) -> list:
    abs_outs = {i for op in tr.ops if op.base == "abs" for i in op.out_ids}
    seen: dict[int, set[tuple]] = {}
    for op in tr.ops:
        dims = _reduced_dims(op)
        if dims is not None and op.in_ids and op.in_ids[0] in abs_outs:
            seen.setdefault(len(op.in_shapes[0]), set()).add(dims)
    out = []
    for rank, dims_set in seen.items():
        if len(dims_set) > 1:
            out.append(finding(
                "NSF002", where,
                f"stage {tr.stage.name!r}: fake_quant amax reductions over "
                f"rank-{rank} inputs disagree on dims ({sorted(dims_set)}): "
                "mixed global/per-problem scales make a request's numerics "
                "depend on its admission group"))
    return out


def _check_stage_syncs(tr: StageTrace, where) -> list:
    out = []
    for i, kind in tr.syncs:
        out.append(finding(
            "NSF003", where,
            f"stage {tr.stage.name!r} calls {tr.ops[i].name} ({kind}): a "
            "device->host sync per dispatch in a hot stage body"
            + (" (the trace ends here)" if tr.out_specs is None
               and i == tr.syncs[-1][0] else "")))
    return out


def check_schedule(sched, cfg=None, where: str | None = None
                   ) -> AnalysisReport:
    """All artifact checks over one compiled schedule."""
    report = AnalysisReport()
    where = where or f"{sched.workload}/{sched.variant}"
    for tr in stage_traces(sched):
        stage_where = f"{where}/{tr.stage.name}"
        report.extend(_check_stage_precision(tr, cfg, stage_where))
        report.extend(_check_stage_fake_quant(tr, stage_where))
        report.extend(_check_stage_syncs(tr, stage_where))
        report.covered("stage_ops")
    report.covered("fused_donation", 0)   # NSF004: nothing to donate
    return report
