"""Kernel registry of the PyTorch port: names, tolerances, routing, counts.

The twin of ``repro.backend.registry`` with one rule in place of its
negotiated plans: **the tensor's device selects the path.**  A CUDA tensor
goes to the hand-written Hopper kernel (the wrapper launches it or raises),
a CPU tensor to the kernel's plain PyTorch version, which repeats the
kernel's arithmetic.  There is no override and no fallback: a CUDA tensor
never reaches a plain version.  ``meta`` tensors take the plain path too;
they carry shapes only and compute nothing (``serve.schedule`` derives its
buffer specs that way).

Each entry keeps the reference's kernel name, its epsilon against the
exact reference, and its ``dispatch_min_size``: below that block dim
``vsa.bind`` / ``vsa.unbind`` take the exact gather reference instead of
the kernel, on every device, as the reference routes on every platform
(``vsa.match_prob`` likewise at simd_fused's floor).

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels.  Each wrapper call that reaches the card makes
one device launch and counts one.

``record_kernels()`` is the counterpart of the reference's
``registry.record_selections``: while it is open, every call of a kernel
wrapper (on any device, ``meta`` included) appends ``(kernel, "kernel")``
and every dispatch that stays on the exact reference below a kernel's
floor appends ``(kernel, "gather")``.  ``serve.schedule`` diffs the records
of the staged and the fused stage lists to negotiate the fused schedule.

``TRACE`` is the open ``core.trace.Tracer`` (None outside a trace, which
runs on ``meta`` tensors only).  Every kernel wrapper is decorated with
``kernel_call``: its ``note_call`` opens the call in the tracer (also a
recorder), and its result, reported to ``TRACE`` with the wrapper's
arguments, closes it, so the call becomes one node of the traced graph,
as a ``pallas_call`` is one node of the reference's jaxpr.  On the card's
path that is one check of this module-level name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
from typing import Callable, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One hand-written kernel of the port.

    ``source`` is the CUDA file under ``repro_torch/csrc/``; ``replaces``
    names the Pallas kernel it ports (file:line of the function that
    reaches ``pl.pallas_call``).
    """

    name: str
    describe: str
    source: str
    replaces: str
    epsilon: float
    dispatch_min_size: int = 0


KERNELS: dict[str, KernelSpec] = {
    "circ_conv": KernelSpec(
        name="circ_conv",
        describe="blockwise circular conv/corr of N×B pairs (VSA bind/unbind)",
        source="circ_conv.cu",
        replaces="src/repro/kernels/circ_conv/kernel.py:89",
        epsilon=1e-3, dispatch_min_size=128),
    "qmatmul": KernelSpec(
        name="qmatmul",
        describe="int8 x int8 / packed-int4 matmul with per-row and "
                 "per-column scales (quantised attribute heads)",
        source="qmatmul.cu",
        replaces="src/repro/kernels/qmatmul/kernel.py:55",
        epsilon=1e-3),
    "unbind_classify": KernelSpec(
        name="unbind_classify",
        describe="fused VSA unbind (circular correlation) -> dense classify "
                 "head; one launch for MIMONet's symbolic tail",
        source="unbind_classify.cu",
        replaces="src/repro/kernels/unbind_classify/kernel.py:56",
        epsilon=1e-3, dispatch_min_size=128),
    "circ_dict": KernelSpec(
        name="circ_dict",
        describe="N queries bound to each of M static dictionary entries "
                 "(circ_bind_dict); the reference registers it under "
                 "circ_conv.  A kernel-level wrapper: no dispatch floor",
        source="circ_dict.cu",
        replaces="src/repro/kernels/circ_conv/kernel.py:115",
        epsilon=1e-3),
    "simd_fused": KernelSpec(
        name="simd_fused",
        describe="fused blockwise normalise / dot / softmax match_prob "
                 "(the SIMD unit)",
        source="simd_fused.cu",
        replaces="src/repro/kernels/simd_fused/kernel.py:44",
        epsilon=1e-3, dispatch_min_size=128),
    "flash_attn": KernelSpec(
        name="flash_attn",
        describe="causal online-softmax attention over (B, S, H, hd), "
                 "k/v pre-repeated to H heads",
        source="flash_attn.cu",
        replaces="src/repro/kernels/flash_attn/kernel.py:66",
        epsilon=3e-2),
}

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
_RECORDERS: list = []   # open ``record_kernels`` lists and the open trace
TRACE = None            # the open ``core.trace.Tracer``, None outside a trace


@contextlib.contextmanager
def record_kernels() -> Iterator[list]:
    """Collect ``(kernel, route)`` for every kernel call while open: route
    ``"kernel"`` from a wrapper (whatever the device), ``"gather"`` from a
    dispatch below the kernel's floor."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def note_call(kernel: str, route: str = "kernel") -> None:
    """Called by a kernel wrapper on every call (and by ``dispatch_path``
    for the gather route); appends to every open ``record_kernels``."""
    for rec in _RECORDERS:
        rec.append((kernel, route))


def kernel_call(kernel: str) -> Callable[[Callable], Callable]:
    """Decorator of ``kernel``'s wrapper: each call is noted to the open
    recorders (``note_call``) and, inside a trace, reported to ``TRACE``
    with the wrapper's arguments by name once it returns."""

    def wrap(fn: Callable) -> Callable:
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            note_call(kernel)
            out = fn(*args, **kwargs)
            if TRACE is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                TRACE.kernel(kernel, out, bound.arguments)
            return out

        return call

    return wrap


def count_launch(kernel: str) -> None:
    """Called by a kernel wrapper right after its launch succeeded."""
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a backward that ``kernel`` does not
    have (as its Pallas twin has no VJP): grad mode on and an input that
    requires grad.  Called by a forward-only wrapper before its launch, so
    that a CUDA output never silently lacks a ``grad_fn``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward on the card (nor has the reference's "
            f"kernel): call it under torch.no_grad() or on inputs that do not "
            f"require grad")


def on_card(t: torch.Tensor) -> bool:
    """True when ``t`` must go to the hand kernel (a CUDA tensor), False
    for the plain version (CPU, or ``meta`` for shape evaluation)."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def dispatch_path(kernel: str, size: int) -> str:
    """``"kernel"`` when a call at block dim ``size`` goes to ``kernel``'s
    wrapper, ``"gather"`` when it stays on the exact reference (below the
    kernel's ``dispatch_min_size``).  Independent of the device.  The
    gather route is noted to ``record_kernels``; the kernel route is noted
    by the wrapper it leads to."""
    if size < KERNELS[kernel].dispatch_min_size:
        note_call(kernel, "gather")
        return "gather"
    return "kernel"


def resolve_device(device=None) -> torch.device:
    """An entry point's ``device=``: None means ``"cuda"``.  Asking for
    CUDA on a host without it raises; nothing carries on on the CPU unless
    the caller asked for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
