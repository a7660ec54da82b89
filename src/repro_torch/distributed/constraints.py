"""The tensor-parallel group of the running code, and its collectives.

The counterpart of ``repro.distributed.constraints``.  The reference's
``maybe_constrain`` hands GSPMD a sharding hint when an ambient mesh
exists and is the identity otherwise.  Here the ambient object is a
process group: ``tp_group(ctx)`` opens a ``TPContext``, which holds the
group, the rank, the world size and the sharding rules, and the layers
(``nn/layers.py``, ``nn/attention.py``, ``nn/moe.py``) read it to compute
their rank's part and to combine the parts.  Without a group every helper
is the identity and no layer leaves its single-process path, so that path
stays bit for bit what it was.

Where each parameter leaf was cut is recorded on the leaf itself
(``tp_dim``, set by ``sharding_rules.shard_leaf``; ``models/lm.py``'s
``_unstack`` carries it to each layer's view of a stacked leaf):
``model_dim(t)`` reads it.  Caches and activations are the layers' own and
follow from the same rules (``attention.tp_heads``).

The collectives use only ``all_reduce`` (a sum), which PyTorch documents
for gloo on CUDA tensors (with ``broadcast`` and ``barrier``):

- ``reduce_partial(x)``: the sum over ranks of a row-parallel partial
  product;
- ``gather_last(x)``: a last dim cut over the ranks made whole, as an
  all_reduce of a zero-filled whole buffer each rank fills at its slice
  (adding zeros is exact, so every rank gets the same bits);
- ``whole(t, dim)``: the same along any dim.  A parameter leaf (one
  that carries ``tp_dim``) is not gathered: the layers read whole only
  norm scales, q/k norms and biases, and ``sharding_rules.cut_leaf``
  keeps the whole of each beside its cut (``tp_whole``), so no step pays
  a collective for them.

Each collective is counted per op in the context's ``stats`` (count,
seconds) and its bytes in ``nbytes`` (the buffer each rank hands gloo's
all_reduce); with ``timed`` set, the device is synchronised around it and
its host seconds are added too (a measurement mode: it costs a sync per
collective).  A context with no group (``group=None``) runs no collective
but records each one as if it had: the dry-run (``launch/dryrun.py``)
traces a rank's step on ``meta`` under such a context to read the step's
collectives.

**SPMD bodies** (``distributed/gpipe.py``, ``compression.py``,
``core/folding.py``), the counterparts of the reference's ``shard_map``
bodies, run under a second ambient context, ``spmd_group(ctx)`` with an
``SPMDContext`` (a world of one mesh axis; ``World.spmd`` opens it on
every rank), so the layers they call never see a tensor-parallel group.
They read ``axis_index`` and call ``psum``, ``all_gather`` and
``ppermute``, built on ``all_reduce`` as above and exact in the same way
(``all_gather`` and ``ppermute`` fill one slot of a zero-filled buffer of
a slot per rank; ``psum`` of addends that are zero on all ranks but one is
that addend).  ``ppermute`` is differentiable: its backward is the
reverse permute, as JAX transposes ``ppermute``; ``psum``'s backward hands
each rank the cotangent of the sum whole, since every rank computes the
same function of the replicated sum.
``entered()`` counts the collectives this process has entered, in any
context: the world reads it to tell a request refused before any
collective from a failure part-way through one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Iterator

import torch

from repro_torch.launch.mesh import Mesh, make_host_mesh

_CURRENT: "TPContext | None" = None
_SPMD: "SPMDContext | None" = None
_ENTERED = 0


@dataclasses.dataclass
class TPContext:
    """A tensor-parallel group as the layers see it.

    ``group`` is a ``torch.distributed`` process group (None for a world
    of one, whose collectives are the identity), ``rank`` / ``size`` the
    rank's index and the world size along ``model``; the parameters were
    cut by ``sharding_rules.world_pspec`` on ``mesh``."""

    group: Any
    rank: int
    size: int
    timed: bool = False
    stats: dict = dataclasses.field(default_factory=dict)
    nbytes: dict = dataclasses.field(default_factory=dict)

    @property
    def mesh(self) -> Mesh:
        return make_host_mesh(data=1, model=self.size)

    def note(self, op: str, seconds: float = 0.0, nbytes: int = 0) -> None:
        """Count one ``op``: ``stats[op]`` is (count, seconds), ``nbytes[op]``
        the bytes handed to the collective, summed."""
        count, total = self.stats.get(op, (0, 0.0))
        self.stats[op] = (count + 1, total + seconds)
        self.nbytes[op] = self.nbytes.get(op, 0) + nbytes


@dataclasses.dataclass
class SPMDContext(TPContext):
    """A world's group as an SPMD body sees it: one mesh axis named
    ``axis`` of ``size`` ranks, the rank's ``device``.  ``state`` persists
    on the rank from one ``World.spmd`` call to the next (a forward's graph
    kept for its backward)."""

    axis: str = "model"
    state: dict = dataclasses.field(default_factory=dict)
    device: str = "cpu"

    @property
    def mesh(self) -> Mesh:
        return Mesh((self.axis,), (self.size,))


def entered() -> int:
    """The collectives this process has entered so far (each counted as it
    starts, so one that fails counts too)."""
    return _ENTERED


def current() -> TPContext | None:
    """The open tensor-parallel context, None outside one."""
    return _CURRENT


@contextlib.contextmanager
def tp_group(ctx: TPContext) -> Iterator[TPContext]:
    """Open the tensor-parallel context ``ctx`` for the code inside."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev


def model_dim(t: torch.Tensor) -> int | None:
    """The dim a parameter leaf was cut along (None: whole, or no group)."""
    if _CURRENT is None:
        return None
    return getattr(t, "tp_dim", None)


def local_range(n: int) -> tuple[int, int]:
    """This rank's [lo, hi) of a dim of whole size ``n`` cut evenly."""
    ctx = _CURRENT
    if ctx is None:
        return 0, n
    part = n // ctx.size
    return ctx.rank * part, (ctx.rank + 1) * part


def take_local(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of a whole ``x`` along ``dim`` (a view)."""
    ctx = _CURRENT
    if ctx is None:
        return x
    lo, hi = local_range(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def local(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's slice along ``dim`` of a parameter leaf: the leaf itself
    where it was cut along ``dim``, else the slice of it (uncut) or of the
    whole it keeps (``tp_whole``; cut elsewhere).  The identity outside a
    group."""
    if _CURRENT is None:
        return t
    if model_dim(t) == dim % t.dim():
        return t
    return take_local(whole(t), dim)


def _all_reduce(x: torch.Tensor, op: str, ctx: TPContext | None = None) -> torch.Tensor:
    """The sum over ``ctx``'s ranks (the tensor-parallel context by
    default) of ``x``, in place; a context without a group records it (a
    group of one moves no bytes)."""
    global _ENTERED
    ctx = _CURRENT if ctx is None else ctx
    nbytes = x.numel() * x.element_size() if ctx.size > 1 else 0
    if ctx.group is None or ctx.size == 1:
        ctx.note(op, nbytes=nbytes)
        return x
    _ENTERED += 1
    x = x.contiguous()
    if ctx.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    ctx.group.allreduce([x]).wait()
    if ctx.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        ctx.note(op, time.perf_counter() - t0, nbytes)
    else:
        ctx.note(op, nbytes=nbytes)
    return x


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """The sum over the group's ranks of each rank's partial ``x`` (the
    identity outside a group)."""
    if _CURRENT is None:
        return x
    return _all_reduce(x.clone() if x._base is not None else x, "reduce_partial")


def whole(t: torch.Tensor, dim: int | None = None, op: str = "whole") -> torch.Tensor:
    """``t`` made whole along ``dim``: each rank's slice placed in a
    zero-filled whole buffer, summed over ranks.  With no ``dim``, ``t`` is
    a parameter leaf: the whole kept beside its cut (``tp_whole``), or
    ``t`` itself where it was not cut."""
    ctx = _CURRENT
    if ctx is None:
        return t
    if dim is None:
        if model_dim(t) is None:
            return t
        whole_t = getattr(t, "tp_whole", None)
        if whole_t is None:
            raise RuntimeError(
                f"a parameter leaf of shape {tuple(t.shape)} cut along dim "
                f"{model_dim(t)} is read whole, but its cut kept no whole copy "
                "(sharding_rules.reads_whole)")
        return whole_t
    dim %= t.dim()
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * ctx.size
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, ctx.rank * n, n).copy_(t)
    return _all_reduce(buf, op)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """A last dim cut over the ranks made whole (the identity outside a
    group)."""
    if _CURRENT is None:
        return x
    return whole(x, -1, op="gather_last")


# ---------------------------------------------------------------------------
# SPMD bodies: one mesh axis over a world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def spmd_group(ctx: SPMDContext) -> Iterator[SPMDContext]:
    """Open the SPMD context ``ctx`` for the body inside."""
    global _SPMD
    prev, _SPMD = _SPMD, ctx
    try:
        yield ctx
    finally:
        _SPMD = prev


def spmd_current(axis: str) -> SPMDContext:
    """The open SPMD context, which must be over ``axis``."""
    ctx = _SPMD
    if ctx is None:
        raise RuntimeError(f"no SPMD group over {axis!r} is open: run the body "
                           "through World.spmd (or spmd_group)")
    if ctx.axis != axis:
        raise ValueError(f"the open SPMD group is over {ctx.axis!r}, not {axis!r}")
    return ctx


def axis_index(axis: str) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    return spmd_current(axis).rank


def _slots(x: torch.Tensor, ctx: SPMDContext, op: str) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in its slot, exactly."""
    buf = torch.zeros((ctx.size, *x.shape), dtype=x.dtype, device=x.device)
    buf[ctx.rank].copy_(x)
    return _all_reduce(buf, op, ctx)


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """(size, *x.shape): each rank's ``x`` stacked in rank order
    (``jax.lax.all_gather``); no gradient."""
    return _slots(x.detach(), spmd_current(axis), "all_gather")


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _all_reduce(x.detach().clone(), "psum", ctx)

    @staticmethod
    def backward(fctx, g):
        return g, None


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` (``jax.lax.psum``)."""
    return _PSum.apply(x, spmd_current(axis))


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, src):
        fctx.ctx, fctx.dst = ctx, {s: d for d, s in src.items()}
        return _ppermute(x.detach(), ctx, src)

    @staticmethod
    def backward(fctx, g):
        return _ppermute(g, fctx.ctx, fctx.dst), None, None


def _ppermute(x: torch.Tensor, ctx: SPMDContext, src: dict) -> torch.Tensor:
    """Rank r receives ``x`` of rank ``src[r]`` (zeros where none sends)."""
    slots = _slots(x, ctx, "ppermute")
    s = src.get(ctx.rank)
    return torch.zeros_like(x) if s is None else slots[s].clone()


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) pairs;
    a rank no pair names as destination receives zeros.  Its backward is
    the reverse permute."""
    ctx = spmd_current(axis)
    return _PPermute.apply(x, ctx, {d: s for s, d in perm})
