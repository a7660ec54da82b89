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

Every rank computes the same whole activations, and a tensor is either
whole (the same bits on every rank) or the rank's part.  The combines move
between the two, and each is a ``torch.autograd.Function`` whose backward
is its transpose, so a loss over a world's cut gives each rank's cut leaf
the single device's gradient of its slice:

- ``reduce_partial(x)``: the sum over ranks of a row-parallel partial
  product.  Backward: the identity (the whole gradient is every partial's);
- ``gather_last(x)`` / ``whole(t, dim)``: a dim cut over the ranks made
  whole, as an all_reduce of a zero-filled whole buffer each rank fills at
  its slice (adding zeros is exact, so every rank gets the same bits).
  Backward: the rank's slice of the whole gradient, no collective;
- ``take_local(x, dim)`` / ``take(x, dim, lo, hi)``: a whole ``x`` narrowed
  to the rank's part.  Backward: the part's gradient in zeros of the
  whole, summed over the ranks (the forward of ``whole``);
- ``copy_in(x)`` (Megatron's *f*): a whole ``x`` entering a product with a
  weight cut along its output dim.  The identity; backward: the ranks'
  partial gradients summed;
- ``reduce_scatter(x, dim)``: the rank's slice of the sum of the ranks'
  partial ``x``: each rank's chunks exchanged in one gloo ``all_to_all``
  on host copies (pinned, from the card), the chunks a rank receives summed
  in rank order, so each rank sends and receives ``(size - 1) / size`` of
  ``x`` where an all_reduce moves twice that.  Backward: the whole of the
  slices' gradients (``whole``);
- ``whole(t)`` with no dim: a parameter leaf read whole.  The layers read
  whole only norm scales, q/k norms, biases and rwkv's token-shift mixes;
  ``sharding_rules.cut_leaf`` keeps the whole of each beside its cut
  (``tp_whole``), so no forward pays a collective for them.  Backward: the
  kept whole's gradient (whole, the same on every rank) sliced to the
  cut; ``local(t)`` of a leaf cut along another dim reads a part of the
  whole, so ``take_local``'s backward sums its gradient first.  The
  optimizer makes each kept whole the whole of the updated cut after a
  step (``wholes``, one collective a dtype).

Serving, training and the dry-run call the same functions: without grad,
or on a tensor that needs none, autograd records nothing and the forward
runs alone.  Every collective is an exact combine on gloo's
``all_reduce`` (which PyTorch documents for gloo on CUDA tensors, with
``broadcast`` and ``barrier``), but ``reduce_scatter``'s exchange.  A
backward reduces a copy of its gradient: autograd may hand one tensor to
two consumers, and ``_all_reduce`` reduces in place.

**Collective order in the backward.**  Every rank must enter the same
collectives in the same order.  Each combine keeps the context it ran in
(it reads no module global in its backward), every rank builds the same
graph, and autograd's engine runs the nodes of one device on one thread
(the caller's for the CPU, the device's own for a card) in an order the
graph fixes: its ready queue is ordered by each node's sequence number,
which the forward assigns in program order on every rank.  Remat
(``torch.utils.checkpoint`` under ``remat=True``) replays a unit's
forward, its combines included, inside the backward, where the context
opened around the step is still the module's ``_CURRENT``.  A rank that
meets another collective than its peers waits in gloo until the group's
timeout (``world.WORLD_TIMEOUT_S``) and raises, and the world breaks
(``entered()`` counts every collective, the backward's too).

Each collective is counted in the context's ``phases``, by the phase of
the step it ran in (``forward``, ``backward`` with remat's replay,
``optimizer``; ``phase(name)``) and op: (count, seconds, bytes), the bytes
those of the buffer each rank hands gloo's all_reduce (a reduce-scatter's
slice, ``N / size`` of its input).  ``stats`` (op -> (count, seconds)) and
``nbytes`` (op -> bytes) sum them over the phases.  With ``timed`` set,
the device is synchronised around each collective and its host seconds
are added too (a measurement mode: it costs a sync per collective).  A
context with no group (``group=None``) runs no collective but records each
one as if it had: the dry-run (``launch/dryrun.py``) traces a rank's step
on ``meta`` under such a context to read the step's collectives, the
backward's included.

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
import math
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
    phase: str = "forward"
    phases: dict = dataclasses.field(default_factory=dict)

    @property
    def mesh(self) -> Mesh:
        return make_host_mesh(data=1, model=self.size)

    def note(self, op: str, seconds: float = 0.0, nbytes: int = 0) -> None:
        """Count one ``op`` in the phase it ran in: ``phases[phase][op]`` is
        (count, seconds, bytes handed to the collective), summed."""
        by_op = self.phases.setdefault(self.phase, {})
        count, total, moved = by_op.get(op, (0, 0.0, 0))
        by_op[op] = (count + 1, total + seconds, moved + nbytes)

    def _totals(self) -> dict:
        out: dict = {}
        for ops in self.phases.values():
            for op, (n, sec, b) in ops.items():
                n0, sec0, b0 = out.get(op, (0, 0.0, 0))
                out[op] = (n0 + n, sec0 + sec, b0 + b)
        return out

    @property
    def stats(self) -> dict:
        """op -> (count, seconds) over every phase."""
        return {op: (n, sec) for op, (n, sec, _) in self._totals().items()}

    @property
    def nbytes(self) -> dict:
        """op -> bytes over every phase."""
        return {op: b for op, (_, _, b) in self._totals().items()}


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


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Count the open context's collectives inside under phase ``name``
    (nothing outside a context)."""
    ctx = _CURRENT
    if ctx is None:
        yield
        return
    prev, ctx.phase = ctx.phase, name
    try:
        yield
    finally:
        ctx.phase = prev


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


def _gather(x: torch.Tensor, dim: int, lo: int, n: int, op: str,
            ctx: TPContext) -> torch.Tensor:
    """A whole of size ``n`` along ``dim``: each rank's ``x`` placed at its
    [lo, lo + x.shape[dim]) of a zero-filled buffer, summed over ranks."""
    shape = list(x.shape)
    shape[dim] = n
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, lo, x.shape[dim]).copy_(x)
    return _all_reduce(buf, op, ctx)


def _reduce_scatter(x: torch.Tensor, dim: int, op: str, ctx: TPContext) -> torch.Tensor:
    """The rank's slice along ``dim`` of the sum over ranks of ``x``: chunk
    ``j`` of every rank's ``x`` sent to rank ``j`` by one gloo
    ``all_to_all`` on host copies (gloo takes only all_reduce and broadcast
    on CUDA tensors; from the card through pinned memory), the chunks the
    rank receives summed in rank order on ``x``'s device."""
    global _ENTERED
    part = x.shape[dim] // ctx.size
    nbytes = x.numel() * x.element_size() // ctx.size if ctx.size > 1 else 0
    if ctx.group is None or ctx.size == 1:
        ctx.note(op, nbytes=nbytes)
        return x.narrow(dim, ctx.rank * part, part).clone()
    _ENTERED += 1
    if ctx.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    chunks = x.unflatten(dim, (ctx.size, part)).movedim(dim, 0)   # chunk j for rank j
    send, recv = (torch.empty(chunks.shape, dtype=x.dtype, pin_memory=x.is_cuda)
                  for _ in range(2))
    send.copy_(chunks, non_blocking=x.is_cuda)
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    ctx.group.alltoall_base(recv, send, [], []).wait()
    got = recv.to(x.device, non_blocking=x.is_cuda)
    y = got[0]
    for j in range(1, ctx.size):
        y = y + got[j]
    if ctx.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        ctx.note(op, time.perf_counter() - t0, nbytes)
    else:
        ctx.note(op, nbytes=nbytes)
    return y


class _ReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _all_reduce(x.clone(), "reduce_partial", ctx)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx, op):
        fctx.dim, fctx.lo, fctx.n = dim, ctx.rank * x.shape[dim], x.shape[dim]
        return _gather(x, dim, fctx.lo, x.shape[dim] * ctx.size, op, ctx)

    @staticmethod
    def backward(fctx, g):
        return g.narrow(fctx.dim, fctx.lo, fctx.n), None, None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, lo, hi, ctx):
        fctx.dim, fctx.lo, fctx.n, fctx.ctx = dim, lo, x.shape[dim], ctx
        return x.narrow(dim, lo, hi - lo)

    @staticmethod
    def backward(fctx, g):
        return _gather(g, fctx.dim, fctx.lo, fctx.n, "take_local", fctx.ctx), None, None, \
            None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format), "copy_in",
                           fctx.ctx), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dim, fctx.ctx = dim, ctx
        return _reduce_scatter(x, dim, "reduce_scatter", ctx)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        n = g.shape[fctx.dim]
        return _gather(g, fctx.dim, ctx.rank * n, n * ctx.size, "reduce_scatter_grad",
                       ctx), None, None


class _WholeLeaf(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, whole_t, dim, lo):
        fctx.dim, fctx.lo, fctx.n = dim, lo, t.shape[dim]
        return whole_t.detach()

    @staticmethod
    def backward(fctx, g):
        return g.narrow(fctx.dim, fctx.lo, fctx.n), None, None, None


def take(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """[lo, hi) along ``dim`` of a whole ``x``: the rank's part (a view),
    whose gradient the backward makes whole over the ranks (op
    ``take_local``); ``x`` itself where [lo, hi) is all of it (it stays
    whole)."""
    ctx = _CURRENT
    dim %= x.dim()
    if ctx is None or (lo, hi) == (0, x.shape[dim]):
        return x
    return _Take.apply(x, dim, lo, hi, ctx)


def take_local(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of a whole ``x`` along ``dim`` (``take``)."""
    if _CURRENT is None:
        return x
    return take(x, dim, *local_range(x.shape[dim]))


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """A whole ``x`` as the input of the rank's part of a product
    (Megatron's *f*: a weight cut along its output dim, a narrowing by
    index): the identity, whose backward sums the ranks' partial
    gradients."""
    ctx = _CURRENT
    if ctx is None:
        return x
    return _CopyIn.apply(x, ctx)


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


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """The sum over the group's ranks of each rank's partial ``x`` (the
    identity outside a group)."""
    ctx = _CURRENT
    if ctx is None:
        return x
    return _ReducePartial.apply(x, ctx)


def reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The rank's slice along ``dim`` of the sum over the group's ranks of
    each rank's partial ``x`` (the identity outside a group)."""
    ctx = _CURRENT
    if ctx is None:
        return x
    return _ReduceScatter.apply(x, dim % x.dim(), ctx)


def whole(t: torch.Tensor, dim: int | None = None, op: str = "whole") -> torch.Tensor:
    """``t`` made whole along ``dim``: each rank's slice placed in a
    zero-filled whole buffer, summed over ranks.  With no ``dim``, ``t`` is
    a parameter leaf: the whole kept beside its cut (``tp_whole``), or
    ``t`` itself where it was not cut."""
    ctx = _CURRENT
    if ctx is None:
        return t
    if dim is None:
        cut = model_dim(t)
        if cut is None:
            return t
        whole_t = getattr(t, "tp_whole", None)
        if whole_t is None:
            raise RuntimeError(
                f"a parameter leaf of shape {tuple(t.shape)} cut along dim "
                f"{cut} is read whole, but its cut kept no whole copy "
                "(sharding_rules.reads_whole)")
        return _WholeLeaf.apply(t, whole_t, cut, ctx.rank * t.shape[cut])
    return _Gather.apply(t, dim % t.dim(), ctx, op)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """A last dim cut over the ranks made whole (the identity outside a
    group)."""
    if _CURRENT is None:
        return x
    return whole(x, -1, op="gather_last")


def sum_over_ranks(x: torch.Tensor, op: str) -> torch.Tensor:
    """The sum over the group's ranks of a copy of ``x`` (no gradient;
    ``x`` itself outside a group)."""
    if _CURRENT is None:
        return x
    return _all_reduce(x.detach().clone(), op)


def wholes(cuts: list) -> list:
    """The whole of each cut leaf of ``cuts`` (each carries ``tp_dim``), made
    whole exactly in one collective per dtype (op ``refresh_whole``): every
    rank places its cuts at their slices of one zero-filled buffer, summed
    over the ranks."""
    ctx = _CURRENT
    out: list = [None] * len(cuts)
    by_dtype: dict = {}
    for i, t in enumerate(cuts):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        shapes = []
        for i in idx:
            shape = list(cuts[i].shape)
            shape[cuts[i].tp_dim] *= ctx.size
            shapes.append(shape)
        sizes = [math.prod(s) for s in shapes]
        buf = torch.zeros(sum(sizes), dtype=dtype, device=cuts[idx[0]].device)
        views = [v.view(s) for v, s in zip(buf.split(sizes), shapes)]
        for i, v in zip(idx, views):
            dim, n = cuts[i].tp_dim, cuts[i].shape[cuts[i].tp_dim]
            v.narrow(dim, ctx.rank * n, n).copy_(cuts[i])
        _all_reduce(buf, "refresh_whole")
        for i, v in zip(idx, views):
            out[i] = v
    return out


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
