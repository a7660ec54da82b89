"""GPipe pipeline parallelism over one mesh axis of a world.

The port of ``repro.distributed.gpipe``.  Stage s is rank s of a world
(``World.spmd``) and holds its own slice of the stacked parameters;
microbatches flow stage to stage by ``constraints.ppermute``, and the
schedule runs ``n_micro + n_stages - 1`` ticks, as the reference's
``scan`` does (bubble fraction (S - 1) / (M + S - 1)).  Every stage runs
``stage_fn`` at every tick and masks what is not its work, as the
reference does, so every rank builds the same graph: the permute's
backward is the reverse permute, and one backward on every rank trains the
pipelined model, the ranks meeting in the same collectives in the same
order.  Non-last stages contribute zeros to the final sum.

The masks are tensors (``torch.where``) even where the stage index could
decide in Python: a branch taken in Python would drop a permute from one
rank's graph, and that rank would then skip the permute's collective in
the backward.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import constraints as tpc


def pipeline_fwd(stage_fn: Callable, n_stages: int, axis: str, params_stage,
                 x_micro: torch.Tensor) -> torch.Tensor:
    """The GPipe schedule, inside an SPMD body over ``axis``.

    ``params_stage``: this stage's parameters; ``x_micro``: (n_micro, mb,
    ...) microbatches (every rank passes them; stage 0 reads them).
    Returns (n_micro, mb, ...): the outputs on the LAST stage, zeros on the
    others (the caller sums over ``axis``)."""
    stage = tpc.axis_index(axis)
    n_micro = x_micro.shape[0]
    dev = x_micro.device
    fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=dev)

    is_first = flag(stage == 0)
    held = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype, device=dev)
    outs = [torch.zeros_like(held) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        incoming = tpc.ppermute(held, axis, fwd_perm)
        my_in = torch.where(is_first, x_micro[min(t, n_micro - 1)], incoming)
        active = t >= stage and t - stage < n_micro
        out = torch.where(flag(active), stage_fn(params_stage, my_in), torch.zeros_like(held))
        mb = min(max(t - stage, 0), n_micro - 1)
        outs[mb] = torch.where(flag(active and stage == n_stages - 1), out, outs[mb])
        held = out
    return torch.stack(outs)


def make_pipelined_fn(stage_fn: Callable, n_stages: int, mesh, axis: str = "pod"):
    """``f(params_stage, x_micro) -> (n_micro, mb, ...)`` outputs, the same
    on every rank, to run inside an SPMD body over ``axis`` of ``mesh``
    (``n_stages`` ranks): ``params_stage`` is the rank's own stage, the
    leading stage dim of the reference's stacked parameters removed."""
    if mesh.shape[axis] != n_stages:
        raise ValueError(f"{n_stages} stages over an axis {axis!r} of {mesh.shape[axis]}")

    def wrapped(params_stage, x_micro):
        ctx = tpc.spmd_current(axis)
        if ctx.size != n_stages:
            raise ValueError(f"{n_stages} stages on a world of {ctx.size} ranks")
        outs = pipeline_fwd(stage_fn, n_stages, axis, params_stage, x_micro)
        return tpc.psum(outs, axis)   # non-last stages contribute zeros

    return wrapped


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
