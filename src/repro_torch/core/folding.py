"""Mesh folding: the port's analogue of AdArray sub-array folding (Sec IV-B).

The port of ``repro.core.folding``.  NSFlow splits its systolic array into
sub-arrays so the NN and vector-symbolic streams run concurrently.  Over a
world (``World.spmd``) the same move is a split of the ranks along one
axis: ranks ``< n_l`` run the NN stream on their row shard of the NN batch
while the other ``n_v`` run the VSA stream on theirs, and each stream's
output is put together exactly: every rank writes its rows into a
zero-filled whole and the ranks' wholes are summed (``constraints.psum``),
as the reference's ``lax.cond`` branch and ``psum`` do.  The DSE's
(N_l : N_v) partition (Algorithm 1) chooses the split.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import constraints as tpc


def make_folded_fn(mesh, axis: str, n_l: int, nn_fn: Callable, vsa_fn: Callable,
                   nn_out_shape, vsa_out_shape):
    """Build ``f(nn_x, vsa_x) -> (nn_out, vsa_out)`` (f32), the two streams
    run concurrently on disjoint rank groups of ``axis`` (sizes n_l : n_v),
    inside an SPMD body over ``axis`` of ``mesh``.

    nn_x: (B_nn, ...), row-sharded across the first n_l ranks; vsa_x:
    (B_vsa, ...), row-sharded across the others.  Every rank passes both;
    shapes must divide by their group's size."""
    n_total = mesh.shape[axis]
    n_v = n_total - n_l
    if not 0 < n_l < n_total:
        raise ValueError(f"n_l={n_l} leaves no rank for one stream of {n_total}")

    def wrapped(nn_x, vsa_x):
        ctx = tpc.spmd_current(axis)
        if ctx.size != n_total:
            raise ValueError(f"a fold over {n_total} ranks on a world of {ctx.size}")
        for name, x, n in (("nn_x", nn_x, n_l), ("vsa_x", vsa_x, n_v)):
            if x.shape[0] % n:
                raise ValueError(f"{name}: {x.shape[0]} rows over {n} ranks")
        idx = ctx.rank
        nn_out = torch.zeros(nn_out_shape, dtype=torch.float32, device=nn_x.device)
        vsa_out = torch.zeros(vsa_out_shape, dtype=torch.float32, device=vsa_x.device)
        if idx < n_l:
            n = nn_x.shape[0] // n_l
            nn_out[idx * n:(idx + 1) * n] = nn_fn(nn_x[idx * n:(idx + 1) * n]).float()
        else:
            n = vsa_x.shape[0] // n_v
            j = idx - n_l
            vsa_out[j * n:(j + 1) * n] = vsa_fn(vsa_x[j * n:(j + 1) * n]).float()
        return tpc.psum(nn_out, axis), tpc.psum(vsa_out, axis)

    return wrapped
