"""Error-feedback int8 gradient compression for a reduction over a world.

The port of ``repro.distributed.compression``.  Quantising each rank's
gradient to int8 and one f32 scale per tensor, with error feedback, keeps
convergence (the residual re-injects each step's quantisation error into
the next).

``compressed_psum(g, axis)`` runs inside an SPMD body (``World.spmd``):
an all-gather of every rank's int8 payload and f32 scale
(``constraints.all_gather``, exact) and a local dequantised sum.  That
all-gather is an all_reduce of a zero-filled buffer with one slot a rank,
so each of n ranks hands gloo n x numel int8 bytes: n / 4 of an f32
psum's bytes (half at n = 2, the same at n = 4), not the reference's
quarter at every n.

``quantize`` divides by a 0-d tensor: PyTorch on CUDA divides by a Python
scalar through a reciprocal, which sends some ``round(g / scale)`` ties
the other way (ROADMAP, "Exact division on the card").
"""

from __future__ import annotations

import torch

from repro_torch.common.tree import tree_map
from repro_torch.distributed import constraints as tpc


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8 like ``g``, scale f32 0-d): ``g ~= q * scale``, ``|q| <= 127``."""
    amax = torch.clamp(g.abs().max(), min=1e-12)
    scale = (amax / torch.tensor(127.0, dtype=amax.dtype, device=amax.device)).float()
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``g``, each quantised: int8 and
    one f32 scale per rank on the wire, in slots of one buffer for all n
    ranks (n / 4 of an f32 psum's bytes a rank).  Within ``sum of scale /
    2`` of the exact sum, elementwise."""
    q, scale = quantize(g)
    qs = tpc.all_gather(q, axis)            # (n, ...) int8
    ss = tpc.all_gather(scale, axis)        # (n,) f32
    return torch.tensordot(ss, qs.float(), dims=1)


def ef_compress_tree(grads, residuals):
    """One error-feedback step: quantise ``g + residual`` leaf by leaf.
    Returns (a tree of ``(q, scale)`` pairs, the new f32 residuals)."""
    def one(g, r):
        x = g.float() + r
        q, s = quantize(x)
        return (q, s), x - dequantize(q, s)

    pairs = tree_map(one, grads, residuals)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def ef_decompress_tree(payload):
    """The dequantised tree of ``ef_compress_tree``'s payload: a tuple of
    two is a ``(q, scale)`` pair, as the reference's ``is_leaf`` reads it."""
    if isinstance(payload, tuple) and len(payload) == 2:
        return dequantize(*payload)
    if isinstance(payload, dict):
        return {k: ef_decompress_tree(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(ef_decompress_tree(v) for v in payload)
    return payload


def init_residuals(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)
