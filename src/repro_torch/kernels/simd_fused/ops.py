"""Wrapper of the fused match_prob kernel (``csrc/simd_fused.cu``).

``fused_match_prob`` is the kernel call: it takes any layout (copied
contiguous first); on a CUDA tensor it launches the Hopper kernel or
raises; on a CPU or ``meta`` tensor it runs the plain version in ``ref``.
It is differentiable: the backward is the autograd of the reference's
plain chain (``ref.match_prob_chain``), as the reference's custom VJP.
The JAX package has no backward kernel, so neither has the port.  Where
autograd records nothing (grad mode off, or no input that requires grad)
the wrapper launches the kernel without the autograd Function.

A call is one launch and allocates only its output.  The grid is
(query tiles of ``QUERY_TILE``) x S CTAs, and the S CTAs of a tile are one
thread-block cluster that splits the dictionary's M entries between them;
``cluster_size`` picks S, and ``smem_bytes`` repeats the kernel's
shared-memory formula.  Each CTA keeps its slice's logits in shared
memory, so M is bounded by ``max_entries``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.simd_fused import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
QUERY_TILE = 4                 # simd_fused.cu's TQ: queries per CTA
PASS = 32                      # simd_fused.cu's PASS: entries a CTA takes at once
MAX_CLUSTER = 8                # the portable cluster size
SMS = 132                      # an H100's streaming multiprocessors
_MAX_SMEM = 227 * 1024         # Hopper's per-block shared memory
_RING = 16 * 256 * 3 * 4       # simd_fused.cu's rings: THREADS x RING x E 16-byte units


def smem_bytes(entries: int, blocks: int, d: int, elt: int = 4) -> int:
    """simd_fused.cu's dynamic shared memory for a CTA holding ``entries``
    logits per query at (blocks, d) and element size ``elt``: the
    threads' rings of dictionary units, the query tile (rows padded to 16
    bytes), the tile's B scales, the cluster's exchange slots and the
    logits."""
    w = 16 // elt
    dp = -(-d // w) * w
    return (_RING + QUERY_TILE * blocks * dp * elt + 4 * QUERY_TILE * blocks
            + 8 * QUERY_TILE + 4 * QUERY_TILE * entries)


@functools.lru_cache(maxsize=64)
def slice_entries(blocks: int, d: int) -> int:
    """The most entries one CTA takes at (blocks, d), f32 (bf16 needs less
    shared memory): what is left of it for the logits."""
    return max(0, (_MAX_SMEM - smem_bytes(0, blocks, d)) // (4 * QUERY_TILE))


def max_entries(blocks: int, d: int) -> int:
    """Largest dictionary M the kernel takes at (blocks, d): a cluster of
    ``MAX_CLUSTER`` CTAs, each holding ``slice_entries`` logits per query
    (83408 at 4 x 256)."""
    return MAX_CLUSTER * slice_entries(blocks, d)


@functools.lru_cache(maxsize=256)
def cluster_size(n: int, m: int, blocks: int, d: int) -> int:
    """The cluster size S of a call: enough CTAs per query tile that tiles
    x S about fills the card's ``SMS`` (S = 1 at N = 512, 8 at N = 64), at
    most ``MAX_CLUSTER`` and no more ranks than the dictionary has passes
    of ``PASS`` entries (a smaller slice leaves warps idle and adds the
    cluster's exchange: S = 1 at M = 16), and at least what the slices need
    to fit shared memory; then the fewest ranks that give each its
    ceil(M / S) entries, so that none is empty."""
    tiles = -(-n // QUERY_TILE)
    s = max(1, min(MAX_CLUSTER, SMS // max(tiles, 1), -(-m // PASS)),
            -(-m // max(slice_entries(blocks, d), 1)))
    return -(-m // -(-m // s))


def _launch(q: torch.Tensor, dictionary: torch.Tensor, temp: float) -> torch.Tensor:
    if q.dim() != 3 or dictionary.dim() != 3 or q.shape[1:] != dictionary.shape[1:]:
        raise ValueError(f"fused_match_prob wants q (N, B, d) and a dictionary "
                         f"(M, B, d), got {tuple(q.shape)} and "
                         f"{tuple(dictionary.shape)}")
    if q.dtype not in _DTYPES or dictionary.dtype != q.dtype:
        raise TypeError(f"fused_match_prob takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype} and {dictionary.dtype}")
    index = q.get_device()
    if dictionary.get_device() != index:
        raise ValueError(f"q on {q.device}, dictionary on {dictionary.device}")
    if not (q.is_contiguous() and dictionary.is_contiguous()):
        raise ValueError("fused_match_prob needs contiguous inputs")
    n, b, d = q.shape
    m = dictionary.shape[0]
    if b * d == 0:
        raise ValueError(f"fused_match_prob needs B, d >= 1, got {(b, d)}")
    if m > max_entries(b, d):
        raise ValueError(f"M={m} dictionary entries exceed the kernel's shared "
                         f"memory at (B, d) = {(b, d)}: M <= {max_entries(b, d)}")
    if n >= 2 ** 31 - QUERY_TILE:
        raise ValueError(f"N={n} exceeds the kernel's grid")
    out = q.new_empty((n, m), dtype=torch.float32)
    if n == 0 or m == 0:
        return out
    _build.launch("simd_fused", index, q.data_ptr(), dictionary.data_ptr(),
                  out.data_ptr(), n, m, b, d, cluster_size(n, m, b, d), float(temp),
                  _DTYPES[q.dtype])
    registry.count_launch("simd_fused")
    return out


class _FusedMatchProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, dictionary, temp):
        ctx.temp = temp
        ctx.save_for_backward(q, dictionary)
        if registry.on_card(q):
            return _launch(q, dictionary, temp)
        return ref.fused_match_prob_ref(q, dictionary, temp)

    @staticmethod
    def backward(ctx, g):
        q, dictionary = ctx.saved_tensors
        with torch.enable_grad():
            qq = q.detach().requires_grad_()
            dd = dictionary.detach().requires_grad_()
            gq, gd = torch.autograd.grad(ref.match_prob_chain(qq, dd, ctx.temp),
                                         (qq, dd), g)
        return gq, gd, None


@registry.kernel_call("simd_fused")
def fused_match_prob(q: torch.Tensor, dictionary: torch.Tensor,
                     temp: float = 1.0) -> torch.Tensor:
    """q: (N, B, d), dictionary: (M, B, d), f32 or bf16 -> probs (N, M)
    f32: softmax over M of the mean blockwise cosine similarity / temp."""
    if not q.is_contiguous():
        q = q.contiguous()
    if not dictionary.is_contiguous():
        dictionary = dictionary.contiguous()
    if registry.on_card(q) and not (torch.is_grad_enabled() and (
            q.requires_grad or dictionary.requires_grad)):
        return _launch(q, dictionary, temp)  # autograd records nothing
    return _FusedMatchProb.apply(q, dictionary, temp)
