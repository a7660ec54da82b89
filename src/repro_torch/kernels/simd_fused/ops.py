"""Wrapper of the fused match_prob kernel (``csrc/simd_fused.cu``).

``fused_match_prob`` is the kernel call, an autograd function that takes
any layout (copied contiguous first): its forward launches the Hopper
kernel on a CUDA tensor (or raises) and runs the plain version in ``ref``
on a CPU tensor; its backward is the autograd of the
reference's plain chain (``ref.match_prob_chain``), as the reference's
custom VJP does.  The JAX package has no backward kernel, so neither has
the port.

The kernel keeps a query tile's logits and rows in shared memory and
streams the dictionary through it, so M is bounded by ``max_entries``.
"""

from __future__ import annotations

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.simd_fused import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_FLOATS = 227 * 1024 // 4   # Hopper's per-block shared memory, in floats
QUERY_TILE = 4                   # simd_fused.cu's TQ: queries per block


def max_entries(blocks: int, d: int) -> int:
    """Largest dictionary M the kernel takes at (blocks, d): a tile's
    ``QUERY_TILE`` query rows and ``QUERY_TILE`` x M logits plus one
    dictionary entry must fit in shared memory (13248 at 4 x 256)."""
    return (_SMEM_FLOATS - (QUERY_TILE + 1) * blocks * d) // QUERY_TILE


def _launch(q: torch.Tensor, dictionary: torch.Tensor, temp: float) -> torch.Tensor:
    if q.dim() != 3 or dictionary.dim() != 3 or q.shape[1:] != dictionary.shape[1:]:
        raise ValueError(f"fused_match_prob wants q (N, B, d) and a dictionary "
                         f"(M, B, d), got {tuple(q.shape)} and "
                         f"{tuple(dictionary.shape)}")
    if q.dtype not in _DTYPES or dictionary.dtype != q.dtype:
        raise TypeError(f"fused_match_prob takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype} and {dictionary.dtype}")
    if dictionary.device != q.device:
        raise ValueError(f"q on {q.device}, dictionary on {dictionary.device}")
    if not (q.is_contiguous() and dictionary.is_contiguous()):
        raise ValueError("fused_match_prob needs contiguous inputs")
    n, b, d = q.shape
    m = dictionary.shape[0]
    if m > max_entries(b, d):
        raise ValueError(f"M={m} dictionary entries exceed the kernel's shared "
                         f"memory at (B, d) = {(b, d)}: M <= {max_entries(b, d)}")
    if n >= 2 ** 31 - QUERY_TILE or m * b >= 2 ** 31:
        raise ValueError(f"(N, M, B) = {(n, m, b)} exceeds the kernel's grid")
    out = torch.empty((n, m), dtype=torch.float32, device=q.device)
    if n == 0 or m == 0:
        return out
    f = b * d
    chunk = min(m, (_SMEM_FLOATS - QUERY_TILE * (f + m)) // f)
    scratch = torch.empty((m, b, d), dtype=torch.float32, device=q.device)
    _build.launch("simd_fused", q.get_device(), q.data_ptr(), dictionary.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), n, m, b, d, chunk, float(temp),
                  _DTYPES[q.dtype])
    registry.count_launch("simd_fused")  # one per call: normalise_rows + match
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


def fused_match_prob(q: torch.Tensor, dictionary: torch.Tensor,
                     temp: float = 1.0) -> torch.Tensor:
    """q: (N, B, d), dictionary: (M, B, d), f32 or bf16 -> probs (N, M)
    f32: softmax over M of the mean blockwise cosine similarity / temp."""
    registry.note_call("simd_fused")
    return _FusedMatchProb.apply(q.contiguous(), dictionary.contiguous(), temp)
