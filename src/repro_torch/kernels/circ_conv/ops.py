"""Wrappers of the circ_conv kernel (``csrc/circ_conv.cu``).

``circ_elem`` is the kernel call: on a CUDA tensor it launches the Hopper
kernel or raises; on a CPU tensor it runs the plain version in ``ref``.
``circ_bind`` is what ``vsa.bind`` / ``vsa.unbind`` call: it broadcasts the
leading dims, materialises them contiguous and flattens to (N, B, d).

Forward only: the autograd function and its backward kernels (conv:
da = corr(b, g), db = corr(a, g); corr: da = corr(g, b), db = conv(g, a))
come with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.circ_conv import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024   # bytes of shared memory one block may use on Hopper


def _launch(x: torch.Tensor, y: torch.Tensor, mode: str) -> torch.Tensor:
    if mode not in ("conv", "corr"):
        raise ValueError(f"mode must be 'conv' or 'corr', got {mode!r}")
    if x.dim() != 3 or x.shape != y.shape:
        raise ValueError(f"circ_elem wants two (N, B, d) tensors of one shape, "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"circ_elem takes float32 or bfloat16 of one dtype, "
                        f"got {x.dtype} and {y.dtype}")
    if y.device != x.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("circ_elem needs contiguous inputs")
    n, b, d = x.shape
    if 2 * d * 4 > _MAX_SMEM:
        raise ValueError(f"block dim d={d} exceeds the kernel's shared memory")
    rows = n * b
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = _build.entry("circ_conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), rows, d,
                _DTYPES[x.dtype], int(mode == "corr"), stream)
    _build.check(rc, "circ_conv")
    registry.count_launch("circ_conv")
    return out


def circ_elem(x: torch.Tensor, y: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """Pairwise binding. x, y: (N, B, d) -> (N, B, d), output in x's dtype.

    ``mode`` is ``"conv"`` (out[n] = Σ_k x[k]·y[(n−k) mod d]) or ``"corr"``
    (out[n] = Σ_k x[k]·y[(n+k) mod d])."""
    registry.note_call("circ_conv")
    if registry.on_card(x):
        return _launch(x, y, mode)
    return ref.circ_elem_ref(x, y, mode)


def circ_bind(a: torch.Tensor, b: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """Elementwise blockwise circular conv/corr with leading-dim broadcast.

    a, b: (..., blocks, d) -> (..., blocks, d)."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-2]
    blocks, d = a.shape[-2:]
    af = a.reshape(-1, blocks, d).contiguous()
    bf = b.reshape(-1, blocks, d).contiguous()
    return circ_elem(af, bf, mode).reshape(*lead, blocks, d)
