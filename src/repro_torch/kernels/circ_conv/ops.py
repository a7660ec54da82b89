"""Wrappers of the circ_conv and circ_dict kernels (``csrc/circ_conv.cu``,
``csrc/circ_dict.cu``).

``circ_elem`` and ``circ_bind_dict`` are the kernel calls: they take any
layout (copied contiguous first); on a CUDA tensor they launch the Hopper
kernel or raise; on a CPU tensor they run the plain version in ``ref``.
``circ_bind`` is what ``vsa.bind`` / ``vsa.unbind`` call: it broadcasts
the leading dims, materialises them contiguous and flattens to (N, B, d).
``circ_bind_dict`` binds N queries to each of M static dictionary entries
and returns (N, M, B, d), which the kernel writes directly; ``circ_dict``
is its (N, B, M, d) view, the layout of the Pallas ``circ_dict``.

``circ_elem`` is differentiable, as the reference's custom VJPs: its
backward is ``circ_elem`` again (conv: da = corr(b, g), db = corr(a, g);
corr: da = corr(g, b), db = conv(g, a)), so on the card it launches the
same kernel twice.  ``circ_bind_dict`` has no backward, as the
reference's ``circ_dict``: on the card it raises when autograd would need
one.
"""

from __future__ import annotations

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.circ_conv import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024   # bytes of shared memory one block may use on Hopper
DICT_QUERY_TILE = 16     # circ_dict.cu's TN: queries per block
# circ_dict stages (TN + 1) rows of d floats per block
DICT_MAX_D = _MAX_SMEM // (4 * (DICT_QUERY_TILE + 1))


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


class _CircElem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, mode):
        ctx.mode = mode
        ctx.save_for_backward(x, y)
        if registry.on_card(x):
            return _launch(x, y, mode)
        return ref.circ_elem_ref(x, y, mode)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.contiguous()
        if ctx.mode == "conv":
            dx, dy = circ_elem(y, g, "corr"), circ_elem(x, g, "corr")
        else:
            dx, dy = circ_elem(g, y, "corr"), circ_elem(g, x, "conv")
        return dx.to(x.dtype), dy.to(y.dtype), None


def circ_elem(x: torch.Tensor, y: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """Pairwise binding. x, y: (N, B, d) -> (N, B, d), output in x's dtype.

    ``mode`` is ``"conv"`` (out[n] = Σ_k x[k]·y[(n−k) mod d]) or ``"corr"``
    (out[n] = Σ_k x[k]·y[(n+k) mod d]).  Differentiable."""
    registry.note_call("circ_conv")
    return _CircElem.apply(x.contiguous(), y.contiguous(), mode)


def circ_bind(a: torch.Tensor, b: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """Elementwise blockwise circular conv/corr with leading-dim broadcast.

    a, b: (..., blocks, d) -> (..., blocks, d)."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-2]
    blocks, d = a.shape[-2:]
    af = a.reshape(-1, blocks, d).contiguous()
    bf = b.reshape(-1, blocks, d).contiguous()
    return circ_elem(af, bf, mode).reshape(*lead, blocks, d)


def _launch_dict(x: torch.Tensor, dictionary: torch.Tensor, mode: str) -> torch.Tensor:
    if mode not in ("conv", "corr"):
        raise ValueError(f"mode must be 'conv' or 'corr', got {mode!r}")
    if x.dim() != 3 or dictionary.dim() != 3 or x.shape[1:] != dictionary.shape[1:]:
        raise ValueError(f"circ_dict wants x (N, B, d) and a dictionary (M, B, d), "
                         f"got {tuple(x.shape)} and {tuple(dictionary.shape)}")
    if x.dtype not in _DTYPES or dictionary.dtype != x.dtype:
        raise TypeError(f"circ_dict takes float32 or bfloat16 of one dtype, "
                        f"got {x.dtype} and {dictionary.dtype}")
    if dictionary.device != x.device:
        raise ValueError(f"x on {x.device}, dictionary on {dictionary.device}")
    if not (x.is_contiguous() and dictionary.is_contiguous()):
        raise ValueError("circ_dict needs contiguous inputs")
    n, b, d = x.shape
    m = dictionary.shape[0]
    if d > DICT_MAX_D:
        raise ValueError(f"block dim d={d} exceeds the kernel's shared memory "
                         f"(d <= {DICT_MAX_D})")
    if m * b > 65535 or n >= 2 ** 31 - DICT_QUERY_TILE:
        raise ValueError(f"(N, M, B) = {(n, m, b)} exceeds the kernel's grid")
    out = torch.empty((n, m, b, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("circ_dict")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dictionary.data_ptr(), out.data_ptr(), n, m, b, d,
                _DTYPES[x.dtype], int(mode == "corr"), stream)
    _build.check(rc, "circ_dict")
    registry.count_launch("circ_dict")
    return out


def circ_dict(x: torch.Tensor, dictionary: torch.Tensor,
              mode: str = "conv") -> torch.Tensor:
    """N queries against M dictionary entries, the Pallas ``circ_dict``.

    x: (N, B, d), dictionary: (M, B, d) -> (N, B, M, d) in x's dtype, a
    transposed view of ``circ_bind_dict``'s output."""
    return circ_bind_dict(x, dictionary, mode).transpose(1, 2)


def circ_bind_dict(x: torch.Tensor, dictionary: torch.Tensor,
                   mode: str = "conv") -> torch.Tensor:
    """x: (N, blocks, d) vs dictionary: (M, blocks, d) -> (N, M, blocks, d).

    A kernel-level entry point, as in the reference: it ignores the
    dispatch floor and goes to the circ_dict kernel at every d.  Forward
    only on the card, as the reference."""
    registry.note_call("circ_dict")
    x, dictionary = x.contiguous(), dictionary.contiguous()
    if registry.on_card(x):
        registry.refuse_grad("circ_dict", x, dictionary)
        return _launch_dict(x, dictionary, mode)
    return ref.circ_dict_ref(x, dictionary, mode).transpose(1, 2)
