"""Wrappers of the circ_conv and circ_dict kernels (``csrc/circ_conv.cu``,
``csrc/circ_dict.cu``).

``circ_elem`` and ``circ_bind_dict`` are the kernel calls: on a CUDA
tensor they launch the Hopper kernel or raise; on a CPU tensor they run
the plain version in ``ref``.  ``circ_elem`` reads its operands by stride:
any (N, B) strides, 0 included (a broadcast key), with the last dimension
contiguous; it copies only an operand whose last dimension is not.
``circ_bind`` is what ``vsa.bind`` / ``vsa.unbind`` call: it broadcasts
the leading dims and merges them into N by ``reshape``, which stays a
view wherever they merge into one stride (a row slice of a stacked tensor,
a key broadcast over the batch), so a served bind makes no copy.
``circ_bind_dict`` (any layout, copied contiguous first) binds N queries to
each of M static dictionary entries and returns (N, M, B, d), which the
kernel writes directly; ``circ_dict`` is its (N, B, M, d) view, the layout
of the Pallas ``circ_dict``.

``circ_elem`` is differentiable, as the reference's custom VJPs: its
backward is ``circ_elem`` again (conv: da = corr(b, g), db = corr(a, g);
corr: da = corr(g, b), db = conv(g, a)), so on the card it launches the
same kernel once for each operand that needs a gradient (a constant key
or codebook gets ``None`` and no launch); the gradient of a broadcast
operand is summed by autograd's own expand backward.  ``circ_bind_dict`` has no backward, as
the reference's ``circ_dict``: on the card it raises when autograd would
need one.
"""

from __future__ import annotations

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.circ_conv import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024   # bytes of shared memory one block may use on Hopper
_ELEM_TILE = 64          # circ_conv.cu's TILE: outputs per tile
DICT_COLS = 64           # circ_dict.cu's WCOLS: d pads to a multiple
DICT_MIN_ROWS = 16       # circ_dict.cu's WROWS: the smallest query tile


def dict_smem_bytes(d: int, elt: int, rows: int = DICT_MIN_ROWS, entries: int = 1) -> int:
    """circ_dict.cu's ``smem_bytes``: shared memory of a block that stages
    ``rows`` queries and ``entries`` dictionary rows at block dim ``d``
    (``elt`` bytes per element).  f32: the query tile as tf32 hi and lo
    words, each row padded by 16 bytes, and each entry's row as hi and lo
    over 2·dp; bf16: the tile as bf16, each entry's row as two word copies
    of dp words, 16 words apart, and the output buffers of the block's 8
    warps, 16 rows of 72 bf16 each."""
    dp = -(-d // DICT_COLS) * DICT_COLS
    if elt == 2:
        return 2 * rows * (dp + 8) + 4 * entries * (2 * dp + 16) + 2 * 8 * 16 * 72
    return 8 * rows * (dp + 4) + 16 * entries * dp


def _dict_max_d(elt: int) -> int:
    """The largest d whose smallest block (16 queries, one entry) fits."""
    d = DICT_COLS
    while dict_smem_bytes(d + DICT_COLS, elt) <= _MAX_SMEM:
        d += DICT_COLS
    return d


DICT_MAX_D = _dict_max_d(4)        # f32
DICT_MAX_D_BF16 = _dict_max_d(2)


def _elem_geometry(d: int) -> tuple[int, int]:
    """circ_conv.cu's padded block dim and k-split for block dim ``d``:
    (dp, S).  A block of one tile needs 4·(3·dp + 64·S) bytes of shared
    memory."""
    dp = -(-d // 128) * 128 if d <= 512 else -(-d // 256) * 256
    return dp, (dp // 32 if dp <= 512 else 16)


def _dense_last(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 or t.shape[-1] == 1


def _launch(x: torch.Tensor, y: torch.Tensor, mode: str) -> torch.Tensor:
    if mode not in ("conv", "corr"):
        raise ValueError(f"mode must be 'conv' or 'corr', got {mode!r}")
    if x.dim() != 3 or x.shape != y.shape:
        raise ValueError(f"circ_elem wants two (N, B, d) tensors of one shape, "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or y.dtype != x.dtype:
        raise TypeError(f"circ_elem takes float32 or bfloat16 of one dtype, "
                        f"got {x.dtype} and {y.dtype}")
    index = x.get_device()
    if y.get_device() != index:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    if not (_dense_last(x) and _dense_last(y)):
        raise ValueError("circ_elem needs a contiguous last dimension")
    n, b, d = x.shape
    dp, splits = _elem_geometry(d)
    if 4 * (3 * dp + _ELEM_TILE * splits) > _MAX_SMEM:
        raise ValueError(f"block dim d={d} exceeds the kernel's shared memory")
    if n * b * (dp // _ELEM_TILE) >= 2 ** 31:
        raise ValueError(f"{n * b} rows exceed the kernel's grid")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    (x_sn, x_sb, _), (y_sn, y_sb, _) = x.stride(), y.stride()
    _build.launch("circ_conv", index, x.data_ptr(), y.data_ptr(), out.data_ptr(), n, b,
                  d, x_sn, x_sb, y_sn, y_sb, dtype, int(mode == "corr"))
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
        need_x, need_y = ctx.needs_input_grad[:2]
        dx = dy = None
        if ctx.mode == "conv":
            if need_x:
                dx = circ_elem(y, g, "corr").to(x.dtype)
            if need_y:
                dy = circ_elem(x, g, "corr").to(y.dtype)
        else:
            if need_x:
                dx = circ_elem(g, y, "corr").to(x.dtype)
            if need_y:
                dy = circ_elem(g, x, "conv").to(y.dtype)
        return dx, dy, None


@registry.kernel_call("circ_conv")
def circ_elem(x: torch.Tensor, y: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """Pairwise binding. x, y: (N, B, d) -> contiguous (N, B, d), output in
    x's dtype.  The operands may be any strided views; only one whose last
    dimension is not contiguous is copied.

    ``mode`` is ``"conv"`` (out[n] = Σ_k x[k]·y[(n−k) mod d]) or ``"corr"``
    (out[n] = Σ_k x[k]·y[(n+k) mod d]).  Differentiable."""
    if not _dense_last(x):
        x = x.contiguous()
    if not _dense_last(y):
        y = y.contiguous()
    return _CircElem.apply(x, y, mode)


def circ_bind(a: torch.Tensor, b: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """Elementwise blockwise circular conv/corr with leading-dim broadcast.

    a, b: (..., blocks, d) -> (..., blocks, d).  The broadcast operands
    reach ``circ_elem`` as views (``reshape`` copies only where the lead
    dims cannot merge into one stride)."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-2]
    blocks, d = a.shape[-2:]
    out = circ_elem(a.reshape(-1, blocks, d), b.reshape(-1, blocks, d), mode)
    return out.reshape(*lead, blocks, d)


def _launch_dict(x: torch.Tensor, dictionary: torch.Tensor, mode: str) -> torch.Tensor:
    if mode not in ("conv", "corr"):
        raise ValueError(f"mode must be 'conv' or 'corr', got {mode!r}")
    if x.dim() != 3 or dictionary.dim() != 3 or x.shape[1:] != dictionary.shape[1:]:
        raise ValueError(f"circ_dict wants x (N, B, d) and a dictionary (M, B, d), "
                         f"got {tuple(x.shape)} and {tuple(dictionary.shape)}")
    if x.dtype not in _DTYPES or dictionary.dtype != x.dtype:
        raise TypeError(f"circ_dict takes float32 or bfloat16 of one dtype, "
                        f"got {x.dtype} and {dictionary.dtype}")
    index = x.get_device()
    if dictionary.get_device() != index:
        raise ValueError(f"x on {x.device}, dictionary on {dictionary.device}")
    if not (x.is_contiguous() and dictionary.is_contiguous()):
        raise ValueError("circ_dict needs contiguous inputs")
    n, b, d = x.shape
    m = dictionary.shape[0]
    if dict_smem_bytes(d, x.element_size()) > _MAX_SMEM:
        limit = DICT_MAX_D if x.dtype == torch.float32 else DICT_MAX_D_BF16
        raise ValueError(f"block dim d={d} exceeds the kernel's shared memory "
                         f"(d <= {limit} at {x.dtype})")
    if n >= 2 ** 31 or -(-n // DICT_MIN_ROWS) * b * m >= 2 ** 31:
        raise ValueError(f"(N, M, B) = {(n, m, b)} exceeds the kernel's grid")
    out = x.new_empty((n, m, b, d))
    if out.numel() == 0:
        return out
    _build.launch("circ_dict", index, x.data_ptr(), dictionary.data_ptr(),
                  out.data_ptr(), n, m, b, d, _DTYPES[x.dtype], int(mode == "corr"))
    registry.count_launch("circ_dict")
    return out


def circ_dict(x: torch.Tensor, dictionary: torch.Tensor,
              mode: str = "conv") -> torch.Tensor:
    """N queries against M dictionary entries, the Pallas ``circ_dict``.

    x: (N, B, d), dictionary: (M, B, d) -> (N, B, M, d) in x's dtype, a
    transposed view of ``circ_bind_dict``'s output."""
    return circ_bind_dict(x, dictionary, mode).transpose(1, 2)


@registry.kernel_call("circ_dict")
def circ_bind_dict(x: torch.Tensor, dictionary: torch.Tensor,
                   mode: str = "conv") -> torch.Tensor:
    """x: (N, blocks, d) vs dictionary: (M, blocks, d) -> (N, M, blocks, d).

    A kernel-level entry point, as in the reference: it ignores the
    dispatch floor and goes to the circ_dict kernel at every d.  Forward
    only on the card, as the reference."""
    x, dictionary = x.contiguous(), dictionary.contiguous()
    if registry.on_card(x):
        registry.refuse_grad("circ_dict", x, dictionary)
        return _launch_dict(x, dictionary, mode)
    return ref.circ_dict_ref(x, dictionary, mode).transpose(1, 2)
