"""Quantised-matmul API: quantise helpers and the kernel wrapper.

``qmatmul`` is the kernel call (``csrc/qmatmul.cu``): on a CUDA tensor it
launches the Hopper kernel or raises; on a CPU tensor it runs the plain
version in ``ref``.  ``quantize_rows``, ``quantize_cols``, ``pack_int4`` and
``qdense`` are ports of ``repro/kernels/qmatmul/ops.py`` and must give
bit-identical quantised operands.
"""

from __future__ import annotations

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.qmatmul import ref


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device.  On a CUDA tensor
    PyTorch divides by a Python scalar as ``x * (1 / c)``, which can be one
    ulp off; a quantiser's scale then moves values across rounding ties
    (the int4 heads land on exact .5 ties) and the card's int8/int4 codes
    differ from the CPU's.  Dividing by a 0-d tensor on ``x``'s device
    keeps the true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_rows(x: torch.Tensor, bits: int = 8):
    """Symmetric per-row quantisation. x: (M, K) -> (q int8, scale (M,) f32).

    The scale is clamped after dividing by qmax, as the reference does."""
    qmax = 2 ** (bits - 1) - 1
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(div_exact(amax, qmax), min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale[:, 0]


def quantize_cols(w: torch.Tensor, bits: int = 8):
    """Symmetric per-column quantisation. w: (K, N) -> (q int8, scale (N,))."""
    qmax = 2 ** (bits - 1) - 1
    amax = w.float().abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(div_exact(amax, qmax), min=1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale[0]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 values in [-8, 7] -> (K, ceil(N/2)) packed, low nibble
    first.  An odd N is padded with a zero column."""
    k, n = q.shape
    if n % 2:
        q = torch.nn.functional.pad(q, (0, 1))
        n += 1
    pairs = q.reshape(k, n // 2, 2)
    return ((pairs[..., 0] & 0x0F) | (pairs[..., 1] << 4)).to(torch.int8)


_BLOCK_M = 64  # qmatmul.cu's BM: output rows per block


def _launch(x_q, w_q, x_scale, w_scale, int4: bool) -> torch.Tensor:
    index = x_q.get_device()
    if (w_q.get_device() != index or x_scale.get_device() != index
            or w_scale.get_device() != index):
        raise ValueError("qmatmul operands must lie on one device")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"qmatmul wants int8 operands, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("qmatmul wants float32 scales")
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError("qmatmul wants 2-D operands")
    m, k = x_q.shape
    n = w_q.shape[1] * (2 if int4 else 1)
    if w_q.shape[0] != k or x_scale.shape != (m,) or w_scale.shape != (n,):
        raise ValueError(
            f"qmatmul shapes do not agree: x_q {tuple(x_q.shape)}, w_q "
            f"{tuple(w_q.shape)} (int4={int4}), x_scale "
            f"{tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}")
    if not (x_q.is_contiguous() and w_q.is_contiguous() and x_scale.is_contiguous()
            and w_scale.is_contiguous()):
        raise ValueError("qmatmul needs contiguous operands")
    if m > 65535 * _BLOCK_M or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"({m}, {k}, {n}) exceeds the kernel's grid")
    out = x_q.new_empty((m, n), dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    _build.launch("qmatmul", index, x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                  w_scale.data_ptr(), out.data_ptr(), m, n, k, int(int4))
    registry.count_launch("qmatmul")
    return out


@registry.kernel_call("qmatmul")
def qmatmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
            w_scale: torch.Tensor, int4: bool = False) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8, or (K, N/2) packed when int4.
    x_scale: (M,) f32 per row; w_scale: (N,) f32 per column -> (M, N) f32."""
    if registry.on_card(x_q):
        return _launch(x_q, w_q, x_scale, w_scale, int4)
    return ref.qmatmul_ref(x_q, w_q, x_scale, w_scale, int4)


def qdense(x: torch.Tensor, w: torch.Tensor, bits_x: int = 8,
           bits_w: int = 8) -> torch.Tensor:
    """Quantise-on-the-fly dense layer: x (M, K) f32, w (K, N) f32 ->
    (M, N) f32."""
    n = w.shape[1]
    x_q, x_s = quantize_rows(x, bits_x)
    w_q, w_s = quantize_cols(w, bits_w)
    int4 = bits_w == 4
    if int4:
        w_q = pack_int4(w_q)
        if n % 2:
            w_s = torch.nn.functional.pad(w_s, (0, 1))
    return qmatmul(x_q, w_q, x_s, w_s, int4=int4)[:, :n]
