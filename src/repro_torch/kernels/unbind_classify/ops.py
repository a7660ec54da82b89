"""Wrappers of the fused unbind -> classify kernel (``csrc/unbind_classify.cu``).

``fused_unbind_classify`` is the kernel call: it takes any layout (copied
contiguous first); on a CUDA tensor it launches the Hopper kernel or
raises; on a CPU or ``meta`` tensor it runs the plain version in ``ref``.
It is differentiable: the forward stays fused and the backward is the
autograd of the plain chain (``ref.fused_unbind_classify_ref``), as the
reference's custom VJP.  Where autograd records nothing (grad mode off, or
no input that requires grad) the wrapper launches the kernel without the
autograd Function.  ``unbind_classify`` is what ``models.mimonet``
calls: it reshapes the dense head's parameters as the reference's
``ops.py`` does.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.unbind_classify import ref

MAX_CLASSES = 32                 # C partial sums per thread live in registers
_TILE = 64                       # unbind_classify.cu's TILE: d pads to a multiple
# Hopper's per-block shared memory less the kernel's static reduction array
# (MAX_WARPS = 16 rows of MAX_CLASSES floats)
_MAX_SMEM = 227 * 1024 - 16 * MAX_CLASSES * 4


@functools.lru_cache(maxsize=64)
def geometry(d: int) -> tuple[int, int]:
    """unbind_classify.cu's padded block dim and slice count for block dim
    ``d``: (dp, S).  S is the largest power of two up to 16 (4 above dp =
    1024) whose slices dp / S are a multiple of 16 and at least 32 long."""
    dp = -(-d // _TILE) * _TILE
    smax = 4 if dp > 1024 else 16
    s = 1
    while 2 * s <= smax and dp % (2 * s * 16) == 0 and dp // (2 * s) >= 32:
        s *= 2
    return dp, s


def smem_bytes(d: int, rows: int = 1) -> int:
    """unbind_classify.cu's dynamic shared memory for ``rows`` staged VSA
    blocks at block dim ``d`` (x twice over, the key and the S partial
    sums of each; w's staging comes on top only where it fits)."""
    dp, s = geometry(d)
    return 4 * (3 + s) * dp * rows


def _max_d() -> int:
    d = _TILE
    while smem_bytes(d + _TILE) <= _MAX_SMEM:
        d += _TILE
    return d


MAX_D = _max_d()


def _launch(keys, x, w, b) -> torch.Tensor:
    index = x.get_device()
    for name, t in (("keys", keys), ("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"unbind_classify takes float32, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"unbind_classify needs contiguous inputs ({name})")
        if t.get_device() != index:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if keys.dim() != 3 or x.dim() != 3 or w.dim() != 3:
        raise ValueError("unbind_classify wants keys (K, B, d), x (N, B, d), "
                         "w (B, d, C)")
    k, blocks, d = keys.shape
    n = x.shape[0]
    c = w.shape[-1]
    if x.shape[1:] != (blocks, d) or w.shape[:2] != (blocks, d) \
            or b.shape != (1, c):
        raise ValueError(f"shapes do not agree: keys {tuple(keys.shape)}, "
                         f"x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"unbind_classify takes 1..{MAX_CLASSES} classes, got {c}")
    if smem_bytes(d) > _MAX_SMEM:
        raise ValueError(f"block dim d={d} exceeds the kernel's shared memory "
                         f"(d <= {MAX_D})")
    if n * k >= 2 ** 31:
        raise ValueError(f"{n * k} rows exceed the kernel's grid")
    out = x.new_empty((n, k, c))
    if n * k == 0:
        return out
    _build.launch("unbind_classify", index, keys.data_ptr(), x.data_ptr(),
                  w.data_ptr(), b.data_ptr(), out.data_ptr(), n, k, blocks, d, c)
    registry.count_launch("unbind_classify")
    return out


class _FusedUnbindClassify(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keys, x, w, b):
        ctx.save_for_backward(keys, x, w, b)
        if registry.on_card(x):
            return _launch(keys, x, w, b)
        return ref.fused_unbind_classify_ref(keys, x, w, b)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(ref.fused_unbind_classify_ref(*args), args, g)


def fused_unbind_classify(keys: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """keys: (K, B, d), x: (N, B, d), w: (B, d, C), b: (1, C) -> logits
    (N, K, C) f32: ``b + Σ_blk corr(keys[k, blk], x[n, blk]) @ w[blk]``."""
    registry.note_call("unbind_classify")
    args = (keys.contiguous(), x.contiguous(), w.contiguous(), b.contiguous())
    if registry.on_card(x) and not (torch.is_grad_enabled()
                                    and any(t.requires_grad for t in args)):
        return _launch(*args)  # autograd records nothing: no Function needed
    return _FusedUnbindClassify.apply(*args)


def unbind_classify(head, keys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """keys: (K, B, d), x: (N, B*d), head: dense params (B*d -> C) ->
    logits (N, K, C) through the fused kernel."""
    k, blocks, d = keys.shape
    c = head["w"].shape[-1]
    w = head["w"].reshape(blocks, d, c)
    bias = head.get("b")
    bias = torch.zeros((1, c), dtype=torch.float32, device=x.device) \
        if bias is None else bias.reshape(1, c).float()
    return fused_unbind_classify(keys, x.reshape(x.shape[0], blocks, d), w, bias)
