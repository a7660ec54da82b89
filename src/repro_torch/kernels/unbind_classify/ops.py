"""Wrappers of the fused unbind -> classify kernel (``csrc/unbind_classify.cu``).

``fused_unbind_classify`` is the kernel call: it takes any layout (copied
contiguous first); on a CUDA tensor it launches the Hopper kernel or
raises; on a CPU or ``meta`` tensor it runs the plain version in ``ref``.
It is differentiable: the forward stays fused and the backward is the
autograd of the plain chain (``ref.fused_unbind_classify_ref``), as the
reference's custom VJP.  ``unbind_classify`` is what ``models.mimonet``
calls: it reshapes the dense head's parameters as the reference's
``ops.py`` does.
"""

from __future__ import annotations

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.unbind_classify import ref

MAX_CLASSES = 32                 # C partial sums per thread live in registers
_MAX_SMEM = 227 * 1024 - 1024    # Hopper's per-block limit, less the reduction


def _launch(keys, x, w, b) -> torch.Tensor:
    args = {"keys": keys, "x": x, "w": w, "b": b}
    for name, t in args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"unbind_classify takes float32, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"unbind_classify needs contiguous inputs ({name})")
        if t.device != x.device:
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
    if 2 * d * 4 > _MAX_SMEM:
        raise ValueError(f"block dim d={d} exceeds the kernel's shared memory")
    if n * k >= 2 ** 31:
        raise ValueError(f"{n * k} rows exceed the kernel's grid")
    out = torch.empty((n, k, c), dtype=torch.float32, device=x.device)
    if n * k == 0:
        return out
    _build.launch("unbind_classify", x.get_device(), keys.data_ptr(), x.data_ptr(),
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
    return _FusedUnbindClassify.apply(*(t.contiguous() for t in (keys, x, w, b)))


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
