"""Layers of the NVSA frontend: dense, conv, eval-mode batchnorm, pooling.

Each layer is a pair (``<name>_spec`` -> P tree, ``<name>`` apply fn) like
``repro.nn.layers``.  Activations keep the reference's NHWC layout at every
public function.  Conv weights are OIHW (``repro_torch.interop`` converts
the reference's HWIO once); inside, an NHWC tensor is handed to
``F.conv2d`` as a channels-last NCHW view, so no copy is made.

``"SAME"`` padding follows XLA: the total padding is split with the odd
element at the end, so it is asymmetric at stride 2 (on 32×32 inputs the
7×7/2 stem pads (2, 3) and the 3/2 max-pool (0, 1), with −inf).  PyTorch's
symmetric ``padding=`` would differ; the pads are applied with ``F.pad``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.nn.init import P


def dense_spec(d_in: int, d_out: int, axes=("embed", "mlp"), bias: bool = False,
               dtype=torch.float32, scale: float | None = None):
    spec = {"w": P((d_in, d_out), axes, init="normal", scale=scale, dtype=dtype)}
    if bias:
        spec["b"] = P((d_out,), (axes[1],), init="zeros", dtype=dtype)
    return spec


def dense(params, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    y = x.to(compute_dtype) @ params["w"].to(compute_dtype)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y


def conv2d_spec(c_in: int, c_out: int, k: int, dtype=torch.float32,
                bias: bool = False):
    """OIHW weight; std sqrt(2 / fan_in) as in the reference."""
    fan_in = c_in * k * k
    spec = {
        "w": P((c_out, c_in, k, k), ("conv_out", "conv_in", None, None),
               init="normal", scale=math.sqrt(2.0 / fan_in), dtype=dtype)
    }
    if bias:
        spec["b"] = P((c_out,), ("conv_out",), init="zeros", dtype=dtype)
    return spec


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` (low, high) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def conv2d(params, x: torch.Tensor, stride: int = 1,
           compute_dtype=torch.float32) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H', W', C_out), ``"SAME"`` padding."""
    w = params["w"].to(compute_dtype)
    xc = _pad_nchw(x.to(compute_dtype).permute(0, 3, 1, 2), w.shape[-1], stride)
    y = F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y


def batchnorm_spec(c: int, dtype=torch.float32):
    return {
        "scale": P((c,), ("conv_out",), init="ones", dtype=dtype),
        "bias": P((c,), ("conv_out",), init="zeros", dtype=dtype),
        "mean": P((c,), ("conv_out",), init="zeros", dtype=dtype),
        "var": P((c,), ("conv_out",), init="ones", dtype=dtype),
    }


def batchnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BN with the running stats: per-example independent."""
    inv = torch.rsqrt(params["var"].float() + eps) * params["scale"].float()
    y = (x.float() - params["mean"].float()) * inv + params["bias"].float()
    return y.to(x.dtype)


def maxpool2d(x: torch.Tensor, k: int = 2, stride: int | None = None) -> torch.Tensor:
    """x: (B, H, W, C), ``"SAME"`` padding with −inf."""
    stride = stride or k
    xc = _pad_nchw(x.permute(0, 3, 1, 2), k, stride, value=-math.inf)
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))
