"""Plain PyTorch version of the qmatmul kernel.

Integer-exact: the accumulator is an int32 sum of int8 products, computed
by broadcasting (no integer matmul is needed, so it runs on the card as
well as on the CPU).  The epilogue follows the Pallas kernel's association,
``acc * (xs * ws)`` (``repro/kernels/qmatmul/kernel.py:49-50``); the JAX
``qmatmul_ref`` computes ``(acc * xs) * ws``, which can differ by one ulp.
"""

from __future__ import annotations

import torch


def unpack_int4_ref(w: torch.Tensor) -> torch.Tensor:
    """(K, N/2) int8, two nibbles per byte -> (K, N) int8 in [-8, 7]:
    low nibble first, each sign-extended by an arithmetic shift."""
    low = (w << 4) >> 4
    high = w >> 4
    return torch.stack([low, high], dim=-1).reshape(w.shape[0], w.shape[1] * 2)


def qmatmul_acc_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    int4: bool = False) -> torch.Tensor:
    """The exact int32 accumulator Σ_k xq[m, k]·wq[k, n] -> (M, N)."""
    if int4:
        w_q = unpack_int4_ref(w_q)
    return (x_q.to(torch.int32)[:, :, None]
            * w_q.to(torch.int32)[None, :, :]).sum(dim=1, dtype=torch.int32)


def qmatmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, int4: bool = False) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 [or (K, N/2) packed] -> (M, N) f32."""
    acc = qmatmul_acc_ref(x_q, w_q, int4)
    return acc.to(torch.float32) * (x_scale[:, None] * w_scale[None, :])
