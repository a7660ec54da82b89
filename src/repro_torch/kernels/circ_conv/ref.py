"""Plain PyTorch versions of the circ_conv and circ_dict kernels (exact
gather formulation).

The CPU paths of ``ops.circ_elem`` and ``ops.circ_dict`` and the
yardsticks ``chip_smoke.py`` holds the CUDA kernels against on the card.
"""

from __future__ import annotations

import torch


def circ_index(d: int, mode: str, device) -> torch.Tensor:
    """(d, d) gather index: row n reads y[(n - k) % d] (conv) or
    y[(n + k) % d] (corr) at column k."""
    if mode not in ("conv", "corr"):
        raise ValueError(f"mode must be 'conv' or 'corr', got {mode!r}")
    n = torch.arange(d, device=device)[:, None]
    k = torch.arange(d, device=device)[None, :]
    return (n - k) % d if mode == "conv" else (n + k) % d


def circ_elem_ref(x: torch.Tensor, y: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """x, y: (..., d) -> (..., d), f32 accumulation, output in x's dtype.

    Like the kernel, the result does not depend on the operands' strides:
    both enter the einsum contiguous (a no-op for contiguous operands),
    since its summation order would otherwise follow their layout."""
    ymat = y[..., circ_index(x.shape[-1], mode, x.device)]  # (..., d, d)
    return torch.einsum("...k,...nk->...n", x.float().contiguous(),
                        ymat.float().contiguous()).to(x.dtype)


def circ_dict_ref(x: torch.Tensor, dictionary: torch.Tensor,
                  mode: str = "conv") -> torch.Tensor:
    """x: (N, B, d), dictionary: (M, B, d) -> (N, B, M, d), f32
    accumulation, output in x's dtype."""
    dmat = dictionary[..., circ_index(x.shape[-1], mode, x.device)]  # (M, B, d, d)
    return torch.einsum("xbk,mbnk->xbmn", x.float(), dmat.float()).to(x.dtype)
