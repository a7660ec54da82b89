"""Plain PyTorch version of the circ_conv kernel (exact gather formulation).

The CPU path of ``ops.circ_elem`` and the yardstick ``chip_smoke.py`` holds
the CUDA kernel against on the card.
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
    """x, y: (..., d) -> (..., d), f32 accumulation, output in x's dtype."""
    ymat = y[..., circ_index(x.shape[-1], mode, x.device)]  # (..., d, d)
    return torch.einsum("...k,...nk->...n", x.float(), ymat.float()).to(x.dtype)
