"""Plain PyTorch version of the flash attention kernel: the materialised
scores of the reference's ``flash_attn/ref.py``, f32 inside, the causal mask
aligned at position 0 (``kpos <= qpos``) with the finite ``NEG_INF``.

The CPU path of ``ops.flash_mha`` and the yardstick ``chip_smoke.py`` holds
the CUDA kernel against on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BH, Skv, hd) -> (BH, Sq, hd) in q's dtype."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = torch.arange(skv, device=q.device)[None, :] \
            <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
