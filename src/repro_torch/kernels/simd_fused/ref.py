"""Plain PyTorch versions of the fused match_prob kernel.

``fused_match_prob_ref`` repeats the kernel's arithmetic (that of the
Pallas ``_match_prob_kernel``): blockwise ``rsqrt(Σx² + 1e-18)``
normalisation, the flat dot, ``/ blocks``, ``/ temp``, a max-subtracted
exp and division by the sum.  It is the CPU path of ``ops`` and the
yardstick ``chip_smoke.py`` holds the CUDA kernel against on the card.

``match_prob_chain`` is the reference's ``simd_fused/ref.py`` chain
(norms clamped at 1e-9, then softmax); the backward of
``ops.fused_match_prob`` is its autograd, as in the reference.
"""

from __future__ import annotations

import torch


def fused_match_prob_ref(q: torch.Tensor, dictionary: torch.Tensor,
                         temp: float = 1.0) -> torch.Tensor:
    """q: (N, B, d), dictionary: (M, B, d) -> probs (N, M) f32."""
    qf = q.float()
    df = dictionary.float()
    qn = qf * torch.rsqrt((qf * qf).sum(dim=-1, keepdim=True) + 1e-18)
    dn = df * torch.rsqrt((df * df).sum(dim=-1, keepdim=True) + 1e-18)
    sims = (qn.reshape(q.shape[0], -1) @ dn.reshape(dictionary.shape[0], -1).T) \
        / q.shape[-2]
    z = sims / temp
    e = torch.exp(z - z.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def match_prob_chain(q: torch.Tensor, dictionary: torch.Tensor,
                     temp: float = 1.0) -> torch.Tensor:
    """The reference's plain chain: q (N, B, d), dictionary (M, B, d) ->
    probs (N, M) f32."""
    qf = q.float()
    df = dictionary.float()
    qn = qf / torch.clamp(torch.linalg.vector_norm(qf, dim=-1, keepdim=True), min=1e-9)
    dn = df / torch.clamp(torch.linalg.vector_norm(df, dim=-1, keepdim=True), min=1e-9)
    sims = torch.einsum("nbd,mbd->nm", qn, dn) / q.shape[-2]
    return torch.softmax(sims / temp, dim=-1)
