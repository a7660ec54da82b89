"""Plain PyTorch versions of the fused unbind -> classify kernel.

``unbind_classify_ref`` is the staged chain of ``unbind_classify/ref.py`` in
the reference: broadcast circular correlation of each channel key against
the trunk output, then the dense head.  ``fused_unbind_classify_ref`` takes
the kernel's own arguments; it is the CPU path of ``ops`` and the yardstick
``chip_smoke.py`` holds the CUDA kernel against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.circ_conv.ref import circ_elem_ref
from repro_torch.nn import layers


def unbind_classify_ref(head, keys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """keys: (K, B, d), x: (N, B*d), head: dense params (B*d -> C) ->
    logits (N, K, C) f32."""
    k, b, d = keys.shape
    n = x.shape[0]
    codes = x.reshape(n, 1, b, d).expand(n, k, b, d)
    kb = keys[None].expand(n, k, b, d)
    unbound = circ_elem_ref(kb, codes, "corr").reshape(n, k, b * d)
    return layers.dense(head, unbound, torch.float32)


def fused_unbind_classify_ref(keys: torch.Tensor, x: torch.Tensor,
                              w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """keys: (K, B, d), x: (N, B, d), w: (B, d, C), b: (1, C) -> (N, K, C)
    f32, the kernel's signature."""
    k, blocks, d = keys.shape
    n = x.shape[0]
    head = {"w": w.reshape(blocks * d, w.shape[-1]), "b": b.reshape(-1)}
    return unbind_classify_ref(head, keys, x.reshape(n, blocks * d))
