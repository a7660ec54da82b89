"""Wrapper of the flash attention kernel (``csrc/flash_attn.cu``).

``flash_mha`` is the kernel call, over the reference's (B, S, H, hd)
layout with k and v already repeated to H heads, in any strides (a view
is copied contiguous first): on a CUDA tensor it launches the Hopper
kernel, which reads that layout in place on the tensor cores (f32 in
3xTF32, bf16 with p split into hi + lo), or raises; on a CPU tensor it
runs the plain version in ``ref`` on (B·H, S, hd), as the reference's
``flash_mha`` transposes.  Forward only, as in the reference: on the card
it raises when autograd would need a backward.
"""

from __future__ import annotations

import torch

from repro_torch.backend import registry
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256   # flash_attn.cu's register accumulator and shared memory
QUERY_TILE = 64      # flash_attn.cu's TC_BQ: query rows per block


def _launch(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_mha wants q (B, Sq, H, hd) and k, v (B, Skv, H, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mha takes float32 or bfloat16 of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_mha needs contiguous inputs")
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernel's 1..{MAX_HEAD_DIM}")
    if -(-sq // QUERY_TILE) * b * h >= 2 ** 31:
        raise ValueError(f"(B, Sq, H) = {(b, sq, h)} exceeds the kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch("flash_attn", q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, sq, skv, h, hd, float(scale), int(causal),
                  _DTYPES[q.dtype])
    registry.count_launch("flash_attn")
    return out


@registry.kernel_call("flash_attn")
def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, H, hd) (GQA groups pre-repeated)
    -> (B, Sq, H, hd) in q's dtype.  The causal mask is aligned at
    position 0: query i sees keys 0..i, also when Sq != Skv."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if registry.on_card(q):
        registry.refuse_grad("flash_attn", q, k, v)
        return _launch(q, k, v, scale, causal)
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    out = ref.flash_attention_ref(q.transpose(1, 2).reshape(b * h, sq, hd),
                                  k.transpose(1, 2).reshape(b * h, skv, hd),
                                  v.transpose(1, 2).reshape(b * h, skv, hd),
                                  scale=scale, causal=causal)
    return out.reshape(b, h, sq, hd).transpose(1, 2)
