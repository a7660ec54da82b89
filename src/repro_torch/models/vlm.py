"""InternVL2-style VLM backbone: the decoder LM over [image patch
embeddings ‖ text tokens].

The port of ``repro.models.vlm``.  As in the reference the vision frontend
is a stub: the caller supplies precomputed patch embeddings (B, n_img,
d_model), as if InternViT and the MLP projector had run; the backbone
(InternLM2-20B class) is ``models.lm``'s body, reused layer by layer on the
concatenated embeddings (``lm.body``, remat included).  Every unwindowed
layer so calls ``flash_mha`` (``nn/attention.py:attention``), under grad
through its kernel forward and plain-chain backward.  ``loss_fn`` covers the
text span only, plus the MoE aux.  Decode is the text LM's, over a cache
whose prefix would hold the image tokens.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    lm: lm.LMConfig
    n_img_tokens: int = 1024


def vlm_spec(cfg: VLMConfig):
    return lm.lm_spec(cfg.lm)


def forward(params, cfg: VLMConfig, patch_embeds: torch.Tensor, tokens: torch.Tensor):
    """patch_embeds: (B, N_img, D) (the stub frontend's output); tokens:
    (B, S).  Returns (hidden (B, N_img + S, D), aux_loss)."""
    c = cfg.lm
    x_txt = layers.embedding(params["embed"], tokens, c.compute_dtype)
    return lm.body(params, c, torch.cat([patch_embeds.to(c.compute_dtype), x_txt], dim=1))


def loss_fn(params, cfg: VLMConfig, batch) -> torch.Tensor:
    """batch: {patch_embeds, tokens, targets}: the cross entropy on the text
    span only, plus ``0.01 x`` the MoE aux."""
    hidden, aux = forward(params, cfg, batch["patch_embeds"], batch["tokens"])
    logits = lm.lm_logits(params, cfg.lm, hidden[:, cfg.n_img_tokens:, :])
    return lm._xent(logits, batch["targets"]) + 0.01 * aux


def cache_shapes(cfg: VLMConfig, batch: int, max_len: int):
    return lm.cache_shapes(cfg.lm, batch, max_len)


def init_caches(cfg: VLMConfig, batch: int, max_len: int, device=None):
    return lm.init_caches(cfg.lm, batch, max_len, device=device)


def decode_step(params, cfg: VLMConfig, caches, token: torch.Tensor, pos):
    return lm.decode_step(params, cfg.lm, caches, token, pos)
