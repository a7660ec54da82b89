"""RWKV-6 (Finch) language model: attention-free, O(1)-state decode.

The port of ``repro.models.rwkv6``.  Arch ``rwkv6-7b``: 32 layers, d_model
4096, d_ff 14336, vocab 65536.  The per-layer decode state is the WKV
matrix (heads, 64, 64) in f32 and the two token-shift carries in bf16,
stacked over layers as in the reference (``state_shapes``), so decode
memory does not grow with the context.

The layers are stacked under ``body`` (a leading layer axis on every leaf,
the reference's ``lax.scan`` layout); the port loops over that axis.
``decode_step`` writes each layer's new state into the state tree in place
and returns it, as ``models.lm.decode_step`` does with its KV caches.
``loss_fn`` is the reference's: the cross entropy of the head's logits.
With ``remat``, each layer is recomputed in the backward under grad, as
the reference's ``jax.checkpoint`` of its scanned layer.

In a tensor-parallel group every layer runs the rank's heads and channels
(``nn/ssm.py``), the embedding, the norms and the head as ``nn/layers.py``
runs them, and the decode state holds the rank's WKV heads.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_map
from repro_torch.models.lm import _run_layers, _stack_spec, _unstack, _xent
from repro_torch.nn import layers, ssm


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """The reference's ``RWKVConfig`` without ``scan_unroll``, which tunes
    its compiled scan (eager PyTorch has nothing for it to do)."""

    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    chunk: int = 16
    impl: str = "chunked"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True

    def tm(self) -> ssm.RWKV6Config:
        return ssm.RWKV6Config(self.d_model, self.head_dim, chunk=self.chunk,
                               impl=self.impl)


def _layer_spec(cfg: RWKVConfig):
    return {
        "ln1": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
        "ln2": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
        "tm": ssm.timemix_spec(cfg.tm(), cfg.param_dtype),
        "cm": ssm.channelmix_spec(cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def rwkv_spec(cfg: RWKVConfig):
    return {
        "embed": layers.embedding_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "ln_in": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
        "final_norm": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
        "body": _stack_spec(_layer_spec(cfg), cfg.n_layers),
        "head": layers.dense_spec(cfg.d_model, cfg.vocab, ("embed", "vocab"),
                                  dtype=cfg.param_dtype),
    }


def _layer_fwd(cfg: RWKVConfig, p, x):
    h = layers.layernorm(p["ln1"], x)
    x = x + ssm.timemix(p["tm"], cfg.tm(), h, cfg.compute_dtype)
    h = layers.layernorm(p["ln2"], x)
    return x + ssm.channelmix(p["cm"], h, compute_dtype=cfg.compute_dtype)


def forward(params, cfg: RWKVConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> hidden (B, S, D) after the final norm."""
    x = layers.embedding(params["embed"], tokens, cfg.compute_dtype)
    x = layers.layernorm(params["ln_in"], x)
    x = _run_layers(cfg, _layer_fwd, params["body"], cfg.n_layers, x)
    return layers.layernorm(params["final_norm"], x)


def logits(params, cfg: RWKVConfig, hidden: torch.Tensor) -> torch.Tensor:
    return layers.dense(params["head"], hidden, cfg.compute_dtype)


def loss_fn(params, cfg: RWKVConfig, batch) -> torch.Tensor:
    """batch: {tokens (B, S), targets (B, S)} -> the cross entropy."""
    return _xent(logits(params, cfg, forward(params, cfg, batch["tokens"])),
                 batch["targets"])


def state_shapes(cfg: RWKVConfig, batch: int):
    """The stacked per-layer state as ``meta`` tensors.  In a
    tensor-parallel group the WKV state holds the rank's heads
    (``ssm.timemix_heads``); the token-shift carries stay whole."""
    tm = cfg.tm()
    h, hd, n = ssm.timemix_heads(tm), tm.head_dim, cfg.n_layers
    return {
        "wkv": torch.empty((n, batch, h, hd, hd), dtype=torch.float32, device="meta"),
        "tm_x": torch.empty((n, batch, cfg.d_model), dtype=torch.bfloat16, device="meta"),
        "cm_x": torch.empty((n, batch, cfg.d_model), dtype=torch.bfloat16, device="meta"),
    }


def init_state(cfg: RWKVConfig, batch: int, device=None):
    """Zeroed state on ``device`` (None = ``"cuda"``)."""
    dev = registry.resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    state_shapes(cfg, batch))


def decode_step(params, cfg: RWKVConfig, state, token: torch.Tensor, pos):
    """token: (B,) ids; ``pos`` is ignored (the state carries the position).
    Writes every layer's new state into ``state`` in place; returns
    (state, logits (B, V))."""
    tm = cfg.tm()
    x = layers.embedding(params["embed"], token, cfg.compute_dtype)
    x = layers.layernorm(params["ln_in"], x)
    for p, st in zip(_unstack(params["body"], cfg.n_layers), _unstack(state, cfg.n_layers)):
        h = layers.layernorm(p["ln1"], x)
        tm_state, y = ssm.timemix_step(
            p["tm"], tm, {"wkv": st["wkv"], "x_prev": st["tm_x"]}, h, cfg.compute_dtype)
        x = x + y
        h = layers.layernorm(p["ln2"], x)
        y = ssm.channelmix(p["cm"], h[:, None, :], st["cm_x"],
                           compute_dtype=cfg.compute_dtype)[:, 0]
        x = x + y
        st["wkv"].copy_(tm_state["wkv"])
        st["tm_x"].copy_(tm_state["x_prev"])
        st["cm_x"].copy_(h)
    x = layers.layernorm(params["final_norm"], x)
    return state, logits(params, cfg, x)
