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
``loss_fn`` waits for training (ROADMAP Queue 1 #5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_map
from repro_torch.models.lm import _layer, _stack_spec
from repro_torch.nn import layers, ssm


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """The reference's ``RWKVConfig`` without ``remat`` and ``scan_unroll``,
    which tune its compiled scan (eager PyTorch has nothing for them to
    do, as in ``models.lm.LMConfig``)."""

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


def forward(params, cfg: RWKVConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> hidden (B, S, D) after the final norm."""
    x = layers.embedding(params["embed"], tokens, cfg.compute_dtype)
    x = layers.layernorm(params["ln_in"], x)
    tm = cfg.tm()
    for i in range(cfg.n_layers):
        p = _layer(params["body"], i)
        h = layers.layernorm(p["ln1"], x)
        x = x + ssm.timemix(p["tm"], tm, h, cfg.compute_dtype)
        h = layers.layernorm(p["ln2"], x)
        x = x + ssm.channelmix(p["cm"], h, compute_dtype=cfg.compute_dtype)
    return layers.layernorm(params["final_norm"], x)


def logits(params, cfg: RWKVConfig, hidden: torch.Tensor) -> torch.Tensor:
    return layers.dense(params["head"], hidden, cfg.compute_dtype)


def state_shapes(cfg: RWKVConfig, batch: int):
    """The stacked per-layer state as ``meta`` tensors."""
    tm = cfg.tm()
    h, hd, n = tm.n_heads, tm.head_dim, cfg.n_layers
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
    for i in range(cfg.n_layers):
        p = _layer(params["body"], i)
        h = layers.layernorm(p["ln1"], x)
        tm_state, y = ssm.timemix_step(
            p["tm"], tm, {"wkv": state["wkv"][i], "x_prev": state["tm_x"][i]}, h,
            cfg.compute_dtype)
        x = x + y
        h = layers.layernorm(p["ln2"], x)
        y = ssm.channelmix(p["cm"], h[:, None, :], state["cm_x"][i],
                           compute_dtype=cfg.compute_dtype)[:, 0]
        x = x + y
        state["wkv"][i].copy_(tm_state["wkv"])
        state["tm_x"][i].copy_(tm_state["x_prev"])
        state["cm_x"][i].copy_(h)
    x = layers.layernorm(params["final_norm"], x)
    return state, logits(params, cfg, x)
