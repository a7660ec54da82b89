"""Seamless-M4T-v2-class encoder-decoder backbone (speech-to-text).

The port of ``repro.models.encdec``.  As in the reference the speech
frontend is a stub: the caller supplies precomputed frame embeddings (B,
S_src, D), as if the w2v-BERT conformer feature extractor had run.  The
backbone is the full enc-dec transformer: a bidirectional encoder and a
causal decoder with cross-attention.  Decode runs the decoder over a
self-attention cache and the static encoder K/V, the paper's "critical
path between two streams" case: serving issues encode(batch i+1) before
decode(batch i) (``examples/serve_lm_torch.py``).

Every attention of the kind reaches the ``flash_attn`` kernel
(``kernels/flash_attn/ops.flash_mha``): the encoder's self-attention
without the causal mask (the reference's ``attend_full`` under an all-true
mask), the decoder's self-attention causal (``nn/attention.py:attention``)
and its cross-attention without the mask (``nn/attention.py:
cross_attention``), at the target length in training and at one query in
the decode step.  Only the decode step's self-attention over its cache is
plain PyTorch, as in every decoder of the port.

The parameters are the reference's leaf for leaf: the encoder and decoder
layers stacked under ``enc`` / ``dec``, which the port walks with
``models/lm.py:_unstack`` where the reference scans.  ``remat`` is the
reference's ``jax.checkpoint`` of each layer: under grad, each encoder and
decoder layer runs through ``torch.utils.checkpoint.checkpoint``
(non-reentrant), so the backward recomputes it, flash_attn launches
included; without grad it does nothing.  ``EncDecConfig`` is the
reference's without ``scan_unroll``, which tunes its compiled scan (eager
PyTorch has nothing for it to do).

In a tensor-parallel group every attention, the encoder's, the decoder's
and the cross-attention, runs the rank's heads through ``flash_mha`` and
ends in ``wo``'s row-parallel reduce (``nn/attention.py``); the biased
MLPs, the layernorms and the tied embedding run as ``nn/layers.py`` runs
them; the cross cache holds the rank's kv heads.  The ``kept_*`` steps
run ``encode``, ``decode_train``, ``init_caches`` and ``decode_step`` over
a dict kept between calls, as a tensor-parallel world's ranks run them
(``distributed.world.model_call``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_map
from repro_torch.models.lm import _run_layers, _stack_spec, _unstack, _xent
from repro_torch.nn import attention as attn
from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    rope_base: float = 10000.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self) -> attn.AttnConfig:
        return attn.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                               self.hd, rope_base=self.rope_base)


def _enc_layer_spec(cfg: EncDecConfig):
    return {
        "ln1": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": attn.gqa_spec(cfg.attn_cfg(), cfg.param_dtype),
        "ln2": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": layers.mlp_spec(cfg.d_model, cfg.d_ff, cfg.param_dtype, bias=True),
    }


def _dec_layer_spec(cfg: EncDecConfig):
    spec = _enc_layer_spec(cfg)
    spec["ln_x"] = layers.layernorm_spec(cfg.d_model, cfg.param_dtype)
    spec["xattn"] = attn.gqa_spec(cfg.attn_cfg(), cfg.param_dtype)
    return spec


def encdec_spec(cfg: EncDecConfig):
    return {
        "embed": layers.embedding_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "enc": _stack_spec(_enc_layer_spec(cfg), cfg.n_enc_layers),
        "dec": _stack_spec(_dec_layer_spec(cfg), cfg.n_dec_layers),
        "enc_norm": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
        "dec_norm": layers.layernorm_spec(cfg.d_model, cfg.param_dtype),
    }


def _enc_layer(cfg: EncDecConfig, p, x, positions):
    h = layers.layernorm(p["ln1"], x)
    x = x + attn.attention(p["attn"], cfg.attn_cfg(), h, positions, cfg.compute_dtype,
                           causal=False)                          # bidirectional
    h = layers.layernorm(p["ln2"], x)
    return x + layers.mlp(p["mlp"], h, compute_dtype=cfg.compute_dtype)


def encode(params, cfg: EncDecConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_src, D) stub frontend embeddings -> encoder states
    (B, S_src, D) in the compute dtype."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(cfg.compute_dtype)
    x = _run_layers(cfg, _enc_layer, params["enc"], cfg.n_enc_layers, x, positions)
    return layers.layernorm(params["enc_norm"], x)


def _dec_layer(cfg: EncDecConfig, p, x, enc_out, positions):
    acfg = cfg.attn_cfg()
    h = layers.layernorm(p["ln1"], x)
    x = x + attn.attention(p["attn"], acfg, h, positions, cfg.compute_dtype)
    h = layers.layernorm(p["ln_x"], x)
    enc_kv = attn.encode_kv(p["xattn"], acfg, enc_out, cfg.compute_dtype)
    x = x + attn.cross_attention(p["xattn"], acfg, h, enc_kv, cfg.compute_dtype)
    h = layers.layernorm(p["ln2"], x)
    return x + layers.mlp(p["mlp"], h, compute_dtype=cfg.compute_dtype)


def decode_train(params, cfg: EncDecConfig, enc_out: torch.Tensor,
                 tgt_tokens: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder: tgt_tokens (B, S_tgt) attending to
    enc_out (B, S_src, D) -> hidden states (B, S_tgt, D)."""
    positions = torch.arange(tgt_tokens.shape[1], device=tgt_tokens.device)
    x = layers.embedding(params["embed"], tgt_tokens, cfg.compute_dtype)
    x = _run_layers(cfg, _dec_layer, params["dec"], cfg.n_dec_layers, x, enc_out,
                    positions)
    return layers.layernorm(params["dec_norm"], x)


def loss_fn(params, cfg: EncDecConfig, batch) -> torch.Tensor:
    """batch: {frames (B, S_src, D), tgt_tokens (B, S_tgt), tgt_targets}."""
    enc_out = encode(params, cfg, batch["frames"])
    hidden = decode_train(params, cfg, enc_out, batch["tgt_tokens"])
    logits = layers.logits(params["embed"], hidden, cfg.compute_dtype)
    return _xent(logits, batch["tgt_targets"])


def cache_shapes(cfg: EncDecConfig, batch: int, max_len: int, src_len: int):
    """The decode caches as ``meta`` tensors, stacked over the decoder
    layers: the self-attention K/V of ``max_len`` tokens and the bf16
    cross-attention K/V of the ``src_len`` encoder states (in a
    tensor-parallel group, of the kv heads the rank's q heads read)."""
    acfg = cfg.attn_cfg()
    _, _, kvlo, kvhi = attn.tp_heads(acfg)
    cross = (batch, src_len, kvhi - kvlo, cfg.hd)
    per_layer = {
        "self": attn.kv_cache_shape(acfg, batch, max_len),
        "cross": {"k": torch.empty(cross, dtype=torch.bfloat16, device="meta"),
                  "v": torch.empty(cross, dtype=torch.bfloat16, device="meta")},
    }
    return tree_map(lambda s: torch.empty((cfg.n_dec_layers,) + tuple(s.shape),
                                          dtype=s.dtype, device="meta"), per_layer)


def init_caches(params, cfg: EncDecConfig, enc_out: torch.Tensor, max_len: int,
                device=None):
    """Decode caches on ``device`` (None = ``"cuda"``): zeroed
    self-attention K/V and each layer's cross K/V of ``enc_out``, cast to
    bf16 whatever the compute dtype, as the reference fixes it."""
    dev = registry.resolve_device(device)
    b, src_len = enc_out.shape[:2]
    caches = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                      cache_shapes(cfg, b, max_len, src_len))
    acfg = cfg.attn_cfg()
    for i, p in enumerate(_unstack(params["dec"], cfg.n_dec_layers)):
        kv = attn.encode_kv(p["xattn"], acfg, enc_out, cfg.compute_dtype)
        for name in ("k", "v"):
            caches["cross"][name][i] = kv[name]
    return caches


def decode_step(params, cfg: EncDecConfig, caches, token: torch.Tensor, pos):
    """token: (B,) ids; pos: an int or (B,) per-slot positions.  Writes
    each layer's self-attention K/V into ``caches`` in place and returns
    (caches, logits (B, V)); the cross caches are read only."""
    acfg = cfg.attn_cfg()
    cdt = cfg.compute_dtype
    n = cfg.n_dec_layers
    x = layers.embedding(params["embed"], token, cdt)
    for p, c in zip(_unstack(params["dec"], n), _unstack(caches, n)):
        h = layers.layernorm(p["ln1"], x)
        _, a = attn.decode_step(p["attn"], acfg, c["self"], h, pos, cdt)
        x = x + a
        h = layers.layernorm(p["ln_x"], x)
        x = x + attn.cross_attention(p["xattn"], acfg, h[:, None, :], c["cross"], cdt)[:, 0]
        h = layers.layernorm(p["ln2"], x)
        x = x + layers.mlp(p["mlp"], h[:, None, :], compute_dtype=cdt)[:, 0]
    x = layers.layernorm(params["dec_norm"], x)
    return caches, layers.logits(params["embed"], x, cdt)


# ---------------------------------------------------------------------------
# The serving steps over a kept state: the encoder states, then the decode
# caches (``distributed.world.model_call`` runs them on every rank)
# ---------------------------------------------------------------------------


def kept_encode(params, cfg: EncDecConfig, state: dict, frames: torch.Tensor):
    """The encoder states (B, S_src, D) of ``frames``, kept in ``state`` (in
    place of what it held) for ``kept_decode_train`` / ``kept_init_caches``."""
    state.clear()
    state["enc_out"] = encode(params, cfg, frames)
    return state["enc_out"]


def kept_decode_train(params, cfg: EncDecConfig, state: dict, tgt_tokens: torch.Tensor):
    """The teacher-forced decoder's logits (B, S_tgt, V) over the kept
    encoder states."""
    hidden = decode_train(params, cfg, state["enc_out"], tgt_tokens)
    return layers.logits(params["embed"], hidden, cfg.compute_dtype)


def kept_init_caches(params, cfg: EncDecConfig, state: dict, max_len: int) -> None:
    """The decode caches over the kept encoder states, kept in ``state`` for
    ``kept_decode_step``."""
    enc = state["enc_out"]
    state["caches"] = init_caches(params, cfg, enc, max_len, device=enc.device)


def kept_decode_step(params, cfg: EncDecConfig, state: dict, token: torch.Tensor, pos):
    """One decode step of ``token`` (B,) at ``pos`` over the kept caches:
    the logits (B, V)."""
    state["caches"], logits = decode_step(params, cfg, state["caches"], token, pos)
    return logits
