"""Griffin / RecurrentGemma: RG-LRU recurrent blocks and local attention,
two to one.

The port of ``repro.models.griffin``.  Arch ``recurrentgemma-9b``: 38
layers, d_model 4096, MQA (one KV head of 256) with a 2048-token window,
d_ff 12288, vocab 256000, the pattern (rec, rec, attn).  The pattern unit
is stacked over its repeats under ``body`` and the remainder is unrolled
under ``tail`` (``GriffinConfig.plan``), the reference's layout.

Decode state: per recurrent layer the RG-LRU hidden (B, D) in f32 and the
conv carry (B, K-1, D) in bf16; per attention layer the windowed ring KV
cache of ``nn/attention.py``.  ``decode_step`` writes every layer's state
in place and returns the tree, as ``models.lm.decode_step`` does.  The
attention layers are windowed, so the forward keeps the plain twins there
(``nn/attention.py:attention``); the flash_attn kernel is not on this path.
``loss_fn`` is the reference's: the cross entropy of the tied readout.  With
``remat``, each unit of ``body`` is recomputed in the backward under grad.

In a tensor-parallel group a recurrent block runs the rank's channels:
``in_x`` / ``in_gate`` column-parallel (cut on ``mlp``), the conv and the
RG-LRU on the same channels, ``out`` row-parallel; its decode state holds
those channels (``rec_width``).  The MQA attention keeps, on every rank,
the kv head its q heads read, as ``nn/attention.py`` does wherever the kv
heads do not divide the group.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_map
from repro_torch.distributed import constraints as tp
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models.lm import _run_layers, _stack_spec, _unstack, _xent
from repro_torch.nn import attention as attn
from repro_torch.nn import layers, ssm


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    """The reference's ``GriffinConfig`` without ``scan_unroll`` (see
    ``models.rwkv6.RWKVConfig``)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    lru_width: int | None = None
    window: int = 2048
    conv_width: int = 4
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    rope_base: float = 10000.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def rnn_d(self) -> int:
        return self.lru_width or self.d_model

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self) -> attn.AttnConfig:
        return attn.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads, self.hd,
                               rope_base=self.rope_base, window=self.window)

    def lru(self) -> ssm.RGLRUConfig:
        return ssm.RGLRUConfig(self.rnn_d)

    def plan(self):
        """(the pattern unit, its repeats, the layer kinds of the tail)."""
        descs = tuple(self.pattern[i % len(self.pattern)] for i in range(self.n_layers))
        u = len(self.pattern)
        reps = self.n_layers // u
        return descs[: reps * u][:u], reps, descs[reps * u:]


def _rec_spec(cfg: GriffinConfig):
    d, r = cfg.d_model, cfg.rnn_d
    return {
        "ln": layers.rmsnorm_spec(d, cfg.param_dtype),
        "in_x": layers.dense_spec(d, r, ("embed", "mlp"), dtype=cfg.param_dtype),
        "in_gate": layers.dense_spec(d, r, ("embed", "mlp"), dtype=cfg.param_dtype),
        "conv": layers.conv1d_spec(r, cfg.conv_width, cfg.param_dtype),
        "lru": ssm.rglru_spec(cfg.lru(), cfg.param_dtype),
        "out": layers.dense_spec(r, d, ("mlp", "embed"), dtype=cfg.param_dtype),
        "ln2": layers.rmsnorm_spec(d, cfg.param_dtype),
        "mlp": layers.glu_mlp_spec(d, cfg.d_ff, cfg.param_dtype),
    }


def _attn_spec(cfg: GriffinConfig):
    return {
        "ln": layers.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": attn.gqa_spec(cfg.attn_cfg(), cfg.param_dtype),
        "ln2": layers.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": layers.glu_mlp_spec(cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def _spec(cfg: GriffinConfig, kind: str):
    return _rec_spec(cfg) if kind == "rec" else _attn_spec(cfg)


def griffin_spec(cfg: GriffinConfig):
    unit, reps, tail = cfg.plan()
    return {
        "embed": layers.embedding_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "final_norm": layers.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "body": _stack_spec({f"u{i}": _spec(cfg, k) for i, k in enumerate(unit)}, reps),
        "tail": [_spec(cfg, k) for k in tail],
    }


def _layers(cfg: GriffinConfig, params, state=None):
    """(kind, layer params, layer state or None) of every layer, in order."""
    unit, reps, tail = cfg.plan()
    states = [None] * reps if state is None else _unstack(state["body"], reps)
    for up, us in zip(_unstack(params["body"], reps), states):
        for i, k in enumerate(unit):
            yield k, up[f"u{i}"], None if us is None else us[f"u{i}"]
    for i, k in enumerate(tail):
        yield k, params["tail"][i], None if state is None else state["tail"][i]


def _embed(params, cfg: GriffinConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = layers.embedding(params["embed"], tokens, cfg.compute_dtype)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)


def _mlp(cfg: GriffinConfig, p, x):
    h = layers.rmsnorm(p["ln2"], x)
    return x + layers.glu_mlp(p["mlp"], h, compute_dtype=cfg.compute_dtype)


def _rec_in(cfg: GriffinConfig, p, h):
    """(gate, x) of a recurrent block's input projections and whether they
    hold the rank's channels (in a group, column-parallel on ``mlp``)."""
    xm = layers.column_input(h.to(cfg.compute_dtype), p["in_gate"]["w"], p["in_x"]["w"])
    gate, local = layers._dense_out(p["in_gate"], h, cfg.compute_dtype, xm)
    xr, _ = layers._dense_out(p["in_x"], h, cfg.compute_dtype, xm)
    return layers.gelu(gate), xr, local


def _rec_out(cfg: GriffinConfig, p, y, local: bool):
    """The block's output projection of ``y`` (row-parallel on the rank's
    channels in a group)."""
    return layers._dense_in(p["out"], y, local, cfg.compute_dtype)


def _rec_fwd(cfg: GriffinConfig, p, x):
    h = layers.rmsnorm(p["ln"], x)
    gate, xr, local = _rec_in(cfg, p, h)
    xr = layers.causal_conv1d(p["conv"], xr, cfg.compute_dtype)
    hr, _ = ssm.rglru(p["lru"], cfg.lru(), xr)
    x = x + _rec_out(cfg, p, hr * gate, local)
    return _mlp(cfg, p, x)


def _attn_fwd(cfg: GriffinConfig, p, x, positions):
    h = layers.rmsnorm(p["ln"], x)
    x = x + attn.attention(p["attn"], cfg.attn_cfg(), h, positions, cfg.compute_dtype)
    return _mlp(cfg, p, x)


def _fwd(cfg: GriffinConfig, kind: str, p, x, positions):
    return _rec_fwd(cfg, p, x) if kind == "rec" else _attn_fwd(cfg, p, x, positions)


def _unit_fwd(cfg: GriffinConfig, up, x, positions):
    for i, kind in enumerate(cfg.plan()[0]):
        x = _fwd(cfg, kind, up[f"u{i}"], x, positions)
    return x


def forward(params, cfg: GriffinConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> hidden (B, S, D) after the final norm."""
    unit, reps, tail = cfg.plan()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, cfg, tokens)
    x = _run_layers(cfg, _unit_fwd, params["body"], reps, x, positions)
    for p, kind in zip(params["tail"], tail):
        x = _fwd(cfg, kind, p, x, positions)
    return layers.rmsnorm(params["final_norm"], x)


def logits(params, cfg: GriffinConfig, hidden: torch.Tensor) -> torch.Tensor:
    """The tied-embedding readout."""
    return layers.logits(params["embed"], hidden, cfg.compute_dtype)


def loss_fn(params, cfg: GriffinConfig, batch) -> torch.Tensor:
    """batch: {tokens (B, S), targets (B, S)} -> the cross entropy."""
    return _xent(logits(params, cfg, forward(params, cfg, batch["tokens"])),
                 batch["targets"])


def rec_width(cfg: GriffinConfig) -> int:
    """The RG-LRU channels this rank runs: in a group whose rules cut
    ``in_x`` on ``mlp``, its share of them; else all."""
    ctx = tp.current()
    if ctx is not None and sr.cut_dim(_rec_spec(cfg)["in_x"]["w"], ctx.mesh) == 1:
        return cfg.rnn_d // ctx.size
    return cfg.rnn_d


def _rec_state(cfg: GriffinConfig, batch: int):
    r = rec_width(cfg)
    return {
        "lru": torch.empty((batch, r), dtype=torch.float32, device="meta"),
        "conv": torch.empty((batch, cfg.conv_width - 1, r),
                            dtype=torch.bfloat16, device="meta"),
    }


def _state(cfg: GriffinConfig, kind: str, batch: int, max_len: int):
    if kind == "rec":
        return _rec_state(cfg, batch)
    return attn.kv_cache_shape(cfg.attn_cfg(), batch, max_len)


def state_shapes(cfg: GriffinConfig, batch: int, max_len: int):
    """The state tree as ``meta`` tensors (stacked under ``body``)."""
    unit, reps, tail = cfg.plan()
    unit_state = {f"u{i}": _state(cfg, k, batch, max_len) for i, k in enumerate(unit)}
    return {
        "body": tree_map(lambda s: torch.empty((reps,) + tuple(s.shape), dtype=s.dtype,
                                               device="meta"), unit_state),
        "tail": [_state(cfg, k, batch, max_len) for k in tail],
    }


def init_state(cfg: GriffinConfig, batch: int, max_len: int, device=None):
    """Zeroed state on ``device`` (None = ``"cuda"``)."""
    dev = registry.resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    state_shapes(cfg, batch, max_len))


def _rec_step(cfg: GriffinConfig, p, st, x):
    h = layers.rmsnorm(p["ln"], x)
    gate, xr, local = _rec_in(cfg, p, h)
    conv_st, xr = layers.causal_conv1d_step(p["conv"], st["conv"], xr)
    lru_st, hr = ssm.rglru_step(p["lru"], cfg.lru(), st["lru"], xr)
    st["conv"].copy_(conv_st)
    st["lru"].copy_(lru_st)
    x = x + _rec_out(cfg, p, hr * gate, local)
    return _mlp(cfg, p, x)


def _attn_step(cfg: GriffinConfig, p, st, x, pos):
    h = layers.rmsnorm(p["ln"], x)
    _, a = attn.decode_step(p["attn"], cfg.attn_cfg(), st, h, pos, cfg.compute_dtype)
    return _mlp(cfg, p, x + a)


def decode_step(params, cfg: GriffinConfig, state, token: torch.Tensor, pos):
    """token: (B,) ids; pos: an int or (B,) per-slot positions (the ring
    entry of the attention layers).  Writes every layer's state in place;
    returns (state, logits (B, V))."""
    x = _embed(params, cfg, token)
    for kind, p, st in _layers(cfg, params, state):
        x = _rec_step(cfg, p, st, x) if kind == "rec" else _attn_step(cfg, p, st, x, pos)
    x = layers.rmsnorm(params["final_norm"], x)
    return state, logits(params, cfg, x)
