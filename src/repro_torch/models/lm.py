"""Decoder-only transformer LM: the dense GQA architectures (llama3.2,
stablelm, starcoder2, gemma3's local:global pattern) and the MoE / MLA ones
(granite-moe's routed experts, deepseek-v3's dense prefix, MoE body, MLA
attention and MTP head).

The port of ``repro.models.lm``.  Layer heterogeneity is a repeating
*pattern unit*, as in the reference: parameters of one unit are stacked
over the repeat count under ``body`` (each leaf gains a leading
``(repeats, ...)`` axis), with unrolled ``prefix`` / ``tail`` layers around
it (deepseek-v3: 3 dense layers, then the MoE body).  The reference scans
``body`` with ``lax.scan``; the port loops over the layer axis of the same
stacked tensors, so the parameter trees are the reference's leaf for leaf.

Entry points: ``forward`` (the full context, behind
``configs.base.prefill_fn``; its unwindowed layers run the ``flash_attn``
kernel), ``lm_logits``, ``decode_step`` (per-slot positions, behind the
serving ``Engine``) and ``prefill``.  Computation runs where the
parameters and tokens lie.  The reference's ``remat`` and ``scan_unroll``
tune its compiled scan; eager PyTorch has nothing for them to do, so the
port's ``LMConfig`` leaves them out.

MoE FFN layers (``nn/moe.py``) add their load-balance loss to the
``aux`` that ``forward`` returns.  MLA layers (``attn_kind="mla"``) run
``nn/attention.py``'s ``mla_attention`` / ``mla_decode_step`` over the
compressed cache.  ``lm_spec`` holds the MTP head's parameters (``mtp``),
so the trees match the reference's; the head runs only in the reference's
``loss_fn``, which waits for training (Queue 1 #5), so serving never reads
it.  Parameters are drawn in ``param_dtype`` (deepseek-v3's is bf16).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_map
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import moe as moe_mod
from repro_torch.nn.init import P


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_base: float = 10000.0
    rope_base_local: float = 10000.0
    rotary_pct: float = 1.0
    attn_kind: str = "gqa"              # gqa | mla
    mla: attn.MLAConfig | None = None
    window: int | None = None           # sliding window for "local" layers
    pattern: tuple[str, ...] = ("global",)  # repeating attention pattern unit
    first_k_dense: int = 0              # deepseek: dense-FFN prefix depth
    dense_d_ff: int | None = None       # FFN width of the dense prefix
    moe: moe_mod.MoEConfig | None = None
    act: str = "swiglu"                 # swiglu | geglu | gelu
    norm_offset: float = 0.0            # gemma-style (1 + scale)
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = True
    mtp: bool = False                   # deepseek multi-token prediction head
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    logit_softcap: float | None = None
    embed_scale: bool = False           # gemma: embeddings × sqrt(d_model)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self, kind: str) -> attn.AttnConfig:
        local = kind == "local"
        return attn.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rope_base=self.rope_base_local if local else self.rope_base,
            rotary_dim=int(self.hd * self.rotary_pct) or None,
            window=self.window if local else None,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
        )


def _check_kind(cfg: LMConfig) -> None:
    if cfg.attn_kind not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: unknown attn_kind {cfg.attn_kind!r}")


# ---------------------------------------------------------------------------
# Stage structure: (prefix unrolled layers, stacked pattern unit × repeats)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StagePlan:
    prefix: tuple[tuple[str, str], ...]   # (attn_kind, ffn_kind) per layer
    unit: tuple[tuple[str, str], ...]
    repeats: int
    tail: tuple[tuple[str, str], ...]


def stage_plan(cfg: LMConfig) -> StagePlan:
    descs = []
    for i in range(cfg.n_layers):
        akind = cfg.pattern[i % len(cfg.pattern)]
        fkind = "dense" if (cfg.moe is None or i < cfg.first_k_dense) else "moe"
        descs.append((akind, fkind))
    prefix = tuple(descs[: cfg.first_k_dense])
    body = descs[cfg.first_k_dense:]
    # the smallest unit length that tiles the body
    for u in range(1, min(len(cfg.pattern) * 2 + 1, max(2, len(body))) + 1):
        reps = len(body) // u
        if reps >= 1 and all(body[i] == body[i % u] for i in range(reps * u)):
            tail = tuple(body[reps * u:])
            return StagePlan(prefix, tuple(body[:u]), reps, tail)
    return StagePlan(prefix, tuple(), 0, tuple(body))


def _layer_spec(cfg: LMConfig, akind: str, fkind: str):
    dt = cfg.param_dtype
    spec = {
        "ln1": layers.rmsnorm_spec(cfg.d_model, dt),
        "ln2": layers.rmsnorm_spec(cfg.d_model, dt),
    }
    if cfg.attn_kind == "mla":
        spec["attn"] = attn.mla_spec(cfg.mla, dt)
    else:
        spec["attn"] = attn.gqa_spec(cfg.attn_cfg(akind), dt)
    if fkind == "moe":
        spec["ffn"] = moe_mod.moe_spec(cfg.moe, dt)
        return spec
    d_ff = cfg.dense_d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        spec["ffn"] = layers.glu_mlp_spec(cfg.d_model, d_ff, dt)
    else:
        spec["ffn"] = layers.mlp_spec(cfg.d_model, d_ff, dt, bias=cfg.qkv_bias)
    return spec


def _stack_spec(spec, n: int):
    """Prepend a stacked layer axis to every P in a spec tree."""
    return tree_map(lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init,
                                p.scale, p.dtype, p.constant), spec)


def lm_spec(cfg: LMConfig):
    _check_kind(cfg)
    plan = stage_plan(cfg)
    spec = {
        "embed": layers.embedding_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "final_norm": layers.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "prefix": [_layer_spec(cfg, a, f) for a, f in plan.prefix],
        "tail": [_layer_spec(cfg, a, f) for a, f in plan.tail],
    }
    if plan.repeats:
        unit = {f"u{i}": _layer_spec(cfg, a, f) for i, (a, f) in enumerate(plan.unit)}
        spec["body"] = _stack_spec(unit, plan.repeats)
    if not cfg.tie_embeddings:
        spec["lm_head"] = layers.dense_spec(cfg.d_model, cfg.vocab,
                                            ("embed", "vocab"), dtype=cfg.param_dtype)
    if cfg.mtp:
        # the reference's MTP head; only its loss_fn (training) reads it
        spec["mtp"] = {
            "proj": layers.dense_spec(2 * cfg.d_model, cfg.d_model,
                                      ("embed", "embed2"), dtype=cfg.param_dtype),
            "layer": _layer_spec(cfg, cfg.pattern[0],
                                 "moe" if cfg.moe else "dense"),
            "norm": layers.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        }
    return spec


def _layer(tree, r: int):
    """Layer ``r`` of a stacked tree: views, no copy."""
    return tree_map(lambda t: t[r], tree)


def _layers(plan: StagePlan, params, caches=None):
    """(attention kind, ffn kind, layer params, layer cache or None) of
    every layer, in order."""
    def cache(tree, key):
        return None if tree is None else tree[key]

    for i, (a, f) in enumerate(plan.prefix):
        yield a, f, params["prefix"][i], cache(cache(caches, "prefix"), i)
    for r in range(plan.repeats):
        unit = _layer(params["body"], r)
        unit_cache = None if caches is None else _layer(caches["body"], r)
        for i, (a, f) in enumerate(plan.unit):
            yield a, f, unit[f"u{i}"], cache(unit_cache, f"u{i}")
    for i, (a, f) in enumerate(plan.tail):
        yield a, f, params["tail"][i], cache(cache(caches, "tail"), i)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn(cfg: LMConfig, params, fkind: str, x):
    """(y, aux): a MoE layer's load-balance loss, 0.0 for a dense one."""
    if fkind == "moe":
        return moe_mod.moe_block(params, cfg.moe, x, cfg.compute_dtype)
    if cfg.act == "swiglu":
        return layers.glu_mlp(params, x, layers.swiglu, cfg.compute_dtype), 0.0
    if cfg.act == "geglu":
        return layers.glu_mlp(params, x, layers.geglu, cfg.compute_dtype), 0.0
    return layers.mlp(params, x, layers.gelu, cfg.compute_dtype), 0.0


def _layer_fwd(cfg: LMConfig, akind: str, fkind: str, params, x, positions):
    h = layers.rmsnorm(params["ln1"], x, offset=cfg.norm_offset)
    if cfg.attn_kind == "mla":
        a = attn.mla_attention(params["attn"], cfg.mla, h, positions, cfg.compute_dtype)
    else:
        a = attn.attention(params["attn"], cfg.attn_cfg(akind), h, positions,
                           cfg.compute_dtype)
    x = x + a
    h = layers.rmsnorm(params["ln2"], x, offset=cfg.norm_offset)
    f, aux = _ffn(cfg, params["ffn"], fkind, h)
    return x + f, aux


def _embed(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = layers.embedding(params["embed"], tokens, cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    return x


def forward(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens: (B, S) -> (hidden (B, S, D), aux_loss).  ``aux_loss`` sums the
    MoE layers' load-balance losses (0.0 without MoE layers)."""
    _check_kind(cfg)
    plan = stage_plan(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, cfg, tokens)
    aux_total = 0.0
    for akind, fkind, p, _ in _layers(plan, params):
        x, aux = _layer_fwd(cfg, akind, fkind, p, x, positions)
        aux_total = aux_total + aux
    x = layers.rmsnorm(params["final_norm"], x, offset=cfg.norm_offset)
    return x, aux_total


def lm_logits(params, cfg: LMConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = layers.logits(params["embed"], hidden, cfg.compute_dtype)
    else:
        out = layers.dense(params["lm_head"], hidden, cfg.compute_dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out.float() / c) * c
    return out


# ---------------------------------------------------------------------------
# Serving: prefill + decode with stacked caches
# ---------------------------------------------------------------------------


def _layer_cache_shape(cfg: LMConfig, akind: str, batch: int, max_len: int):
    if cfg.attn_kind == "mla":
        return attn.mla_cache_shape(cfg.mla, batch, max_len)
    return attn.kv_cache_shape(cfg.attn_cfg(akind), batch, max_len)


def cache_shapes(cfg: LMConfig, batch: int, max_len: int):
    """The cache tree as ``meta`` tensors (stacked under ``body`` like the
    parameters)."""
    _check_kind(cfg)
    plan = stage_plan(cfg)
    shapes = {
        "prefix": [_layer_cache_shape(cfg, a, batch, max_len) for a, _ in plan.prefix],
        "tail": [_layer_cache_shape(cfg, a, batch, max_len) for a, _ in plan.tail],
    }
    if plan.repeats:
        unit = {f"u{i}": _layer_cache_shape(cfg, a, batch, max_len)
                for i, (a, _) in enumerate(plan.unit)}
        shapes["body"] = tree_map(
            lambda s: torch.empty((plan.repeats,) + tuple(s.shape), dtype=s.dtype,
                                  device="meta"), unit)
    return shapes


def init_caches(cfg: LMConfig, batch: int, max_len: int, device=None):
    """Zeroed caches on ``device`` (None = ``"cuda"``; the port's entry
    points name their device, where the reference allocates on JAX's
    default one)."""
    dev = registry.resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_shapes(cfg, batch, max_len))


def _layer_decode(cfg: LMConfig, akind: str, fkind: str, params, cache, x_t, pos):
    h = layers.rmsnorm(params["ln1"], x_t, offset=cfg.norm_offset)
    if cfg.attn_kind == "mla":
        cache, a = attn.mla_decode_step(params["attn"], cfg.mla, cache, h, pos,
                                        cfg.compute_dtype)
    else:
        cache, a = attn.decode_step(params["attn"], cfg.attn_cfg(akind), cache, h,
                                    pos, cfg.compute_dtype)
    x_t = x_t + a
    h = layers.rmsnorm(params["ln2"], x_t, offset=cfg.norm_offset)
    f, _ = _ffn(cfg, params["ffn"], fkind, h[:, None, :])
    return x_t + f[:, 0]


def decode_step(params, cfg: LMConfig, caches, token: torch.Tensor, pos):
    """token: (B,) ids; pos: an int or (B,) per-slot positions.  Writes
    each layer's K/V into ``caches`` in place; returns (caches, logits
    (B, V))."""
    _check_kind(cfg)
    plan = stage_plan(cfg)
    x = _embed(params, cfg, token)
    for akind, fkind, p, c in _layers(plan, params, caches):
        x = _layer_decode(cfg, akind, fkind, p, c, x, pos)
    x = layers.rmsnorm(params["final_norm"], x, offset=cfg.norm_offset)
    return caches, lm_logits(params, cfg, x)


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, max_len: int | None = None):
    """Run the full context; return (last-token logits, caches).

    As in the reference, the caches come back zeroed: it never writes the
    prompt's K/V back (ROADMAP Queue 3), and the port mirrors it.  The
    serving ``Engine`` fills its caches by scanning ``decode_step``."""
    b, s = tokens.shape
    max_len = max_len or s
    hidden, _ = forward(params, cfg, tokens)
    caches = init_caches(cfg, b, max_len, device=tokens.device)
    logits = lm_logits(params, cfg, hidden[:, -1:])[:, 0]
    return logits, caches
