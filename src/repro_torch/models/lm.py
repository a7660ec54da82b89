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
kernel), ``loss_fn`` (training: the causal-LM cross entropy), ``lm_logits``,
``decode_step`` (per-slot positions, behind the serving ``Engine``) and
``prefill``.  Computation runs where the parameters and tokens lie.

``remat`` is the reference's ``jax.checkpoint`` of each pattern unit of
``body``: under grad, each unit runs through
``torch.utils.checkpoint.checkpoint`` (non-reentrant), so the backward
recomputes it, flash_attn launches included; without grad it does
nothing.  The reference's ``scan_unroll`` tunes its compiled scan, and
eager PyTorch has nothing for it to do.  The body's stacked leaves are
unbound once per forward (``_unstack``), so their gradients are stacked
once, not accumulated layer by layer into full-size zeros.

MoE FFN layers (``nn/moe.py``) add their load-balance loss to the
``aux`` that ``forward`` returns, and ``loss_fn`` adds ``0.01 x aux``.
MLA layers (``attn_kind="mla"``) run ``nn/attention.py``'s
``mla_attention`` / ``mla_decode_step`` over the compressed cache.  The
MTP head (``mtp``, deepseek-v3) runs only in ``loss_fn``: one more layer
over ``proj([hidden, embed(targets)])`` predicting the token after next,
weighted 0.3.  Parameters are drawn in ``param_dtype`` (deepseek-v3's is
bf16).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backend import registry
from repro_torch.common.tree import tree_leaves, tree_map
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
    remat: bool = True                  # recompute each body unit in the backward
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


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree (parameters, caches or state),
    each leaf unbound once: views, no copy, whose gradients autograd
    stacks in one step."""
    if not n:
        return []
    cols = [_unbind(t) for t in tree_leaves(tree)]

    def layer(r: int):
        it = iter([c[r] for c in cols])
        return tree_map(lambda _: next(it), tree)

    return [layer(r) for r in range(n)]


def _unbind(t: torch.Tensor) -> tuple:
    """``t.unbind(0)``; a leaf cut for tensor parallelism hands where it
    was cut (``tp_dim``, ``distributed.sharding_rules.cut_leaf``) and the
    whole it keeps (``tp_whole``) on to each layer's view."""
    views = t.unbind(0)
    dim = getattr(t, "tp_dim", None)
    if dim is not None:
        wholes = t.tp_whole.unbind(0) if hasattr(t, "tp_whole") else (None,) * len(views)
        for v, w in zip(views, wholes):
            v.tp_dim = dim - 1
            if w is not None:
                v.tp_whole = w
    return views


def _needs_grad(*trees) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in tree_leaves(tree))


def _remat(cfg, fn, p, x, *args):
    """``fn(cfg, p, x, *args)``; under grad with ``cfg.remat``, through
    ``checkpoint`` (non-reentrant), so the backward recomputes it."""
    if cfg.remat and _needs_grad(p, x):
        return checkpoint(fn, cfg, p, x, *args, use_reentrant=False)
    return fn(cfg, p, x, *args)


def _run_layers(cfg, fn, stacked, n: int, x, *args):
    """``x = fn(cfg, p, x, *args)`` over the ``n`` layers (or units) ``p``
    of ``stacked``, each through ``_remat``."""
    for p in _unstack(stacked, n):
        x = _remat(cfg, fn, p, x, *args)
    return x


def _layers(plan: StagePlan, params, caches=None):
    """(attention kind, ffn kind, layer params, layer cache or None) of
    every layer, in order."""
    def cache(tree, key):
        return None if tree is None else tree[key]

    for i, (a, f) in enumerate(plan.prefix):
        yield a, f, params["prefix"][i], cache(cache(caches, "prefix"), i)
    units = _unstack(params["body"], plan.repeats)
    unit_caches = [None] * plan.repeats if caches is None \
        else _unstack(caches["body"], plan.repeats)
    for unit, unit_cache in zip(units, unit_caches):
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


def _unit_fwd(cfg: LMConfig, unit, x, positions, unit_kinds):
    aux_u = 0.0
    for i, (a, f) in enumerate(unit_kinds):
        x, aux = _layer_fwd(cfg, a, f, unit[f"u{i}"], x, positions)
        aux_u = aux_u + aux
    return x, aux_u


def body(params, cfg: LMConfig, x: torch.Tensor):
    """The layers and the final norm over embeddings x (B, S, D) ->
    (hidden, aux_loss); shared by ``forward`` and the VLM's forward.  Under
    grad with ``cfg.remat``, each pattern unit of ``body`` is recomputed in
    the backward."""
    plan = stage_plan(cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = 0.0
    for p, (a, f) in zip(params["prefix"], plan.prefix):
        x, aux = _layer_fwd(cfg, a, f, p, x, positions)
        aux_total = aux_total + aux
    for unit in _unstack(params["body"], plan.repeats):
        x, aux = _remat(cfg, _unit_fwd, unit, x, positions, plan.unit)
        aux_total = aux_total + aux
    for p, (a, f) in zip(params["tail"], plan.tail):
        x, aux = _layer_fwd(cfg, a, f, p, x, positions)
        aux_total = aux_total + aux
    x = layers.rmsnorm(params["final_norm"], x, offset=cfg.norm_offset)
    return x, aux_total


def forward(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens: (B, S) -> (hidden (B, S, D), aux_loss).  ``aux_loss`` sums the
    MoE layers' load-balance losses (0.0 without MoE layers)."""
    _check_kind(cfg)
    return body(params, cfg, _embed(params, cfg, tokens))


def lm_logits(params, cfg: LMConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = layers.logits(params["embed"], hidden, cfg.compute_dtype)
    else:
        out = layers.dense(params["lm_head"], hidden, cfg.compute_dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out.float() / c) * c
    return out


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32; targets (B, S) ids."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, targets[..., None].long(), dim=-1).mean()


def loss_fn(params, cfg: LMConfig, batch) -> torch.Tensor:
    """batch: {tokens (B, S), targets (B, S)} -> the scalar training loss:
    the cross entropy, deepseek's MTP term (0.3 x the cross entropy of the
    token after next) and ``0.01 x`` the MoE load-balance loss."""
    targets = batch["targets"]
    hidden, aux = forward(params, cfg, batch["tokens"])
    loss = _xent(lm_logits(params, cfg, hidden), targets)
    if cfg.mtp:
        # one extra depth predicting token t+2 from (hidden_t, embed(target_t))
        emb_next = layers.embedding(params["embed"], targets, cfg.compute_dtype)
        h2 = layers.dense(params["mtp"]["proj"], torch.cat([hidden, emb_next], dim=-1),
                          cfg.compute_dtype)
        h2, _ = _layer_fwd(cfg, cfg.pattern[0], "moe" if cfg.moe else "dense",
                           params["mtp"]["layer"], h2,
                           torch.arange(hidden.shape[1], device=hidden.device))
        h2 = layers.rmsnorm(params["mtp"]["norm"], h2, offset=cfg.norm_offset)
        loss = loss + 0.3 * _xent(lm_logits(params, cfg, h2[:, :-1]), targets[:, 1:])
    return loss + 0.01 * aux


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
