"""Mixture-of-Experts: routing, capacity-bounded dispatch, expert FFNs.

The port of ``repro.nn.moe``.  The reference computes the MoE in plain
XLA, with no Pallas kernel, and the port computes it in plain PyTorch:
``topk`` routing, a stable sort for each (token, slot) pair's place in
its expert's queue, ``index_put`` into (E, capacity, D) buffers, batched
expert matmuls (``bmm``), and each token's k weighted expert outputs
gathered back and summed.  Two paths share one
parameter layout (E stacked experts):

- ``gather`` (default): each expert takes at most ``_capacity`` pairs in
  token order; the rest go to an overflow slot and are dropped, exactly
  the pairs the reference drops.
- ``dense``: the reference's one-hot dispatch oracle (O(T·E·C) memory),
  for small tests.

Expert parallelism, as in the reference: ``moe_gather(...,
expert_shard=(lo, n))`` serves experts [lo, lo + n) only (the shared
expert on shard 0 only), and its output is a partial sum the caller
reduces.  Inside a tensor-parallel group (``distributed.constraints``)
``moe_block`` takes the rank's experts from the rules (experts over the
``model`` axis, ``TP_RULES["experts"]``), routes on the whole router,
and ends in ``reduce_partial``; each pair keeps the queue position it has
on one device, so the same pairs are dropped.  Under grad the whole
tokens and routing weights that enter the rank's experts (and the router's
cut columns) pass ``copy_in``, so their gradients are summed over the
ranks before they meet the whole routing.  ``MoEConfig.ep_constraint``
is the reference's GSPMD hint on the expert buffers: the identity outside
a group, as ``maybe_constrain`` is, and inside one too, where each rank's
buffers hold only its experts already.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import constraints as tp
from repro_torch.nn import layers
from repro_torch.nn.init import P


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0  # always-on shared experts (DeepSeek)
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    impl: str = "gather"  # gather | dense
    router_norm_topk: bool = True  # renormalize top-k probs
    ep_constraint: bool = False  # GSPMD's expert-buffer hint: the identity here


def moe_spec(cfg: MoEConfig, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = lambda fan: 1.0 / math.sqrt(fan)  # noqa: E731
    spec = {
        "router": P((d, e), ("embed", "experts"), dtype=torch.float32, scale=s(d)),
        "gate": P((e, d, f), ("experts", "embed", "mlp"), dtype=dtype, scale=s(d)),
        "up": P((e, d, f), ("experts", "embed", "mlp"), dtype=dtype, scale=s(d)),
        "down": P((e, f, d), ("experts", "mlp", "embed"), dtype=dtype, scale=s(f)),
    }
    if cfg.n_shared:
        sf = cfg.shared_d_ff or cfg.d_ff * cfg.n_shared
        spec["shared"] = layers.glu_mlp_spec(d, sf, dtype=dtype)
    return spec


def route(params, cfg: MoEConfig, x: torch.Tensor):
    """x: (T, D) -> (weights (T, k), idx (T, k), probs (T, E) f32).  In a
    group, a router cut along its experts gives each rank's columns of the
    logits, made whole, so every rank routes on the same bits."""
    router = params["router"]
    if tp.model_dim(router) == 1:
        logits = tp.gather_last(tp.copy_in(x.float()) @ router.float())
    else:
        logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, idx, probs


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss (mean prob × mean assignment fraction)."""
    me = probs.mean(dim=0)
    assign = F.one_hot(idx, n_experts).float().sum(dim=1)  # (T, E)
    ce = assign.mean(dim=0)
    return n_experts * torch.sum(me * ce)


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts))
    return max(4, -(-c // 4) * 4)


def dispatch(idx: torch.Tensor, n_experts: int, cap: int):
    """Queue position of each (token, slot) pair within its expert, in
    token order (a stable sort, as in the reference), and whether the pair
    fits the expert's ``cap``.  idx: (T, k) -> (pos, keep), both (T*k,)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    by_expert = flat[order]
    # each expert's first place in the sorted pairs (``bincount`` has no
    # ``meta`` kernel, which the dry-run traces on)
    offsets = torch.searchsorted(by_expert, torch.arange(n_experts, dtype=flat.dtype,
                                                         device=idx.device))
    ranks = torch.arange(flat.numel(), device=idx.device) - offsets[by_expert]
    pos = torch.empty_like(flat)
    pos[order] = ranks
    return pos, pos < cap


def _expert_ffn(gate_w, up_w, down_w, xe: torch.Tensor, compute_dtype) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D), batched over experts."""
    g = torch.bmm(xe, gate_w.to(compute_dtype))
    u = torch.bmm(xe, up_w.to(compute_dtype))
    return torch.bmm(F.silu(g) * u, down_w.to(compute_dtype))


def _shared(params, cfg: MoEConfig, x: torch.Tensor, compute_dtype):
    return layers.glu_mlp(params["shared"], x, compute_dtype=compute_dtype)


def moe_dense(params, cfg: MoEConfig, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """One-hot dispatch oracle. x: (T, D) -> (y (T, D), aux)."""
    t, _ = x.shape
    w, idx, probs = route(params, cfg, x)
    cap = _capacity(cfg, t)
    pos, keep = dispatch(idx, cfg.n_experts, cap)
    pos, keep = pos.reshape(t, cfg.top_k), keep.reshape(t, cfg.top_k)
    onehot_e = F.one_hot(idx, cfg.n_experts).to(compute_dtype)
    # a dropped pair's position lies past the capacity: no column, as
    # jax.nn.one_hot gives for an index out of range
    onehot_c = F.one_hot(torch.where(keep, pos, 0), cap).to(compute_dtype) \
        * keep[..., None].to(compute_dtype)
    disp = onehot_e[..., :, None] * onehot_c[..., None, :]  # (T,k,E,C)
    comb = disp * w[..., None, None].to(compute_dtype)
    xe = torch.einsum("td,tkec->ecd", x.to(compute_dtype), disp)
    ye = _expert_ffn(params["gate"], params["up"], params["down"], xe, compute_dtype)
    y = torch.einsum("ecd,tkec->td", ye, comb)
    if cfg.n_shared:
        y = y + _shared(params, cfg, x, compute_dtype)
    return y, aux_load_balance_loss(probs, idx, cfg.n_experts)


def moe_gather(params, cfg: MoEConfig, x: torch.Tensor, compute_dtype=torch.bfloat16,
               expert_shard: tuple[int, int] | None = None):
    """Gather/scatter path. x: (T, D) -> (y (T, D), aux).  Every pair past
    its expert's capacity goes to one overflow slot, which is dropped.

    ``expert_shard=(lo, n)`` serves experts [lo, lo + n) only: ``y`` is a
    partial sum the caller reduces over the shards, and the shared expert
    is added on shard 0 only.  The expert weights may be whole (they are
    sliced) or already the shard's ``n``."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    w, idx, probs = route(params, cfg, x)
    lo, n_local = expert_shard if expert_shard is not None else (0, e)
    cap = _capacity(cfg, t)
    flat = idx.reshape(-1)
    local = (flat >= lo) & (flat < lo + n_local)
    # pairs of other shards go to an overflow expert n_local; a pair's
    # place in its expert's queue is the one it has over all experts
    pos, _ = dispatch(torch.where(local, flat - lo, n_local).reshape(idx.shape),
                      n_local + 1, cap)
    keep = local & (pos < cap)
    slot = torch.where(keep, (flat - lo) * cap + pos, n_local * cap)
    token_of = torch.arange(t * k, device=x.device) // k
    # in a group the tokens and weights below feed only the rank's experts
    xc = tp.copy_in(x.to(compute_dtype))
    w = tp.copy_in(w)
    xe = torch.zeros((n_local * cap + 1, d), dtype=compute_dtype, device=x.device)
    xe[slot] = xc[token_of]
    gate_w, up_w, down_w = (params[name] if params[name].shape[0] == n_local
                            else params[name][lo:lo + n_local]
                            for name in ("gate", "up", "down"))
    ye = _expert_ffn(gate_w, up_w, down_w, xe[:-1].reshape(n_local, cap, d),
                     compute_dtype)
    ye_flat = torch.cat([ye.reshape(n_local * cap, d),
                         torch.zeros((1, d), dtype=compute_dtype, device=x.device)])
    contrib = ye_flat[slot] * (w.reshape(-1, 1) * keep[:, None]).to(compute_dtype)
    # each token's k pairs are adjacent: a sum over them is the reference's
    # scatter-add, in a fixed order (index_add would add with atomics on a
    # GPU, in an order that changes from run to run)
    y = contrib.view(t, k, d).sum(dim=1)
    if cfg.n_shared and lo == 0:
        y = y + _shared(params, cfg, x, compute_dtype)
    return y, aux_load_balance_loss(probs, idx, e)


def _moe_block_tp(params, cfg: MoEConfig, xf: torch.Tensor, compute_dtype):
    """A group's MoE layer: the rank's experts on every rank's routes,
    reduced; the shared expert tensor-parallel after the reduce."""
    lo, hi = tp.local_range(cfg.n_experts)
    y, aux = moe_gather(params, dataclasses.replace(cfg, n_shared=0), xf,
                        compute_dtype, expert_shard=(lo, hi - lo))
    y = tp.reduce_partial(y)
    if cfg.n_shared:
        y = y + _shared(params, cfg, xf, compute_dtype)
    return y, aux


def moe_block(params, cfg: MoEConfig, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """x: (B, S, D) -> (y (B, S, D), aux_loss)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if tp.current() is not None:
        y, aux = _moe_block_tp(params, cfg, xf, compute_dtype)
    elif cfg.impl == "dense":
        y, aux = moe_dense(params, cfg, xf, compute_dtype)
    else:
        y, aux = moe_gather(params, cfg, xf, compute_dtype)
    return y.reshape(b, s, d), aux
