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

Expert parallelism (``moe_gather``'s ``expert_shard=`` and
``MoEConfig.ep_constraint``) waits for the port's distribution layer
(ROADMAP Queue 1 #6) and raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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
    ep_constraint: bool = False  # a sharding constraint (Queue 1 #6)


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
    """x: (T, D) -> (weights (T, k), idx (T, k), probs (T, E) f32)."""
    logits = x.float() @ params["router"].float()
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
    counts = torch.bincount(flat, minlength=n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat, stable=True)
    ranks = torch.arange(flat.numel(), device=idx.device) - offsets[flat[order]]
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


def _refuse_ep(cfg: MoEConfig, expert_shard) -> None:
    if expert_shard is not None or cfg.ep_constraint:
        raise NotImplementedError(
            "expert parallelism (expert_shard=, ep_constraint) is not ported "
            "yet (ROADMAP Queue 1 #6, distribution)")


def moe_dense(params, cfg: MoEConfig, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """One-hot dispatch oracle. x: (T, D) -> (y (T, D), aux)."""
    _refuse_ep(cfg, None)
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
    its expert's capacity goes to one overflow slot, which is dropped."""
    _refuse_ep(cfg, expert_shard)
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    w, idx, probs = route(params, cfg, x)
    cap = _capacity(cfg, t)
    pos, keep = dispatch(idx, e, cap)
    slot = torch.where(keep, idx.reshape(-1) * cap + pos, e * cap)
    token_of = torch.arange(t * k, device=x.device) // k
    xc = x.to(compute_dtype)
    xe = torch.zeros((e * cap + 1, d), dtype=compute_dtype, device=x.device)
    xe[slot] = xc[token_of]
    ye = _expert_ffn(params["gate"], params["up"], params["down"],
                     xe[:-1].reshape(e, cap, d), compute_dtype)
    ye_flat = torch.cat([ye.reshape(e * cap, d),
                         torch.zeros((1, d), dtype=compute_dtype, device=x.device)])
    contrib = ye_flat[slot] * (w.reshape(-1, 1) * keep[:, None]).to(compute_dtype)
    # each token's k pairs are adjacent: a sum over them is the reference's
    # scatter-add, in a fixed order (index_add would add with atomics on a
    # GPU, in an order that changes from run to run)
    y = contrib.view(t, k, d).sum(dim=1)
    if cfg.n_shared:
        y = y + _shared(params, cfg, x, compute_dtype)
    return y, aux_load_balance_loss(probs, idx, e)


def moe_block(params, cfg: MoEConfig, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """x: (B, S, D) -> (y (B, S, D), aux_loss)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if cfg.impl == "dense":
        y, aux = moe_dense(params, cfg, xf, compute_dtype)
    else:
        y, aux = moe_gather(params, cfg, xf, compute_dtype)
    return y.reshape(b, s, d), aux
