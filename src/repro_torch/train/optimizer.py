"""AdamW with optional 8-bit moments, over the port's parameter trees.

The port of ``repro.train.optimizer``, with its functional API:
``apply_updates(params, grads, state, cfg) -> (params, state, metrics)``
over nested dicts and lists of tensors (``common.tree``).  The 8-bit path
keeps ``m`` and ``sqrt(v)`` as blockwise-scaled int8 (round half to even,
clamped to [-128, 127], zero-padded to ``qblock``), re-quantised each step.

A leaf the loss does not reach (BN running stats under ``train=True``) has
no gradient in torch, where JAX gives zeros: a ``None`` grad is taken as
zeros, so the norm, the decay and the moments are the reference's.
``value_and_grad`` takes the gradients of a loss in that form.

Inside a tensor-parallel group (``distributed.constraints``) the step runs
on each rank's cut: a cut leaf's gradient is its slice of the single
device's (the combines' backward), its moments are cut like it, and
AdamW's elementwise arithmetic on the cut is the whole's on that slice.
Two things cross the ranks, each in one collective a step: the global
norm (each cut leaf's sum of squares summed over the ranks, each
replicated leaf counted once, so every rank clips by the same bits) and,
after the update, the wholes the layers read beside a cut (``tp_whole``,
``sharding_rules.reads_whole``), gathered exactly from the updated cuts
(``constraints.wholes``) so each is again the whole of its leaf.  8-bit
moments block a cut leaf unlike its whole and are refused over a live
group (ROADMAP Queue 1 #5); the dry-run's group-less context traces them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.distributed import constraints as tp


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    quantized_state: bool = False  # 8-bit moments
    qblock: int = 256


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; f32 on
    ``step``'s device.  Every division is by a 0-d tensor: PyTorch divides
    by a Python scalar on the card, and divides a Python scalar by a tensor
    everywhere, through a reciprocal, which can be one ulp off."""
    step = torch.as_tensor(step)
    s = step.float()
    warm = torch.clamp((s + 1) / _f32(cfg.warmup_steps, s), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / _f32(max(1, cfg.total_steps - cfg.warmup_steps), s), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


# --- blockwise int8 moment quantisation --------------------------------------


def _q8(x: torch.Tensor, block: int):
    """(q int8 (n_blocks, block), scale f32 (n_blocks, 1))."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    amax = torch.clamp(blocks.abs().amax(dim=1, keepdim=True), min=1e-12)
    scale = amax / _f32(127.0, amax)
    q = torch.clamp(torch.round(blocks / scale), -128, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:size].reshape(shape)


def _refuse_quantized_in_a_world(cfg: AdamWConfig) -> None:
    ctx = tp.current()
    if cfg.quantized_state and ctx is not None and ctx.group is not None and ctx.size > 1:
        raise NotImplementedError(
            "8-bit moments (AdamWConfig.quantized_state) over a tensor-parallel world: "
            "a cut leaf's quantisation blocks are not its whole's; they wait for "
            "ROADMAP Queue 1 #5")


def init_state(params, cfg: AdamWConfig):
    """Zero moments for every leaf, on its device, and ``step`` 0 (int32);
    in a group each moment is cut like its leaf (it has the cut's
    shape)."""
    _refuse_quantized_in_a_world(cfg)
    def zero_like(p):
        if cfg.quantized_state:
            n_blocks = -(-p.numel() // cfg.qblock)
            return {
                "m_q": torch.zeros((n_blocks, cfg.qblock), dtype=torch.int8, device=p.device),
                "m_s": torch.zeros((n_blocks, 1), dtype=torch.float32, device=p.device),
                "v_q": torch.zeros((n_blocks, cfg.qblock), dtype=torch.int8, device=p.device),
                "v_s": torch.zeros((n_blocks, 1), dtype=torch.float32, device=p.device),
            }
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zero_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_shapes(param_shapes, cfg: AdamWConfig):
    """What ``init_state`` builds for parameters shaped like
    ``param_shapes``, as ``meta`` tensors (shapes and dtypes, no storage):
    f32 ``m`` / ``v`` like each parameter, or, with ``quantized_state``,
    int8 ``m_q`` / ``v_q`` (n_blocks, qblock) and f32 ``m_s`` / ``v_s``
    (n_blocks, 1); and the int32 ``step``.  The dry-run reads it."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def shape_like(p):
        if cfg.quantized_state:
            n_blocks = -(-math.prod(p.shape) // cfg.qblock)
            return {"m_q": meta((n_blocks, cfg.qblock), torch.int8),
                    "m_s": meta((n_blocks, 1), torch.float32),
                    "v_q": meta((n_blocks, cfg.qblock), torch.int8),
                    "v_s": meta((n_blocks, 1), torch.float32)}
        return {"m": meta(tuple(p.shape), torch.float32),
                "v": meta(tuple(p.shape), torch.float32)}
    return {"mu": tree_map(shape_like, param_shapes), "step": meta((), torch.int32)}


def global_norm(tree, params=None) -> torch.Tensor:
    """sqrt of the sum of squares of every (non-None) leaf, in f32.  In a
    tensor-parallel group, with ``params`` (the tree ``tree`` is the
    gradient of: its leaves say which are cut), the cut leaves' sum is
    summed over the ranks in one collective and the replicated leaves'
    added once."""
    leaves = tree_leaves(tree)
    if tp.current() is None or params is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves if x is not None))
    cut = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    rep = torch.zeros_like(cut)
    for x, p in zip(leaves, tree_leaves(params)):
        if x is not None:
            if tp.model_dim(p) is None:
                rep = rep + torch.sum(torch.square(x.float()))
            else:
                cut = cut + torch.sum(torch.square(x.float()))
    return torch.sqrt(tp.sum_over_ranks(cut, "global_norm") + rep)


def apply_updates(params, grads, state, cfg: AdamWConfig, donate: bool = False):
    """One AdamW step.  Returns (new_params, new_state, metrics).

    The lr comes from the step before the increment, the bias corrections
    from the step after; the global-norm clip and the weight decay cover
    every leaf.

    ``donate`` writes the new values into the tensors of ``params`` and
    ``state["mu"]`` in place (the reference's jitted step donates them) and
    returns those trees: the step then holds one leaf's temporaries in
    place of a second copy of the parameters and moments.  The values are
    the same bit for bit: each leaf is updated as in the functional step,
    then copied back."""
    _refuse_quantized_in_a_world(cfg)
    with torch.no_grad(), tp.phase("optimizer"):
        step = state["step"] + 1
        gnorm = global_norm(grads, params)
        clip = torch.clamp(_f32(cfg.grad_clip, gnorm) / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        lr = schedule(cfg, state["step"])
        bc1 = 1 - torch.pow(_f32(cfg.b1, step), step.float())
        bc2 = 1 - torch.pow(_f32(cfg.b2, step), step.float())

        def upd(p, g, mu):
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device) if g is None \
                else g.float() * clip
            if cfg.quantized_state:
                m = _dq8(mu["m_q"], mu["m_s"], g.shape, g.numel())
                # v is kept as quantised sqrt(v): sqrt halves the dynamic
                # range, so small entries do not round to zero
                v = torch.square(_dq8(mu["v_q"], mu["v_s"], g.shape, g.numel()))
            else:
                m, v = mu["m"], mu["v"]
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = p.float()
            new_p = (pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype)
            if cfg.quantized_state:
                mq, ms = _q8(m, cfg.qblock)
                vq, vs = _q8(torch.sqrt(v), cfg.qblock)
                return new_p, {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
            return new_p, {"m": m, "v": v}

        def upd_in_place(p, g, mu):
            new_p, new_mu = upd(p, g, mu)
            p.copy_(new_p)
            for k, t in new_mu.items():
                mu[k].copy_(t)
            return p, mu

        # at each parameter leaf: its grad (or None) and its moment dict
        out = tree_map(upd_in_place if donate else upd, params, grads, state["mu"])
        new_params = tree_map(lambda _, o: o[0], params, out)
        if tp.current() is not None:
            _keep_cuts(tree_leaves(params), tree_leaves(new_params))
    new_mu = tree_map(lambda _, o: o[1], params, out)
    return new_params, {"mu": new_mu, "step": step}, {"grad_norm": gnorm, "lr": lr}


def _keep_cuts(old: list, new: list) -> None:
    """The record of each updated cut leaf (``tp_dim``) and its whole
    (``tp_whole``), gathered from the updated cuts in one collective a
    dtype (into the old whole where the step donates)."""
    kept = [(p, q) for p, q in zip(old, new) if hasattr(p, "tp_whole")]
    for p, q in zip(old, new):
        if q is not p and hasattr(p, "tp_dim"):
            q.tp_dim = p.tp_dim
    fresh = tp.wholes([q for _, q in kept])
    for (p, q), w in zip(kept, fresh):
        if q is p:
            p.tp_whole.copy_(w)
        else:
            q.tp_whole = w


def _unflatten(structure, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def _leaf(p: torch.Tensor) -> torch.Tensor:
    """``p`` detached as a leaf to differentiate, keeping the record of a
    tensor-parallel cut (``tp_dim``, ``tp_whole``) that the layers read."""
    out = p.detach().requires_grad_(p.is_floating_point())
    for name in ("tp_dim", "tp_whole"):
        if hasattr(p, name):
            setattr(out, name, getattr(p, name))
    return out


def value_and_grad(fn, has_aux: bool = False):
    """``jax.value_and_grad`` over the first argument, a tree of tensors:
    returns ``g(params, *args) -> (value, grads)`` (``((value, aux),
    grads)`` with ``has_aux``), the value and grads detached.  A float
    leaf the value does not reach gets ``None``; ``apply_updates`` takes
    it as zeros.  In a tensor-parallel group each cut leaf's gradient is
    its slice of the single device's, each replicated leaf's the whole
    one, the same bits on every rank."""
    def g(params, *args, **kwargs):
        leaves = [_leaf(p) for p in tree_leaves(params)]
        out = fn(_unflatten(params, leaves), *args, **kwargs)
        value = out[0] if has_aux else out
        wrt = [p for p in leaves if p.requires_grad]
        # in a group the backward runs the combines' transposes (and remat's
        # replay of the forward's) under the context still open here
        with tp.phase("backward"):
            got = iter(torch.autograd.grad(value, wrt, allow_unused=True))
        grads = _unflatten(params, [next(got) if p.requires_grad else None
                                    for p in leaves])
        if has_aux:
            return (value.detach(), out[1]), grads
        return value.detach(), grads
    return g
