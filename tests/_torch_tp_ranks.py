"""Rank-side helpers of ``tests/test_torch_tp.py``, ``test_torch_tp_kinds.py``
and ``test_torch_tp_train.py``: the workers of a tensor-parallel world
import this module by name to run them, so it imports only torch and the
port."""

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.distributed import constraints as tpc
from repro_torch.distributed import world as W
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import train_step


def cut_dims(rank, layer: str = "u0") -> dict:
    """Where the rank's first body layer's attention leaves were cut."""
    attn = rank.params["body"][layer]["attn"]
    return {k: getattr(v, "tp_dim", None) for k, v in attn.items()}


def first_moe_block(rank, x) -> torch.Tensor:
    """The MoE block of the first body layer on ``x`` (1, T, D), f32."""
    cfg = rank.spec.cfg
    layer = lm._unstack(rank.params["body"], lm.stage_plan(cfg).repeats)[0]["u0"]
    y, _ = rank.run(lambda: moe.moe_block(layer["ffn"], cfg.moe, x.to(rank.device),
                                          torch.float32))
    return y


def kv_cache_heads(rank) -> int:
    """The kv heads of the rank's engine's first body cache."""
    rank.run(rank.engine._ensure_pool)
    return int(rank.engine._caches["body"]["u0"]["k"].shape[3])


def refuse_before_any_collective(rank):
    """Raise on every rank before any collective."""
    raise ValueError(f"rank {rank.ctx.rank} refused before any collective")


def raise_after_a_collective(rank):
    """Raise on every rank after one ``reduce_partial``."""
    rank.run(lambda: tpc.reduce_partial(torch.ones(2, device=rank.device)))
    raise ValueError(f"rank {rank.ctx.rank} raised after a collective")


def leaf_dims(rank, paths) -> list:
    """For each path (a tuple of keys) into the rank's parameters: the dim
    its leaf was cut along and whether it keeps its whole beside the cut."""
    out = []
    for path in paths:
        t = rank.params
        for k in path:
            t = t[k]
        out.append((getattr(t, "tp_dim", None), hasattr(t, "tp_whole")))
    return out


def pool_shapes(rank) -> dict:
    """The shapes of the rank's engine's decode state, by '/'-joined path."""
    rank.run(rank.engine._ensure_pool)
    return _shapes(rank.engine._caches)


def model_cache_shapes(rank) -> dict:
    """The shapes of the decode caches the enc-dec steps keep on the rank
    (``encdec.kept_init_caches``)."""
    return _shapes(rank.state["caches"])


def _shapes(tree, prefix: str = "") -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: tuple(tree.shape)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def load_caches(rank, whole) -> None:
    """Set the enc-dec decode caches the rank keeps (``rank.state``) from
    the whole caches ``whole`` (every layer's kv heads): the rank's share,
    the kv heads its q heads read."""
    from repro_torch.nn import attention as attn

    _, _, lo, hi = rank.run(lambda: attn.tp_heads(rank.spec.cfg.attn_cfg()))
    rank.state["caches"] = {
        part: {n: t[:, :, :, lo:hi].clone().to(rank.device) for n, t in kv.items()}
        for part, kv in whole.items()}


# -- training (``test_torch_tp_train.py``) ------------------------------------


def cut_invariants(rank) -> dict:
    """The rank's trainer's parameters: each cut the slice of the whole it
    keeps, bit for bit; the digests of the replicated leaves and the kept
    wholes (``world.trainer_digests``)."""
    ctx, params = rank.ctx, rank.engine.params
    slices = all(torch.equal(t, t.tp_whole.narrow(t.tp_dim, ctx.rank * t.shape[t.tp_dim],
                                                  t.shape[t.tp_dim]))
                 for t in tree_leaves(params) if hasattr(t, "tp_whole"))
    return {"slices": slices, "n_whole": sum(hasattr(t, "tp_whole") for t in tree_leaves(params)),
            "digests": W.trainer_digests(rank)}


def grads_then_step(rank, batch) -> dict:
    """On the rank's trainer: the loss and the gradients of its cut on
    ``batch`` (host tensors, None where autograd gives none), then one
    ``train_step`` on the same batch; the cut parameters after it, the
    global norm, each phase's collectives and ``cut_invariants``."""
    tr = rank.engine
    batch = {k: v.to(rank.device) for k, v in batch.items()}
    loss, grads = rank.run(lambda: opt.value_and_grad(tr.loss_fn)(tr.params, batch))
    rank.ctx.phases.clear()
    tr.params, tr.opt_state, metrics = rank.run(lambda: train_step(
        tr.loss_fn, tr.params, tr.opt_state, {k: v[None] for k, v in batch.items()}, tr.ocfg))
    return {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
            "grads": [None if g is None else g.cpu() for g in tree_leaves(grads)],
            "dims": [getattr(p, "tp_dim", None) for p in tree_leaves(tr.params)],
            "params": [p.detach().cpu() for p in tree_leaves(tr.params)],
            "phases": {ph: {op: n for op, (n, _, _) in ops.items()}
                       for ph, ops in rank.ctx.phases.items()},
            **cut_invariants(rank)}


def fed_updates(rank, grads_seq: list) -> dict:
    """``apply_updates`` under the rank's group from its trainer's
    parameters and fresh moments, fed in turn each whole gradient of
    ``grads_seq`` (lists of host tensors in leaf order) cut to the rank's
    slice: the cut parameters after the last, each step's global norm, the
    replicated leaves' and kept wholes' digests, and whether each cut is
    the slice of its kept whole.  The trainer's own state is not touched."""
    tr, r = rank.engine, rank.ctx.rank
    params, state, norms = tr.params, opt.init_state(tr.params, tr.ocfg), []
    for grads in grads_seq:
        cut = iter([g.narrow(p.tp_dim, r * p.shape[p.tp_dim], p.shape[p.tp_dim])
                    if hasattr(p, "tp_dim") else g
                    for g, p in zip(grads, tree_leaves(params))])
        tree = tree_map(lambda _: next(cut).contiguous().to(rank.device), params)
        params, state, m = rank.run(lambda: opt.apply_updates(params, tree, state, tr.ocfg))
        norms.append(float(m["grad_norm"]))
    leaves = tree_leaves(params)
    return {"params": [p.detach().cpu() for p in leaves], "norms": norms,
            "digests": W.trainer_digests(rank, params),
            "slices": all(torch.equal(t, t.tp_whole.narrow(
                t.tp_dim, r * t.shape[t.tp_dim], t.shape[t.tp_dim]))
                for t in leaves if hasattr(t, "tp_whole"))}


def leaf_digests(rank) -> list:
    """The ``digest`` of every leaf the rank holds (its trainer's, or the
    model's parameters)."""
    params = rank.engine.params if rank.params is None else rank.params
    return [W.digest(t) for t in tree_leaves(params)]


def whole_params(rank):
    """The trainer's parameters made whole (every rank gathers; rank 0
    gets them)."""
    state = rank.run(rank.engine.whole_state)
    return None if state is None else state["params"]


def raise_after_a_backward_collective(rank):
    """A backward that sums a column-parallel input's gradient over the
    ranks, then a raise on every rank."""
    def step():
        x = torch.ones(3, device=rank.device, requires_grad=True)
        tpc.copy_in(x).sum().backward()
    rank.run(step)
    raise ValueError(f"rank {rank.ctx.rank} raised after a backward collective")
