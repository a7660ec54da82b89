"""Rank-side helpers of ``tests/test_torch_tp.py``: the workers of a
tensor-parallel world import this module by name to run them, so it
imports only torch and the port."""

import torch

from repro_torch.distributed import constraints as tpc
from repro_torch.models import lm
from repro_torch.nn import moe


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
