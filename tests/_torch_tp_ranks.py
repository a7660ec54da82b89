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
