"""Rank-side helpers of ``tests/test_torch_dist_train.py``: the workers of
a world import this module by name to run them (``World.spmd``), so it
imports only torch and the port."""

import torch

from repro_torch.core import folding
from repro_torch.distributed import compression, gpipe
from repro_torch.distributed import constraints as tpc
from repro_torch.models import nvsa


def tanh_dense(p, h):
    """The reference test's stage: one dense layer and a tanh."""
    return torch.tanh(h @ p["w"] + p["b"])


def gpipe_dense(w, b, x):
    """On every rank: its stage of the stacked ``w`` / ``b`` (host tensors)
    through the pipeline over ``pod`` on the rank's device, the loss
    sum(out ** 2) and its backward.  Returns (out, this stage's grads)."""
    ctx = tpc.spmd_current("pod")
    p = {"w": w[ctx.rank].to(ctx.device, copy=True).requires_grad_(),
         "b": b[ctx.rank].to(ctx.device, copy=True).requires_grad_()}
    out = gpipe.make_pipelined_fn(tanh_dense, ctx.size, ctx.mesh, "pod")(p, x.to(ctx.device))
    (out ** 2).sum().backward()
    return out.detach(), {"w": p["w"].grad, "b": p["b"].grad}


def fold_dense(n_l, w, nn_x, vsa_x):
    """The reference's ``FOLD_SCRIPT`` streams folded over ``model``."""
    ctx = tpc.spmd_current("model")
    f = folding.make_folded_fn(ctx.mesh, "model", n_l, lambda x: torch.tanh(x @ w),
                               lambda x: torch.roll(x, 1, dims=-1) * 2.0,
                               tuple(nn_x.shape), tuple(vsa_x.shape))
    return f(nn_x, vsa_x)


def nvsa_streams(cfg, params, codebooks):
    """NVSA's two streams as folding takes them: the frontend on panels
    (N, H, W, 1) -> every attribute's PMFs side by side (N, sum V), and the
    symbolic back end on PMFs packed as ``pack_pmfs`` packs them (N, 16,
    sum V) -> the answer log-probs (N, 8)."""
    sizes = list(cfg.raven.attr_sizes)

    def nn_fn(x):
        return torch.cat(nvsa.frontend_pmfs(params, cfg, x)[0], dim=-1)

    def vsa_fn(x):
        parts = torch.split(x, sizes, dim=-1)
        return nvsa.reason(cfg, codebooks, [p[:, :8] for p in parts],
                           [p[:, 8:] for p in parts])[0]

    return nn_fn, vsa_fn


def pack_pmfs(ctx_pmfs, cand_pmfs):
    """Per-attribute (N, 8, V) context and candidate PMFs as one (N, 16,
    sum V) tensor."""
    return torch.cat([torch.cat([c, a], dim=1) for c, a in zip(ctx_pmfs, cand_pmfs)],
                     dim=-1)


def fold_nvsa(n_l, cfg, params, codebooks, images, packed):
    """NVSA's frontend folded beside its symbolic back end over ``model``."""
    ctx = tpc.spmd_current("model")
    nn_fn, vsa_fn = nvsa_streams(cfg, params, codebooks)
    n_v = sum(cfg.raven.attr_sizes)
    f = folding.make_folded_fn(ctx.mesh, "model", n_l, nn_fn, vsa_fn,
                               (images.shape[0], n_v), (packed.shape[0], 8))
    return f(images, packed)


def compressed_sum(g):
    """Each rank's ``g[rank]`` summed by ``compressed_psum`` over ``data``."""
    ctx = tpc.spmd_current("data")
    return compression.compressed_psum(g[ctx.rank], "data")
