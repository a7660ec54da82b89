"""Layers: dense, embedding, norms, RoPE, activations, MLP blocks, the
causal temporal conv of the RG-LRU block (the LM substrate) and conv,
batchnorm (eval and train mode), pooling (the NVSA frontend).

Each layer is a pair (``<name>_spec`` -> P tree, ``<name>`` apply fn) like
``repro.nn.layers``.  The LM layers keep the reference's arithmetic: norms
in f32, RoPE angles in f32 with the rotate-half layout (not interleaved
pairs), and GELU in its tanh form, which ``jax.nn.gelu`` takes by default.  Activations keep the reference's NHWC layout at every
public function.  Conv weights are OIHW (``repro_torch.interop`` converts
the reference's HWIO once); inside, an NHWC tensor is handed to
``F.conv2d`` as a channels-last NCHW view, so no copy is made.

``"SAME"`` padding follows XLA: the total padding is split with the odd
element at the end, so it is asymmetric at stride 2 (on 32×32 inputs the
7×7/2 stem pads (2, 3) and the 3/2 max-pool (0, 1), with −inf).  PyTorch's
symmetric ``padding=`` would differ; the pads are applied with ``F.pad``.

Inside a tensor-parallel group (``distributed.constraints.tp_group``) the
LM layers take their rank's cut of each leaf, by where it was cut
(``tp_dim``): ``dense`` and the MLP blocks are column-parallel on a weight
cut along its output dim (the whole input passes ``copy_in``, once for the
gate and up projections that share it, so its gradient is summed over the
ranks) and row-parallel, ending in ``reduce_partial``, on one cut along its
input dim; the embedding is a masked lookup plus ``reduce_partial`` on a
vocab-cut table and a lookup plus ``gather_last`` on an embed-cut one (the
fallback); ``logits`` end in ``gather_last``; a cut norm scale or bias is
made whole.  The activations between layers are whole on every rank;
``groupnorm`` and the causal conv, channel-wise, run on the rank's channels
inside a block.  Outside a group the same code runs on whole leaves: no cut
is taken and no collective is made.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import constraints as tp
from repro_torch.nn.init import P


def dense_spec(d_in: int, d_out: int, axes=("embed", "mlp"), bias: bool = False,
               dtype=torch.float32, scale: float | None = None):
    spec = {"w": P((d_in, d_out), axes, init="normal", scale=scale, dtype=dtype)}
    if bias:
        spec["b"] = P((d_out,), (axes[1],), init="zeros", dtype=dtype)
    return spec


def dense(params, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ w (+ b)``, whole on every rank of a group (``_dense_in``)."""
    return _dense_in(params, x, False, compute_dtype)


def _bias(params, y: torch.Tensor, local: bool, compute_dtype) -> torch.Tensor:
    """``y`` plus the bias, cut like ``y``'s last dim (``local``) or whole."""
    if "b" not in params:
        return y
    b = params["b"]
    if local != (tp.model_dim(b) is not None):
        b = tp.take_local(b, 0) if local else tp.whole(b)
    return y + b.to(compute_dtype)


def _dense_out(params, x: torch.Tensor, compute_dtype, xm: torch.Tensor | None = None):
    """A dense on a whole ``x``: (y, whether y's last dim is this rank's
    cut; never outside a group).  Column-parallel on a weight cut along its
    output dim, on ``xm`` (``x`` in the compute dtype through ``copy_in``,
    which a caller shares between projections, ``column_input``; made here
    where None); a weight cut along its input dim takes the rank's slice of
    ``x`` and reduces the partial product."""
    w = params["w"]
    dim = tp.model_dim(w)
    if dim == 1:
        if xm is None:
            xm = tp.copy_in(x.to(compute_dtype))
        y = xm @ w.to(compute_dtype)
        return _bias(params, y, True, compute_dtype), True
    if dim == 0:
        y = tp.reduce_partial(tp.take_local(x, -1).to(compute_dtype) @ w.to(compute_dtype))
    else:
        y = x.to(compute_dtype) @ w.to(compute_dtype)
    return _bias(params, y, False, compute_dtype), False


def column_input(x: torch.Tensor, *ws) -> torch.Tensor | None:
    """A whole ``x`` through ``copy_in`` once, as the input the products
    with the weights ``ws`` share where one is cut along an output dim (any
    but its first, the input dim), so the backward sums its gradient over
    the ranks in one collective; else None.  The projections take it as
    ``xm`` (``_dense_out``, ``attention._heads_tp``)."""
    if any(tp.model_dim(w) not in (None, 0) for w in ws):
        return tp.copy_in(x)
    return None


def _dense_in(params, x: torch.Tensor, x_local: bool, compute_dtype) -> torch.Tensor:
    """A dense whose output is whole on every rank of a group; ``x_local``
    says ``x``'s last dim is this rank's cut (a column-parallel output),
    which a weight cut along its input dim multiplies as it is
    (row-parallel)."""
    w = params["w"]
    dim = tp.model_dim(w)
    if x_local and dim != 0:
        x, x_local = tp.gather_last(x), False
    if dim == 0:
        xs = x if x_local else tp.take_local(x, -1)
        y = tp.reduce_partial(xs.to(compute_dtype) @ w.to(compute_dtype))
        return _bias(params, y, False, compute_dtype)
    y, local = _dense_out(params, x, compute_dtype)
    return tp.gather_last(y) if local else y


def embedding_spec(vocab: int, d: int, dtype=torch.float32):
    return {"table": P((vocab, d), ("vocab", "embed"), init="normal", scale=0.02,
                       dtype=dtype)}


def embedding(params, ids: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table, cast after the gather (the same values as the
    reference's cast-then-gather, without casting the whole table)."""
    table = params["table"]
    dim = tp.model_dim(table)
    if dim == 0:
        # vocab-cut: this rank's rows, zeros elsewhere, summed over ranks
        n = table.shape[0]
        lo = tp.current().rank * n
        mask = (ids >= lo) & (ids < lo + n)
        rows = table[torch.clamp(ids - lo, 0, n - 1)].to(compute_dtype)
        return tp.reduce_partial(torch.where(mask[..., None], rows, 0))
    if dim == 1:
        return tp.gather_last(table[ids].to(compute_dtype))
    return table[ids].to(compute_dtype)


def logits(params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Tied-embedding readout: x @ table.T"""
    table = params["table"]
    dim = tp.model_dim(table)
    if dim == 0:
        return tp.gather_last(tp.copy_in(x.to(compute_dtype)) @ table.to(compute_dtype).T)
    if dim == 1:
        return tp.reduce_partial(
            tp.take_local(x, -1).to(compute_dtype) @ table.to(compute_dtype).T)
    return x.to(compute_dtype) @ table.to(compute_dtype).T


def rmsnorm_spec(d: int, dtype=torch.float32):
    return {"scale": P((d,), ("embed",), init="ones", dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6, offset: float = 0.0) -> torch.Tensor:
    """``offset=1`` is gemma's (1 + w) scale."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (offset + tp.whole(params["scale"]).float())
    return y.to(x.dtype)


def layernorm_spec(d: int, dtype=torch.float32):
    return {
        "scale": P((d,), ("embed",), init="ones", dtype=dtype),
        "bias": P((d,), ("embed",), init="zeros", dtype=dtype),
    }


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * tp.whole(params["scale"]).float() + tp.whole(params["bias"]).float()
    return y.to(x.dtype)


def groupnorm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
              bias: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over the last axis, in f32 (RWKV's time-mix output).  In a
    group the caller hands the rank's heads and its slice of ``scale`` /
    ``bias`` (``constraints.local``): each group is one head, so a rank
    normalises its own."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def rope_freqs(head_dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (base ** exponent)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0,
               rotary_dim: int | None = None) -> torch.Tensor:
    """Rotary embedding, rotate-half layout.

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    ``rotary_dim`` < head_dim rotates the first ``rotary_dim`` features only
    (StableLM's partial rotary).
    """
    head_dim = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else head_dim
    xr, xp = x[..., :rd], x[..., rd:]
    freqs = rope_freqs(rd, base, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, rd//2)
    angles = angles[..., None, :]                  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([rotated, xp], dim=-1) if rd < head_dim else rotated


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return gelu(gate) * up


def relu_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def glu_mlp_spec(d_model: int, d_ff: int, dtype=torch.float32):
    return {
        "gate": dense_spec(d_model, d_ff, ("embed", "mlp"), dtype=dtype),
        "up": dense_spec(d_model, d_ff, ("embed", "mlp"), dtype=dtype),
        "down": dense_spec(d_ff, d_model, ("mlp", "embed"), dtype=dtype),
    }


def glu_mlp(params, x: torch.Tensor, act=swiglu, compute_dtype=torch.bfloat16) -> torch.Tensor:
    xm = column_input(x.to(compute_dtype), params["gate"]["w"], params["up"]["w"])
    g, local = _dense_out(params["gate"], x, compute_dtype, xm)
    u, _ = _dense_out(params["up"], x, compute_dtype, xm)
    return _dense_in(params["down"], act(g, u), local, compute_dtype)


def mlp_spec(d_model: int, d_ff: int, dtype=torch.float32, bias: bool = False):
    return {
        "up": dense_spec(d_model, d_ff, ("embed", "mlp"), bias=bias, dtype=dtype),
        "down": dense_spec(d_ff, d_model, ("mlp", "embed"), bias=bias, dtype=dtype),
    }


def mlp(params, x: torch.Tensor, act=gelu, compute_dtype=torch.bfloat16) -> torch.Tensor:
    h, local = _dense_out(params["up"], x, compute_dtype)
    return _dense_in(params["down"], act(h), local, compute_dtype)


def conv2d_spec(c_in: int, c_out: int, k: int, dtype=torch.float32,
                bias: bool = False):
    """OIHW weight; std sqrt(2 / fan_in) as in the reference."""
    fan_in = c_in * k * k
    spec = {
        "w": P((c_out, c_in, k, k), ("conv_out", "conv_in", None, None),
               init="normal", scale=math.sqrt(2.0 / fan_in), dtype=dtype)
    }
    if bias:
        spec["b"] = P((c_out,), ("conv_out",), init="zeros", dtype=dtype)
    return spec


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` (low, high) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def conv2d(params, x: torch.Tensor, stride: int = 1,
           compute_dtype=torch.float32) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H', W', C_out), ``"SAME"`` padding."""
    w = params["w"].to(compute_dtype)
    xc = _pad_nchw(x.to(compute_dtype).permute(0, 3, 1, 2), w.shape[-1], stride)
    y = F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y


def batchnorm_spec(c: int, dtype=torch.float32):
    return {
        "scale": P((c,), ("conv_out",), init="ones", dtype=dtype),
        "bias": P((c,), ("conv_out",), init="zeros", dtype=dtype),
        "mean": P((c,), ("conv_out",), init="zeros", dtype=dtype),
        "var": P((c,), ("conv_out",), init="ones", dtype=dtype),
    }


def batchnorm(params, x: torch.Tensor, train: bool = False, eps: float = 1e-5,
              stats_sink: dict | None = None, stats_key=None) -> torch.Tensor:
    """Functional BN over the last (channel) axis.  ``train=False`` uses the
    running stats: per-example independent.  ``train=True`` normalises with
    the batch's f32 mean and population variance and, given a
    ``stats_sink`` dict, records them (detached) under ``stats_key`` for
    :func:`bn_apply_stats`."""
    if train:
        axes = tuple(range(x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, correction=0)
        if stats_sink is not None:
            stats_sink[stats_key] = (mean.detach(), var.detach())
    else:
        mean, var = params["mean"], params["var"]
    inv = torch.rsqrt(var.float() + eps) * params["scale"].float()
    y = (x.float() - mean.float()) * inv + params["bias"].float()
    return y.to(x.dtype)


def bn_apply_stats(params, stats: dict, momentum: float = 0.9):
    """Fold collected BN batch statistics into the running stats (an EMA).

    ``stats`` maps a path into ``params`` (dict keys and list indices, e.g.
    ``("stages", 0, 1, "bn1")``) to ``(batch_mean, batch_var)``.  Returns a
    new tree with those ``mean`` / ``var`` leaves replaced; every other leaf
    is shared."""
    def update(tree, path, mean, var):
        if not path:
            return {**tree,
                    "mean": momentum * tree["mean"] + (1 - momentum) * mean,
                    "var": momentum * tree["var"] + (1 - momentum) * var}
        head, rest = path[0], path[1:]
        if isinstance(tree, dict):
            return {k: (update(v, rest, mean, var) if k == head else v)
                    for k, v in tree.items()}
        return [update(v, rest, mean, var) if i == head else v
                for i, v in enumerate(tree)]

    with torch.no_grad():
        for path, (mean, var) in stats.items():
            params = update(params, tuple(path), mean, var)
    return params


def maxpool2d(x: torch.Tensor, k: int = 2, stride: int | None = None) -> torch.Tensor:
    """x: (B, H, W, C), ``"SAME"`` padding with −inf."""
    stride = stride or k
    xc = _pad_nchw(x.permute(0, 3, 1, 2), k, stride, value=-math.inf)
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def conv1d_spec(d: int, width: int = 4, dtype=torch.float32):
    """Depthwise temporal conv: ``w`` (K, D), the reference's layout (2-D, so
    ``interop.from_reference`` carries it across unchanged)."""
    return {
        "w": P((width, d), (None, "embed"), init="normal",
               scale=1.0 / math.sqrt(width), dtype=dtype),
        "b": P((d,), ("embed",), init="zeros", dtype=dtype),
    }


def causal_conv1d(params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Depthwise causal temporal conv. x: (B, S, D).  The K shifted products
    are summed in the reference's order, in ``x``'s dtype.  Depthwise, so in
    a group it runs on the rank's channels: ``x`` the rank's cut of them
    and ``w`` / ``b`` cut on the same channels (the rules cut the conv's
    channels and the projection that feeds it alike)."""
    w = params["w"].to(compute_dtype)  # (K, D)
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = pad[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + pad[:, i:i + s] * w[i]
    return y + params["b"].to(compute_dtype)


def causal_conv1d_step(params, state: torch.Tensor, x_t: torch.Tensor):
    """One decode step. state: (B, K-1, D), the trailing inputs; x_t: (B, D)
    (in a group, the rank's channels, as ``causal_conv1d``).  Returns (new
    state, y (B, D))."""
    w = params["w"].to(x_t.dtype)
    window = torch.cat([state.to(x_t.dtype), x_t[:, None, :]], dim=1)  # (B, K, D)
    y = torch.einsum("bkd,kd->bd", window, w) + params["b"].to(x_t.dtype)
    return window[:, 1:, :], y
