"""Attention-free sequence mixers: RWKV-6 (Finch) time mix and channel mix,
and RG-LRU (Griffin).

The port of ``repro.nn.ssm``.  RWKV-6 keeps the reference's two forward
paths of the WKV recurrence, equal up to f32 rounding:

- ``wkv6_scan``     the token-level recurrence: the oracle, and the
                    per-token decode step.
- ``wkv6_chunked``  the chunk-parallel matmul form: S / C sequential steps of
                    (C, C) and (C, hd) matmuls in place of S token steps.
                    Intra-chunk decay products are taken in log space in
                    f32, with the reference's exclusive cumsum, its clamp at
                    ``LOG_CLAMP`` and its ``tril(-1)`` + diagonal-``u``
                    structure.  It is the prefill forward's path at
                    ``impl="chunked"``.

``rglru`` is the RG-LRU's diagonal linear recurrence h_t = a_t h_{t-1} +
b_t over the sequence.  The reference runs it as ``lax.associative_scan``;
the port runs the same combine as a log-depth (Hillis-Steele) scan of
ceil(log2 S) elementwise steps over the whole sequence, with ``h0`` folded
into the first element as the reference folds it.  The two sum in another
order, so they agree to f32 rounding.

None of these is a Pallas kernel in the reference (they are plain ``jnp``
code), so the port writes them in plain PyTorch, which runs where the
tensors lie.  Parameters are cast to the compute dtype at each call; the
WKV state and the recurrences run in f32, as in the reference.

In a tensor-parallel group (``distributed.constraints``) each mixer runs
the rank's heads or channels, by the cuts the rules give its leaves:

- the time mix: the token-shift mixes are whole on every rank (their
  tables, cut on the embed dim by the fallback, are read whole:
  ``sharding_rules.reads_whole``) and feed ``wr`` / ``wk`` / ``wv`` /
  ``wg``, cut on ``heads_flat``, column-parallel; the decay LoRA is
  row-parallel on ``decay_a`` and lands on the rank's heads through its
  cut of ``decay_b`` and ``w0``; the WKV recurrence, ``u`` and the
  groupnorm run per local head, and ``wo`` is row-parallel.  The WKV
  state holds the rank's heads (``timemix_heads``); the token-shift
  carries stay whole;
- the channel mix: ``wk`` cut on ``mlp``, ``wv`` row-parallel;
- the RG-LRU on the rank's channels (its input is a column-parallel
  projection's output): ``wa`` / ``wx``, cut on their input dim, are
  row-parallel, their partial products reduce-scattered in one collective
  onto the rank's channels (``constraints.reduce_scatter``: the rank
  receives its share of the gate pre-activations only).

Under grad a whole tensor entering the rank's heads passes ``copy_in``
(the decay LoRA's output into ``decay_b``'s cut), as the column-parallel
projections' inputs do in ``layers._dense_out``.

Outside a group the same code runs on whole leaves, with no collective.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import constraints as tp
from repro_torch.distributed import sharding_rules as sr
from repro_torch.nn import layers
from repro_torch.nn.init import P

LOG_CLAMP = 60.0


# ---------------------------------------------------------------------------
# RWKV-6 time mix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    shift_lora: int = 32
    decay_lora: int = 64
    chunk: int = 16
    impl: str = "chunked"  # chunked | scan

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def timemix_spec(cfg: RWKV6Config, dtype=torch.float32):
    d, hd = cfg.d_model, cfg.head_dim
    h = cfg.n_heads
    s = lambda fan: 1.0 / math.sqrt(fan)  # noqa: E731
    return {
        # data-dependent token shift: shared LoRA-A, per-stream B + static mu
        "mu_x": P((d,), ("embed",), init="uniform", scale=0.5, dtype=dtype),
        "shift_a": P((d, cfg.shift_lora), ("embed", None), dtype=dtype, scale=s(d)),
        "shift_b": P((5, cfg.shift_lora, d), (None, None, "embed"), init="zeros",
                     dtype=dtype),
        "mu": P((5, d), (None, "embed"), init="uniform", scale=0.5, dtype=dtype),
        # projections
        "wr": P((d, d), ("embed", "heads_flat"), dtype=dtype, scale=s(d)),
        "wk": P((d, d), ("embed", "heads_flat"), dtype=dtype, scale=s(d)),
        "wv": P((d, d), ("embed", "heads_flat"), dtype=dtype, scale=s(d)),
        "wg": P((d, d), ("embed", "heads_flat"), dtype=dtype, scale=s(d)),
        "wo": P((d, d), ("heads_flat", "embed"), dtype=dtype, scale=s(d)),
        # data-dependent decay
        "w0": P((d,), ("embed",), init="constant", constant=-4.0, dtype=dtype),
        "decay_a": P((d, cfg.decay_lora), ("embed", None), dtype=dtype, scale=s(d)),
        "decay_b": P((cfg.decay_lora, d), (None, "embed"), init="zeros", dtype=dtype),
        # per-(head, channel) bonus
        "u": P((h, hd), ("heads", "hd"), init="uniform", scale=0.5, dtype=dtype),
        # output groupnorm
        "ln_scale": P((d,), ("embed",), init="ones", dtype=dtype),
        "ln_bias": P((d,), ("embed",), init="zeros", dtype=dtype),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Previous-token shift along seq. x: (B, S, D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """prev - x, where prev is x shifted by one token, ``x_prev`` (B, D) (the
    decode carry) or zeros in front."""
    if x_prev is None:
        return _shift(x) - x
    prev = torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return prev - x


def timemix_heads(cfg: RWKV6Config) -> int:
    """The heads this rank's time mix runs: in a group whose rules cut
    ``wr``'s ``heads_flat`` columns, its share of them; else all."""
    ctx = tp.current()
    if ctx is not None and sr.cut_dim(timemix_spec(cfg)["wr"], ctx.mesh) == 1:
        return cfg.n_heads // ctx.size
    return cfg.n_heads


def _on_heads(t: torch.Tensor, cfg: RWKV6Config, dim: int = -1) -> torch.Tensor:
    """A per-channel leaf on the channels of the rank's heads (whole outside
    a group, or where the heads are not cut)."""
    if timemix_heads(cfg) == cfg.n_heads:
        return tp.whole(t)
    return tp.local(t, dim)


def timemix_project(params, cfg: RWKV6Config, x: torch.Tensor,
                    x_prev: torch.Tensor | None, compute_dtype=torch.bfloat16):
    """r, k, v, g and log w from a (B, S, D) input.  ``x_prev``: the (B, D)
    carry of a decode step (the previous token's input), else None.  In a
    group, on the rank's heads (``timemix_heads``)."""
    cd = compute_dtype
    x = x.to(cd)
    sx = _token_shift(x, x_prev)
    xr_base = x + sx * tp.whole(params["mu_x"]).to(cd)
    lora = torch.tanh(xr_base @ tp.whole(params["shift_a"]).to(cd))
    # einsum("bsr,nrd->nbsd") as one broadcast matmul
    deltas = lora[None] @ tp.whole(params["shift_b"]).to(cd)[:, None]
    mu = tp.whole(params["mu"]).to(cd)
    xr, xk, xv, xw, xg = (x + sx * (mu[i] + deltas[i]) for i in range(5))
    r, _ = layers._dense_out({"w": params["wr"]}, xr, cd)
    k, _ = layers._dense_out({"w": params["wk"]}, xk, cd)
    v, _ = layers._dense_out({"w": params["wv"]}, xv, cd)
    g = F.silu(layers._dense_out({"w": params["wg"]}, xg, cd)[0])
    dlora = torch.tanh(layers.dense({"w": params["decay_a"]}, xw, cd)).float()
    if timemix_heads(cfg) != cfg.n_heads:
        dlora = tp.copy_in(dlora)   # whole, into the rank's heads
    logw = -torch.exp(_on_heads(params["w0"], cfg).float()
                      + dlora @ _on_heads(params["decay_b"], cfg).float())
    return r, k, v, g, logw    # log w strictly negative


def _to_heads(x: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, h, hd)


def wkv6_scan(r, k, v, logw, u, state=None):
    """The exact recurrence. r, k, v, logw: (B, S, H, hd); u: (H, hd).

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ ;  out_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    Returns (out (B, S, H, hd) f32, final state (B, H, hd, hd) f32)."""
    b, s, h, hd = r.shape
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    st = state.float()
    ud = u.float()[None, :, :, None]
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
        outs.append((r[:, t, :, None, :] @ (st + ud * kv))[:, :, 0])
        st = torch.exp(logw[:, t])[..., None] * st + kv
    return torch.stack(outs, dim=1), st


def wkv6_chunked(r, k, v, logw, u, state=None, chunk: int = 16):
    """The chunk-parallel WKV: ``wkv6_scan``'s signature and result."""
    b, s, h, hd = r.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def blocks(a):  # (B, S, H, hd) -> (nc, B, H, C, hd) f32
        a = a.float()
        if pad:
            a = F.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(b, nc, chunk, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lw = blocks(r), blocks(k), blocks(v), blocks(logw)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    st = state.float()
    uk = u.float()[None, :, None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=r.device),
                     diagonal=-1)
    eye = torch.eye(chunk, dtype=torch.float32, device=r.device)

    def cl(z):
        return torch.clamp(z, -LOG_CLAMP, LOG_CLAMP)

    outs = []
    for c in range(nc):
        rb, kb, vb, lwb = rc[c], kc[c], vc[c], lw[c]  # (B, H, C, hd)
        el = torch.cumsum(lwb, dim=2) - lwb  # exclusive cumsum: L_t = sum_{s<t}
        ltot = el[:, :, -1:, :] + lwb[:, :, -1:, :]  # (B, H, 1, hd)
        r_dec = rb * torch.exp(cl(el))                 # r̃_t
        k_inc = kb * torch.exp(cl(-(el + lwb)))        # k̃_s = k ⊘ P_{s+1}
        k_out = kb * torch.exp(cl(ltot - el - lwb))    # k̂_s for the state update
        a = r_dec @ k_inc.transpose(-1, -2)            # (B, H, C, C)
        diag = (rb * (uk * kb)).sum(dim=-1)            # (B, H, C)
        a = a * tri + eye * diag[..., None]
        outs.append(a @ vb + r_dec @ st)
        st = torch.exp(cl(ltot))[..., 0, :, None] * st + k_out.transpose(-1, -2) @ vb
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nc * chunk, h, hd)
    return out[:, :s], st


def _timemix_out(params, cfg: RWKV6Config, out, g, compute_dtype):
    """GroupNorm over heads, the gate, the output projection (in a group:
    the rank's heads, then ``wo`` row-parallel)."""
    b, s, h, hd = out.shape
    y = layers.groupnorm(out.reshape(b, s, h * hd).to(compute_dtype), h,
                         _on_heads(params["ln_scale"], cfg),
                         _on_heads(params["ln_bias"], cfg))
    return layers._dense_in({"w": params["wo"]}, y * g, h != cfg.n_heads, compute_dtype)


def timemix(params, cfg: RWKV6Config, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Full-sequence RWKV-6 time mix. x: (B, S, D) -> (B, S, D)."""
    h, hd = timemix_heads(cfg), cfg.head_dim
    r, k, v, g, logw = timemix_project(params, cfg, x, None, compute_dtype)
    rh, kh, vh, lwh = (_to_heads(a, h, hd) for a in (r, k, v, logw))
    u = _on_heads(params["u"], cfg, 0).float()
    if cfg.impl == "scan":
        out, _ = wkv6_scan(rh, kh, vh, lwh, u)
    else:
        out, _ = wkv6_chunked(rh, kh, vh, lwh, u, chunk=cfg.chunk)
    return _timemix_out(params, cfg, out, g, compute_dtype)


def timemix_state_shape(cfg: RWKV6Config, batch: int):
    """{wkv, x_prev} as ``meta`` tensors (the WKV state of the rank's heads
    in a group)."""
    h, hd = timemix_heads(cfg), cfg.head_dim
    return {
        "wkv": torch.empty((batch, h, hd, hd), dtype=torch.float32, device="meta"),
        "x_prev": torch.empty((batch, cfg.d_model), dtype=torch.bfloat16, device="meta"),
    }


def timemix_step(params, cfg: RWKV6Config, state, x_t: torch.Tensor,
                 compute_dtype=torch.bfloat16):
    """One-token decode on O(1) state. x_t: (B, D).  Returns (new state, y
    (B, D)); the carry ``x_prev`` keeps the state's dtype: bf16 in
    ``timemix_state_shape``, as in the reference (a state in f32 keeps the
    carry exact, which a check of the step against the full-sequence time
    mix at f32 compute uses)."""
    h, hd = timemix_heads(cfg), cfg.head_dim
    r, k, v, g, logw = timemix_project(params, cfg, x_t[:, None], state["x_prev"],
                                       compute_dtype)
    rh, kh, vh, lwh = (_to_heads(a, h, hd) for a in (r, k, v, logw))
    out, wkv = wkv6_scan(rh, kh, vh, lwh, _on_heads(params["u"], cfg, 0).float(),
                         state["wkv"])
    y = _timemix_out(params, cfg, out, g, compute_dtype)[:, 0]
    return {"wkv": wkv, "x_prev": x_t.to(state["x_prev"].dtype)}, y


# ---------------------------------------------------------------------------
# RWKV channel mix
# ---------------------------------------------------------------------------


def channelmix_spec(d: int, d_ff: int, dtype=torch.float32):
    s = lambda fan: 1.0 / math.sqrt(fan)  # noqa: E731
    return {
        "mu_k": P((d,), ("embed",), init="uniform", scale=0.5, dtype=dtype),
        "wk": P((d, d_ff), ("embed", "mlp"), dtype=dtype, scale=s(d)),
        "wv": P((d_ff, d), ("mlp", "embed"), dtype=dtype, scale=s(d_ff)),
    }


def channelmix(params, x: torch.Tensor, x_prev: torch.Tensor | None = None,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = x.to(compute_dtype)
    sx = _token_shift(x, x_prev)
    xk = x + sx * tp.whole(params["mu_k"]).to(compute_dtype)
    h, local = layers._dense_out({"w": params["wk"]}, xk, compute_dtype)
    return layers._dense_in({"w": params["wv"]}, layers.relu_sq(h), local, compute_dtype)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: int
    c: float = 8.0


def rglru_spec(cfg: RGLRUConfig, dtype=torch.float32):
    d = cfg.width
    s = 1.0 / math.sqrt(d)
    return {
        # Λ init so that a = exp(-c·softplus(Λ)) lands in [0.9, 0.999]
        "lam": P((d,), ("embed",), init="uniform", scale=0.5, dtype=dtype),
        "wa": P((d, d), ("embed", "embed2"), dtype=dtype, scale=s),
        "ba": P((d,), ("embed",), init="zeros", dtype=dtype),
        "wx": P((d, d), ("embed", "embed2"), dtype=dtype, scale=s),
        "bx": P((d,), ("embed",), init="zeros", dtype=dtype),
    }


def _rglru_gates(params, cfg: RGLRUConfig, x: torch.Tensor):
    """(a, b) of h_t = a_t h_{t-1} + b_t, both f32.  In a group ``x`` holds
    the rank's channels (``local``) or all: ``wa`` / ``wx`` cut on their
    input dim (the rules' fallback) are row-parallel, both partial products
    reduce-scattered onto the rank's channels in one collective (reduced
    whole where ``x`` is whole); uncut, they multiply whole channels."""
    xf = x.float()
    local = xf.shape[-1] != cfg.width
    wa, wx = params["wa"], params["wx"]
    if tp.model_dim(wa) == 0:       # wx is cut alike: the same axes and shape
        xs = xf if local else tp.take_local(xf, -1)
        parts = torch.stack([xs @ wa.float(), xs @ wx.float()])
        pa, px = tp.reduce_scatter(parts, -1) if local else tp.reduce_partial(parts)
    else:
        pa, px = xf @ wa.float(), xf @ wx.float()

    def vec(name):
        return (tp.local(params[name]) if local else tp.whole(params[name])).float()

    ra = torch.sigmoid(pa + vec("ba"))
    rx = torch.sigmoid(px + vec("bx"))
    return _rglru_ab(vec("lam"), cfg, ra, rx, xf)


def _rglru_ab(lam: torch.Tensor, cfg: RGLRUConfig, ra, rx, xf):
    log_a = -cfg.c * F.softplus(lam.float()) * ra
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (rx * xf)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = 0): the combine
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r) in ceil(log2 S)
    Hillis-Steele steps."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru(params, cfg: RGLRUConfig, x: torch.Tensor, h0: torch.Tensor | None = None):
    """x: (B, S, D).  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (σ(gate_x) · x_t).
    Returns (h in x's dtype, the last h (B, D) f32)."""
    a, b = _rglru_gates(params, cfg, x)  # (B, S, D) f32 each
    if h0 is not None:
        # fold the carry into the first element: b_0 += a_0 * h0
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(params, cfg: RGLRUConfig, h: torch.Tensor, x_t: torch.Tensor):
    """One decode step. h: (B, D) f32; x_t: (B, D).  Returns (new h f32, the
    output in x_t's dtype)."""
    a, b = _rglru_gates(params, cfg, x_t)
    h_new = a * h.float() + b
    return h_new, h_new.to(x_t.dtype)
