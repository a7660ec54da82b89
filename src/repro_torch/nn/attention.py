"""Attention: GQA / MQA, full and sliding-window, MLA and cross-attention,
prefill and decode.

The port of ``repro.nn.attention``.  Layouts are the
reference's: q (B, S, H, hd), k / v (B, S, KV, hd), ``wq`` (D, H, hd),
``wo`` (H, hd, D), and the finite ``NEG_INF`` mask value.

``attention`` (the full-sequence forward behind ``models.lm.forward``)
computes, without a window, exactly what the Pallas kernel
``flash_attention`` computes: causal attention with the mask aligned at
position 0.  So there it calls ``kernels/flash_attn/ops.flash_mha`` on the
repeated K/V, which launches the hand-written Hopper kernel on a CUDA
tensor and runs its plain version on a CPU tensor.  With a window it runs
``attend_full`` / ``attend_chunked``, the torch twins of the reference's
plain XLA code (the reference computes every case there, outside any
Pallas kernel).

Decode keeps a KV cache per layer: a ring buffer of the window's length
for windowed layers (entry ``pos % L``), the full ``max_len`` otherwise,
with a per-slot ``pos`` vector for continuous batching.  The port writes
the new K/V into the cache in place (the reference returns a new cache),
which spares a copy of every layer's cache per token; ``decode_step``
returns the same dict.

MLA (DeepSeek-V3's multi-head latent attention) is the reference's: the
prefill decompresses K and V per head and runs ``attend_full`` /
``attend_chunked`` (its q·k head dim, nope + rope = 192, differs from its
v head dim, 128, and ``flash_attention`` takes one head dim for q, k and
v, so MLA keeps the plain twins, as windowed layers do); decode keeps the
compressed ``ckv`` ‖ ``kpe`` cache and attends in the rank-``kv_lora_rank``
space with ``W_kb`` absorbed into the query.

Cross-attention (the enc-dec kind's decoder) attends from the decoder's
queries, without RoPE, to K/V that ``encode_kv`` projects once from the
encoder output.  Every key is visible to every query, which is what
``flash_attention`` computes without its causal mask, so
``cross_attention`` calls ``flash_mha(..., causal=False)`` for any Sq:
the target length in training, 1 at each decode step.  The encoder's own
bidirectional self-attention (``models/encdec.py:encode``) calls it the
same way (``attention(..., causal=False)``).  So the calls that reach the
kernel are ``attention`` without a window, ``cross_attention`` and the
encoder's layers; windowed layers, the decode step's self-attention and
MLA keep their plain twins.

In a tensor-parallel group (``distributed.constraints``) every attention
runs the rank's heads: GQA / MQA the rank's cut of ``wq``'s heads and the
kv heads they read (``tp_heads``; a kv head that does not divide the group
is kept by every rank whose q heads read it), cross-attention likewise
over ``encode_kv``'s kv heads, MLA its cut of the up-projections' heads
(``mla_heads``) over latents that ``wq_a`` / ``wkv_a``, row-parallel, make
whole on every rank, so its compressed cache is whole on every rank.  Each
ends in ``wo``'s row-parallel reduce (``_out_tp``).  Under grad a whole
tensor that enters the rank's heads passes ``copy_in`` (the input of the
head-cut projections, once for q, k and v; MLA's latents; a whole k read by
a subset of the q heads; a q/k norm scale on the rank's heads) or ``take``
(a whole projection narrowed to the rank's heads), so its gradient is
summed over the ranks.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.backend import registry
from repro_torch.distributed import constraints as tp
from repro_torch.distributed import sharding_rules as sr
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.nn import layers
from repro_torch.nn.init import P

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """The reference's ``AttnConfig`` without ``shard_heads``, a sharding
    constraint that has no meaning on one device."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_base: float = 10000.0
    rotary_dim: int | None = None  # partial rotary if < head_dim
    window: int | None = None  # sliding-window size (None = full)
    qkv_bias: bool = False
    softmax_scale: float | None = None
    qk_norm: bool = False  # gemma3-style per-head RMS norm of q/k

    @property
    def scale(self) -> float:
        return self.softmax_scale or 1.0 / math.sqrt(self.head_dim)


def gqa_spec(cfg: AttnConfig, dtype=torch.float32):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": P((d, h, hd), ("embed", "heads", "hd"), dtype=dtype,
                scale=1.0 / math.sqrt(d)),
        "wk": P((d, kv, hd), ("embed", "kv", "hd"), dtype=dtype,
                scale=1.0 / math.sqrt(d)),
        "wv": P((d, kv, hd), ("embed", "kv", "hd"), dtype=dtype,
                scale=1.0 / math.sqrt(d)),
        "wo": P((h, hd, d), ("heads", "hd", "embed"), dtype=dtype,
                scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        spec["bq"] = P((h, hd), ("heads", "hd"), init="zeros", dtype=dtype)
        spec["bk"] = P((kv, hd), ("kv", "hd"), init="zeros", dtype=dtype)
        spec["bv"] = P((kv, hd), ("kv", "hd"), init="zeros", dtype=dtype)
    if cfg.qk_norm:
        spec["qnorm"] = P((hd,), ("hd",), init="ones", dtype=dtype)
        spec["knorm"] = P((hd,), ("hd",), init="ones", dtype=dtype)
    return spec


def _headwise_rms(x, scale, eps=1e-6):
    xf = x.float()
    v = torch.square(xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps) * scale).to(x.dtype)


def _norm_scale(scale: torch.Tensor, on_part: bool) -> torch.Tensor:
    """A q / k norm's scale, whole, in f32; through ``copy_in`` where the
    heads it scales are the rank's part (``on_part``)."""
    s = tp.whole(scale).float()
    return tp.copy_in(s) if on_part else s


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matmul."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).unflatten(-1, (h, e))


def out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd") (or "bhe,hed->bd") as one matmul."""
    h, e, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * e, d)


def tp_heads(cfg: AttnConfig) -> tuple[int, int, int, int]:
    """(q lo, q hi, kv lo, kv hi): the query heads this rank attends and
    the kv heads they read; all heads outside a group.  The q heads are
    the rank's cut of ``wq``'s heads where the rules cut it there, else
    all of them."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    ctx = tp.current()
    if ctx is None:
        return 0, h, 0, kv
    if sr.cut_dim(gqa_spec(cfg)["wq"], ctx.mesh) == 1:
        qlo, qhi = tp.local_range(h)
    else:
        qlo, qhi = 0, h
    g = h // kv
    return qlo, qhi, qlo // g, (qhi - 1) // g + 1


def _heads_tp(x: torch.Tensor, w: torch.Tensor, b, lo: int, hi: int,
              compute_dtype, xm: torch.Tensor | None = None) -> torch.Tensor:
    """Heads [lo, hi) of ``x @ w`` (+ ``b``): in a group, by where ``w`` was
    cut: along its heads (they are this rank's), its input dim (a partial
    product, reduced), its head dim (made whole), or not at all (as
    outside a group, where [lo, hi) is every head).  ``xm`` is ``x``
    through ``copy_in`` (``layers.column_input``) for a ``w`` cut along its
    heads or head dim, made here where None."""
    dim = tp.model_dim(w)
    wc = w.to(compute_dtype)
    if dim in (1, 2) and xm is None:
        xm = tp.copy_in(x)
    if dim == 1:
        y = _heads(xm, wc)
        if b is not None:
            y = y + (b if tp.model_dim(b) == 0
                     else tp.take(tp.whole(b), 0, lo, hi)).to(compute_dtype)
        return y
    if dim == 0:
        y = tp.reduce_partial(_heads(tp.take_local(x, -1), wc))
    elif dim == 2:
        y = tp.gather_last(_heads(xm, wc))
    else:
        y = _heads(x, wc)
    if b is not None:
        y = y + tp.whole(b).to(compute_dtype)
    return tp.take(y, -2, lo, hi)


def _kv_for_q(k: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """The kv heads (B, S, KV_local, hd) repeated to the rank's q heads (to
    every q head outside a group)."""
    groups = cfg.n_heads // cfg.n_kv_heads
    qlo, qhi, kvlo, kvhi = tp_heads(cfg)
    if qlo % groups == 0 and (qhi - qlo) % groups == 0:
        return _repeat_kv(k, groups)
    if kvhi - kvlo == cfg.n_kv_heads:
        k = tp.copy_in(k)   # whole, read by the rank's q heads only
    idx = torch.arange(qlo, qhi, device=k.device) // groups - kvlo
    return k.index_select(2, idx)


def _out_tp(out: torch.Tensor, wo: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``out_project``; in a group row-parallel on ``wo`` cut along its
    heads (``out`` holds the rank's heads) or its head dim, column-parallel
    on one cut along the embed dim."""
    dim = tp.model_dim(wo)
    wc = wo.to(compute_dtype)
    if dim == 0:
        return tp.reduce_partial(out_project(out, wc))
    if dim == 1:
        return tp.reduce_partial(out_project(tp.take_local(out, -1), wc))
    if dim == 2:
        return tp.gather_last(out_project(tp.copy_in(out), wc))
    return out_project(out, wc)


def gqa_project(params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                compute_dtype=torch.bfloat16):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied; in a
    group, the rank's q heads and the kv heads they read (``tp_heads``)."""
    x = x.to(compute_dtype)
    qlo, qhi, kvlo, kvhi = tp_heads(cfg)
    xm = layers.column_input(x, params["wq"], params["wk"], params["wv"])
    q = _heads_tp(x, params["wq"], params.get("bq"), qlo, qhi, compute_dtype, xm)
    k = _heads_tp(x, params["wk"], params.get("bk"), kvlo, kvhi, compute_dtype, xm)
    v = _heads_tp(x, params["wv"], params.get("bv"), kvlo, kvhi, compute_dtype, xm)
    if cfg.qk_norm:
        q = _headwise_rms(q, _norm_scale(params["qnorm"], qhi - qlo < cfg.n_heads))
        k = _headwise_rms(k, _norm_scale(params["knorm"], kvhi - kvlo < cfg.n_kv_heads))
    q = layers.apply_rope(q, positions, cfg.rope_base, cfg.rotary_dim)
    k = layers.apply_rope(k, positions, cfg.rope_base, cfg.rotary_dim)
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(b, s, kv * groups, hd)


def causal_mask(sq: int, skv: int, q_offset: int = 0, window: int | None = None,
                device=None) -> torch.Tensor:
    """(sq, skv) boolean mask — True = attendable."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def attend_full(q, k, v, mask, scale: float) -> torch.Tensor:
    """Direct attention. q: (B,Sq,H,hd), k/v: (B,Skv,H,hd), mask: (Sq,Skv).
    The scores are taken in q's dtype, as in the reference, then scaled in
    f32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend_chunked(q, k, v, scale: float, q_offset: int = 0,
                   window: int | None = None, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's
    ``lax.scan``, a loop here).  Never materialises more than
    (B, H, Sq, kv_chunk) scores.  Causal."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    skv = k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((b, h, sq, vd), dtype=torch.float32, device=q.device)
    for start in range(0, skv, kv_chunk):
        kb, vb = k[:, start:start + kv_chunk], v[:, start:start + kv_chunk]
        pad = kv_chunk - kb.shape[1]
        if pad:  # the reference pads the last chunk with zeros
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        kpos = start + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        valid = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < skv)
        if window is not None:
            valid = valid & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(valid[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)  # noqa: E741
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,H,hd)


CHUNKED_THRESHOLD = 4096


def attention(params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              compute_dtype=torch.bfloat16, kv_chunk: int = 1024,
              causal: bool = True) -> torch.Tensor:
    """Self-attention over a full sequence (prefill), causal from position
    0.  Without a window: the ``flash_attn`` kernel (``flash_mha``), also
    without its causal mask (``causal=False``: the enc-dec kind's
    bidirectional encoder).  With one: ``attend_full``, or
    ``attend_chunked`` past ``CHUNKED_THRESHOLD`` tokens, as in the
    reference.  In a group, over the rank's heads."""
    q, k, v = gqa_project(params, cfg, x, positions, compute_dtype)
    k, v = _kv_for_q(k, cfg), _kv_for_q(v, cfg)
    s = x.shape[1]
    if cfg.window is None:
        out = flash_ops.flash_mha(q, k, v, cfg.scale, causal=causal)
    elif not causal:
        raise ValueError("a windowed attention is causal")
    elif s > CHUNKED_THRESHOLD:
        out = attend_chunked(q, k, v, cfg.scale, window=cfg.window, kv_chunk=kv_chunk)
    else:
        mask = causal_mask(s, s, window=cfg.window, device=x.device)
        out = attend_full(q, k, v, mask, cfg.scale)
    return _out_tp(out, params["wo"], compute_dtype)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


def kv_cache_shape(cfg: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """{k, v} as ``meta`` tensors.  Sliding-window layers hold only the
    window (a ring buffer).  In a group, the kv heads the rank's q heads
    read (``tp_heads``)."""
    length = min(max_len, cfg.window) if cfg.window else max_len
    _, _, kvlo, kvhi = tp_heads(cfg)
    shp = (batch, length, kvhi - kvlo, cfg.head_dim)
    return {"k": torch.empty(shp, dtype=dtype, device="meta"),
            "v": torch.empty(shp, dtype=dtype, device="meta")}


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    """Zeroed {k, v} on ``device`` (None = ``"cuda"``)."""
    dev = registry.resolve_device(device)
    return {name: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for name, t in kv_cache_shape(cfg, batch, max_len, dtype).items()}


def decode_step(params, cfg: AttnConfig, cache, x_t: torch.Tensor, pos,
                compute_dtype=torch.bfloat16):
    """One-token decode. x_t: (B, D); pos: an int or (B,) per-slot
    positions (each slot of a continuous batch at its own depth).

    Writes the token's K/V into ``cache`` in place (entry ``pos % L`` of a
    windowed layer's ring) and returns (cache, out (B, D))."""
    b, _ = x_t.shape
    pos_b = torch.as_tensor(pos, dtype=torch.long, device=x_t.device).expand(b)
    q, k_t, v_t = gqa_project(params, cfg, x_t[:, None, :], pos_b[:, None],
                              compute_dtype)
    k_cache, v_cache = cache["k"], cache["v"]
    cache_len = k_cache.shape[1]
    slot = pos_b % cache_len if cfg.window else pos_b  # (B,)
    rows = torch.arange(b, device=x_t.device)
    k_cache[rows, slot] = k_t[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_t[:, 0].to(v_cache.dtype)

    k = _kv_for_q(k_cache.to(compute_dtype), cfg)
    v = _kv_for_q(v_cache.to(compute_dtype), cfg)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * cfg.scale
    kpos = torch.arange(cache_len, device=x_t.device)
    if cfg.window:
        # ring buffer: entry i holds the latest absolute position p <= pos
        # with p % L == i; valid while within the window
        age = (slot[:, None] - kpos[None, :]) % cache_len
        valid = age < torch.clamp(pos_b + 1, max=cache_len)[:, None]
    else:
        valid = kpos[None, :] <= pos_b[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)[:, 0]
    return cache, _out_tp(out, params["wo"], compute_dtype)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V3), with the absorbed decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_base: float = 10000.0

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.qk_nope_dim + self.qk_rope_dim)


def mla_spec(cfg: MLAConfig, dtype=torch.float32):
    d, h = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s = lambda fan: 1.0 / math.sqrt(fan)  # noqa: E731
    return {
        "wq_a": P((d, r_q), ("embed", "qlora"), dtype=dtype, scale=s(d)),
        "q_a_norm": P((r_q,), ("qlora",), init="ones", dtype=dtype),
        "wq_b": P((r_q, h, dn + dr), ("qlora", "heads", "hd"), dtype=dtype,
                  scale=s(r_q)),
        "wkv_a": P((d, r_kv + dr), ("embed", "kvlora"), dtype=dtype, scale=s(d)),
        "kv_a_norm": P((r_kv,), ("kvlora",), init="ones", dtype=dtype),
        "wk_b": P((r_kv, h, dn), ("kvlora", "heads", "hd"), dtype=dtype, scale=s(r_kv)),
        "wv_b": P((r_kv, h, dv), ("kvlora", "heads", "hd"), dtype=dtype, scale=s(r_kv)),
        "wo": P((h, dv, d), ("heads", "hd", "embed"), dtype=dtype, scale=s(h * dv)),
    }


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    v = torch.square(xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps) * tp.whole(scale).float()).to(x.dtype)


def mla_heads(cfg: MLAConfig) -> tuple[int, int]:
    """[lo, hi): the heads this rank attends, its cut of ``wq_b``'s heads
    where a group's rules cut them there (``wk_b``, ``wv_b`` and ``wo`` are
    cut on the same heads), else all of them."""
    ctx = tp.current()
    if ctx is not None and sr.cut_dim(mla_spec(cfg)["wq_b"], ctx.mesh) == 1:
        return tp.local_range(cfg.n_heads)
    return 0, cfg.n_heads


def _mla_up(params, name: str, cfg: MLAConfig, compute_dtype) -> torch.Tensor:
    """The up-projection ``name`` (r, H, e) on this rank's heads."""
    w = params[name]
    if mla_heads(cfg) != (0, cfg.n_heads):
        w = tp.local(w, 1)
    return w.to(compute_dtype)


def _mla_latents(params, cfg: MLAConfig, x: torch.Tensor, compute_dtype):
    """x (..., D) in the compute dtype -> (q (..., H, nope + rope) before
    RoPE, the normed latent c_kv (..., r_kv), the shared k_pe (..., rope)
    before RoPE).  In a group, ``wq_a`` / ``wkv_a`` are row-parallel (cut on
    the embed dim), so the latents are whole on every rank, and q holds
    the rank's heads (``mla_heads``)."""
    lo, hi = mla_heads(cfg)
    cq = _rms(layers.dense({"w": params["wq_a"]}, x, compute_dtype), params["q_a_norm"])
    q = _heads_tp(cq, params["wq_b"], None, lo, hi, compute_dtype)
    kv_a = layers.dense({"w": params["wkv_a"]}, x, compute_dtype)
    c_kv = _rms(kv_a[..., :cfg.kv_lora_rank], params["kv_a_norm"])
    return q, c_kv, kv_a[..., cfg.kv_lora_rank:]


def mla_attention(params, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor,
                  compute_dtype=torch.bfloat16, kv_chunk: int = 1024) -> torch.Tensor:
    """Prefill MLA: decompress K and V per head, causal attention
    (``attend_full``, or ``attend_chunked`` past ``CHUNKED_THRESHOLD``).  In
    a group, over the rank's heads, ending in ``wo``'s row-parallel
    reduce."""
    x = x.to(compute_dtype)
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q, c_kv, k_pe = _mla_latents(params, cfg, x, compute_dtype)
    if mla_heads(cfg) != (0, cfg.n_heads):
        # the whole latents enter the rank's heads only
        c_kv, k_pe = tp.copy_in(c_kv), tp.copy_in(k_pe)
    h = q.shape[-2]
    q_pe = layers.apply_rope(q[..., dn:], positions, cfg.rope_base)
    k_pe = layers.apply_rope(k_pe[:, :, None, :], positions, cfg.rope_base)
    k_nope = _heads(c_kv, _mla_up(params, "wk_b", cfg, compute_dtype))
    v = _heads(c_kv, _mla_up(params, "wv_b", cfg, compute_dtype))
    q_full = torch.cat([q[..., :dn], q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe.expand(b, s, h, dr)], dim=-1)
    if s > CHUNKED_THRESHOLD:
        out = attend_chunked(q_full, k_full, v, cfg.scale, kv_chunk=kv_chunk)
    else:
        out = attend_full(q_full, k_full, v, causal_mask(s, s, device=x.device),
                          cfg.scale)
    return _out_tp(out, params["wo"], compute_dtype)


def mla_cache_shape(cfg: MLAConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The compressed cache, (c_kv ‖ k_pe) per token, as ``meta`` tensors.
    In a group it stays whole on every rank: each rank's heads read all of
    it.  The reference's policy would cut its sequence over the model axis
    (``sharding_rules.cache_pspec``), which waits for ROADMAP Queue 1 #6
    item 6."""
    return {name: torch.empty((batch, max_len, width), dtype=dtype, device="meta")
            for name, width in (("ckv", cfg.kv_lora_rank), ("kpe", cfg.qk_rope_dim))}


def mla_init_cache(cfg: MLAConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
    """Zeroed {ckv, kpe} on ``device`` (None = ``"cuda"``)."""
    dev = registry.resolve_device(device)
    return {name: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for name, t in mla_cache_shape(cfg, batch, max_len, dtype).items()}


def mla_decode_step(params, cfg: MLAConfig, cache, x_t: torch.Tensor, pos,
                    compute_dtype=torch.bfloat16):
    """Absorbed decode: attention runs in the compressed (rank
    ``kv_lora_rank``) space,

        score = (q_nope @ W_kb)ᵀ c + q_peᵀ k_pe ;  out = (attn @ c) @ W_vb.

    ``pos`` is an int or (B,) per-slot positions.  Writes the token's c_kv
    and k_pe into ``cache`` in place; returns (cache, out (B, D)).  In a
    group every rank writes the same whole latents and attends its heads."""
    x_t = x_t.to(compute_dtype)
    b, _ = x_t.shape
    dn = cfg.qk_nope_dim
    pos_b = torch.as_tensor(pos, dtype=torch.long, device=x_t.device).expand(b)
    q, c_t, kpe_t = _mla_latents(params, cfg, x_t, compute_dtype)
    q_pe = layers.apply_rope(q[:, None, :, dn:], pos_b[:, None], cfg.rope_base)[:, 0]
    kpe_t = layers.apply_rope(kpe_t[:, None, None, :], pos_b[:, None],
                              cfg.rope_base)[:, 0, 0]
    ckv, kpe = cache["ckv"], cache["kpe"]
    rows = torch.arange(b, device=x_t.device)
    ckv[rows, pos_b] = c_t.to(ckv.dtype)
    kpe[rows, pos_b] = kpe_t.to(kpe.dtype)

    # absorb W_kb into the query: q_eff (B, H, r_kv)
    q_eff = torch.einsum("bhe,rhe->bhr", q[..., :dn], _mla_up(params, "wk_b", cfg,
                                                               compute_dtype))
    c = ckv.to(compute_dtype)
    s_c = torch.einsum("bhr,bsr->bhs", q_eff, c)
    s_pe = torch.einsum("bhe,bse->bhs", q_pe, kpe.to(compute_dtype))
    scores = (s_c + s_pe).float() * cfg.scale
    valid = torch.arange(ckv.shape[1], device=x_t.device)[None, :] <= pos_b[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    out_c = torch.einsum("bhs,bsr->bhr", probs, c)
    out = torch.einsum("bhr,rhe->bhe", out_c, _mla_up(params, "wv_b", cfg, compute_dtype))
    return cache, _out_tp(out, params["wo"], compute_dtype)


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec, seamless-m4t)
# ---------------------------------------------------------------------------


def cross_attention(params, cfg: AttnConfig, x: torch.Tensor, enc_kv,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (B, Sq, D); enc_kv: precomputed {k, v}: (B, Skv, KV, hd).  The
    reference's unmasked softmax is the ``flash_attn`` kernel without its
    causal mask (``flash_mha``).  In a group, over the rank's q heads
    (``tp_heads``), ``enc_kv`` holding the kv heads they read
    (``encode_kv``), ending in ``wo``'s row-parallel reduce."""
    x = x.to(compute_dtype)
    qlo, qhi, _, _ = tp_heads(cfg)
    q = _heads_tp(x, params["wq"], None, qlo, qhi, compute_dtype)
    k = _kv_for_q(enc_kv["k"].to(compute_dtype), cfg)
    v = _kv_for_q(enc_kv["v"].to(compute_dtype), cfg)
    out = flash_ops.flash_mha(q, k, v, cfg.scale, causal=False)
    return _out_tp(out, params["wo"], compute_dtype)


def encode_kv(params, cfg: AttnConfig, enc_out: torch.Tensor,
              compute_dtype=torch.bfloat16):
    """The encoder output's cross-attention K/V, (B, S, KV, hd) each, no
    RoPE; in a group, the kv heads the rank's q heads read."""
    enc_out = enc_out.to(compute_dtype)
    _, _, kvlo, kvhi = tp_heads(cfg)
    return {key: _heads_tp(enc_out, params[w], None, kvlo, kvhi, compute_dtype)
            for key, w in (("k", "wk"), ("v", "wv"))}
