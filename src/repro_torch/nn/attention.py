"""Attention: GQA / MQA, full and sliding-window, prefill and decode.

The port of the GQA half of ``repro.nn.attention``.  Layouts are the
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

MLA and cross-attention are not ported (ROADMAP Queue 1 #4).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.backend import registry
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


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matmul."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).unflatten(-1, (h, e))


def out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd") (or "bhe,hed->bd") as one matmul."""
    h, e, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * e, d)


def gqa_project(params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                compute_dtype=torch.bfloat16):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied."""
    x = x.to(compute_dtype)
    q = _heads(x, params["wq"].to(compute_dtype))
    k = _heads(x, params["wk"].to(compute_dtype))
    v = _heads(x, params["wv"].to(compute_dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    if cfg.qk_norm:
        q = _headwise_rms(q, params["qnorm"].float())
        k = _headwise_rms(k, params["knorm"].float())
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
              compute_dtype=torch.bfloat16, kv_chunk: int = 1024) -> torch.Tensor:
    """Self-attention over a full sequence (prefill), causal from position
    0.  Without a window: the ``flash_attn`` kernel (``flash_mha``).  With
    one: ``attend_full``, or ``attend_chunked`` past ``CHUNKED_THRESHOLD``
    tokens, as in the reference."""
    q, k, v = gqa_project(params, cfg, x, positions, compute_dtype)
    groups = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    s = x.shape[1]
    if cfg.window is None:
        out = flash_ops.flash_mha(q, k, v, cfg.scale, causal=True)
    elif s > CHUNKED_THRESHOLD:
        out = attend_chunked(q, k, v, cfg.scale, window=cfg.window, kv_chunk=kv_chunk)
    else:
        mask = causal_mask(s, s, window=cfg.window, device=x.device)
        out = attend_full(q, k, v, mask, cfg.scale)
    return out_project(out, params["wo"].to(compute_dtype))


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


def kv_cache_shape(cfg: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """{k, v} as ``meta`` tensors.  Sliding-window layers hold only the
    window (a ring buffer)."""
    length = min(max_len, cfg.window) if cfg.window else max_len
    shp = (batch, length, cfg.n_kv_heads, cfg.head_dim)
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

    groups = cfg.n_heads // cfg.n_kv_heads
    k = _repeat_kv(k_cache.to(compute_dtype), groups)
    v = _repeat_kv(v_cache.to(compute_dtype), groups)
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
    return cache, out_project(out, params["wo"].to(compute_dtype))
