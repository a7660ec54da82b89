"""Attention: GQA / MQA, full and sliding-window, and MLA, prefill and
decode.

The port of ``repro.nn.attention`` without cross-attention.  Layouts are the
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

Cross-attention (``cross_attention``, ``encode_kv``) waits for the
enc-dec kind (ROADMAP Queue 1 #4 item 3).
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
    return (xf * torch.rsqrt(v + eps) * scale.float()).to(x.dtype)


def _mla_latents(params, cfg: MLAConfig, x: torch.Tensor, compute_dtype):
    """x (..., D) in the compute dtype -> (q (..., H, nope + rope) before
    RoPE, the normed latent c_kv (..., r_kv), the shared k_pe (..., rope)
    before RoPE)."""
    cq = _rms(x @ params["wq_a"].to(compute_dtype), params["q_a_norm"])
    q = _heads(cq, params["wq_b"].to(compute_dtype))
    kv_a = x @ params["wkv_a"].to(compute_dtype)
    c_kv = _rms(kv_a[..., :cfg.kv_lora_rank], params["kv_a_norm"])
    return q, c_kv, kv_a[..., cfg.kv_lora_rank:]


def mla_attention(params, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor,
                  compute_dtype=torch.bfloat16, kv_chunk: int = 1024) -> torch.Tensor:
    """Prefill MLA: decompress K and V per head, causal attention
    (``attend_full``, or ``attend_chunked`` past ``CHUNKED_THRESHOLD``)."""
    x = x.to(compute_dtype)
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q, c_kv, k_pe = _mla_latents(params, cfg, x, compute_dtype)
    q_pe = layers.apply_rope(q[..., dn:], positions, cfg.rope_base)
    k_pe = layers.apply_rope(k_pe[:, :, None, :], positions, cfg.rope_base)
    k_nope = _heads(c_kv, params["wk_b"].to(compute_dtype))
    v = _heads(c_kv, params["wv_b"].to(compute_dtype))
    q_full = torch.cat([q[..., :dn], q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe.expand(b, s, h, dr)], dim=-1)
    if s > CHUNKED_THRESHOLD:
        out = attend_chunked(q_full, k_full, v, cfg.scale, kv_chunk=kv_chunk)
    else:
        out = attend_full(q_full, k_full, v, causal_mask(s, s, device=x.device),
                          cfg.scale)
    return out_project(out, params["wo"].to(compute_dtype))


def mla_cache_shape(cfg: MLAConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The compressed cache, (c_kv ‖ k_pe) per token, as ``meta`` tensors."""
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
    and k_pe into ``cache`` in place; returns (cache, out (B, D))."""
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
    q_eff = torch.einsum("bhe,rhe->bhr", q[..., :dn], params["wk_b"].to(compute_dtype))
    c = ckv.to(compute_dtype)
    s_c = torch.einsum("bhr,bsr->bhs", q_eff, c)
    s_pe = torch.einsum("bhe,bse->bhs", q_pe, kpe.to(compute_dtype))
    scores = (s_c + s_pe).float() * cfg.scale
    valid = torch.arange(ckv.shape[1], device=x_t.device)[None, :] <= pos_b[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    out_c = torch.einsum("bhs,bsr->bhr", probs, c)
    out = torch.einsum("bhr,rhe->bhe", out_c, params["wv_b"].to(compute_dtype))
    return cache, out_project(out, params["wo"].to(compute_dtype))
