"""Continuous-batching LM serving and the enc-dec overlap on the PyTorch port.

The twin of ``examples/serve_lm.py``:

Part 1: slot-based continuous batching on a llama-family model: 8 ragged
         requests stream through a 4-slot KV pool, retired slots are
         refilled from the queue mid-flight, decode runs in blocks of 8
         tokens, sampling at temperature 0.7, top-k 32.
Part 2: seamless-m4t-style enc-dec serving where encode(batch i+1) is
         issued before decode(batch i), NSFlow's inter-loop overlap (paper
         Fig. 4 ③) mapped to serving, as the reference issues it.  Both
         go to one stream: on a CUDA device the launches are asynchronous,
         so the device runs the encoder while the host issues the decode
         loop behind it.

The parameters are drawn from a ``torch.Generator`` seeded 0 on the device
and sampling uses the port's seeded streams, so the tokens are the port's
own, not the reference's.

Usage (from the repository root):
  PYTHONPATH=src python examples/serve_lm_torch.py [--device cuda|cpu] \\
      [--arch-width smoke|full]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.models import encdec
from repro_torch.nn import init as nninit
from repro_torch.serve.engine import Engine, Request, ServeConfig


def _make(arch_id: str, width: str, dev: torch.device):
    arch = ARCHS[arch_id]
    cfg = arch.make_smoke() if width == "smoke" else arch.make_full()
    params = nninit.materialize(cbase.model_spec(arch, cfg),
                                torch.Generator(dev).manual_seed(0))
    return arch, cfg, params


def serve_llama(device=None, width: str = "smoke"):
    """Part 1; returns the engine's results by uid."""
    dev = registry.resolve_device(device)
    arch, cfg, params = _make("llama3.2-3b", width, dev)
    step, init_caches = cbase.serve_fns(arch, cfg, max_len=64)
    engine = Engine(step, init_caches,
                    ServeConfig(max_new_tokens=16, max_slots=4, max_len=64,
                                decode_block=8, temperature=0.7, top_k=32,
                                eos_id=1, seed=0), params=params)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(2, cfg.vocab, (int(rng.integers(4, 14)),)
                                        ).astype(np.int32))
            for i in range(8)]
    t0 = time.time()
    results = engine.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.tokens) for r in results.values())
    print(f"[serve_lm] llama-{width}: {len(results)} requests ({toks} tokens) through "
          f"a {engine.cfg.max_slots}-slot pool in {dt:.1f}s ({toks / dt:.1f} tok/s)")
    print(f"[serve_lm] slot utilization {engine.utilization():.0%}, "
          f"requests per slot: {engine.stats['slots_served']}")
    for uid in sorted(results)[:3]:
        r = results[uid]
        print(f"[serve_lm]   req {uid}: prompt {r.prompt_len} -> "
              f"{r.tokens[:8].tolist()}{' (eos)' if r.finished_by_eos else ''}")
    return results


def encdec_frames(d_model: int, n_batches: int, batch: int, src_len: int,
                  seed: int = 1) -> list[torch.Tensor]:
    """The example's stub frame embeddings: (batch, src_len, d_model) bf16
    per batch, standard normal from ``seed``, drawn in the reference
    example's order."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(batch, src_len, d_model))).to(torch.bfloat16)
            for _ in range(n_batches)]


def greedy_decode(params, cfg, enc_out, new_tokens: int, max_len: int,
                  dev: torch.device, keep_logits: bool = False):
    """Greedy decode of one batch from token 0 over ``enc_out``'s caches:
    (tokens (B, new_tokens), f32 logits (B, new_tokens, V) or None)."""
    caches = encdec.init_caches(params, cfg, enc_out, max_len, device=dev)
    tok = torch.zeros(enc_out.shape[0], dtype=torch.long, device=dev)
    toks, logits_seen = [], []
    for t in range(new_tokens):
        caches, logits = encdec.decode_step(params, cfg, caches, tok, t)
        tok = logits.argmax(-1)
        toks.append(tok)
        if keep_logits:
            logits_seen.append(logits.float())
    return torch.stack(toks, 1), (torch.stack(logits_seen, 1) if keep_logits else None)


def serve_encdec_overlap(device=None, width: str = "smoke", cfg=None, params=None,
                         n_batches: int = 3, batch: int = 2, src_len: int = 24,
                         new_tokens: int = 8, max_len: int = 32,
                         keep_logits: bool = False) -> list[dict]:
    """Part 2: ``n_batches`` batches of (batch, src_len) frames, greedy
    ``new_tokens`` each, encode(i+1) issued before decode(i).  ``cfg`` and
    ``params`` (default: the arch at ``width``, seeded 0) let a caller
    serve its own.  Returns per batch {"frames", "enc_out", "tokens",
    "logits" (with ``keep_logits``)}, all on the device."""
    dev = registry.resolve_device(device)
    if cfg is None:
        _, cfg, drawn = _make("seamless-m4t-large-v2", width, dev)
        params = drawn if params is None else params
    frames = [f.to(dev) for f in encdec_frames(cfg.d_model, n_batches, batch, src_len)]
    out = []
    t0 = time.time()
    enc_next = encdec.encode(params, cfg, frames[0])
    for i in range(n_batches):
        enc_cur = enc_next
        if i + 1 < n_batches:
            enc_next = encdec.encode(params, cfg, frames[i + 1])   # overlapped encode
        toks, logits = greedy_decode(params, cfg, enc_cur, new_tokens, max_len, dev,
                                     keep_logits)
        out.append({"frames": frames[i], "enc_out": enc_cur, "tokens": toks,
                    "logits": logits})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[serve_lm] enc-dec pipelined serving: {n_batches} batches x "
          f"{new_tokens} tokens in {time.time() - t0:.1f}s "
          f"(encode i+1 issued before decode i)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch-width", choices=("smoke", "full"), default="smoke")
    args = ap.parse_args(argv)
    serve_llama(args.device, args.arch_width)
    serve_encdec_overlap(args.device, args.arch_width)


if __name__ == "__main__":
    main()
