"""End-to-end LM training on the PyTorch port: a llama-family model on the
synthetic token stream for a few hundred steps, with checkpoint/restart.

The twin of ``examples/train_lm.py``, with its widths, flags and schedule:
AdamW at ``--lr`` with 20 warmup steps and cosine decay over ``--steps``,
a checkpoint every ``max(25, steps // 4)`` steps, ``SyntheticTokens`` seed
0, ``remat`` on (the ``LMConfig`` default), bf16 compute.  The initial
parameters are drawn from a ``torch.Generator`` seeded 0 on the device, so
the losses are the port's own, not the reference's.  A checkpoint under
``--ckpt-dir`` is resumed.

Usage (from the repository root):
  PYTHONPATH=src python examples/train_lm_torch.py [--device cuda|cpu] \\
      [--width demo|full100m] [--steps 200] [--batch 8] [--seq 256] \\
      [--lr 1e-3] [--ckpt-dir results/lm_ckpt_torch] \\
      [--out results/train_lm_torch_metrics.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch.backend import registry
from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
from repro_torch.models import lm
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import FailureInjector, Trainer, TrainerConfig

WIDTHS = {
    # ~25M params
    "demo": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                 head_dim=64, d_ff=1024, vocab=8192),
    # ~100M params: the end-to-end scale
    "full100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                     head_dim=64, d_ff=2048, vocab=32768),
}


def make_trainer(width: str, steps: int, batch: int, seq: int, lr: float,
                 ckpt_dir: str, device=None,
                 injector: FailureInjector | None = None) -> tuple[Trainer, int]:
    """The example's ``Trainer`` and its parameter count."""
    dev = registry.resolve_device(device)
    cfg = lm.LMConfig(name=f"lm-{width}", **WIDTHS[width])
    spec = lm.lm_spec(cfg)
    params = nninit.materialize(spec, torch.Generator(device=dev).manual_seed(0))
    loader = SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    trainer = Trainer(
        loss_fn=lambda p, b: lm.loss_fn(p, cfg, b), params=params,
        tcfg=TrainerConfig(total_steps=steps, ckpt_every=max(25, steps // 4),
                           ckpt_dir=ckpt_dir),
        ocfg=opt_mod.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps),
        loader=loader, injector=injector, device=dev)
    return trainer, nninit.param_count(spec)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", choices=list(WIDTHS), default="demo")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="results/lm_ckpt_torch")
    ap.add_argument("--out", default="results/train_lm_torch_metrics.json")
    args = ap.parse_args(argv)

    trainer, n_params = make_trainer(args.width, args.steps, args.batch, args.seq,
                                     args.lr, args.ckpt_dir, args.device)
    print(f"[train_lm] {args.width}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens on {trainer.device}")
    if trainer.try_restore():
        print(f"[train_lm] resumed from step {trainer.step}")
    t0 = time.time()
    hist = trainer.run()
    dt = time.time() - t0
    if not hist:
        print("[train_lm] nothing to do (checkpoint already at target step)")
        return
    print(f"[train_lm] loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({dt / max(1, len(hist)):.2f}s/step)")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        {"width": args.width, "device": str(trainer.device), "steps": len(hist),
         "losses": [h["loss"] for h in hist],
         "s_per_step": dt / max(1, len(hist))}, indent=1))


if __name__ == "__main__":
    main()
