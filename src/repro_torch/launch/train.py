"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``: a real training loop on one device
(``--device``, default the card; ``cpu`` runs the plain versions), with
checkpoint/restart and the synthetic token pipeline, over the port's
``configs/registry.py:ARCHS``, ``data/tokens.py:SyntheticTokens``,
``nn/init.py`` (a seeded ``torch.Generator``), ``train/trainer.py:Trainer``
and ``AdamWConfig(quantized_state=arch.opt_8bit)``.  Token-LM kinds only
(``lm``, ``rwkv``, ``griffin``); the others exit with the reference's
message.

``--ckpt-dir`` has no default: a run saves there and ``--resume`` restores
from there, so two runs must not share a directory by accident (the
reference's fixed default is the fault the port's ``TrainerConfig``
already refuses).  ``main(argv)`` returns the metrics history.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch.backend import registry
from repro_torch.configs import base as cbase
from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> list[dict]:
    from repro_torch.configs.registry import ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the reduced one)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    arch = ARCHS[args.arch]
    if arch.kind not in ("lm", "rwkv", "griffin"):
        raise SystemExit(f"{args.arch}: token-LM training only in this launcher "
                         "(vlm/encdec need modality batches — see examples/)")
    dev = registry.resolve_device(args.device)
    cfg = arch.make_full() if args.full else arch.make_smoke()
    spec = cbase.model_spec(arch, cfg)
    params = nninit.materialize(spec, torch.Generator(dev).manual_seed(0))
    n_params = nninit.param_count(spec)
    print(f"[train] arch={args.arch} params={n_params / 1e6:.2f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} device={dev}")

    loader = SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab, seq_len=args.seq,
        global_batch=args.batch * args.accum, seed=0))
    trainer = Trainer(
        loss_fn=cbase.loss_fn(arch, cfg), params=params,
        tcfg=TrainerConfig(total_steps=args.steps, ckpt_every=max(10, args.steps // 5),
                           ckpt_dir=args.ckpt_dir, grad_accum=args.accum),
        ocfg=opt_mod.AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                                 total_steps=args.steps,
                                 quantized_state=arch.opt_8bit),
        loader=loader, device=dev)
    del params
    if args.resume and trainer.try_restore():
        print(f"[train] resumed from step {trainer.step}")
    t0 = time.time()
    hist = trainer.run()
    dt = time.time() - t0
    if hist:
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"in {dt:.0f}s ({dt / len(hist):.2f}s/step)")
    if args.metrics_out:
        p = pathlib.Path(args.metrics_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(hist, indent=1))
    return hist


if __name__ == "__main__":
    main()
