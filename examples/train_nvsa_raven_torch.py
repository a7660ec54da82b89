"""End-to-end NVSA on the PyTorch port: train the ResNet frontend on
synthetic RAVEN panels, then evaluate neuro-symbolic reasoning accuracy
and model memory across precisions (the paper's Tab. IV).

The twin of ``examples/train_nvsa_raven.py``, with its settings: the
seed-11 panel set, AdamW (lr 3e-3, warmup 20, weight decay 1e-4), batches
of 64 drawn by ``numpy.random.default_rng(0)``, and after each update the
BN batch statistics folded into the running stats (momentum 0.9).  The
initial parameters are drawn from a seeded ``torch.Generator``, so the
numbers are the port's own, not the reference's.

Usage (from the repository root):
  PYTHONPATH=src python examples/train_nvsa_raven_torch.py \\
      [--device cuda|cpu] [--steps 400] [--n-train 400] [--n-eval 128] \\
      [--out results/nvsa_tab4_torch.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.data import raven
from repro_torch.models import nvsa
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt_mod

# Tab. IV's columns: (label, nn_precision, symb_precision)
PRECISIONS = (("fp32", "fp32", "fp32"), ("bf16", "bf16", "bf16"),
              ("int8", "int8", "int8"), ("mp", "int8", "int4"),
              ("int4", "int4", "int4"))
STYLES = ("raven", "iraven", "pgm")


def train_frontend(cfg: nvsa.NVSAConfig, steps: int, n_problems: int,
                   batch: int = 64, lr: float = 3e-3, log_every: int = 50,
                   device=None, params=None):
    """Train the frontend; returns (params, the per-step losses as one f32
    CPU tensor, the loop's seconds on the host clock).  ``params`` defaults to a draw from ``torch.Generator`` seed
    0 on the device.  On a CUDA device TF32 is turned off for conv and
    matmul, as ``ReasonEngine`` does."""
    dev = registry.resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    imgs, attrs = raven.panel_dataset(cfg.raven, seed=11, n_problems=n_problems)
    print(f"[nvsa] supervision set: {imgs.shape[0]} panels", flush=True)
    imgs_d, attrs_d = torch.from_numpy(imgs).to(dev), torch.from_numpy(attrs).to(dev)
    if params is None:
        params = nninit.materialize(nvsa.nvsa_spec(cfg),
                                    torch.Generator(device=dev).manual_seed(0))
    ocfg = opt_mod.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps,
                               weight_decay=1e-4)
    state = opt_mod.init_state(params, ocfg)
    grad_fn = opt_mod.value_and_grad(nvsa.frontend_loss, has_aux=True)

    rng = np.random.default_rng(0)
    losses = []
    t0 = time.time()
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, imgs.shape[0], batch)).to(dev)
        (loss, bn_stats), grads = grad_fn(params, cfg, imgs_d[idx], attrs_d[idx])
        params, state, _ = opt_mod.apply_updates(params, grads, state, ocfg)
        # fold this step's BN batch statistics into the running stats, so
        # eval-mode BN (serving, nvsa.solve) sees trained statistics
        params = nvsa.frontend_apply_bn_stats(params, bn_stats, momentum=0.9)
        losses.append(loss)
        if s % log_every == 0 or s == steps - 1:
            print(f"[nvsa] step {s:4d} loss {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    losses = torch.stack(losses).float().cpu()  # waits for the device
    return params, losses, time.time() - t0


def tab4(params, base: nvsa.NVSAConfig, n_eval: int) -> dict:
    """Answer and rule accuracy and memory bytes per RAVEN style and
    precision, on the params' device."""
    results = {}
    for style in STYLES:
        rcfg = dataclasses.replace(base.raven, style=style)
        batch = raven.generate_batch(rcfg, seed=777, n=n_eval)
        row = {}
        for label, nn_p, sy_p in PRECISIONS:
            cfg = dataclasses.replace(base, raven=rcfg, nn_precision=nn_p,
                                      symb_precision=sy_p)
            codebooks = nvsa.nvsa_codebooks(cfg, torch.Generator().manual_seed(1))
            acc, racc = nvsa.accuracy(params, codebooks, cfg, batch)
            mem = nvsa.nvsa_memory_bytes(cfg, params)
            row[label] = {"answer_acc": acc, "rule_acc": racc, "memory_bytes": mem}
            print(f"[tab4] {style:7s} {label:5s} acc {acc:.3f} rule {racc:.3f} "
                  f"mem {mem / 1e6:.2f} MB", flush=True)
        results[style] = row
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--n-train", type=int, default=400)
    ap.add_argument("--n-eval", type=int, default=128)
    ap.add_argument("--out", default="results/nvsa_tab4_torch.json")
    args = ap.parse_args()

    base = nvsa.NVSAConfig()
    params, _, _ = train_frontend(base, args.steps, args.n_train, device=args.device)
    results = tab4(params, base, args.n_eval)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"[tab4] wrote {out}")


if __name__ == "__main__":
    main()
