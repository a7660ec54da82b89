"""NVSA — Neuro-Vector-Symbolic Architecture (Hersche et al. 2023), in PyTorch.

The port of ``repro.models.nvsa``: the serving path, and the frontend's
training half (``frontend_loss`` with train-mode batchnorm, the BN EMA
fold, ``accuracy`` and the Tab. IV memory count):

  neuro:    ResNet frontend -> per-attribute PMFs over discrete values
  symbolic: FPE block-code encoding -> VSA rule abduction -> rule
            execution on row 3 by circular conv/corr (the circ_conv kernel)
            -> candidate similarity

Precision is a config knob: ``nn_precision`` fake-quantises the frontend
(int8/int4; with ``use_qmatmul`` the attribute heads run on the qmatmul
kernel) or computes it in bf16;
``symb_precision`` fake-quantises codebooks and panel codes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.data.raven import N_RULES, RavenConfig
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.nn import layers, resnet
from repro_torch.vsa import fpe, ops as vsa


@dataclasses.dataclass(frozen=True)
class NVSAConfig:
    raven: RavenConfig = RavenConfig()
    blocks: int = 4
    d: int = 256
    cnn_width: int = 16
    cnn_feat: int = 128
    rule_temp: float = 0.1
    answer_temp: float = 0.05
    nn_precision: str = "fp32"    # fp32 | bf16 | int8 | int4
    symb_precision: str = "fp32"  # fp32 | bf16 | int8 | int4
    # run the attribute heads on the qmatmul kernel when nn_precision is
    # int8/int4 (the served mixed-precision path)
    use_qmatmul: bool = False


# ---------------------------------------------------------------------------
# Parameters (trained) and codebooks (static, seed-derived)
# ---------------------------------------------------------------------------


def _resnet_cfg(cfg: NVSAConfig) -> resnet.ResNetConfig:
    return resnet.ResNetConfig(in_channels=1, width=cfg.cnn_width,
                               out_dim=cfg.cnn_feat)


def nvsa_spec(cfg: NVSAConfig):
    heads = {
        f"attr{i}": layers.dense_spec(cfg.cnn_feat, n, ("mlp", None), bias=True)
        for i, n in enumerate(cfg.raven.attr_sizes)
    }
    return {"frontend": resnet.resnet_spec(_resnet_cfg(cfg)), "heads": heads}


def nvsa_codebooks(cfg: NVSAConfig, generator: torch.Generator):
    """Static VSA memory (CPU tensors): FPE codebooks per attribute, shift
    codes and roles, drawn in that order from ``generator``."""
    books, shifts = [], []
    for n in cfg.raven.attr_sizes:
        phase = fpe.fpe_base_phase(generator, cfg.blocks, cfg.d)
        # values up to 2n-2 occur under arith_plus predictions
        books.append(fpe.fpe_codebook(phase, 2 * n - 1, cfg.d))
        shifts.append(fpe.fpe_encode(phase, [1.0, -1.0], cfg.d))
    roles = vsa.random_codebook(generator, cfg.raven.n_attrs, cfg.blocks, cfg.d)
    return {"books": books, "shifts": shifts, "roles": roles}


# ---------------------------------------------------------------------------
# Precision emulation
# ---------------------------------------------------------------------------

_BITS = {"int8": 8, "int4": 4}


def fake_quant(x: torch.Tensor, precision: str,
               axes: tuple[int, ...] | None = None) -> torch.Tensor:
    """Symmetric fake quantisation.  ``axes=None`` scales by the global
    amax (weights, static codebooks); reduction ``axes`` give per-slice
    scales (per problem in the serving path).  amax is clamped before the
    division by qmax, as in the reference."""
    if precision == "fp32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    bits = _BITS[precision]
    qmax = 2.0 ** (bits - 1) - 1
    if axes is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axes, keepdim=True)
    scale = qops.div_exact(torch.clamp(amax, min=1e-12), qmax)
    return torch.round(x / scale).clamp(-qmax - 1, qmax) * scale


def quant_tree(tree, precision: str):
    """Fake-quantise every float leaf with its own global amax (BN mean,
    var, scale and bias included, as the reference does)."""
    return tree_map(lambda x: fake_quant(x, precision)
                    if x.dtype in (torch.float32, torch.bfloat16) else x, tree)


def quantize_codebooks(cfg: NVSAConfig, codebooks):
    """Static VSA memory at cfg.symb_precision (no-op for fp32/bf16)."""
    if cfg.symb_precision not in _BITS:
        return codebooks
    sy = cfg.symb_precision
    return {
        "books": [fake_quant(b, sy) for b in codebooks["books"]],
        "shifts": [fake_quant(s, sy) for s in codebooks["shifts"]],
        "roles": fake_quant(codebooks["roles"], sy),
    }


_BITS_OF = {"fp32": 32, "bf16": 16, "int8": 8, "int4": 4}


def nvsa_memory_bytes(cfg: NVSAConfig, params) -> int:
    """Model memory at the configured mixed precision (Tab. IV): every
    parameter at ``nn_precision`` bits, the codebooks, shift codes and
    roles at ``symb_precision`` bits."""
    bits_nn = _BITS_OF[cfg.nn_precision]
    bits_sy = _BITS_OF[cfg.symb_precision]
    nn_elems = sum(x.numel() for x in tree_leaves(params))
    sy_elems = sum((2 * n - 1) * cfg.blocks * cfg.d for n in cfg.raven.attr_sizes)
    sy_elems += (2 * cfg.raven.n_attrs + cfg.raven.n_attrs) * cfg.blocks * cfg.d
    return (nn_elems * bits_nn + sy_elems * bits_sy) // 8


# ---------------------------------------------------------------------------
# Neuro frontend
# ---------------------------------------------------------------------------


def frontend_pmfs(params, cfg: NVSAConfig, images: torch.Tensor,
                  train: bool = False, bn_stats: dict | None = None):
    """images: (N, H, W, 1) -> (list of (N, V_attr) PMFs, list of logits).

    ``train=False`` (serving, ``solve``) uses the running BN stats, so each
    image's PMFs are independent of its batch.  ``train=True`` uses batch
    statistics and records them in ``bn_stats`` for
    ``frontend_apply_bn_stats``.  At ``nn_precision="bf16"`` the ResNet and
    heads compute in bf16; the logits are f32."""
    p = params
    if cfg.nn_precision in _BITS:
        p = quant_tree(params, cfg.nn_precision)
    compute_dtype = torch.bfloat16 if cfg.nn_precision == "bf16" else torch.float32
    feats = torch.relu(resnet.resnet(p["frontend"], _resnet_cfg(cfg), images,
                                     train=train, compute_dtype=compute_dtype,
                                     bn_stats=bn_stats))
    if cfg.use_qmatmul and cfg.nn_precision in _BITS:
        # heads on the qmatmul kernel: int8 activations (per-row scales) x
        # int8/packed-int4 weights (per-column scales)
        bits = _BITS[cfg.nn_precision]
        logits = []
        for i in range(cfg.raven.n_attrs):
            h = p["heads"][f"attr{i}"]
            y = qops.qdense(feats.float(), h["w"].float(), bits_w=bits)
            logits.append(y + h["b"].float())
    else:
        logits = [layers.dense(p["heads"][f"attr{i}"], feats, compute_dtype).float()
                  for i in range(cfg.raven.n_attrs)]
    return [torch.softmax(l, dim=-1) for l in logits], logits


def frontend_loss(params, cfg: NVSAConfig, images: torch.Tensor, attrs: torch.Tensor):
    """Supervised attribute cross-entropy, the frontend's training
    objective, in train-mode BN.  attrs: (N, n_attrs) integer labels.
    Returns ``(loss, bn_stats)``: the batch statistics feed
    ``frontend_apply_bn_stats``."""
    bn_stats: dict = {}
    _, logits = frontend_pmfs(params, cfg, images, train=True, bn_stats=bn_stats)
    loss = 0.0
    for i, l in enumerate(logits):
        logp = torch.log_softmax(l, dim=-1)
        loss = loss - torch.gather(logp, 1, attrs[:, i: i + 1].long()).mean()
    return loss / cfg.raven.n_attrs, bn_stats


def frontend_apply_bn_stats(params, bn_stats: dict, momentum: float = 0.9):
    """EMA-fold one step's BN batch statistics into the frontend's running
    stats; returns a new params tree."""
    return {**params,
            "frontend": layers.bn_apply_stats(params["frontend"], bn_stats, momentum)}


# ---------------------------------------------------------------------------
# Symbolic reasoning (VSA)
# ---------------------------------------------------------------------------


def _pmf_to_code(pmf: torch.Tensor, book: torch.Tensor, n: int) -> torch.Tensor:
    """Probability-weighted superposition: (N, V) × (Vbig, B, d) -> (N, B, d).
    Only the first ``n`` book entries correspond to observable values."""
    return torch.einsum("nv,vbd->nbd", pmf, book[:n])


def _rule_predict(rule_idx: int, c1: torch.Tensor, c2: torch.Tensor,
                  shifts: torch.Tensor) -> torch.Tensor:
    """Predict a row's 3rd code from its first two under each RPM rule."""
    if rule_idx == 0:  # constant
        return c2
    if rule_idx == 1:  # progression +1
        return vsa.bind(c2, shifts[0][None])
    if rule_idx == 2:  # progression -1
        return vsa.bind(c2, shifts[1][None])
    if rule_idx == 3:  # arithmetic a3 = a1 + a2
        return vsa.bind(c1, c2)
    # arithmetic a3 = a1 - a2  (spectral conj subtraction)
    return vsa.unbind(c2, c1)


def reason(cfg: NVSAConfig, codebooks, ctx_pmfs, cand_pmfs):
    """Symbolic stage.

    ctx_pmfs:  list per attr of (N, 8, V) PMFs for the context panels
    cand_pmfs: list per attr of (N, 8, V) PMFs for the candidate panels
    Returns (answer_logprobs (N, 8), rule_probs (n_attr, N, R)).
    At d >= 128 one call makes 42 bind/unbind kernel calls: per attribute
    8 in rule scoring and 4 in execution, then 3 role binds for the
    prediction and 3 for the candidates.
    """
    n = ctx_pmfs[0].shape[0]
    rule_probs_all = []
    pred_codes = []  # per attr: (N, B, d) predicted 9th-panel code
    for ai in range(cfg.raven.n_attrs):
        book = codebooks["books"][ai]
        shifts = codebooks["shifts"][ai]
        n_vals = cfg.raven.attr_sizes[ai]
        codes = _pmf_to_code(ctx_pmfs[ai].reshape(n * 8, -1), book, n_vals)
        codes = codes.reshape(n, 8, cfg.blocks, cfg.d)
        # score each rule on the two complete rows
        scores = []
        for r in range(N_RULES):
            s = 0.0
            for r0 in (0, 3):
                pred = _rule_predict(r, codes[:, r0], codes[:, r0 + 1], shifts)
                s = s + vsa.similarity(pred, codes[:, r0 + 2])
            scores.append(s / 2.0)
        rule_prob = torch.softmax(torch.stack(scores, dim=-1) / cfg.rule_temp,
                                  dim=-1)  # (N, R)
        rule_probs_all.append(rule_prob)
        # execute all rules on row 3, mix by posterior
        preds = torch.stack(
            [_rule_predict(r, codes[:, 6], codes[:, 7], shifts)
             for r in range(N_RULES)], dim=1)  # (N, R, B, d)
        pred_codes.append(torch.einsum("nr,nrbd->nbd", rule_prob, preds))

    # compose panel-level codes with attribute roles, compare to candidates
    roles = codebooks["roles"]  # (A, B, d)
    pred_panel = sum(
        vsa.bind(pred_codes[ai], roles[ai][None])
        for ai in range(cfg.raven.n_attrs))  # (N, B, d)
    cand_codes = []
    for ai in range(cfg.raven.n_attrs):
        book = codebooks["books"][ai]
        n_vals = cfg.raven.attr_sizes[ai]
        c = _pmf_to_code(cand_pmfs[ai].reshape(n * 8, -1), book, n_vals)
        cand_codes.append(vsa.bind(c.reshape(n, 8, cfg.blocks, cfg.d),
                                   roles[ai][None, None]))
    cand_panel = sum(cand_codes)  # (N, 8, B, d)

    if cfg.symb_precision in _BITS:
        # per-problem activation scales (axis 0 = batch)
        pred_panel = fake_quant(pred_panel, cfg.symb_precision,
                                axes=tuple(range(1, pred_panel.dim())))
        cand_panel = fake_quant(cand_panel, cfg.symb_precision,
                                axes=tuple(range(1, cand_panel.dim())))

    sims = vsa.similarity(pred_panel[:, None], cand_panel)  # (N, 8)
    logp = torch.log_softmax(sims / cfg.answer_temp, dim=-1)
    return logp, torch.stack(rule_probs_all)


# ---------------------------------------------------------------------------
# End-to-end
# ---------------------------------------------------------------------------


def solve(params, codebooks, cfg: NVSAConfig, context: torch.Tensor,
          candidates: torch.Tensor):
    """context: (N, 8, H, W, 1); candidates: (N, 8, H, W, 1).

    Returns (answer_logprobs (N, 8), rule_probs (A, N, R))."""
    n, _, h, w, c = context.shape
    codebooks = quantize_codebooks(cfg, codebooks)
    ctx_pmfs, _ = frontend_pmfs(params, cfg, context.reshape(n * 8, h, w, c))
    cand_pmfs, _ = frontend_pmfs(params, cfg, candidates.reshape(n * 8, h, w, c))
    ctx_pmfs = [p.reshape(n, 8, -1) for p in ctx_pmfs]
    cand_pmfs = [p.reshape(n, 8, -1) for p in cand_pmfs]
    return reason(cfg, codebooks, ctx_pmfs, cand_pmfs)


def accuracy(params, codebooks, cfg: NVSAConfig, batch) -> tuple[float, float]:
    """(answer accuracy, rule accuracy) of ``solve`` on a numpy batch of
    ``data.raven.generate_batch``, on the params' device (the codebooks are
    moved there)."""
    dev = tree_leaves(params)[0].device
    codebooks = tree_map(lambda t: t.to(dev), codebooks)
    with torch.no_grad():
        logp, rule_probs = solve(params, codebooks, cfg,
                                 torch.as_tensor(batch["context"], device=dev),
                                 torch.as_tensor(batch["candidates"], device=dev))
    answers = torch.as_tensor(np.asarray(batch["answer"]), device=dev)
    rules = torch.as_tensor(np.asarray(batch["rules"]), device=dev)
    ans_acc = (logp.argmax(-1) == answers).float().mean()
    rule_acc = (rule_probs.argmax(-1).T == rules).float().mean()
    return float(ans_acc), float(rule_acc)


def oracle_pmfs(cfg: NVSAConfig, attrs: torch.Tensor):
    """Ground-truth one-hot PMFs (symbolic-only upper bound)."""
    return [(attrs[..., i, None] == torch.arange(n, device=attrs.device)).float()
            for i, n in enumerate(cfg.raven.attr_sizes)]
