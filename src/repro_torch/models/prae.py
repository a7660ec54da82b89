"""PrAE — Probabilistic Abduction and Execution (Zhang et al., CVPR'21), in PyTorch.

The port of ``repro.models.prae``.  The symbolic engine works on attribute
probability tables: progression is an index shift, arithmetic a discrete
circular (cross-)correlation of distributions; abduction scores each rule
by the likelihood it gives the observed third panel, execution predicts
the 9th panel's PMF.  It launches no kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.data.raven import N_RULES, RavenConfig


@dataclasses.dataclass(frozen=True)
class PrAEConfig:
    raven: RavenConfig = RavenConfig()
    rule_temp: float = 0.1
    answer_temp: float = 0.05
    eps: float = 1e-6


def _shift_pmf(p: torch.Tensor, delta: int) -> torch.Tensor:
    """Progression: P(v) -> P(v - delta) with wraparound."""
    return torch.roll(p, delta, dims=-1)


def _mod_index(n: int, sign: int, device) -> torch.Tensor:
    """(n, n) index: row v, column k reads (v + sign·k) mod n."""
    v = torch.arange(n, device=device)[:, None]
    k = torch.arange(n, device=device)[None, :]
    return (v + sign * k) % n


def _conv_pmf(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Arithmetic plus: out[v] = Σ_k p[k]·q[(v − k) mod n]."""
    idx = _mod_index(p.shape[-1], -1, p.device)
    return torch.einsum("...k,...vk->...v", p, q[..., idx])


def _corr_pmf(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Arithmetic minus: out[v] = Σ_k q[k]·p[(v + k) mod n]."""
    idx = _mod_index(p.shape[-1], 1, p.device)
    return torch.einsum("...k,...vk->...v", q, p[..., idx])


def rule_execute(rule_idx: int, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    if rule_idx == 0:
        return p2
    if rule_idx == 1:
        return _shift_pmf(p2, 1)
    if rule_idx == 2:
        return _shift_pmf(p2, -1)
    if rule_idx == 3:
        return _conv_pmf(p1, p2)
    return _corr_pmf(p1, p2)


def solve_from_pmfs(cfg: PrAEConfig, ctx_pmfs, cand_pmfs):
    """ctx_pmfs / cand_pmfs: lists per attr of (N, 8, V).  Returns (answer
    log-probs (N, 8), rule posteriors (A, N, R))."""
    total = 0.0
    posts = []
    for ai in range(cfg.raven.n_attrs):
        pm = ctx_pmfs[ai]
        # abduction: likelihood of the observed third panel under each rule
        logits = []
        for r in range(N_RULES):
            ll = 0.0
            for r0 in (0, 3):
                pred = rule_execute(r, pm[:, r0], pm[:, r0 + 1])
                ll = ll + (pm[:, r0 + 2] * torch.log(pred + cfg.eps)).sum(-1)
            logits.append(ll / 2.0)
        post = torch.softmax(torch.stack(logits, dim=-1) / cfg.rule_temp, dim=-1)
        posts.append(post)
        # execution on row 3
        preds = torch.stack([rule_execute(r, pm[:, 6], pm[:, 7])
                             for r in range(N_RULES)], dim=1)  # (N, R, V)
        pred9 = torch.einsum("nr,nrv->nv", post, preds)
        pred9 = pred9 / torch.clamp(pred9.sum(-1, keepdim=True), min=cfg.eps)
        # candidate scoring: cross-entropy against the predicted PMF
        total = total + torch.einsum("npv,nv->np", cand_pmfs[ai],
                                     torch.log(pred9 + cfg.eps))
    logp = torch.log_softmax(total / cfg.answer_temp, dim=-1)
    return logp, torch.stack(posts)


def accuracy(cfg: PrAEConfig, ctx_pmfs, cand_pmfs, answers: torch.Tensor, rules=None):
    """(answer accuracy, rule accuracy or None when ``rules`` is None)."""
    logp, posts = solve_from_pmfs(cfg, ctx_pmfs, cand_pmfs)
    acc = float((logp.argmax(-1) == answers).float().mean())
    racc = None
    if rules is not None:
        rules = torch.as_tensor(rules, device=posts.device)
        racc = float((posts.argmax(-1).T == rules).float().mean())
    return acc, racc
