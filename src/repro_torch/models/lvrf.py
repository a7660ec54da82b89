"""LVRF — Learn-VRF: probabilistic abduction with learned VSA rules
(Hersche et al., NeurIPS'23), in PyTorch.

The port of ``repro.models.lvrf``: the serving path, ``loss_fn`` and
``accuracy``.  A rule ``R_k`` maps a
row's first two panel codes to a predicted third code by binding.
Abduction is a softmax posterior over rules from the two complete context
rows; execution is the posterior-weighted binding on row 3.  Every rule
application is a circular convolution with learned operands (the circ_conv
kernel at d >= 128): 27 kernel calls per group, by a count from the code
(per attribute, 6 in abduction and 3 in execution).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.data.raven import RavenConfig
from repro_torch.nn.init import P
from repro_torch.vsa import fpe, ops as vsa


@dataclasses.dataclass(frozen=True)
class LVRFConfig:
    raven: RavenConfig = RavenConfig()
    blocks: int = 4
    d: int = 128
    n_rules: int = 8          # learned rule slots (>= true rule count)
    rule_temp: float = 0.1
    answer_temp: float = 0.05


def lvrf_spec(cfg: LVRFConfig):
    """Learned parameters: rule codebook and pair-role codes, per attribute."""
    a = cfg.raven.n_attrs
    return {
        "rules": P((a, cfg.n_rules, cfg.blocks, cfg.d),
                   (None, None, None, None), init="normal", scale=1.0 / cfg.d),
        "role1": P((a, cfg.blocks, cfg.d), (None, None, None), init="normal",
                   scale=1.0 / math.sqrt(cfg.d)),
        "role2": P((a, cfg.blocks, cfg.d), (None, None, None), init="normal",
                   scale=1.0 / math.sqrt(cfg.d)),
    }


def lvrf_codebooks(cfg: LVRFConfig, generator: torch.Generator):
    """Static FPE value codebooks, one per attribute (CPU tensors)."""
    books = []
    for n in cfg.raven.attr_sizes:
        phase = fpe.fpe_base_phase(generator, cfg.blocks, cfg.d)
        books.append(fpe.fpe_codebook(phase, 2 * n - 1, cfg.d))
    return books


def _pair_code(c1, c2, role1, role2):
    """Row context code: bind each panel code with its positional role."""
    return vsa.bind(c1, role1) + vsa.bind(c2, role2)


def _apply_rules(pair, rules):
    """pair: (N, B, d); rules: (R, B, d) -> (N, R, B, d) predicted codes."""
    return vsa.bind(pair[:, None], rules[None])


# -- pipeline stages --------------------------------------------------------
# frontend PMFs -> encode + abduce (learned-rule posterior) -> execute
# (posterior-weighted circ-conv execution + candidate match)


def encode_codes(books, cfg: LVRFConfig, pmfs) -> torch.Tensor:
    """PMF lists (per attr, (N, 8, V)) -> stacked codes (A, N, 8, B, d)."""
    return torch.stack([
        torch.einsum("npv,vbd->npbd", pmfs[ai],
                     books[ai][: cfg.raven.attr_sizes[ai]])
        for ai in range(cfg.raven.n_attrs)])


def abduce(params, cfg: LVRFConfig, codes: torch.Tensor) -> torch.Tensor:
    """Rule posteriors from the two complete rows: (A, N, 8, B, d) ->
    (A, N, R)."""
    posts = []
    for ai in range(cfg.raven.n_attrs):
        rules = params["rules"][ai]
        r1, r2 = params["role1"][ai][None], params["role2"][ai][None]
        post_logits = 0.0
        for r0 in (0, 3):
            pair = _pair_code(codes[ai][:, r0], codes[ai][:, r0 + 1], r1, r2)
            preds = _apply_rules(pair, rules)                         # (N, R, B, d)
            sims = vsa.similarity(preds, codes[ai][:, r0 + 2][:, None])  # (N, R)
            post_logits = post_logits + sims / cfg.rule_temp
        posts.append(torch.softmax(post_logits, dim=-1))
    return torch.stack(posts)


def execute(params, books, cfg: LVRFConfig, codes: torch.Tensor,
            posts: torch.Tensor, cand_pmfs) -> torch.Tensor:
    """Posterior-weighted rule execution on row 3 and candidate match ->
    answer log-probs (N, 8)."""
    total_sims = 0.0
    for ai in range(cfg.raven.n_attrs):
        rules = params["rules"][ai]
        r1, r2 = params["role1"][ai][None], params["role2"][ai][None]
        pair3 = _pair_code(codes[ai][:, 6], codes[ai][:, 7], r1, r2)
        preds3 = _apply_rules(pair3, rules)
        pred = torch.einsum("nr,nrbd->nbd", posts[ai], preds3)
        cand = torch.einsum("npv,vbd->npbd", cand_pmfs[ai],
                            books[ai][: cfg.raven.attr_sizes[ai]])
        total_sims = total_sims + vsa.similarity(pred[:, None], cand)  # (N, 8)
    return torch.log_softmax(total_sims / cfg.answer_temp, dim=-1)


def solve_from_pmfs(params, books, cfg: LVRFConfig, ctx_pmfs, cand_pmfs):
    """ctx_pmfs / cand_pmfs: lists per attr of (N, 8, V).  Returns (answer
    log-probs (N, 8), rule posteriors (A, N, R)): the stages composed."""
    codes = encode_codes(books, cfg, ctx_pmfs)
    posts = abduce(params, cfg, codes)
    return execute(params, books, cfg, codes, posts, cand_pmfs), posts


def loss_fn(params, books, cfg: LVRFConfig, ctx_pmfs, cand_pmfs,
            answers: torch.Tensor) -> torch.Tensor:
    """Answer cross-entropy.  The learned rules and roles are bound by
    circ_conv, so its backward carries their gradient at d >= 128."""
    logp, _ = solve_from_pmfs(params, books, cfg, ctx_pmfs, cand_pmfs)
    return -torch.gather(logp, 1, answers[:, None].long()).mean()


def accuracy(params, books, cfg: LVRFConfig, ctx_pmfs, cand_pmfs,
             answers: torch.Tensor) -> float:
    with torch.no_grad():
        logp, _ = solve_from_pmfs(params, books, cfg, ctx_pmfs, cand_pmfs)
    return float((logp.argmax(-1) == answers).float().mean())
