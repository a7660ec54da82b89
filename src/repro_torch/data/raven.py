"""Synthetic RAVEN / I-RAVEN / PGM-style progressive-matrix generator.

The original datasets are not redistributable, so the accuracy experiments
(paper Tab. IV) run on a procedurally generated equivalent: 3×3 panels of
rendered geometric objects whose attributes (shape type, size, color) evolve
row-wise under RPM rules {constant, progression ±1, arithmetic ±}. Eight
candidate answers include the target plus attribute-perturbed distractors —
I-RAVEN-style balanced distractors (each differs from the answer in exactly
one attribute) so shortcut solutions do not work.

Everything is numpy (host side) and deterministic in the seed.  This is the
port's own copy of ``repro.data.raven``: it must give the same problems for
the same seed (a parity test checks this), so change both or neither.
"""

from __future__ import annotations

import dataclasses

import numpy as np

RULES = ("constant", "prog_plus", "prog_minus", "arith_plus", "arith_minus")
N_RULES = len(RULES)


@dataclasses.dataclass(frozen=True)
class RavenConfig:
    image_size: int = 32
    n_types: int = 5      # shapes: triangle, square, pentagon, hexagon, circle
    n_sizes: int = 6
    n_colors: int = 8
    style: str = "raven"  # raven | iraven | pgm  (distractor / noise policy)
    noise: float = 0.02

    @property
    def attr_sizes(self) -> tuple[int, int, int]:
        return (self.n_types, self.n_sizes, self.n_colors)

    @property
    def n_attrs(self) -> int:
        return 3


def _apply_rule(rule: int, a1: int, a2: int, n: int) -> int:
    """Third value in a row under ``rule`` given the first two. Values that
    leave [0, n) are wrapped — the generator rejects wrap cases for arith."""
    if RULES[rule] == "constant":
        return a2
    if RULES[rule] == "prog_plus":
        return (a2 + 1) % n
    if RULES[rule] == "prog_minus":
        return (a2 - 1) % n
    if RULES[rule] == "arith_plus":
        return (a1 + a2) % n
    return (a1 - a2) % n


def _rule_predicts(rule: int, a1: int, a2: int) -> int:
    """Unwrapped 3rd value a rule abduction engine would predict from the
    first two (no modulo: out-of-range predictions match nothing)."""
    name = RULES[rule]
    if name == "constant":
        return a2
    if name == "prog_plus":
        return a2 + 1
    if name == "prog_minus":
        return a2 - 1
    if name == "arith_plus":
        return a1 + a2
    return a1 - a2


def _grid_ambiguous(rows: np.ndarray, rule: int, n: int) -> bool:
    """True if some other rule also explains both complete rows yet predicts
    a different 9th panel — unanswerable even for a perfect reasoner (e.g.
    (3,0,3),(1,0,1): arith± coincide when a2 == 0 but diverge on row 3).

    Checked under both unwrapped and modulo-wrapped rule semantics, so the
    grid is unambiguous whether the abduction engine treats out-of-range
    predictions as non-matches or wraps them mod n (e.g. prog_plus with
    a2 == n-1 predicting 0 only via wrap-around)."""
    predictors = (_rule_predicts,
                  lambda r, a1, a2: _apply_rule(r, a1, a2, n))
    for r in range(N_RULES):
        if r == rule:
            continue
        for predict in predictors:
            if all(predict(r, rows[i, 0], rows[i, 1]) == rows[i, 2]
                   for i in (0, 1)):
                if predict(r, rows[2, 0], rows[2, 1]) != rows[2, 2]:
                    return True
    return False


def _row_values(rng: np.random.Generator, rule: int, n: int) -> tuple[int, int, int]:
    name = RULES[rule]
    for _ in range(64):
        if name == "constant":
            a1 = int(rng.integers(n))
            row = (a1, a1, a1)
        elif name == "prog_plus":
            a1 = int(rng.integers(0, n - 2))
            row = (a1, a1 + 1, a1 + 2)
        elif name == "prog_minus":
            a1 = int(rng.integers(2, n))
            row = (a1, a1 - 1, a1 - 2)
        elif name == "arith_plus":
            a1 = int(rng.integers(0, n - 1))
            a2 = int(rng.integers(0, n - a1))
            row = (a1, a2, a1 + a2)
        else:  # arith_minus
            a1 = int(rng.integers(0, n))
            a2 = int(rng.integers(0, a1 + 1))
            row = (a1, a2, a1 - a2)
        if all(0 <= v < n for v in row):
            return row
    raise RuntimeError("rule sampling failed")


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _shape_mask(size_px: int, type_idx: int, radius: float) -> np.ndarray:
    """Rasterize shape ``type_idx`` with given radius on a size_px canvas."""
    c = (size_px - 1) / 2.0
    yy, xx = np.mgrid[0:size_px, 0:size_px]
    dy, dx = yy - c, xx - c
    r = np.hypot(dx, dy)
    if type_idx == 4:  # circle
        return r <= radius
    n_vertices = [3, 4, 5, 6][type_idx]
    theta = np.arctan2(dy, dx)
    # regular polygon: boundary radius as a function of angle
    k = np.pi / n_vertices
    offset = np.pi / 2 if n_vertices % 2 else k  # point-up orientation
    bound = radius * np.cos(k) / np.cos(((theta + offset) % (2 * k)) - k)
    return r <= bound


def render_panel(cfg: RavenConfig, attrs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """attrs: (type, size, color) -> (H, W, 1) float32 in [0, 1]."""
    s = cfg.image_size
    t, sz, col = int(attrs[0]), int(attrs[1]), int(attrs[2])
    radius = (0.18 + 0.62 * (sz + 1) / cfg.n_sizes) * (s / 2 - 1)
    intensity = 0.25 + 0.75 * (col + 1) / cfg.n_colors
    mask = _shape_mask(s, t, radius)
    img = np.zeros((s, s), np.float32)
    img[mask] = intensity
    if cfg.noise > 0:
        img = img + rng.normal(0, cfg.noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)[..., None]


# ---------------------------------------------------------------------------
# Problem generation
# ---------------------------------------------------------------------------


def generate_problem(cfg: RavenConfig, seed: int):
    """One RPM problem.

    Returns dict with:
      context_attrs (8, 3) int32, candidate_attrs (8, 3), answer int32,
      rules (3,) int32, context (8, H, W, 1), candidates (8, H, W, 1),
      panel_attrs (9, 3) — full grid incl. the true 9th panel.
    """
    rng = np.random.default_rng(seed)
    sizes = cfg.attr_sizes
    rules = np.array([rng.integers(N_RULES) for _ in range(cfg.n_attrs)], np.int32)
    grid = np.zeros((3, 3, cfg.n_attrs), np.int32)
    for ai in range(cfg.n_attrs):
        for _ in range(64):
            for row in range(3):
                grid[row, :, ai] = _row_values(rng, int(rules[ai]), sizes[ai])
            if not _grid_ambiguous(grid[:, :, ai], int(rules[ai]), sizes[ai]):
                break
    panel_attrs = grid.reshape(9, cfg.n_attrs)
    answer_attrs = panel_attrs[8]

    # I-RAVEN-style distractors: each differs in exactly one attribute
    candidates = [answer_attrs.copy()]
    seen = {tuple(answer_attrs)}
    attempts = 0
    while len(candidates) < 8 and attempts < 256:
        attempts += 1
        c = answer_attrs.copy()
        ai = int(rng.integers(cfg.n_attrs))
        if cfg.style == "pgm":  # pgm-style: perturb 1-2 attributes
            for aj in rng.choice(cfg.n_attrs, size=int(rng.integers(1, 3)),
                                 replace=False):
                c[aj] = int(rng.integers(sizes[aj]))
        else:
            delta = int(rng.integers(1, sizes[ai]))
            c[ai] = (c[ai] + delta) % sizes[ai]
        if tuple(c) not in seen:
            seen.add(tuple(c))
            candidates.append(c)
    while len(candidates) < 8:  # degenerate fallback
        c = np.array([rng.integers(s) for s in sizes], np.int32)
        if tuple(c) not in seen:
            seen.add(tuple(c))
            candidates.append(c)
    candidates = np.stack(candidates)
    perm = rng.permutation(8)
    candidates = candidates[perm]
    answer = int(np.where(perm == 0)[0][0])

    context_imgs = np.stack([render_panel(cfg, a, rng) for a in panel_attrs[:8]])
    cand_imgs = np.stack([render_panel(cfg, a, rng) for a in candidates])
    return {
        "context_attrs": panel_attrs[:8],
        "panel_attrs": panel_attrs,
        "candidate_attrs": candidates,
        "answer": answer,
        "rules": rules,
        "context": context_imgs,
        "candidates": cand_imgs,
    }


def generate_batch(cfg: RavenConfig, seed: int, n: int):
    """Batched problems, stacked along axis 0 (all-numpy, loader-friendly)."""
    probs = [generate_problem(cfg, seed * 100003 + i) for i in range(n)]
    return {k: np.stack([p[k] for p in probs]) for k in probs[0]}


def panel_dataset(cfg: RavenConfig, seed: int, n_problems: int):
    """Flattened (image, attrs) supervision set for the CNN frontend."""
    batch = generate_batch(cfg, seed, n_problems)
    imgs = np.concatenate(
        [batch["context"].reshape(-1, cfg.image_size, cfg.image_size, 1),
         batch["candidates"].reshape(-1, cfg.image_size, cfg.image_size, 1)])
    attrs = np.concatenate(
        [batch["context_attrs"].reshape(-1, cfg.n_attrs),
         batch["candidate_attrs"].reshape(-1, cfg.n_attrs)])
    return imgs.astype(np.float32), attrs.astype(np.int32)
