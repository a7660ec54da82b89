"""Per-traffic-class SLO targets and windowed online attainment.

The port's copy of ``repro.serve.slo`` (numpy only).  ``DEFAULT_PRIORITY``
lives here alone; ``serve.runtime`` and ``serve.reason`` read it from here.

The serving stack advertises *real-time* NSAI: the claim only means
something as a service level objective — "p99 arrival→done latency for
interactive traffic stays under X ms at the advertised capacity".  This
module holds the vocabulary the overload control plane
(:mod:`repro_torch.serve.control`) speaks:

- **priority classes** (:data:`PRIORITIES`): every request envelope
  carries one of a small ranked set of traffic classes.  Rank order is
  the shedding order — under overload the front-door sheds
  lowest-priority-first, so ``interactive`` traffic keeps its SLO while
  ``batch`` absorbs the rejects.
- **targets** (:class:`SLOTarget`): a per-class total-latency p99 bound
  plus the attainment fraction that must meet it.
- **online estimation** (:class:`SLOEstimator`): a windowed per
  (model, class) p99 estimate the feedback controller reads each tick.
  Pure data structure — observations carry their own timestamps, no
  clock is read here.
- **report-side attainment** (:func:`attainment`): exact per-class
  attainment over a finished :class:`~repro_torch.serve.frontdoor.
  FrontDoorReport`'s latencies, for benches and CI gates.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Mapping

import numpy as np

# Ranked traffic classes, highest priority first.  The index in this
# tuple is the shed rank: under overload the control plane sheds from
# the *end* of this tuple first.
PRIORITIES: tuple[str, ...] = ("interactive", "standard", "batch")
PRIORITY_RANK: dict[str, int] = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "standard"


def validate_priority(name: str) -> str:
    """Return ``name`` if it is a known priority class, else raise a
    named ValueError listing the valid classes."""
    if name not in PRIORITY_RANK:
        raise ValueError(f"unknown priority class {name!r} "
                         f"(known: {', '.join(PRIORITIES)})")
    return name


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One traffic class's objective: windowed/report p99 of total
    (arrival→done) latency must stay ≤ ``total_p99_ms``, and at least
    ``attainment`` of requests must individually meet it."""

    total_p99_ms: float
    attainment: float = 0.99

    def __post_init__(self):
        if self.total_p99_ms <= 0:
            raise ValueError(f"total_p99_ms must be > 0, "
                             f"got {self.total_p99_ms}")
        if not 0.0 < self.attainment <= 1.0:
            raise ValueError(f"attainment must be in (0, 1], "
                             f"got {self.attainment}")

    def met_by(self, total_s: float) -> bool:
        return total_s * 1e3 <= self.total_p99_ms


def slo_targets(spec: float | Mapping[str, float] | None,
                ) -> dict[str, SLOTarget]:
    """Build per-class targets from a scalar or per-class ms spec.

    A scalar ``x`` is the *interactive* p99 target; ``standard`` gets a
    conventional 4x relaxation and ``batch`` runs best-effort (no
    target).  A mapping pins classes explicitly (unknown class names
    raise); ``None`` means no objectives at all."""
    if spec is None:
        return {}
    if isinstance(spec, Mapping):
        return {validate_priority(k): SLOTarget(total_p99_ms=float(v))
                for k, v in spec.items()}
    x = float(spec)
    return {"interactive": SLOTarget(total_p99_ms=x),
            "standard": SLOTarget(total_p99_ms=4.0 * x)}


class SLOEstimator:
    """Windowed per (model, priority) total-latency estimator.

    ``observe`` appends one completed request; ``p99_ms`` reads the
    current window.  The window is a fixed-size deque (last ``window``
    completions), so the estimate tracks the *recent* regime — exactly
    what a feedback controller wants under bursty load, where a
    lifetime percentile would average the burst away."""

    def __init__(self, targets: Mapping[str, SLOTarget] | None = None,
                 window: int = 128):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.targets = dict(targets or {})
        self.window = window
        self._obs: dict[tuple[str, str], deque] = {}

    def observe(self, model: str, priority: str, total_s: float,
                now: float) -> None:
        key = (model, priority)
        dq = self._obs.get(key)
        if dq is None:
            dq = self._obs[key] = deque(maxlen=self.window)
        dq.append((now, total_s))

    def count(self, model: str, priority: str | None = None) -> int:
        return sum(len(dq) for (m, p), dq in self._obs.items()
                   if m == model and (priority is None or p == priority))

    def p99_ms(self, model: str, priority: str | None = None) -> float:
        vals = [s for (m, p), dq in self._obs.items()
                if m == model and (priority is None or p == priority)
                for _, s in dq]
        if not vals:
            return float("nan")
        return float(np.percentile(vals, 99)) * 1e3

    def snapshot(self, model: str) -> dict[str, dict]:
        """Per-priority window state the controller reads each tick:
        ``{priority: {n, p99_ms, target_ms, ok}}`` (``target_ms``/``ok``
        are None for classes without an objective)."""
        out: dict[str, dict] = {}
        for p in PRIORITIES:
            n = self.count(model, p)
            if not n and p not in self.targets:
                continue
            p99 = self.p99_ms(model, p)
            tgt = self.targets.get(p)
            out[p] = {"n": n, "p99_ms": p99,
                      "target_ms": tgt.total_p99_ms if tgt else None,
                      "ok": (None if tgt is None or not n
                             else bool(p99 <= tgt.total_p99_ms))}
        return out


def attainment(latencies: Iterable, targets: Mapping[str, SLOTarget],
               model: str | None = None) -> dict[str, dict]:
    """Exact per-class SLO attainment over finished request latencies.

    ``latencies`` is any iterable of objects with ``model``,
    ``priority`` and ``total_s`` (e.g. :class:`~repro_torch.serve.frontdoor.
    RequestLatency`).  Returns ``{priority: {n, met, attainment,
    target_ms, ok}}`` for every class with a target or traffic; ``ok``
    is None for classes without an objective."""
    counts: dict[str, list[int]] = {}
    for lat in latencies:
        if model is not None and lat.model != model:
            continue
        prio = getattr(lat, "priority", DEFAULT_PRIORITY)
        row = counts.setdefault(prio, [0, 0])
        row[0] += 1
        tgt = targets.get(prio)
        if tgt is None or tgt.met_by(lat.total_s):
            row[1] += 1
    out: dict[str, dict] = {}
    for prio in PRIORITIES:
        if prio not in counts and prio not in targets:
            continue
        n, met = counts.get(prio, [0, 0])
        tgt = targets.get(prio)
        frac = met / n if n else float("nan")
        out[prio] = {
            "n": n, "met": met, "attainment": frac,
            "target_ms": tgt.total_p99_ms if tgt else None,
            "ok": (None if tgt is None
                   else bool(n and frac >= tgt.attainment)),
        }
    return out
