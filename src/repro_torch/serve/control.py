"""Overload control plane: bounded priority queues + SLO feedback.

The port's copy of ``repro.serve.control`` (plain Python).

`deploy()` derives the front-door's admission parameters (deadline,
bucket cap, in-flight depth) from the DSE once — the right *initial*
operating point, but production traffic is bursty and diurnal, and a
static point either wastes capacity at 3am or melts at the noon burst.
This module closes the loop:

- :class:`ClassQueues` — per-model pending queues, one FIFO per
  priority class (:data:`~repro_torch.serve.slo.PRIORITIES`), with a total
  depth bound and **reject-with-backpressure shedding**: when the bound
  is hit the queue either evicts the newest request of the lowest
  priority class (``lowest-priority`` policy — an interactive arrival
  pushes out queued batch work) or rejects the arrival itself
  (``tail-drop``).  Every shed is a first-class :class:`ShedRecord`,
  never a silent drop.
- :class:`OverloadController` — an AIMD-style feedback loop over the
  front-door knobs, ticked on the serving clock: each ``tick_s`` it
  reads the windowed per-class p99 (:class:`~repro_torch.serve.slo.
  SLOEstimator`) against the targets and adapts the per-model admission
  deadline and bucket cap.  SLO violated → cut the deadline
  (multiplicative decrease) and, if the queue shows sustained backlog,
  step the bucket cap *up* (amortize dispatch overhead: throughput
  mode) — otherwise step it *down* (stop waiting for stragglers:
  latency mode).  Healthy with headroom → relax the deadline back
  (multiplicative increase) and drift the cap toward the DSE point.

Everything here is pure policy over explicit ``now`` timestamps — this
module never reads a clock (no ``time`` import), so every decision is deterministic under the virtual
clock and the soak bench's two-run bit-identical gate holds.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Mapping

from repro_torch.serve.slo import (DEFAULT_PRIORITY, PRIORITIES,
                                   PRIORITY_RANK, SLOEstimator, SLOTarget,
                                   validate_priority)

__all__ = [
    "SHED_POLICIES", "ShedRecord", "ClassQueues", "ControlConfig",
    "ControlDecision", "OverloadController", "validate_shed_policy",
    "DEFAULT_PRIORITY",
]

# lowest-priority: a full queue evicts the newest request of the lowest
#   priority class strictly below the arrival (push-out); arrivals at
#   the bottom class shed themselves.
# tail-drop: a full queue always sheds the arriving request.
SHED_POLICIES: tuple[str, ...] = ("lowest-priority", "tail-drop")


def validate_shed_policy(name: str) -> str:
    if name not in SHED_POLICIES:
        raise ValueError(f"unknown shed policy {name!r} "
                         f"(known: {', '.join(SHED_POLICIES)})")
    return name


@dataclasses.dataclass(frozen=True)
class ShedRecord:
    """One rejected request — the backpressure signal, fully accounted.

    ``reason`` is ``queue-full`` (the arrival itself was rejected) or
    ``pushout`` (a queued lower-priority request was evicted to admit a
    higher-priority arrival).  ``arrival_s``/``shed_s`` are seconds on
    the serving clock origin."""

    uid: int
    model: str
    priority: str
    arrival_s: float
    shed_s: float
    reason: str                   # queue-full | pushout


class ClassQueues:
    """Bounded per-priority pending queues for one model.

    ``depth`` bounds the *total* queued requests across classes
    (``None`` = unbounded, the legacy front-door behavior).  ``offer``
    admits or sheds per the policy and returns the :class:`ShedRecord`
    if anything was shed; ``pop`` drains up to ``k`` requests in
    priority order (then FIFO within a class).  A high-water mark
    (``depth_max``) proves boundedness in the soak gate."""

    def __init__(self, depth: int | None = None,
                 policy: str = "lowest-priority"):
        if depth is not None and depth < 1:
            raise ValueError(f"queue depth bound must be >= 1, got {depth}")
        self.depth = depth
        self.policy = validate_shed_policy(policy)
        self._queues: dict[str, deque] = {p: deque() for p in PRIORITIES}
        self.depth_max = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def counts(self) -> dict[str, int]:
        return {p: len(q) for p, q in self._queues.items() if q}

    @property
    def oldest_t(self) -> float | None:
        heads = [q[0].t for q in self._queues.values() if q]
        return min(heads) if heads else None

    def _evict_for(self, rank: int) -> tuple[Any, str] | None:
        """Newest queued item of the lowest class strictly below
        ``rank``, removed (with its class) — None if nothing outranked."""
        for p in reversed(PRIORITIES):
            if PRIORITY_RANK[p] <= rank:
                return None
            q = self._queues[p]
            if q:
                return q.pop(), p
        return None

    def offer(self, item: Any, priority: str, now: float,
              ) -> ShedRecord | None:
        """Enqueue ``item`` (an arrival with ``.t``/``.request.uid``)
        under ``priority``; returns the shed record if the bound forced
        a rejection (the arrival itself, or a lower-priority victim the
        arrival pushed out)."""
        prio = validate_priority(priority)
        shed = None
        if self.depth is not None and len(self) >= self.depth:
            evicted = (self._evict_for(PRIORITY_RANK[prio])
                       if self.policy == "lowest-priority" else None)
            if evicted is None:
                return ShedRecord(
                    uid=item.request.uid, model=item.model, priority=prio,
                    arrival_s=item.t, shed_s=now, reason="queue-full")
            victim, vclass = evicted
            shed = ShedRecord(
                uid=victim.request.uid, model=victim.model,
                priority=vclass, arrival_s=victim.t,
                shed_s=now, reason="pushout")
        self._queues[prio].append(item)
        self.depth_max = max(self.depth_max, len(self))
        return shed

    def pop(self, k: int) -> list[Any]:
        """Drain up to ``k`` items, priority order then FIFO."""
        out: list[Any] = []
        for p in PRIORITIES:
            q = self._queues[p]
            while q and len(out) < k:
                out.append(q.popleft())
        return out


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Feedback-loop tuning.  Defaults are deliberately gentle: halve
    the deadline on violation, relax it back 1.25x per healthy tick,
    only call the window healthy below 70% of target."""

    tick_s: float = 0.05          # controller period on the serving clock
    window: int = 128             # SLOEstimator window per (model, class)
    min_obs: int = 8              # ignore classes with fewer completions
    headroom: float = 0.7         # p99 <= headroom*target counts healthy
    decrease: float = 0.5         # deadline multiplier on SLO violation
    increase: float = 1.25        # deadline multiplier when healthy
    min_deadline_s: float = 1e-3
    max_deadline_s: float = 0.2
    queue_depth: int | None = None   # per-model pending bound (None = off)
    shed_policy: str = "lowest-priority"
    adapt: bool = True            # False = observe/shed only, fixed knobs

    def __post_init__(self):
        if self.tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {self.tick_s}")
        if not 0.0 < self.decrease < 1.0:
            raise ValueError(f"decrease must be in (0, 1), "
                             f"got {self.decrease}")
        if self.increase <= 1.0:
            raise ValueError(f"increase must be > 1, got {self.increase}")
        if not 0.0 < self.headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], "
                             f"got {self.headroom}")
        if not 0 < self.min_deadline_s <= self.max_deadline_s:
            raise ValueError(
                f"need 0 < min_deadline_s <= max_deadline_s, got "
                f"{self.min_deadline_s}..{self.max_deadline_s}")
        if self.queue_depth is not None and self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1 or None, "
                             f"got {self.queue_depth}")
        validate_shed_policy(self.shed_policy)


@dataclasses.dataclass(frozen=True)
class ControlDecision:
    """One non-hold controller action, for the report/soak artifact."""

    t: float
    model: str
    action: str                   # tighten | throughput | relax
    deadline_s: float             # new operating point after the action
    cap: int
    p99_ms: float                 # pooled windowed p99 at decision time
    queue_depth: int
    inflight: int


class _Operating:
    """Mutable per-model operating point (not a dataclass: the analyzer
    treats frozen config types as immutable policy, this is state)."""

    __slots__ = ("deadline_s", "cap", "buckets", "deadline0", "cap0")

    def __init__(self, deadline_s: float, cap: int,
                 buckets: tuple[int, ...]):
        self.deadline_s = deadline_s
        self.cap = cap
        self.buckets = buckets
        self.deadline0 = deadline_s
        self.cap0 = cap


class OverloadController:
    """SLO feedback over the front-door's per-model admission knobs.

    Bind each model to its DSE-derived initial operating point
    (``bind``), feed completed-request latencies (``observe``) and tick
    on the serving clock (``maybe_tick``).  ``deadline_s(model)`` /
    ``cap(model)`` are the live knobs the front-door reads each loop.
    """

    def __init__(self, targets: Mapping[str, SLOTarget] | None = None,
                 cfg: ControlConfig | None = None):
        self.cfg = cfg or ControlConfig()
        self.targets = dict(targets or {})
        self.estimator = SLOEstimator(self.targets, window=self.cfg.window)
        self.decisions: list[ControlDecision] = []
        self.ticks = 0
        self._op: dict[str, _Operating] = {}
        self._next_tick: float | None = None

    # -- operating points ---------------------------------------------

    def bind(self, model: str, deadline_s: float, cap: int,
             buckets: tuple[int, ...] | None = None) -> None:
        """Set ``model``'s initial operating point (idempotent: a model
        already bound keeps its live state)."""
        if model in self._op:
            return
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        chain = tuple(sorted(set(buckets or ()) | {cap}))
        chain = tuple(b for b in chain if b <= cap) or (cap,)
        dl = min(max(deadline_s, self.cfg.min_deadline_s),
                 self.cfg.max_deadline_s)
        self._op[model] = _Operating(dl, cap, chain)

    def bound(self) -> set[str]:
        return set(self._op)

    def deadline_s(self, model: str) -> float:
        return self._op[model].deadline_s

    def cap(self, model: str) -> int:
        return self._op[model].cap

    def queues(self, model: str) -> ClassQueues:
        """A bounded pending-queue set per this controller's policy."""
        return ClassQueues(depth=self.cfg.queue_depth,
                           policy=self.cfg.shed_policy)

    # -- feedback ------------------------------------------------------

    def observe(self, model: str, priority: str, total_s: float,
                now: float) -> None:
        self.estimator.observe(model, priority, total_s, now)

    def maybe_tick(self, now: float, obs: Mapping[str, Mapping[str, Any]],
                   ) -> list[ControlDecision]:
        """Run one control tick if ``tick_s`` elapsed since the last.
        ``obs`` maps model -> {queue_depth, inflight} (pool-merged, see
        :func:`repro_torch.serve.runtime.engine_observation`)."""
        if self._next_tick is None:
            self._next_tick = now + self.cfg.tick_s
            return []
        if now < self._next_tick:
            return []
        # fixed cadence (not now + tick_s): ticks stay phase-locked to
        # the serving clock regardless of loop jitter, which keeps the
        # decision trace bit-identical across runs
        while self._next_tick <= now:
            self._next_tick += self.cfg.tick_s
        return self.tick(now, obs)

    def tick(self, now: float, obs: Mapping[str, Mapping[str, Any]],
             ) -> list[ControlDecision]:
        self.ticks += 1
        out: list[ControlDecision] = []
        if not self.cfg.adapt or not self.targets:
            return out
        for model in sorted(self._op):
            op = self._op[model]
            snap = self.estimator.snapshot(model)
            judged = [(row["p99_ms"], row["target_ms"])
                      for row in snap.values()
                      if row["target_ms"] is not None
                      and row["n"] >= self.cfg.min_obs]
            if not judged:
                continue
            violated = any(p99 > tgt for p99, tgt in judged)
            healthy = all(p99 <= self.cfg.headroom * tgt
                          for p99, tgt in judged)
            o = obs.get(model, {})
            qd = int(o.get("queue_depth", 0))
            infl = int(o.get("inflight", 0))
            action = None
            if violated:
                op.deadline_s = max(self.cfg.min_deadline_s,
                                    op.deadline_s * self.cfg.decrease)
                if qd >= op.cap:
                    # sustained backlog: the door is throughput-bound —
                    # bigger groups amortize dispatch overhead
                    op.cap = self._step(op, +1)
                    action = "throughput"
                else:
                    # shallow queue: latency-bound — stop holding groups
                    # open for stragglers
                    op.cap = self._step(op, -1)
                    action = "tighten"
            elif healthy:
                relaxed = min(self.cfg.max_deadline_s,
                              op.deadline_s * self.cfg.increase)
                drifted = (self._step(op, +1) if op.cap < op.cap0
                           else self._step(op, -1) if op.cap > op.cap0
                           else op.cap)
                if relaxed != op.deadline_s or drifted != op.cap:
                    op.deadline_s, op.cap = relaxed, drifted
                    action = "relax"
            if action is not None:
                out.append(ControlDecision(
                    t=now, model=model, action=action,
                    deadline_s=op.deadline_s, cap=op.cap,
                    p99_ms=self.estimator.p99_ms(model),
                    queue_depth=qd, inflight=infl))
        self.decisions.extend(out)
        return out

    @staticmethod
    def _step(op: _Operating, direction: int) -> int:
        chain = op.buckets
        i = chain.index(op.cap) if op.cap in chain else 0
        return chain[min(max(i + direction, 0), len(chain) - 1)]
