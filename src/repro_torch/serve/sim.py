"""Deterministic simulated engine + bursty traces for control-plane soak.

The port's copy of ``repro.serve.sim`` (numpy and plain Python; it runs
no kernel).

Soaking the overload control plane needs *hours* of bursty traffic and
100k+ requests — far beyond what the real jitted engines can serve in a
CI budget, and irrelevant to what's under test (the admission policy,
the feedback controller, the shedding accounting).  :class:`SimEngine`
is an :class:`~repro_torch.serve.runtime.EngineProtocol` implementation whose
service is a closed-form queueing model on the *injected virtual
clock*: one serial server, per-group service time ``base_s +
per_item_s * bucket``.  Because it never reads real time (no ``time``
import),
an entire multi-hour soak runs in seconds of host time and two runs of
the same trace produce bit-identical reports.

:func:`bursty_times` generates the production-shaped load: a diurnal
sinusoid over a base Poisson rate with superimposed burst windows —
the traffic NSFlow-style real-time serving has to survive.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.serve import runtime as rt
from repro_torch.serve.runtime import GroupRecord


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """Minimal protocol request envelope for the simulated engine."""

    uid: int
    priority: str = "standard"
    work: int = 1


@dataclasses.dataclass(frozen=True)
class SimResult:
    uid: int


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Closed-form per-group service time: ``base_s`` dispatch overhead
    plus ``per_item_s`` per padded row of the compiled bucket."""

    base_s: float = 0.004
    per_item_s: float = 0.001

    def group_s(self, bucket: int) -> float:
        return self.base_s + self.per_item_s * bucket

    def capacity_rps(self, bucket: int) -> float:
        """Advertised steady-state capacity serving full groups at
        ``bucket``: requests per second the serial server sustains."""
        return bucket / self.group_s(bucket)


class SimEngine:
    """Protocol engine with deterministic virtual-time service.

    ``clock``/``sleep`` are *required*: a simulated engine on the host
    clock is meaningless, and the front-door drives both (it points
    ``eng.clock`` at its own clock for the serve and its sleeps advance
    the shared virtual time).  Completion is single-server FIFO: a
    group dispatched at ``t`` finishes at ``max(t, server_free) +
    group_s(bucket)``.
    """

    def __init__(self, clock: Callable[[], float],
                 sleep: Callable[[float], None],
                 cap: int = 8, buckets: Sequence[int] | None = None,
                 service: ServiceModel | None = None,
                 max_inflight: int = 4, variant: str = "sim"):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        self.clock = clock
        self._sleep = sleep
        self.cap = cap
        self.buckets = tuple(sorted(buckets)) if buckets else \
            _pow2_chain(cap)
        if self.buckets[-1] != cap:
            raise ValueError(f"largest bucket {self.buckets[-1]} must "
                             f"equal cap {cap}")
        self.service = service or ServiceModel()
        self.max_inflight = max_inflight
        self.variant = variant
        self.stats = rt.fresh_split_stats()
        self.runs: list[dict] = []
        self._inflight: list[tuple[GroupRecord, list[SimRequest], float]] \
            = []
        # results collected by the window trim inside submit, buffered
        # until the next drain call (mirrors ReasonEngine's ready buffer)
        self._done: dict[int, SimResult] = {}
        self._free_t: float | None = None
        self._index = 0
        self._warm: set[int] = set()

    @property
    def admission_cap(self) -> int:
        return self.cap

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def accepting(self) -> bool:
        """True while ``submit`` would dispatch without blocking on the
        in-flight window — the backpressure signal the front-door's
        overload path reads (see ``FrontDoor._accepting``)."""
        return len(self._inflight) < self.max_inflight

    def _bucket_for(self, size: int) -> int:
        for b in self.buckets:
            if b >= size:
                return b
        return self.buckets[-1]

    def submit(self, group: Sequence[SimRequest]) -> GroupRecord:
        if not group:
            raise ValueError("empty admission group")
        if len(group) > self.cap:
            raise ValueError(f"group of {len(group)} exceeds "
                             f"admission cap {self.cap}")
        bucket = self._bucket_for(len(group))
        rec = GroupRecord(uids=tuple(r.uid for r in group),
                          index=self._index, variant=self.variant,
                          bucket=bucket, size=len(group))
        self._index += 1
        rec.dispatch_t = self.clock()
        # bounded in-flight window: block (advancing virtual time) until
        # there is room — mirrors the staged pipeline's depth-k window
        while len(self._inflight) >= self.max_inflight:
            self._drain_one()
        start = rec.dispatch_t if self._free_t is None else \
            max(rec.dispatch_t, self._free_t)
        done_at = start + self.service.group_s(bucket)
        self._free_t = done_at
        self._inflight.append((rec, list(group), done_at))
        return rec

    def _drain_one(self) -> None:
        rec, group, done_at = self._inflight.pop(0)
        dt = done_at - self.clock()
        if dt > 0:
            self._sleep(dt)
        self._collect(rec, group, done_at)

    def _collect(self, rec: GroupRecord, group: list[SimRequest],
                 done_at: float) -> None:
        rec.done_t = max(done_at, self.clock())
        warm = rec.bucket in self._warm
        self._warm.add(rec.bucket)
        split = self.stats["measured" if warm else "warmup"]
        split["requests"] += rec.size
        split["work"] += sum(r.work for r in group)
        split["wall_time_s"] += rec.done_t - rec.dispatch_t
        self.runs.append({"index": rec.index, "bucket": rec.bucket,
                          "size": rec.size, "warmup": not warm})
        self._done.update((r.uid, SimResult(uid=r.uid)) for r in group)

    def drain_ready(self) -> dict[int, SimResult]:
        """Collect every in-flight group whose completion time has
        passed on the (possibly virtual) clock.  Non-blocking."""
        now = self.clock()
        while self._inflight and self._inflight[0][2] <= now:
            self._collect(*self._inflight.pop(0))
        out, self._done = self._done, {}
        return out

    def drain_all(self) -> dict[int, SimResult]:
        while self._inflight:
            self._drain_one()
        out, self._done = self._done, {}
        return out


def _pow2_chain(cap: int) -> tuple[int, ...]:
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    return tuple(out) + (cap,)


# ---------------------------------------------------------------------------
# bursty traffic
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Burst:
    """One overload window: offered rate is multiplied by ``mult`` for
    ``dur_s`` seconds starting at ``t0_s``."""

    t0_s: float
    dur_s: float
    mult: float


def diurnal_rate(t: float, base_rps: float, amp: float = 0.4,
                 period_s: float = 3600.0,
                 bursts: Sequence[Burst] = ()) -> float:
    """Offered rate at time ``t``: diurnal sinusoid over ``base_rps``
    with burst windows multiplied on top."""
    r = base_rps * (1.0 + amp * np.sin(2.0 * np.pi * t / period_s))
    for b in bursts:
        if b.t0_s <= t < b.t0_s + b.dur_s:
            r *= b.mult
    return float(max(r, 1e-9))


def bursty_times(n: int, base_rps: float, *, amp: float = 0.4,
                 period_s: float = 3600.0, bursts: Sequence[Burst] = (),
                 seed: int = 0, start_s: float = 0.0) -> list[float]:
    """``n`` arrival times from an inhomogeneous Poisson process whose
    rate follows :func:`diurnal_rate`.  Deterministic in ``seed``."""
    if base_rps <= 0:
        raise ValueError(f"base_rps must be > 0, got {base_rps}")
    rng = np.random.default_rng(seed)
    t = start_s
    out = []
    for _ in range(n):
        t += float(rng.exponential(
            1.0 / diurnal_rate(t, base_rps, amp, period_s, bursts)))
        out.append(t)
    return out


def sim_requests(n: int, mix: dict[str, float] | None = None,
                 seed: int = 0, uid0: int = 0) -> list[SimRequest]:
    """``n`` :class:`SimRequest` envelopes with priorities drawn from
    ``mix`` (class -> weight; default all ``standard``).  Deterministic
    in ``seed``."""
    if not mix:
        return [SimRequest(uid=uid0 + i) for i in range(n)]
    from repro_torch.serve.slo import validate_priority

    classes = [validate_priority(c) for c in mix]
    w = np.asarray([float(mix[c]) for c in classes], dtype=float)
    if (w < 0).any() or not w.sum():
        raise ValueError(f"priority mix weights must be >= 0 and sum > 0: "
                         f"{mix}")
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(classes), size=n, p=w / w.sum())
    return [SimRequest(uid=uid0 + i, priority=classes[int(k)])
            for i, k in enumerate(picks)]
