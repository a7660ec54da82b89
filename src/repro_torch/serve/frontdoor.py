"""Online admission for mixed serving traffic: the deadline-batched front-door.

The port's copy of ``repro.serve.frontdoor`` (numpy and plain Python).  It
drives engines only through the ``EngineProtocol`` surface, so it is the
reference's policy unchanged, the per-replica breakdown of a
``ReplicaPool`` included.  It serves the four reasoners and the LM
slot-pool ``Engine`` side by side, with the reference's accounting:
tokens/s for LM models, problems/s for NSAI models.

NSFlow's pitch is *real-time* NSAI acceleration, but an engine that only
accepts pre-collected request lists (``ReasonEngine.run`` / ``Engine.run``)
makes a trickle of traffic pay full-batch latency and a burst pay padding
waste.  This module is the front-door that turns **arrival-timed** online
traffic into admission groups any :class:`~repro_torch.serve.runtime.
EngineProtocol` engine can serve well:

- **batch-full-or-deadline admission**: a group closes the moment it
  reaches the admission cap (``full``) or ``deadline_s`` after its first
  request arrived (``deadline``) — bursts fill batches, trickles wait at
  most one deadline.  When the arrival stream ends, open groups close
  immediately (``flush``).
- **shape bucketing**: a closed partial group is padded by the NSAI
  engine to the smallest *covering bucket* of the schedule's compiled
  batch sizes (``StagedSchedule.batch_buckets``, e.g. 2/4/8) instead of
  the max — see ``pow2_buckets``.  The LM engine's bucket is its slot
  pool.
- **multiplexing over the protocol**: one front-door serves any mix of
  engines — NSAI staged pipelines (nvsa, mimonet, ...) *and* slot-pool LM
  engines (llama3.2-3b, granite-moe-1b-a400m, ...) — because it only
  drives the unified ``submit`` / ``drain_ready`` / ``drain_all``
  surface.  Each arrival names its model, groups are formed per model,
  and every engine keeps its own in-flight window on the shared host.
- **per-request latency accounting**: arrival -> dispatch (queueing) and
  dispatch -> answers-on-host (service) per request, with p50/p95/p99
  summaries (:meth:`FrontDoorReport.percentiles`) and per-class
  throughput in each class's own unit (tokens/s for LM rows, problems/s
  for NSAI rows — see :meth:`FrontDoorReport.work_per_s`).

The serve loop is single-threaded and event-driven: it admits due
arrivals, closes groups by the policy, dispatches them asynchronously
through ``submit`` (host staging overlaps device compute), and while
waiting for traffic calls ``drain_ready`` on every engine — which both
collects groups whose device buffers have already materialized (so
``done`` timestamps are not deferred to the next dispatch) *and* lets
engines that need host pumping (the LM slot pool) advance one decode
block per call.  ``clock``/``sleep`` are injectable — tests drive the
policy deterministically on a virtual clock; benchmarks use real time.

Traffic models: :func:`poisson_arrivals` (open-loop Poisson at a given
offered rate), :func:`trace_arrivals` (replay explicit timestamps), and
:func:`merge_arrivals` to interleave per-model streams into one time-
ordered front-door feed (stable on ties: equal timestamps keep each
stream's FIFO order, earlier-argument streams first).
:func:`with_priorities` stamps a priority-class mix onto a stream.

**Overload control** (optional): pass an :class:`~repro_torch.serve.control.
OverloadController` and the front-door (a) keeps its pending queues in
bounded per-priority-class :class:`~repro_torch.serve.control.ClassQueues` —
arrivals beyond the depth bound are *shed* (reject-with-backpressure,
lowest-priority-first) and surfaced in the report as first-class
:class:`~repro_torch.serve.control.ShedRecord` outcomes, and (b) feeds every
completion back to the controller's windowed per-class p99 estimator
and lets it adapt the per-model deadline and bucket cap each control
tick.  Without a controller the behavior is the legacy unbounded FIFO.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np

from repro_torch.serve import runtime as rt
from repro_torch.serve import slo as slo_mod
from repro_torch.serve.control import (ClassQueues, OverloadController,
                                       ShedRecord)
from repro_torch.serve.runtime import EngineProtocol, GroupRecord
from repro_torch.serve.slo import DEFAULT_PRIORITY, SLOTarget


# ---------------------------------------------------------------------------
# traffic models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArrivalRequest:
    """One request with its offered arrival time (seconds, stream origin).

    ``request`` is any protocol request envelope (``serve.engine.Request``,
    ``serve.reason.ReasonRequest`` — anything the named model's engine
    accepts).  ``priority`` names the traffic class for overload control
    (one of :data:`~repro_torch.serve.slo.PRIORITIES`); ``None`` defers to the
    request envelope's own ``priority`` attribute, defaulting to
    ``standard``."""

    t: float
    model: str
    request: Any
    priority: str | None = None


def poisson_arrivals(model: str, requests: Iterable[Any],
                     rate_rps: float, seed: int = 0, start_s: float = 0.0
                     ) -> Iterator[ArrivalRequest]:
    """Open-loop Poisson traffic: exponential inter-arrival gaps at
    ``rate_rps`` requests/s.  Lazy — each request is pulled (rendered)
    only when its arrival is generated, so preprocessing runs inside the
    serving loop like real ingest."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    t = start_s
    for req in requests:
        t += float(rng.exponential(1.0 / rate_rps))
        yield ArrivalRequest(t=t, model=model, request=req)


def trace_arrivals(model: str, times_s: Sequence[float],
                   requests: Iterable[Any]
                   ) -> Iterator[ArrivalRequest]:
    """Replay an explicit arrival-time trace (must be nondecreasing).
    Times and requests must pair up exactly — a length mismatch in either
    direction raises instead of silently dropping traffic."""
    last = -float("inf")
    it = iter(requests)
    for t in times_s:
        if t < last:
            raise ValueError(f"trace times must be nondecreasing "
                             f"({t} after {last})")
        last = t
        try:
            req = next(it)
        except StopIteration:
            raise ValueError("trace has more times than requests") from None
        yield ArrivalRequest(t=float(t), model=model, request=req)
    if next(it, None) is not None:
        raise ValueError("trace has more requests than times "
                         "(the extras would silently never be served)")


def merge_arrivals(*streams: Iterable[ArrivalRequest]
                   ) -> Iterator[ArrivalRequest]:
    """Interleave time-ordered per-model streams into one ordered feed.

    ``heapq.merge`` is stable: arrivals with equal timestamps come out in
    argument order, and each stream's own FIFO order is always preserved —
    simultaneous cross-model arrivals therefore admit deterministically
    (regression-tested; the admission policy depends on it).
    """
    return heapq.merge(*streams, key=lambda a: a.t)


def with_priorities(stream: Iterable[ArrivalRequest],
                    mix: str | Mapping[str, float],
                    seed: int = 0) -> Iterator[ArrivalRequest]:
    """Stamp priority classes onto an arrival stream.

    ``mix`` is either one class name (every arrival gets it) or a
    ``{class: weight}`` mapping sampled per arrival with a seeded rng —
    deterministic, so traced replays shed identically.  Unknown class
    names raise the named :func:`~repro_torch.serve.slo.validate_priority`
    error."""
    if isinstance(mix, str):
        prio = slo_mod.validate_priority(mix)
        for a in stream:
            yield dataclasses.replace(a, priority=prio)
        return
    classes = [slo_mod.validate_priority(c) for c in mix]
    w = np.asarray([float(mix[c]) for c in classes], dtype=float)
    if (w < 0).any() or not w.sum():
        raise ValueError(f"priority mix weights must be >= 0 and "
                         f"sum > 0: {dict(mix)}")
    rng = np.random.default_rng(seed)
    p = w / w.sum()
    for a in stream:
        yield dataclasses.replace(
            a, priority=classes[int(rng.choice(len(classes), p=p))])


def pow2_buckets(max_batch: int, min_bucket: int = 2) -> tuple[int, ...]:
    """Power-of-two batch buckets up to (and always including) max_batch:
    8 -> (2, 4, 8); 6 -> (2, 4, 6).

    ``min_bucket`` defaults to 2, not 1: XLA (CPU) lowers rank-degenerate
    batch-1 matmuls/convs through different accumulation paths, so a
    bucket of 1 is the one compiled shape whose answers can differ from
    the others in final ulps.  With buckets >= 2 a request's answer is
    bit-identical whichever bucket serves it (regression-tested); pass
    ``min_bucket=1`` to trade that for zero padding on singleton groups.
    """
    if max_batch < 1 or min_bucket < 1:
        raise ValueError("max_batch and min_bucket must be >= 1")
    out = []
    b = min_bucket
    while b < max_batch:
        out.append(b)
        b *= 2
    return tuple(out) + (max_batch,)


# ---------------------------------------------------------------------------
# latency accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestLatency:
    """Per-request timing through the front-door (seconds from serve start).

    ``queue_s`` = arrival -> first work dispatched (admission wait + any
    blocking on the in-flight window / slot pool); ``service_s`` =
    dispatch -> answers materialized on the host."""

    uid: int
    model: str
    arrival_s: float
    dispatch_s: float
    done_s: float
    bucket: int
    group_size: int
    close_reason: str             # full | deadline | flush
    priority: str = DEFAULT_PRIORITY

    @property
    def queue_s(self) -> float:
        return self.dispatch_s - self.arrival_s

    @property
    def service_s(self) -> float:
        return self.done_s - self.dispatch_s

    @property
    def total_s(self) -> float:
        return self.done_s - self.arrival_s


@dataclasses.dataclass
class ServedGroup:
    """One admission group as the front-door closed and served it."""

    model: str
    uids: tuple[int, ...]
    bucket: int
    size: int
    close_reason: str
    open_s: float                 # arrival of the group's first request
    close_s: float                # when the admission policy closed it
    dispatch_s: float
    done_s: float
    # which replica of a ReplicaPool served the group (None = unpooled
    # engine); read off the engine's GroupRecord stamp
    replica: int | None = None


@dataclasses.dataclass
class FrontDoorReport:
    """Results + latency accounting of one ``FrontDoor.serve`` call.

    ``results`` maps model -> uid -> the engine's own result type
    (``Result`` with generated ``tokens`` for LM engines, ``ReasonResult``
    with an ``answer`` for NSAI engines) — one report covers both request
    classes.

    Overload-control outcomes are first class: ``shed`` lists every
    rejected request (:class:`~repro_torch.serve.control.ShedRecord` — never a
    silent drop, so ``offered == admitted + shed`` exactly), ``slo``
    holds the targets that were in force, ``decisions`` the controller's
    non-hold actions, and ``queue_depth_max`` the per-model pending
    high-water mark (the boundedness proof the soak gate reads)."""

    results: dict[str, dict[int, Any]]
    latencies: list[RequestLatency]
    groups: list[ServedGroup]
    wall_time_s: float
    shed: list[ShedRecord] = dataclasses.field(default_factory=list)
    slo: dict[str, SLOTarget] = dataclasses.field(default_factory=dict)
    decisions: list = dataclasses.field(default_factory=list)
    queue_depth_max: dict[str, int] = dataclasses.field(
        default_factory=dict)

    def offered(self, model: str | None = None) -> int:
        """Requests that reached the front-door: admitted + shed."""
        admitted = sum(1 for l in self.latencies
                       if model is None or l.model == model)
        return admitted + sum(1 for s in self.shed
                              if model is None or s.model == model)

    def shed_counts(self, model: str | None = None) -> dict[str, int]:
        """Shed requests per priority class."""
        out: dict[str, int] = {}
        for s in self.shed:
            if model is None or s.model == model:
                out[s.priority] = out.get(s.priority, 0) + 1
        return {p: out[p] for p in slo_mod.PRIORITIES if p in out}

    def shed_rate(self, model: str | None = None) -> float:
        offered = self.offered(model)
        n_shed = sum(1 for s in self.shed
                     if model is None or s.model == model)
        return n_shed / offered if offered else 0.0

    def slo_attainment(self, model: str | None = None) -> dict[str, dict]:
        """Exact per-class SLO attainment (see :func:`repro_torch.serve.slo.
        attainment`) against the targets this serve ran under."""
        return slo_mod.attainment(self.latencies, self.slo, model)

    def percentiles(self, field: str = "total_s", model: str | None = None,
                    qs: tuple[int, ...] = (50, 95, 99)) -> dict[str, float]:
        """{p50: ..., p95: ...} over ``field`` (queue_s | service_s |
        total_s), optionally for one model."""
        vals = [getattr(l, field) for l in self.latencies
                if model is None or l.model == model]
        if not vals:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(vals, q)) for q in qs}

    def throughput_rps(self, model: str | None = None) -> float:
        n = sum(1 for l in self.latencies
                if model is None or l.model == model)
        return n / self.wall_time_s if self.wall_time_s else 0.0

    def work_per_s(self, model: str | None = None) -> float:
        """Served throughput in the class's own work unit: generated
        tokens/s for LM models, problems/s for NSAI models (mixing models
        of different classes sums their units — pass ``model`` for a
        meaningful number)."""
        total = sum(rt.work_units(r)
                    for m, res in self.results.items()
                    if model is None or m == model
                    for r in res.values())
        return total / self.wall_time_s if self.wall_time_s else 0.0

    def bucket_histogram(self, model: str | None = None) -> dict[int, int]:
        hist: dict[int, int] = {}
        for g in self.groups:
            if model is None or g.model == model:
                hist[g.bucket] = hist.get(g.bucket, 0) + 1
        return dict(sorted(hist.items()))

    def work_unit(self, model: str) -> str:
        """'tok' (LM) or 'prob' (NSAI) for one model's served results."""
        return rt.work_unit_name(self.results.get(model, {}).values())

    def replica_breakdown(self, model: str | None = None
                          ) -> dict[int, dict] | None:
        """Per-replica utilization out of the merged report.

        ``{replica: {groups, requests, busy_s, share}}`` where ``busy_s``
        sums the replica's dispatch->done service intervals and ``share``
        is its fraction of served requests.  ``None`` when no group was
        served by a :class:`~repro_torch.serve.replica.ReplicaPool`
        (unpooled engines leave ``ServedGroup.replica`` unset).
        """
        groups = [g for g in self.groups
                  if (model is None or g.model == model)
                  and g.replica is not None]
        if not groups:
            return None
        total = sum(g.size for g in groups)
        out: dict[int, dict] = {}
        for g in groups:
            row = out.setdefault(g.replica, {"groups": 0, "requests": 0,
                                             "busy_s": 0.0, "share": 0.0})
            row["groups"] += 1
            row["requests"] += g.size
            row["busy_s"] += g.done_s - g.dispatch_s
        for row in out.values():
            row["share"] = row["requests"] / total if total else 0.0
        return dict(sorted(out.items()))

    def summary(self) -> str:
        lines = []
        for model in sorted(self.results):
            n = len(self.results[model])
            if not n:
                continue
            q = self.percentiles("queue_s", model)
            s = self.percentiles("service_s", model)
            t = self.percentiles("total_s", model)
            hist = ",".join(f"{b}x{c}" for b, c in
                            self.bucket_histogram(model).items())
            lines.append(
                f"{model}: {n} served @ {self.throughput_rps(model):.1f}/s"
                f" ({self.work_per_s(model):.1f} {self.work_unit(model)}/s)"
                f" | queue p50/p95/p99 {q['p50'] * 1e3:.1f}/"
                f"{q['p95'] * 1e3:.1f}/{q['p99'] * 1e3:.1f}ms"
                f" | service p50/p95/p99 {s['p50'] * 1e3:.1f}/"
                f"{s['p95'] * 1e3:.1f}/{s['p99'] * 1e3:.1f}ms"
                f" | total p99 {t['p99'] * 1e3:.1f}ms | buckets {hist}")
            sheds = self.shed_counts(model)
            if sheds:
                parts = " ".join(f"{p}:{c}" for p, c in sheds.items())
                lines.append(
                    f"{model}: shed {sum(sheds.values())} "
                    f"({self.shed_rate(model):.1%} of "
                    f"{self.offered(model)} offered) [{parts}] "
                    f"queue<= {self.queue_depth_max.get(model, 0)}")
            if self.slo:
                att = self.slo_attainment(model)
                parts = " ".join(
                    f"{p}:{row['attainment']:.1%}"
                    f"{'' if row['target_ms'] is None else '@' + format(row['target_ms'], '.0f') + 'ms'}"
                    for p, row in att.items() if row["n"])
                if parts:
                    lines.append(f"{model}: slo attainment {parts}")
            replicas = self.replica_breakdown(model)
            if replicas:
                parts = " ".join(
                    f"r{i}:{row['groups']}g/{row['requests']}req/"
                    f"{row['share']:.0%}" for i, row in replicas.items())
                lines.append(f"{model}: replicas {parts}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the front-door
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrontDoorConfig:
    # close an admission group this long after its first request arrived
    deadline_s: float = 0.02
    # admission cap per group (None = each engine's ``admission_cap``)
    max_batch: int | None = None
    # while groups are in flight, sleeps are capped at this poll interval
    # so ready groups get drained (and done-stamped) promptly — and so
    # LM engines, which decode one block per drain_ready call, make
    # progress between arrivals
    poll_s: float = 0.002


class FrontDoor:
    """Deadline-batched, shape-bucketed admission over protocol engines.

    ``engines`` maps model name -> any :class:`~repro_torch.serve.runtime.
    EngineProtocol` implementation (``ReasonEngine``, the LM ``Engine``,
    or a mix) — model constants are bound inside each engine, so the
    front-door schedules traffic only.  ``serve`` consumes a time-ordered
    :class:`ArrivalRequest` stream (use :func:`merge_arrivals` for
    several models) and returns a :class:`FrontDoorReport`.

    ``clock``/``sleep`` default to real time; tests inject a virtual pair
    to drive the admission policy deterministically.  The engines' record
    clocks are pointed at the front-door clock for the duration of
    ``serve`` so queue/service latencies share one origin.

    ``controller`` (optional) turns on the overload control plane: the
    DSE-derived static knobs become the controller's *initial* operating
    point, pending queues become bounded priority
    :class:`~repro_torch.serve.control.ClassQueues` with shedding, and the
    controller adapts deadline/bucket-cap each tick from the windowed
    per-class p99 feedback (see :mod:`repro_torch.serve.control`).
    """

    def __init__(self, engines: Mapping[str, EngineProtocol],
                 cfg: FrontDoorConfig | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 controller: OverloadController | None = None):
        if not engines:
            raise ValueError("front-door needs at least one engine")
        cfg = cfg or FrontDoorConfig()
        if cfg.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        self.engines = dict(engines)
        self.cfg = cfg
        self._clock = clock
        self._sleep = sleep
        self.caps = {m: min(cfg.max_batch or eng.admission_cap,
                            eng.admission_cap)
                     for m, eng in self.engines.items()}
        if any(c < 1 for c in self.caps.values()):
            raise ValueError(f"admission caps must be >= 1: {self.caps}")
        self.controller = controller
        if controller is not None:
            for m, cap in self.caps.items():
                if m not in controller.bound():
                    controller.bind(m, deadline_s=cfg.deadline_s, cap=cap,
                                    buckets=pow2_buckets(cap, min_bucket=1))

    def _deadline(self, model: str) -> float:
        if self.controller is not None:
            return self.controller.deadline_s(model)
        return self.cfg.deadline_s

    def _cap(self, model: str) -> int:
        if self.controller is not None:
            return min(self.controller.cap(model), self.caps[model])
        return self.caps[model]

    def _accepting(self, model: str) -> bool:
        """Whether a group close should dispatch now.  Only consulted in
        overload-control mode: deferring closes while the engine's
        in-flight window is full keeps backlog in the front-door's
        *bounded* queue (where the depth bound sheds it) instead of
        blocking inside ``submit`` — that's the backpressure that makes
        reject-with-backpressure possible.  Engines without an
        ``accepting`` signal always dispatch (legacy behavior)."""
        if self.controller is None:
            return True
        return getattr(self.engines[model], "accepting", True)

    def serve(self, arrivals: Iterable[ArrivalRequest]) -> FrontDoorReport:
        """Serve one arrival stream to completion (single-threaded event
        loop; see module docstring for the policy).  An empty stream
        returns a well-formed empty report."""
        saved_clocks = {m: eng.clock for m, eng in self.engines.items()}
        for eng in self.engines.values():
            eng.clock = self._clock
        try:
            return self._serve(arrivals)
        finally:
            for m, eng in self.engines.items():
                eng.clock = saved_clocks[m]

    def _serve(self, arrivals: Iterable[ArrivalRequest]) -> FrontDoorReport:
        ctl = self.controller
        results: dict[str, dict[int, Any]] = {m: {} for m in self.engines}
        # per-model bounded priority queues (unbounded single-class FIFO
        # when no controller — the legacy behavior, byte for byte)
        pending: dict[str, ClassQueues] = \
            {m: (ctl.queues(m) if ctl is not None else ClassQueues())
             for m in self.engines}
        shed: list[ShedRecord] = []
        # serve-lifetime duplicate guard: engines intentionally allow uid
        # reuse after a drain, so a duplicate that slips past a mid-serve
        # drain would silently overwrite the earlier answer in `results`
        seen: dict[str, set] = {m: set() for m in self.engines}
        # (model, rec, close_reason, close_s, [arrival times], [classes])
        submitted: list[tuple[str, GroupRecord, str, float,
                              list[float], list[str]]] = []
        # submitted groups whose completion hasn't been fed back yet
        watch: list[tuple[str, GroupRecord, list[float], list[str]]] = []

        t0 = self._clock()

        def now() -> float:
            return self._clock() - t0

        def close_group(model: str, reason: str):
            group = pending[model].pop(self._cap(model))
            rec = self.engines[model].submit([a.request for a in group])
            entry = (model, rec, reason, now(), [a.t for a in group],
                     [a.priority or DEFAULT_PRIORITY for a in group])
            submitted.append(entry)
            if ctl is not None:
                watch.append((model, rec, entry[4], entry[5]))

        def feedback():
            # feed completions to the windowed estimator and let the
            # controller adapt the operating point if a tick is due
            t = now()
            live = []
            for model, rec, arrs, prios in watch:
                if rec.done_t is None:
                    live.append((model, rec, arrs, prios))
                    continue
                done_s = rec.done_t - t0
                for arr, prio in zip(arrs, prios):
                    ctl.observe(model, prio, done_s - arr, t)
            watch[:] = live
            obs = {m: dict(rt.engine_observation(eng),
                           queue_depth=len(pending[m]))
                   for m, eng in self.engines.items()}
            ctl.maybe_tick(t, obs)

        it = iter(arrivals)
        nxt = next(it, None)
        last_t = -float("inf")
        while True:
            t = now()
            # admit every due arrival (pulling the iterator renders the
            # request — ingest work happens inside the serving loop)
            while nxt is not None and nxt.t <= t:
                if nxt.model not in self.engines:
                    raise ValueError(f"arrival for unknown model "
                                     f"{nxt.model!r} (serving "
                                     f"{sorted(self.engines)})")
                if nxt.t < last_t - 1e-9:
                    raise ValueError("arrival stream is not time-ordered "
                                     f"({nxt.t:.6f} after {last_t:.6f}) — "
                                     "use merge_arrivals")
                last_t = nxt.t
                model = nxt.model
                uid = nxt.request.uid
                if uid in seen[model]:
                    raise ValueError(f"duplicate request uid {uid} for "
                                     f"model {model!r} (results are keyed "
                                     "by uid)")
                seen[model].add(uid)
                prio = nxt.priority or rt.request_priority(nxt.request)
                arrival = dataclasses.replace(nxt, priority=prio)
                rejected = pending[model].offer(arrival, prio, now())
                if rejected is not None:
                    shed.append(rejected)
                nxt = next(it, None)
                while len(pending[model]) >= self._cap(model) \
                        and self._accepting(model):
                    close_group(model, "full")
            if nxt is None:
                # stream over: no future arrival can fill an open group,
                # so holding it to the deadline only adds latency.  Flush
                # in arrival order ACROSS models (oldest open group
                # first), not engine-dict order — cross-model dispatch
                # order must track arrival order
                flushable = [m for m in self.engines if pending[m]]
                while flushable:
                    model = min(flushable,
                                key=lambda m: pending[m].oldest_t)
                    close_group(model, "flush")
                    flushable = [m for m in self.engines if pending[m]]
                break
            t = now()
            # deadline closes, oldest open group first across models so
            # simultaneous expiries dispatch in arrival order; a close is
            # deferred (not skipped) while the engine signals
            # backpressure — the queue keeps aging and sheds at its bound
            deferred = False
            due = sorted(
                (pending[m].oldest_t, m) for m in self.engines
                if pending[m]
                and t >= pending[m].oldest_t + self._deadline(m))
            for _, model in due:
                if not pending[model]:
                    continue
                if self._accepting(model):
                    close_group(model, "deadline")
                else:
                    deferred = True
            if ctl is not None:
                feedback()
            events = [nxt.t] + \
                [pending[m].oldest_t + self._deadline(m)
                 for m in self.engines if pending[m]]
            dt = min(events) - now()
            if dt > 0:
                # the device keeps working while the host waits; collect
                # whatever finished so done-stamps aren't deferred, and
                # let host-pumped engines (LM decode) advance a block
                inflight = 0
                for model, eng in self.engines.items():
                    results[model].update(eng.drain_ready())
                    inflight += eng.inflight
                self._sleep(min(dt, self.cfg.poll_s) if inflight else dt)
            elif deferred:
                # every pending event is past due but the engines are
                # backpressuring: drain to free window room and let time
                # advance one poll, or a virtual clock would livelock
                for model, eng in self.engines.items():
                    results[model].update(eng.drain_ready())
                self._sleep(self.cfg.poll_s)

        for model, eng in self.engines.items():
            results[model].update(eng.drain_all())
        if ctl is not None:
            feedback()
        wall = now()

        latencies: list[RequestLatency] = []
        groups: list[ServedGroup] = []
        for model, rec, reason, close_s, arr_times, prios in submitted:
            if rec.dispatch_t is None or rec.done_t is None:
                raise RuntimeError(
                    f"{model}: engine left group {rec.index} unstamped "
                    f"(dispatch_t={rec.dispatch_t}, done_t={rec.done_t}) "
                    "after drain_all — protocol violation")
            dispatch_s = rec.dispatch_t - t0
            done_s = rec.done_t - t0
            groups.append(ServedGroup(
                model=model, uids=rec.uids, bucket=rec.bucket, size=rec.size,
                close_reason=reason, open_s=min(arr_times), close_s=close_s,
                dispatch_s=dispatch_s, done_s=done_s, replica=rec.replica))
            for uid, arr, prio in zip(rec.uids, arr_times, prios):
                latencies.append(RequestLatency(
                    uid=uid, model=model, arrival_s=arr,
                    dispatch_s=dispatch_s, done_s=done_s, bucket=rec.bucket,
                    group_size=rec.size, close_reason=reason,
                    priority=prio))
        return FrontDoorReport(
            results=results, latencies=latencies, groups=groups,
            wall_time_s=wall, shed=shed,
            slo=dict(ctl.targets) if ctl is not None else {},
            decisions=list(ctl.decisions) if ctl is not None else [],
            queue_depth_max={m: q.depth_max for m, q in pending.items()})
