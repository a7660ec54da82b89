"""Workload-generic NSAI serving: N-stage pipelines with host/device overlap.

The port of ``repro.serve.reason``.  ``ReasonEngine`` runs any
:class:`~repro_torch.serve.schedule.StagedSchedule` and holds no
workload-specific logic.  Admission groups flow through the pipeline with
an in-flight window of ``ReasonConfig.max_inflight`` dispatched but
undrained groups, so group *i*'s device work overlaps the host's staging of
group *i+1*:

- inputs are stacked, padded to the covering bucket, put in pinned host
  memory and copied to the card with ``non_blocking=True``;
- every stage launches on the current CUDA stream without waiting, and a
  ``torch.cuda.Event`` recorded after the last stage marks the group done
  (where the reference calls ``jax.block_until_ready``);
- ``drain_ready`` polls that event; only a drain copies answers back.

Schedules: ``overlap`` (the stages one after another, asynchronously),
``fused`` (the schedule's fused callable once per group) and ``sequential``
(synchronise after every stage and finish a group before the next; it also
measures the per-stage time breakdown).  ``overlap`` and ``sequential`` run
the same functions and give the same answers.  ``fused`` substitutes the
fused callable only where the schedule allows it (``fused_ok``: negotiated
exact, or forced); otherwise it serves the group stage by stage and counts
it in ``stats["fused_fallback_groups"]``, as the reference does.

Two entry points, as in the reference: ``run(requests)`` (the offline
loop) and ``submit`` / ``drain_ready`` / ``drain_all`` (the
:class:`~repro_torch.serve.runtime.EngineProtocol` surface a front-door
drives).  Stats split warmup from steady state: the first group of a
(variant, bucket, mode) shape is accounted under ``stats["warmup"]``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.common.tree import tree_map
from repro_torch.serve import runtime as rt
from repro_torch.serve.runtime import GroupRecord
from repro_torch.serve.schedule import StagedSchedule

SCHEDULES = ("overlap", "sequential", "fused")


@dataclasses.dataclass
class ReasonConfig:
    batch_size: int = 4           # max problems per admission group
    schedule: str = "overlap"     # overlap | sequential | fused
    # which compiled variant to run (None = the engine's first)
    variant: str | None = None
    # dispatched-but-undrained groups resident at once before the executor
    # blocks on the oldest (1 = double buffering)
    max_inflight: int = 1
    # compiled batch-size buckets, ascending (None = (batch_size,))
    buckets: tuple[int, ...] | None = None


@dataclasses.dataclass
class ReasonRequest:
    uid: int
    # RAVEN reasoning traffic
    context: np.ndarray | None = None          # (8, H, W, 1) float32
    candidates: np.ndarray | None = None       # (8, H, W, 1) float32
    context_attrs: np.ndarray | None = None    # (8, A) int32 — oracle variant
    candidate_attrs: np.ndarray | None = None  # (8, A) int32
    # superposed-classification traffic (mimonet)
    images: np.ndarray | None = None           # (K, H, W, 1) float32
    # traffic class for overload control; the engine ignores it
    priority: str = rt.DEFAULT_PRIORITY


@dataclasses.dataclass
class ReasonResult:
    uid: int
    answer: int | np.ndarray
    answer_logprobs: np.ndarray
    batch: int                    # pipeline group index that served it
    rule_posteriors: np.ndarray | None = None


def _fresh_stats() -> dict:
    return {
        "requests": 0, "batches": 0,
        # stage-function calls: K per staged group, 1 per fused group
        "dispatches": 0,
        "fused_groups": 0,
        # fused-schedule groups served stage by stage (not ``fused_ok``)
        "fused_fallback_groups": 0,
        # cumulative sequential-schedule stage times {variant: {stage: s}}
        "stage_time_s": {},
        **rt.fresh_split_stats(),
    }


class ReasonEngine:
    """Generic N-stage pipelined executor over StagedSchedules.

    ``schedules`` maps variant name -> :class:`StagedSchedule` (a single
    schedule is accepted too); all must run on one device.  ``consts`` is
    the workload's constant tree, already on that device.  On a CUDA
    device the engine turns TF32 off for cuDNN and matmuls, so the fp32
    paths run in true fp32 as the reference's do.  ``clock`` stamps
    :class:`GroupRecord`\\ s (a front-door injects its own); ``wall`` is the
    real clock the throughput accounting reads.
    """

    def __init__(self, schedules: StagedSchedule | Mapping[str, StagedSchedule],
                 cfg: ReasonConfig, consts=None, clock=time.perf_counter,
                 wall=time.perf_counter):
        if isinstance(schedules, StagedSchedule):
            schedules = {schedules.variant: schedules}
        if not schedules:
            raise ValueError("engine needs at least one compiled schedule")
        if cfg.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        if cfg.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if cfg.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        devices = {s.device for s in schedules.values()}
        if len(devices) != 1:
            raise ValueError(f"schedules on several devices: {devices}")
        for s in schedules.values():
            if s.batch_buckets and s.batch_buckets[-1] < cfg.batch_size:
                raise ValueError(
                    f"{s.workload}/{s.variant}: largest compiled bucket "
                    f"{s.batch_buckets[-1]} < batch_size {cfg.batch_size} — "
                    "admission groups would not fit any bucket")
        self.schedules = dict(schedules)
        self.device = devices.pop()
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            # cuDNN convolutions default to TF32; the reference is fp32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.default_variant = cfg.variant or next(iter(self.schedules))
        if self.default_variant not in self.schedules:
            raise ValueError(f"unknown variant {self.default_variant!r}; "
                             f"compiled: {sorted(self.schedules)}")
        self.cfg = cfg
        self.consts = consts
        self.clock = clock
        self.wall = wall
        self.stats = _fresh_stats()
        self.runs: list[dict] = []
        self._inflight: collections.deque = collections.deque()
        self._ready: dict[int, ReasonResult] = {}  # collected, undrained
        self._next_index = 0
        self._warmed: set[tuple[str, int, str]] = set()
        self._cold_run = False
        self._run_stage_time: dict[str, float] = {}
        self._in_run = False          # run() accounts at run level instead
        self._last_acct = float("-inf")  # busy-window edge for group stats

    @property
    def admission_cap(self) -> int:
        """Largest admission group ``submit`` accepts (protocol surface)."""
        return self.cfg.batch_size

    # -- host-side staging --------------------------------------------------

    def _resolve(self, schedule: str | None, variant: str | None):
        schedule = schedule or self.cfg.schedule
        variant = variant or self.default_variant
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        if variant not in self.schedules:
            raise ValueError(f"unknown variant {variant!r}; "
                             f"compiled: {sorted(self.schedules)}")
        return schedule, variant, self.schedules[variant]

    def _ingest(self, req: ReasonRequest, sched: StagedSchedule):
        try:
            return sched.ingest(req)
        except (ValueError, AttributeError, TypeError) as e:
            raise ValueError(
                f"request {req.uid}: cannot ingest for workload "
                f"{sched.workload!r} variant {sched.variant!r}: {e}") from e

    def _stage(self, batch: list[ReasonRequest], sched: StagedSchedule):
        """Stack one admission group, pad it to its covering bucket by
        repeating the last request (padded rows are computed and dropped at
        collect) and start its copy to the device.  Returns
        ``(device_bufs, bucket)``."""
        trees = [self._ingest(r, sched) for r in batch]
        bucket = sched.covering_bucket(len(batch)) if sched.batch_buckets \
            else self.cfg.batch_size
        pad = bucket - len(batch)

        def stack(*leaves):
            x = np.stack(leaves)
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            t = torch.from_numpy(x)
            if self.cuda:
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

        return tree_map(stack, *trees), bucket

    def _collect(self, batch: list[ReasonRequest], out,
                 rec: GroupRecord, sched: StagedSchedule,
                 cold: bool = False, t0: float | None = None):
        """Copy one group's answers to the host (blocks if pending) into the
        ready buffer.  Outside ``run()`` the group is accounted into the
        warmup/measured split here: wall time is the union of per-group
        busy windows on the real clock."""
        host = tree_map(lambda t: t.cpu().numpy(), out)
        for i, req in enumerate(batch):  # padded rows have no request
            fields = sched.collect(host, i)
            self._ready[req.uid] = ReasonResult(uid=req.uid, batch=rec.index,
                                                **fields)
        rec.done_t = self.clock()
        self.stats["requests"] += len(batch)
        if not self._in_run and t0 is not None:
            now = self.wall()
            kind = "warmup" if cold else "measured"
            self.stats[kind]["requests"] += len(batch)
            self.stats[kind]["work"] += len(batch)
            self.stats[kind]["wall_time_s"] += max(
                0.0, now - max(t0, self._last_acct))
            self._last_acct = now

    def _batches(self, requests: Iterable[ReasonRequest]):
        """Pull admission groups lazily from the request stream."""
        it = iter(requests)
        seen: set = set()
        while True:
            batch = list(itertools.islice(it, self.cfg.batch_size))
            if not batch:
                return
            for req in batch:
                if req.uid in seen:
                    raise ValueError(f"duplicate request uid {req.uid} "
                                     "(results are keyed by uid)")
                seen.add(req.uid)
            yield batch

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # -- group-level API (a front-door drives these) ------------------------

    def submit(self, group: list[ReasonRequest],
               schedule: str | None = None, variant: str | None = None
               ) -> GroupRecord:
        """Dispatch one admission group through the pipeline.

        Under ``overlap`` / ``fused`` the group's whole pipeline is
        enqueued before the engine waits on anything, then the in-flight
        window is trimmed back to ``cfg.max_inflight`` by draining the
        oldest group (its record gets ``done_t`` in place; its answers wait
        for the next ``drain_*``).  Under ``sequential`` the group is served
        synchronously, with per-stage timing, and returned complete."""
        consts = self.consts
        if consts is None:
            raise ValueError(
                "engine has no consts bound — pass consts= to ReasonEngine "
                "(configs.base.reason_engine binds them for you)")
        schedule, variant, sched = self._resolve(schedule, variant)
        sequential = schedule == "sequential"
        if not group:
            raise ValueError("empty admission group")
        if len(group) > self.cfg.batch_size:
            raise ValueError(f"admission group of {len(group)} exceeds "
                             f"batch_size {self.cfg.batch_size}")
        pending = {r.uid for entry in self._inflight for r in entry[0]}
        seen: set = set()
        for req in group:
            if req.uid in self._ready or req.uid in pending \
                    or req.uid in seen:
                raise ValueError(f"duplicate request uid {req.uid} "
                                 "(results are keyed by uid)")
            seen.add(req.uid)
        bufs, bucket = self._stage(group, sched)
        use_fused = schedule == "fused" and sched.fused_ok
        if schedule == "fused" and not use_fused:
            # the fused list is only epsilon-equivalent (or was not
            # compiled): serve stage by stage, as the reference does
            self.stats["fused_fallback_groups"] += 1
        mode = "fused" if use_fused else "staged"
        cold = (variant, bucket, mode) not in self._warmed
        if cold:
            self._warmed.add((variant, bucket, mode))
            self._cold_run = True
        rec = GroupRecord(uids=tuple(r.uid for r in group),
                          index=self._next_index, variant=variant,
                          bucket=bucket, size=len(group))
        self._next_index += 1
        stage_time = self.stats["stage_time_s"].setdefault(variant, {})
        t0 = self.wall()
        rec.dispatch_t = self.clock()
        if use_fused:
            bufs = sched.fused_fn(consts, bufs)
            self.stats["dispatches"] += 1
            self.stats["fused_groups"] += 1
        else:
            for stage in sched.stages:
                ts = self.wall()
                bufs = stage.fn(consts, bufs)
                self.stats["dispatches"] += 1
                if sequential:
                    self._sync()
                    dt = self.wall() - ts
                    stage_time[stage.name] = stage_time.get(stage.name, 0.0) + dt
                    self._run_stage_time[stage.name] = \
                        self._run_stage_time.get(stage.name, 0.0) + dt
        self.stats["batches"] += 1
        if sequential:
            self._collect(group, bufs, rec, sched, cold=cold, t0=t0)
            return rec
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        self._inflight.append((group, bufs, rec, sched, cold, t0, done))
        # window backpressure, strictly after the new dispatch
        while len(self._inflight) > self.cfg.max_inflight:
            self._drain_one()
        return rec

    def _drain_one(self) -> GroupRecord | None:
        if not self._inflight:
            return None
        group, bufs, rec, sched, cold, t0, _ = self._inflight.popleft()
        self._collect(group, bufs, rec, sched, cold=cold, t0=t0)
        return rec

    def _take_ready(self) -> dict[int, ReasonResult]:
        out, self._ready = self._ready, {}
        return out

    def drain_all(self) -> dict[int, ReasonResult]:
        """Drain every in-flight group, oldest first (blocking), and return
        all finished results ``{uid: ReasonResult}``."""
        while self._inflight:
            self._drain_one()
        return self._take_ready()

    def drain_ready(self) -> dict[int, ReasonResult]:
        """Collect, oldest first, the in-flight groups whose done event has
        fired (non-blocking), and return every finished result."""
        while self._inflight:
            done = self._inflight[0][-1]
            if done is not None and not done.query():
                break
            self._drain_one()
        return self._take_ready()

    @property
    def inflight(self) -> int:
        """Dispatched-but-undrained admission groups."""
        return len(self._inflight)

    @property
    def accepting(self) -> bool:
        """True while ``submit`` would dispatch without blocking on the
        in-flight window (the front-door's backpressure signal)."""
        return len(self._inflight) < self.cfg.max_inflight

    # -- the offline loop ---------------------------------------------------

    def run(self, requests: Iterable[ReasonRequest],
            schedule: str | None = None, variant: str | None = None
            ) -> dict[int, ReasonResult]:
        """Serve all requests; returns {uid: ReasonResult}.

        Appends a per-run record to ``self.runs`` ({schedule, variant,
        requests, wall_time_s, warmup, stage_time_s, problems_per_s}); runs
        that first touched a (variant, bucket, mode) shape are flagged
        ``warmup`` and kept out of the measured stats."""
        schedule, variant, _ = self._resolve(schedule, variant)
        if self._inflight or self._ready:
            raise ValueError("engine has undrained in-flight groups "
                             "(call drain_all first)")
        self._cold_run = False
        self._run_stage_time = {}
        self._in_run = True
        t_start = self.wall()
        try:
            for batch in self._batches(requests):
                self.submit(batch, schedule=schedule, variant=variant)
            results = self.drain_all()
        finally:
            self._in_run = False
        dt = self.wall() - t_start
        kind = "warmup" if self._cold_run else "measured"
        self.stats[kind]["requests"] += len(results)
        self.stats[kind]["work"] += len(results)
        self.stats[kind]["wall_time_s"] += dt
        self.runs.append({
            "schedule": schedule, "variant": variant,
            "requests": len(results), "wall_time_s": dt,
            "warmup": self._cold_run,
            "stage_time_s": dict(self._run_stage_time),
            "problems_per_s": len(results) / dt if dt else 0.0,
        })
        return results

    @property
    def last_run(self) -> dict | None:
        """Per-run stats record of the most recent ``run()``."""
        return self.runs[-1] if self.runs else None

    def problems_per_s(self) -> float:
        """Measured steady-state throughput (warmup runs excluded)."""
        return rt.measured_rate(self.stats)

    def reset_stats(self):
        """Zero the cumulative stats and per-run records (the warmed-shape
        set survives)."""
        self.stats = _fresh_stats()
        self.runs = []


def requests_from_batch(batch: dict, start_uid: int = 0
                        ) -> list[ReasonRequest]:
    """Adapt one ``data.raven.generate_batch`` dict into requests."""
    n = len(batch["answer"])
    return [ReasonRequest(
        uid=start_uid + i,
        context=batch["context"][i], candidates=batch["candidates"][i],
        context_attrs=batch["context_attrs"][i],
        candidate_attrs=batch["candidate_attrs"][i]) for i in range(n)]
