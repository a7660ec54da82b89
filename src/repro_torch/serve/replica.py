"""Data-parallel engine replicas behind one protocol surface.

The port's copy of ``repro.serve.replica``.  NSFlow's scalability claim
(paper Sec V) is that the generated array keeps serving heterogeneous
NSAI streams as they scale; the serving-side analogue is data parallelism
over whole engines: N identical protocol engines, each with its constants
on its own device, served as ONE
:class:`~repro_torch.serve.runtime.EngineProtocol` implementation, so the
front door (and anything else that drives submit/drain) shards admission
groups across devices unchanged.

``ReplicaPool`` is that implementation:

- **least-inflight dispatch**: ``submit`` routes each admission group to
  the replica with the fewest dispatched-but-undrained groups (ties to the
  lowest index, so routing is deterministic for a given arrival order).
  Each replica keeps its own depth-k in-flight window, so k x N groups can
  be resident.
- **answer invariance**: every replica is built from the same constants,
  and an engine's outputs depend only on the request and the group it was
  admitted with, never on the replica index or co-resident groups.
  ``tests/test_torch_replica.py`` pins the 4-replica answers to the
  1-replica ones.
- **merged accounting**: ``stats`` sums the replicas' stats trees (so
  ``measured_rate`` and the warmup/measured split keep working),
  ``drain_*`` merge the per-replica result dicts, and
  :class:`~repro_torch.serve.runtime.GroupRecord`\\ s come back stamped with
  the serving ``replica`` index, which the front door's per-replica
  breakdown reads.

Placement is the caller's job (``configs.base.reason_engine_pool`` moves
each replica's constants to ``cuda:(i % device_count)``, or keeps them on
the CPU).  The pool itself is device-agnostic: N replicas on one device
still shard load across N in-flight windows.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Mapping, Sequence

from repro_torch.serve import runtime as rt
from repro_torch.serve.runtime import EngineProtocol, GroupRecord


def _merge_stats(trees: Sequence[Any]):
    """Recursively sum the replicas' stats trees.

    Numbers sum; dicts merge by key (missing keys default to the other
    side); equal-length numeric lists sum elementwise.  Anything non-numeric keeps the
    first replica's value — stats trees hold counters, so that only
    covers identity-like fields.
    """
    trees = [t for t in trees if t is not None]
    if not trees:
        return None
    head = trees[0]
    if isinstance(head, Mapping):
        keys = []
        for t in trees:
            keys += [k for k in t if k not in keys]
        return {k: _merge_stats([t[k] for t in trees if k in t])
                for k in keys}
    if isinstance(head, bool):
        return head
    if isinstance(head, (int, float)):
        return sum(trees)
    if isinstance(head, list) and head and \
            all(isinstance(x, (int, float)) for x in head) and \
            all(len(t) == len(head) for t in trees):
        return [sum(col) for col in zip(*trees)]
    return head


class ReplicaPool:
    """N protocol engines served as one (see module docstring).

    ``replicas`` must be non-empty and homogeneous (same engine class,
    same serving config) — the pool checks only the protocol surface, but
    heterogeneous replicas would break the answer-invariance contract.
    ``clock`` fans out: the front-door saves/sets/restores ``eng.clock``
    around ``serve``, and every replica must stamp records on that same
    clock for queue/service latencies to share an origin.
    """

    def __init__(self, replicas: Sequence[EngineProtocol]):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        caps = {r.admission_cap for r in replicas}
        if len(caps) != 1:
            raise ValueError(f"replicas disagree on admission_cap: "
                             f"{sorted(caps)} — the pool routes any group "
                             "to any replica, so caps must match")
        self.replicas = replicas
        self.runs: list = []          # protocol surface; per-replica runs
        # pool-level routing counters, per replica: admission groups and
        # requests dispatched (deploy's report reads these; the per-group
        # truth is GroupRecord.replica on every record)
        self.dispatched_groups = [0] * len(replicas)
        self.dispatched_requests = [0] * len(replicas)

    def __len__(self) -> int:
        return len(self.replicas)

    # -- protocol surface ---------------------------------------------------

    @property
    def clock(self) -> Callable[[], float]:
        return self.replicas[0].clock

    @clock.setter
    def clock(self, clock: Callable[[], float]):
        for r in self.replicas:
            r.clock = clock

    @property
    def wall(self) -> Callable[[], float]:
        """The replicas' real wall-clock (throughput accounting source) —
        engines predating the ``wall`` parameter fall back to
        ``time.perf_counter``."""
        return getattr(self.replicas[0], "wall", time.perf_counter)

    @property
    def admission_cap(self) -> int:
        """Largest group ``submit`` accepts — every replica's cap."""
        return self.replicas[0].admission_cap

    @property
    def inflight(self) -> int:
        """Dispatched-but-undrained groups across every replica."""
        return sum(r.inflight for r in self.replicas)

    @property
    def stats(self) -> dict:
        """The replicas' stats trees, recursively summed."""
        return _merge_stats([r.stats for r in self.replicas])

    @property
    def accepting(self) -> bool:
        """True while at least one replica would take a group without
        blocking — least-inflight routing sends work to that replica."""
        return any(getattr(r, "accepting", True) for r in self.replicas)

    def submit(self, group, **kw) -> GroupRecord:
        """Dispatch one admission group to the least-loaded replica.

        Least-inflight, ties to the lowest index: a burst of back-to-back
        groups round-robins across idle replicas, a slow replica stops
        receiving work until it drains.  The returned record carries the
        chosen ``replica`` index.
        """
        i = min(range(len(self.replicas)),
                key=lambda j: (self.replicas[j].inflight, j))
        rec = self.replicas[i].submit(group, **kw)
        rec.replica = i
        self.dispatched_groups[i] += 1
        self.dispatched_requests[i] += rec.size
        return rec

    def drain_ready(self) -> dict[int, Any]:
        """Non-blocking drain over every replica (merged ``{uid: result}``).

        Every replica gets its ``drain_ready`` call even when an earlier
        one returns results, so no replica's finished groups wait for the
        next call.
        """
        out: dict[int, Any] = {}
        for r in self.replicas:
            out.update(r.drain_ready())
        return out

    def drain_all(self) -> dict[int, Any]:
        """Run every replica's in-flight window to completion (merged)."""
        out: dict[int, Any] = {}
        for r in self.replicas:
            out.update(r.drain_all())
        return out

    def observation(self) -> dict[str, Any]:
        """Pool-merged view for the overload controller's tick (see
        :func:`repro_torch.serve.runtime.engine_observation`): total in-flight
        depth, the per-replica split (a hot replica hides behind a pool
        average — the controller's backlog signal shouldn't), and the
        steady-state work rate off the merged stats tree."""
        return {"inflight": self.inflight,
                "inflight_per_replica": [r.inflight for r in self.replicas],
                "work_rate": rt.measured_rate(self.stats)}

    # -- offline + accounting helpers ---------------------------------------

    def run(self, requests, **kw) -> dict[int, Any]:
        """Offline loop over the protocol: admission groups of
        ``admission_cap``, least-inflight routed, then drain everything.

        Unlike the single engines' ``run`` this one accounts per group
        (the protocol path), so the pool needs no run-level stats of its
        own; a per-pool-run record still lands in ``self.runs``.
        """
        import itertools

        t0 = self.wall()
        it = iter(requests)
        n = 0
        while True:
            group = list(itertools.islice(it, self.admission_cap))
            if not group:
                break
            self.submit(group, **kw)
            n += len(group)
        results = self.drain_all()
        dt = self.wall() - t0
        self.runs.append({"requests": len(results), "wall_time_s": dt,
                          "replicas": len(self.replicas)})
        return results

    def measured_rate(self, field: str = "work") -> float:
        """Steady-state pool throughput (work units/s, warmup excluded)."""
        return rt.measured_rate(self.stats, field)

    def problems_per_s(self) -> float:
        """Alias matching ``ReasonEngine`` (work == problems for NSAI)."""
        return self.measured_rate()

    def per_replica(self) -> list[dict]:
        """Routing + utilization counters per replica.

        ``busy_s`` is the replica's own accounted busy time (warmup +
        measured wall); ``share`` its fraction of the pool's dispatched
        work units — together the per-replica utilization breakdown
        ``Deployment.report()`` and the front-door summary surface.
        """
        stats = [r.stats for r in self.replicas]
        total_work = sum(s["measured"]["work"] + s["warmup"]["work"]
                         for s in stats)
        out = []
        for i, (r, s) in enumerate(zip(self.replicas, stats)):
            work = s["measured"]["work"] + s["warmup"]["work"]
            out.append({
                "replica": i,
                "groups": self.dispatched_groups[i],
                "requests": self.dispatched_requests[i],
                "work": work,
                "busy_s": s["measured"]["wall_time_s"]
                + s["warmup"]["wall_time_s"],
                "share": work / total_work if total_work else 0.0,
                "inflight": r.inflight,
            })
        return out

    def reset_stats(self):
        for r in self.replicas:
            r.reset_stats()
        self.runs = []
        self.dispatched_groups = [0] * len(self.replicas)
        self.dispatched_requests = [0] * len(self.replicas)
