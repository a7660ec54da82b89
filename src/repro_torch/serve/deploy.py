"""``deploy()``: the paper's generator -> serving-architecture loop.

The port of ``repro.serve.deploy`` for the four reasoners on one device.
NSFlow's headline claim (paper Sec III, V) is end to end: a design
architecture generator reads the workload's dataflow dependencies and
emits the serving architecture.  For each NSAI workload:

1. **trace**: the staged pipeline is compiled
   (``compile_reason_schedule``) and its
   :class:`~repro_torch.core.dataflow.DataflowGraph` traced from the
   composed stages on ``meta`` tensors (``serve.schedule.ensure_graph``,
   the torch twin of the reference's jaxpr walk).
2. **explore**: ``core.dse.explore`` runs Algorithm 1 over the graph under
   the :class:`Budget`'s PE count: the AdArray shape, the mode and the
   static nn/vsa partition.
3. **derive**: ``core.dse.serving_plan`` maps the design point onto the
   serving knobs (batch buckets, ``max_inflight``, overlap or sequential
   schedule); ``overlap`` becomes ``fused`` where the compiled schedule's
   fused callable is negotiated exact.  The engine is built from the plan,
   on ``device`` (None = ``"cuda"``; tests pass ``"cpu"``), with
   constants drawn from a ``torch.Generator`` seeded with ``(seed, model
   index)``.

The result is a :class:`Deployment`: one
:class:`~repro_torch.serve.frontdoor.FrontDoor` over every engine, with an
:class:`~repro_torch.serve.control.OverloadController` attached when the
budget sets ``slo_ms`` or ``queue_depth``.  ``Deployment.report()`` keeps
the reference's keys and records None where the port has no counterpart
yet (the lowering plan, the mesh point, replica pools, the preflight
analysis).

What the port does not have yet raises ``NotImplementedError`` naming its
ROADMAP item, and is never ignored: a ``Budget`` with ``devices``,
``replicas`` or ``tp`` above 1 (replicas and the mesh co-search, Queue 1
#3d and #6), ``backend=`` (the lowering-plan layer, #3e), ``preflight=``
other than ``"off"`` (the analyzer, #7).  An LM model name raises
``KeyError`` (the LM substrate, #4).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.serve.control import (ControlConfig, OverloadController,
                                       validate_shed_policy)
from repro_torch.serve.frontdoor import (ArrivalRequest, FrontDoor,
                                         FrontDoorConfig, FrontDoorReport,
                                         merge_arrivals, poisson_arrivals,
                                         with_priorities)
from repro_torch.serve.slo import slo_targets


@dataclasses.dataclass(frozen=True)
class Traffic:
    """What the deployment is sized to serve (the ``traffic`` argument)."""

    rate_rps: float = 20.0        # per-model Poisson offered load
    deadline_s: float = 0.02      # admission-group deadline
    poll_s: float = 0.002         # front-door drain poll while in flight


@dataclasses.dataclass(frozen=True)
class Budget:
    """Resource envelope the generator explores under.

    The reference's fields.  ``max_pes``, ``max_batch`` and
    ``inflight_cap`` size the DSE and the serving plan; ``slo_ms`` /
    ``queue_depth`` / ``shed_policy`` size the overload control plane
    (setting either of the first two attaches an ``OverloadController``).
    ``devices``, ``replicas`` and ``tp`` size the mesh side of the search,
    which the port does not have yet: a value above 1 (or
    ``replicas="auto"``) raises ``NotImplementedError``.  The reference's
    LM fields (slot pool, KV length, decode block, generation budget) wait
    for the LM substrate (ROADMAP Queue 1 #4)."""

    max_pes: int = 4096           # AdArray PE budget handed to the DSE
    max_batch: int = 8            # admission-group ceiling (NSAI buckets)
    inflight_cap: int = 4         # ceiling on the DSE-derived window depth
    devices: int | None = None    # device pool (None = 1 here)
    replicas: int | str | None = None  # DP engine replicas (None = 1)
    tp: int | None = None         # LM tensor-parallel degree (None = 1)
    slo_ms: float | Mapping[str, float] | None = None
    queue_depth: int | None = None
    shed_policy: str = "lowest-priority"


def _refuse_unported(budget: Budget, backend, preflight: str) -> None:
    """Raise for every option whose layer the port does not have yet."""
    if budget.replicas == "auto" or any(
            v is not None and v > 1
            for v in (budget.devices, budget.replicas, budget.tp)):
        raise NotImplementedError(
            f"Budget(devices={budget.devices}, replicas={budget.replicas}, "
            f"tp={budget.tp}): the port serves one engine per model on one "
            "device; replica pools and the mesh co-search are ROADMAP "
            "Queue 1 #3d and #6")
    if backend is not None:
        raise NotImplementedError(
            f"backend={backend!r}: the port has no lowering-plan layer "
            "(ROADMAP Queue 1 #3e); the tensor's device selects each kernel")
    if preflight != "off":
        raise NotImplementedError(
            f"preflight={preflight!r}: the port has no analyzer yet "
            "(ROADMAP Queue 1 #7); pass preflight='off'")


@dataclasses.dataclass
class Deployment:
    """One deployed serving runtime: engines + one front-door.

    ``classes[model]`` is the runtime traffic class (``"reason"``);
    ``designs`` / ``plans`` carry the DSE point and the derived serving
    plan, ``configs`` the model configs, ``variants`` the served variant,
    ``seed`` the seed the constants were drawn from."""

    engines: dict[str, Any]
    door: FrontDoor
    classes: dict[str, str]
    designs: dict[str, Any]
    plans: dict[str, Any]
    configs: dict[str, Any]
    variants: dict[str, str | None]
    traffic: Traffic
    budget: Budget
    seed: int = 0
    controller: OverloadController | None = None

    def serve(self, arrivals: Iterable[ArrivalRequest]) -> FrontDoorReport:
        """Serve one merged arrival stream through the front-door."""
        return self.door.serve(arrivals)

    def report(self) -> dict:
        """Per-model deployment record with the chosen DSE point, under the
        reference's keys (None where the port has no counterpart)."""
        out = {}
        for m, eng in self.engines.items():
            design, sched = self.designs[m], eng.schedules[self.variants[m]]
            serving = {
                "batch_size": eng.cfg.batch_size,
                "buckets": tuple(eng.cfg.buckets or ()),
                "max_inflight": eng.cfg.max_inflight,
                "schedule": eng.cfg.schedule,
                "variant": self.variants[m],
                "fused": {
                    "ok": sched.fused_ok,
                    "equivalence": sched.fused_equivalence,
                    "epsilon": sched.fused_epsilon,
                    "lowering_diff": sched.fused_lowering_diff,
                    "groups": eng.stats["fused_groups"],
                    "fallback_groups": eng.stats["fused_fallback_groups"],
                },
                "dispatches": eng.stats["dispatches"],
                "measured_requests": eng.stats["measured"]["requests"],
                "problems_per_s": eng.problems_per_s(),
            }
            out[m] = {
                "class": self.classes[m],
                "design": design.summary(),
                "searched_points": design.searched_points,
                "serving": serving,
                "backend": None,
                "mesh": None,
                "replicas": 1,
                "per_replica": None,
            }
        out["analysis"] = None
        ctl = self.controller
        out["control"] = None if ctl is None else {
            "slo_ms": {p: t.total_p99_ms for p, t in ctl.targets.items()},
            "queue_depth": ctl.cfg.queue_depth,
            "shed_policy": ctl.cfg.shed_policy,
            "tick_s": ctl.cfg.tick_s,
            "operating": {m: {"deadline_s": ctl.deadline_s(m),
                              "cap": ctl.cap(m)}
                          for m in sorted(ctl.bound())},
            "ticks": ctl.ticks,
            "decisions": len(ctl.decisions),
        }
        return out

    def summary(self) -> str:
        """One line per model: class, serving knobs, DSE tag."""
        lines = []
        for m, rec in self.report().items():
            if m in ("analysis", "control"):
                continue
            design = self.designs[m]
            knobs = " ".join(f"{k}={v}" for k, v in rec["serving"].items())
            lines.append(f"{m} [{rec['class']}]: {knobs} | dse={design.tag()} "
                         f"({design.searched_points} points) | mesh=n/a "
                         f"| backend=n/a")
        if self.controller is not None:
            ctl = self.controller
            slos = " ".join(f"{p}<= {t.total_p99_ms:.0f}ms"
                            for p, t in ctl.targets.items()) or "none"
            lines.append(f"control: slo [{slos}] "
                         f"queue_depth={ctl.cfg.queue_depth} "
                         f"shed={ctl.cfg.shed_policy} "
                         f"tick={ctl.cfg.tick_s * 1e3:.0f}ms")
        return "\n".join(lines)

    # -- synthetic traffic + warmup -----------------------------------------

    def _streams(self, n: int, seed: int):
        """Per-model lazy request streams + ground-truth thunks."""
        from repro_torch.configs import base as cbase

        streams, truths = {}, {}
        for i, m in enumerate(self.engines):
            factory, truth = cbase.REASON_WORKLOADS[m].make_requests(
                self.configs[m], n, seed=seed + i)
            streams[m], truths[m] = factory(), truth
        return streams, truths

    def synthetic_traffic(self, n: int, seed: int = 100,
                          priorities: str | Mapping[str, float] | None
                          = None):
        """A merged Poisson arrival feed of ``n`` requests per model at
        the traffic's offered rate.  Returns ``(arrivals, truths)`` where
        ``truths[model]()`` materialises ground truth lazily.
        ``priorities`` stamps a traffic-class mix onto the stream (see
        :func:`~repro_torch.serve.frontdoor.with_priorities`)."""
        streams, truths = self._streams(n, seed)
        arrivals = merge_arrivals(*(
            poisson_arrivals(m, s, self.traffic.rate_rps, seed=seed + j)
            for j, (m, s) in enumerate(streams.items())))
        if priorities is not None:
            arrivals = with_priorities(arrivals, priorities, seed=seed)
        return arrivals, truths

    def warmup(self):
        """Serve one group at every compiled bucket of every engine before
        traffic arrives, so online latencies never include a shape's first
        run (kernel builds, cuDNN and allocator set-up)."""
        from repro_torch.configs import base as cbase

        for m, eng in self.engines.items():
            for b in eng.cfg.buckets or (eng.cfg.batch_size,):
                factory, _ = cbase.REASON_WORKLOADS[m].make_requests(
                    self.configs[m], b, seed=5000 + b)
                eng.run(factory())
        return self


def deploy(workloads: Iterable[str], traffic: Traffic | None = None,
           budget: Budget | None = None, *, seed: int = 0,
           options: Mapping[str, Mapping[str, Any]] | None = None,
           backend=None, preflight: str = "off", device=None,
           clock: Callable[[], float] = time.perf_counter,
           sleep: Callable[[float], None] = time.sleep) -> Deployment:
    """Deploy NSAI workloads behind one front-door on one device.

    ``workloads``: model names of the runtime registry (``nvsa``, ``prae``,
    ``mimonet``, ``lvrf``).  ``options[model]`` passes ``make_config``
    knobs (``d``, ``nn_precision``) and an optional ``variant``.  The
    serving configuration is derived, not hand-set (see the module
    docstring).  ``device``: None means ``"cuda"`` (raises without CUDA);
    ``"cpu"`` serves on the plain versions."""
    from repro_torch.configs import base as cbase
    from repro_torch.core import dse
    from repro_torch.serve import runtime as rt
    from repro_torch.serve import schedule as sch
    from repro_torch.serve.reason import ReasonConfig

    traffic = traffic or Traffic()
    budget = budget or Budget()
    options = dict(options or {})
    models = rt.resolve_models("frontdoor", workloads)
    if not models:
        raise ValueError("deploy needs at least one workload")
    if preflight not in ("error", "warn", "off"):
        raise ValueError(f"preflight must be 'error', 'warn' or 'off', "
                         f"got {preflight!r}")
    _refuse_unported(budget, backend, preflight)
    dev = registry.resolve_device(device)

    engines: dict[str, Any] = {}
    designs: dict[str, Any] = {}
    plans: dict[str, Any] = {}
    configs: dict[str, Any] = {}
    variants: dict[str, str | None] = {}
    for i, m in enumerate(models):
        entry = cbase.REASON_WORKLOADS[m]
        opts = dict(options.get(m, {}))
        variant = opts.pop("variant", None) or entry.variants[0]
        cfg = entry.make_config(**opts)
        consts = entry.make_consts(cfg, torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, i]).generate_state(1)[0])))
        # generator step: trace the pipeline the schedule will execute and
        # explore the design space over its dataflow graph
        probe = cbase.compile_reason_schedule(
            m, cfg, variant=variant, consts=consts,
            batch_size=budget.max_batch, device=dev, fused=False)
        design = dse.explore(sch.ensure_graph(probe), max_pes=budget.max_pes)
        plan = dse.serving_plan(design, max_batch=budget.max_batch,
                                inflight_cap=budget.inflight_cap)
        eng = cbase.reason_engine(
            m, cfg,
            ReasonConfig(batch_size=plan.batch_size, schedule=plan.schedule,
                         variant=variant, max_inflight=plan.max_inflight,
                         buckets=plan.buckets),
            consts=consts, variants=(variant,), device=dev)
        # one call per group where the fused callable is negotiated exact
        if plan.schedule == "overlap" and eng.schedules[variant].fused_ok:
            eng.cfg.schedule = "fused"
        engines[m], designs[m], plans[m] = eng, design, plan
        configs[m], variants[m] = cfg, variant

    controller = None
    if budget.slo_ms is not None or budget.queue_depth is not None:
        validate_shed_policy(budget.shed_policy)
        controller = OverloadController(
            targets=slo_targets(budget.slo_ms),
            cfg=ControlConfig(queue_depth=budget.queue_depth,
                              shed_policy=budget.shed_policy))
        for m in models:
            controller.bind(m, deadline_s=traffic.deadline_s,
                            cap=plans[m].batch_size,
                            buckets=tuple(plans[m].buckets
                                          or (plans[m].batch_size,)))

    door = FrontDoor(engines,
                     FrontDoorConfig(deadline_s=traffic.deadline_s,
                                     poll_s=traffic.poll_s),
                     clock=clock, sleep=sleep, controller=controller)
    return Deployment(engines=engines, door=door,
                      classes=dict.fromkeys(models, "reason"),
                      designs=designs, plans=plans, configs=configs,
                      variants=variants, traffic=traffic, budget=budget,
                      seed=seed, controller=controller)
