"""``deploy()``: the paper's generator -> serving-architecture loop.

The port of ``repro.serve.deploy`` on one device: the four reasoners and
the LM archs the port builds, freely mixed.  NSFlow's headline claim
(paper Sec III, V) is end to end: a design architecture generator reads
the workload's dataflow dependencies and emits the serving architecture.
For each NSAI workload:

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

An LM model has no DSE step, as in the reference: its ``ServeConfig``
comes from the budget's LM fields (``max_slots``, ``max_len``,
``decode_block``, ``max_new_tokens``) overridden by its options, and
``configs.base.lm_engine`` builds the slot-pool ``Engine`` over the arch's
smoke config, its parameters drawn from the same ``(seed, model index)``
seed.

The result is a :class:`Deployment`: one
:class:`~repro_torch.serve.frontdoor.FrontDoor` over every engine, with an
:class:`~repro_torch.serve.control.OverloadController` attached when the
budget sets ``slo_ms`` or ``queue_depth``.  ``Deployment.backend`` is
``registry.negotiate(device)``, the record of what the device selects per
kernel; ``Deployment.report()`` keeps the reference's keys and records
None where the port has no counterpart yet (the mesh point, the preflight
analysis).  A ``Deployment`` whose engine is a
:class:`~repro_torch.serve.replica.ReplicaPool` (built by hand with
``configs.base.reason_engine_pool``) reports and warms it as the
reference does.

What the port does not have yet raises ``NotImplementedError`` naming its
ROADMAP item, and is never ignored: a ``Budget`` with ``devices``,
``replicas`` or ``tp`` above 1 (deploy's replica count comes from the mesh
co-search, Queue 1 #3d and #6; LM replica pools and tensor-parallel
decode, #4 item 4), ``preflight=`` other than ``"off"`` (the analyzer,
#7).  ``backend=`` other than None raises too, by design (#3e): the
device selects each kernel, and no plan may send a CUDA tensor to a plain
version.  A recurrent arch (rwkv6-7b, recurrentgemma-9b) raises
``KeyError`` (#4 item 3).
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
    ``replicas="auto"``) raises ``NotImplementedError``.  ``max_slots``,
    ``max_len``, ``decode_block`` and ``max_new_tokens`` size every LM
    model's slot-pool engine."""

    max_pes: int = 4096           # AdArray PE budget handed to the DSE
    max_batch: int = 8            # admission-group ceiling (NSAI buckets)
    inflight_cap: int = 4         # ceiling on the DSE-derived window depth
    max_slots: int = 4            # LM slot-pool size
    max_len: int = 128            # LM per-slot KV capacity
    decode_block: int = 8         # LM tokens per decode block
    max_new_tokens: int = 24      # LM default generation budget
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
            f"tp={budget.tp}): deploy() serves one engine per model on one "
            "device; its replica count comes from the mesh co-search "
            "(ROADMAP Queue 1 #3d and #6; LM pools and tensor-parallel "
            "decode, #4 item 4). Build an NSAI pool by hand with "
            "configs.base.reason_engine_pool")
    if backend is not None:
        raise NotImplementedError(
            f"backend={backend!r}: the port takes no lowering override "
            "(ROADMAP Queue 1 #3e, by design): the tensor's device selects "
            "each kernel; pass device='cpu' for the plain versions")
    if preflight != "off":
        raise NotImplementedError(
            f"preflight={preflight!r}: the port has no analyzer yet "
            "(ROADMAP Queue 1 #7); pass preflight='off'")


@dataclasses.dataclass
class Deployment:
    """One deployed serving runtime: engines + one front-door.

    ``classes[model]`` is the runtime traffic class (``"reason"`` or
    ``"lm"``); ``designs`` / ``plans`` carry the DSE point and the derived
    serving plan of NSAI models (None for LM models), ``configs`` the
    model configs (an arch's smoke config for LM models), ``variants``
    the served variant, ``seed`` the seed the constants were drawn from, ``backend`` the
    device's :class:`~repro_torch.backend.registry.LoweringPlan` and
    ``options`` the per-model options ``deploy()`` was called with (a
    golden trace re-deploys from them)."""

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
    backend: registry.LoweringPlan | None = None
    options: dict = dataclasses.field(default_factory=dict)

    def _pool(self, m: str):
        """The model's ReplicaPool, or None when served by a bare engine."""
        from repro_torch.serve.replica import ReplicaPool

        eng = self.engines[m]
        return eng if isinstance(eng, ReplicaPool) else None

    def _base(self, m: str):
        """The model's representative engine (replica 0 of a pool), to read
        compile-time structure from; stats come from the pool (merged)."""
        pool = self._pool(m)
        return pool.replicas[0] if pool is not None else self.engines[m]

    def backend_record(self) -> dict | None:
        """The device's LoweringPlan as a plain record: platform, how it
        was chosen, and the route per registered kernel."""
        if self.backend is None:
            return None
        return {"platform": self.backend.platform,
                "source": self.backend.source,
                "lowerings": self.backend.tags()}

    def serve(self, arrivals: Iterable[ArrivalRequest]) -> FrontDoorReport:
        """Serve one merged arrival stream through the front-door."""
        return self.door.serve(arrivals)

    def report(self) -> dict:
        """Per-model deployment record with the chosen DSE point, under the
        reference's keys (None where the port has no counterpart).  Stats
        come off the engine, for a pool the sum over its replicas."""
        out = {}
        backend = self.backend_record()
        for m, eng in self.engines.items():
            pool, base = self._pool(m), self._base(m)
            design = self.designs[m]
            if self.classes[m] != "reason":
                out[m] = {
                    "class": self.classes[m], "design": None,
                    "searched_points": None,
                    "serving": {"max_slots": base.cfg.max_slots,
                                "max_len": base.cfg.max_len,
                                "decode_block": base.cfg.decode_block},
                    "backend": backend, "mesh": None, "replicas": 1,
                    "per_replica": None}
                continue
            sched = base.schedules[self.variants[m]]
            serving = {
                "batch_size": base.cfg.batch_size,
                "buckets": tuple(base.cfg.buckets or ()),
                "max_inflight": base.cfg.max_inflight,
                "schedule": base.cfg.schedule,
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
                "backend": backend,
                "mesh": None,
                "replicas": len(pool) if pool is not None else 1,
                "per_replica": pool.per_replica() if pool is not None else None,
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
        """One line per model: class, serving knobs, DSE and backend tags,
        and a pool's per-replica split."""
        lines = []
        backend = f"backend={self.backend.tag()}" if self.backend else \
            "backend=n/a"
        for m, rec in self.report().items():
            if m in ("analysis", "control"):
                continue
            design = self.designs[m]
            dse = (f"dse={design.tag()} ({design.searched_points} points)"
                   if design is not None else "dse=n/a (single nn stream)")
            knobs = " ".join(f"{k}={v}" for k, v in rec["serving"].items())
            lines.append(f"{m} [{rec['class']}]: {knobs} | {dse} | mesh=n/a "
                         f"| {backend}")
            if rec["per_replica"]:
                split = " ".join(
                    f"r{r['replica']}:{r['groups']}g/{r['requests']}req"
                    f"/{r['share']:.0%}" for r in rec["per_replica"])
                lines.append(f"  {m} replicas: {split}")
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
        """Per-model lazy request streams + NSAI ground-truth thunks.  An LM
        model's stream holds ``n`` prompts of ``min(16, max_len -
        max_new_tokens)`` tokens drawn uniformly from its vocabulary, the
        reference's."""
        from repro_torch.configs import base as cbase
        from repro_torch.serve.engine import Request

        streams, truths = {}, {}
        for i, m in enumerate(self.engines):
            if self.classes[m] == "reason":
                factory, truth = cbase.REASON_WORKLOADS[m].make_requests(
                    self.configs[m], n, seed=seed + i)
                streams[m], truths[m] = factory(), truth
            else:
                cfg, scfg = self.configs[m], self._base(m).cfg
                plen = max(1, min(16, scfg.max_len - scfg.max_new_tokens))
                rng = np.random.default_rng(seed + i)

                def lm_stream(rng=rng, vocab=cfg.vocab, plen=plen):
                    for uid in range(n):
                        yield Request(uid=uid, prompt=rng.integers(
                            0, vocab, (plen,)).astype(np.int32))

                streams[m] = lm_stream()
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
        traffic arrives, and run one slot pool's worth of requests through
        every LM engine, so online latencies never include a shape's first
        run (kernel builds, cuDNN and allocator set-up).  A pool warms
        every replica: each keeps its own warmed-shape set and device."""
        from repro_torch.configs import base as cbase

        for m in self.engines:
            pool = self._pool(m)
            subs = pool.replicas if pool is not None else [self.engines[m]]
            if self.classes[m] != "reason":
                for sub in subs:
                    streams, _ = self._streams(sub.cfg.max_slots, seed=5000)
                    sub.run(list(streams[m]))
                continue
            for sub in subs:
                for b in sub.cfg.buckets or (sub.cfg.batch_size,):
                    factory, _ = cbase.REASON_WORKLOADS[m].make_requests(
                        self.configs[m], b, seed=5000 + b)
                    sub.run(factory())
        return self


def deploy(workloads: Iterable[str], traffic: Traffic | None = None,
           budget: Budget | None = None, *, seed: int = 0,
           options: Mapping[str, Mapping[str, Any]] | None = None,
           backend=None, preflight: str = "off", device=None,
           clock: Callable[[], float] = time.perf_counter,
           sleep: Callable[[float], None] = time.sleep) -> Deployment:
    """Deploy a mixed set of workloads behind one front-door on one device.

    ``workloads``: model names of the runtime registry: NSAI workload ids
    (``nvsa``, ``prae``, ``mimonet``, ``lvrf``) and the port's LM arch ids
    (``llama3.2-3b``, ``granite-moe-1b-a400m``, ...), freely mixed.
    ``options[model]`` passes ``make_config`` knobs (``d``,
    ``nn_precision``) and an optional ``variant`` to an NSAI model, and
    ``ServeConfig`` field overrides to an LM model.  The NSAI serving
    configuration is derived, not hand-set (see the module docstring).
    ``device``: None means ``"cuda"`` (raises without CUDA); ``"cpu"``
    serves on the plain versions."""
    from repro_torch.configs import base as cbase
    from repro_torch.core import dse
    from repro_torch.serve import runtime as rt
    from repro_torch.serve import schedule as sch
    from repro_torch.serve.engine import ServeConfig
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
    lowering_plan = registry.negotiate(dev)

    engines: dict[str, Any] = {}
    classes: dict[str, str] = {}
    designs: dict[str, Any] = {}
    plans: dict[str, Any] = {}
    configs: dict[str, Any] = {}
    variants: dict[str, str | None] = {}
    for i, m in enumerate(models):
        opts = dict(options.get(m, {}))
        gen = torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))
        if m not in cbase.REASON_WORKLOADS:
            # resolve_models validated every name, so this is an LM arch:
            # no design point, the budget's slot pool and the options
            scfg = dataclasses.replace(
                ServeConfig(max_slots=budget.max_slots,
                            max_len=budget.max_len,
                            decode_block=budget.decode_block,
                            max_new_tokens=budget.max_new_tokens), **opts)
            engines[m], configs[m] = cbase.lm_engine(m, scfg, key=gen,
                                                     device=dev)
            classes[m], designs[m], plans[m], variants[m] = \
                "lm", None, None, None
            continue
        entry = cbase.REASON_WORKLOADS[m]
        variant = opts.pop("variant", None) or entry.variants[0]
        cfg = entry.make_config(**opts)
        consts = entry.make_consts(cfg, gen)
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
        configs[m], variants[m], classes[m] = cfg, variant, "reason"

    controller = None
    if budget.slo_ms is not None or budget.queue_depth is not None:
        validate_shed_policy(budget.shed_policy)
        controller = OverloadController(
            targets=slo_targets(budget.slo_ms),
            cfg=ControlConfig(queue_depth=budget.queue_depth,
                              shed_policy=budget.shed_policy))
        for m in models:
            if classes[m] == "reason":
                cap = plans[m].batch_size
                buckets = tuple(plans[m].buckets or (cap,))
            else:
                cap, buckets = budget.max_slots, None
            controller.bind(m, deadline_s=traffic.deadline_s, cap=cap,
                            buckets=buckets)

    door = FrontDoor(engines,
                     FrontDoorConfig(deadline_s=traffic.deadline_s,
                                     poll_s=traffic.poll_s),
                     clock=clock, sleep=sleep, controller=controller)
    return Deployment(engines=engines, door=door,
                      classes=classes,
                      designs=designs, plans=plans, configs=configs,
                      variants=variants, traffic=traffic, budget=budget,
                      seed=seed, controller=controller, backend=lowering_plan,
                      options={m: dict(options.get(m, {})) for m in models
                               if options.get(m)})
