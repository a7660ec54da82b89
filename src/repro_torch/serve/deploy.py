"""``deploy()``: the paper's generator -> serving-architecture loop.

The port of ``repro.serve.deploy``: the four reasoners and the LM archs
the port builds, freely mixed, on a pool of devices.  NSFlow's headline claim
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

An LM model (kind ``lm``, ``rwkv`` or ``griffin``; the recurrent kinds
prefill with exact-length scans) has no DSE step, as in the reference:
its ``ServeConfig`` comes from the budget's LM fields (``max_slots``,
``max_len``, ``decode_block``, ``max_new_tokens``) overridden by its
options, and ``configs.base.lm_engine_pool`` builds the slot-pool
``Engine`` over the arch's smoke config, its parameters drawn from the
same ``(seed, model index)`` seed.

The mesh side is the reference's co-search (``_mesh_plan`` over
``core.meshdse.serving_search``, under the H100 table of
``launch.mesh.HW``): the device pool is ``Budget.devices`` (None = every
visible CUDA device, or the one CPU device), and each model gets a mesh
point whose ``data`` axis is its replica count and whose ``model`` axis is
its tensor-parallel degree.  An NSAI model serves whole pipelines, one per
replica (``reason_engine_pool``, replica i on device ``i % pool``); an LM
model serves ``replicas`` engines (``lm_engine_pool``) or one engine
tensor-parallel over ``Budget.tp`` devices of the pool
(``distributed.world``).  A pool larger than the visible devices wraps
round-robin: ``Budget(devices=2)`` on one card runs two ranks there.
``replicas="auto"`` takes the search's winner.

The result is a :class:`Deployment`: one
:class:`~repro_torch.serve.frontdoor.FrontDoor` over every engine, with an
:class:`~repro_torch.serve.control.OverloadController` attached when the
budget sets ``slo_ms`` or ``queue_depth``.  ``Deployment.backend`` is
``registry.negotiate(device)``, the record of what the device selects per
kernel; ``Deployment.report()`` keeps the reference's keys, the mesh
point and replica count included.  A ``Deployment`` whose engine is a
:class:`~repro_torch.serve.replica.ReplicaPool` reports and warms it as
the reference does.  ``Deployment.close()`` ends the tensor-parallel
worlds.

``preflight`` gates the deployment as in the reference: ``"error"`` (the
default) runs the cheap tier of ``repro_torch.analyze`` over the reason
models' schedules (for a pool, its first replica's) and raises
``PreflightError`` when an error-severity finding survives; ``"warn"``
records the failing report and carries on; ``"off"`` skips it.  The
report lands in ``Deployment.report()["analysis"]``.

``backend=`` other than None raises ``NotImplementedError``, by design
(ROADMAP Queue 1 #3e): the device selects each kernel, and no plan may
send a CUDA tensor to a plain version.  ``Budget.tp`` beyond the pool
raises; it is never ignored for an LM model (an NSAI model serves whole
pipelines, as in the reference).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_leaves
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
    ``devices`` / ``replicas`` / ``tp`` size the mesh side of the search:
    ``devices`` is the device pool (None = the visible CUDA devices, or
    the CPU), ``replicas`` the data-parallel engine replica count per
    model (None = 1, ``"auto"`` = the data axis of the mesh-DSE winner
    under ``devices``), ``tp`` the tensor-parallel degree of each LM
    engine (NSAI pipelines serve whole, so it does not apply to them).
    ``max_slots``, ``max_len``, ``decode_block`` and ``max_new_tokens``
    size every LM model's slot-pool engine."""

    max_pes: int = 4096           # AdArray PE budget handed to the DSE
    max_batch: int = 8            # admission-group ceiling (NSAI buckets)
    inflight_cap: int = 4         # ceiling on the DSE-derived window depth
    max_slots: int = 4            # LM slot-pool size
    max_len: int = 128            # LM per-slot KV capacity
    decode_block: int = 8         # LM tokens per decode block
    max_new_tokens: int = 24      # LM default generation budget
    devices: int | None = None    # device pool (None = the visible devices)
    replicas: int | str | None = None  # DP engine replicas (None = 1)
    tp: int | None = None         # LM tensor-parallel degree (None = 1)
    slo_ms: float | Mapping[str, float] | None = None
    queue_depth: int | None = None
    shed_policy: str = "lowest-priority"


def _refuse_backend(backend) -> None:
    if backend is not None:
        raise NotImplementedError(
            f"backend={backend!r}: the port takes no lowering override "
            "(ROADMAP Queue 1 #3e, by design): the tensor's device selects "
            "each kernel; pass device='cpu' for the plain versions")


def _mesh_plan(n_params: float, d_model: int, n_layers: int, seq: int,
               batch: int, ndev: int, replicas, tp: int,
               kv_bytes_per_tok: float = 0.0):
    """Resolve (replica count, deployed MeshPoint) for one model, as the
    reference does.

    ``replicas="auto"`` lets the serving-mode mesh DSE pick: search the
    whole ``ndev`` pool with the model axis pinned to ``tp`` and take the
    winner's data axis.  An explicit/None replica count is honored as-is:
    the search then runs at ``chips = replicas x tp`` so the recorded
    point describes the factorization actually deployed (its ``bound_s``
    is the per-step roofline prediction for that mesh)."""
    from repro_torch.core import meshdse

    def pts_at(chips, b):
        pts = meshdse.serving_search(
            n_params, n_params, d_model, n_layers, seq, b,
            devices=chips, kv_bytes_per_tok=kv_bytes_per_tok,
            max_model=tp)
        return [p for p in pts if p.model == tp] or pts

    if replicas == "auto":
        point = pts_at(max(1, ndev), batch)[0]
        return point.data, point
    r = int(replicas or 1)
    # the search drops data axes that don't divide the batch; an explicit
    # replica count is honored regardless, so round the modeled batch up
    b = batch if (batch % r == 0 or batch < r) else -(-batch // r) * r
    pts = pts_at(r * tp, b)
    point = next((p for p in pts if p.data == r and p.model == tp), pts[0])
    return r, point


@dataclasses.dataclass
class Deployment:
    """One deployed serving runtime: engines + one front-door.

    ``classes[model]`` is the runtime traffic class (``"reason"`` or
    ``"lm"``); ``designs`` / ``plans`` carry the DSE point and the derived
    serving plan of NSAI models (None for LM models), ``configs`` the
    model configs (an arch's smoke config for LM models), ``variants``
    the served variant, ``seed`` the seed the constants were drawn from, ``backend`` the
    device's :class:`~repro_torch.backend.registry.LoweringPlan`,
    ``options`` the per-model options ``deploy()`` was called with (a
    golden trace re-deploys from them) and ``analysis`` the preflight
    :class:`~repro_torch.analyze.findings.AnalysisReport` (None when
    ``preflight="off"`` or for a hand-built Deployment)."""

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
    analysis: Any = None
    # the mesh-DSE outcome per model: the deployed MeshPoint (data =
    # replicas, model = TP degree; empty for a hand-built Deployment) and
    # the replica count (1 when absent)
    mesh: dict = dataclasses.field(default_factory=dict)
    replicas: dict = dataclasses.field(default_factory=dict)

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

    def close(self) -> None:
        """End every tensor-parallel engine's world (a no-op for engines on
        one device)."""
        for eng in self.engines.values():
            if hasattr(eng, "world"):
                eng.close()

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
        """Per-model deployment record with the chosen DSE point and mesh
        point, under the reference's keys.  Stats come off the engine, for
        a pool the sum over its replicas; ``replicas`` counts the engines
        that serve the model (a pool's length)."""
        out = {}
        backend = self.backend_record()
        for m, eng in self.engines.items():
            pool, base = self._pool(m), self._base(m)
            design = self.designs[m]
            point = self.mesh.get(m)
            mesh = point.record() if point is not None else None
            if self.classes[m] != "reason":
                out[m] = {
                    "class": self.classes[m], "design": None,
                    "searched_points": None,
                    "serving": {"max_slots": base.cfg.max_slots,
                                "max_len": base.cfg.max_len,
                                "decode_block": base.cfg.decode_block},
                    "backend": backend, "mesh": mesh,
                    "replicas": len(pool) if pool is not None else self.replicas.get(m, 1),
                    "per_replica": pool.per_replica() if pool is not None else None}
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
                "mesh": mesh,
                "replicas": len(pool) if pool is not None else self.replicas.get(m, 1),
                "per_replica": pool.per_replica() if pool is not None else None,
            }
        out["analysis"] = (self.analysis.to_dict()
                           if self.analysis is not None else None)
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
            point = self.mesh.get(m)
            mesh = (f"{point.tag()} replicas={rec['replicas']}"
                    if point is not None else "mesh=n/a")
            lines.append(f"{m} [{rec['class']}]: {knobs} | {dse} | {mesh} "
                         f"| {backend}")
            if rec["per_replica"]:
                split = " ".join(
                    f"r{r['replica']}:{r['groups']}g/{r['requests']}req"
                    f"/{r['share']:.0%}" for r in rec["per_replica"])
                lines.append(f"  {m} replicas: {split}")
        if self.analysis is not None:
            verdict = "PASS" if self.analysis.ok else "FAIL"
            lines.append(f"preflight {verdict}: "
                         f"{len(self.analysis.errors)} error(s), "
                         f"{len(self.analysis.warnings)} warning(s)")
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
           backend=None, preflight: str = "error", device=None,
           clock: Callable[[], float] = time.perf_counter,
           sleep: Callable[[float], None] = time.sleep) -> Deployment:
    """Deploy a mixed set of workloads behind one front-door.

    ``workloads``: model names of the runtime registry: NSAI workload ids
    (``nvsa``, ``prae``, ``mimonet``, ``lvrf``) and the port's LM arch ids
    (``llama3.2-3b``, ``granite-moe-1b-a400m``, ...), freely mixed.
    ``options[model]`` passes ``make_config`` knobs (``d``,
    ``nn_precision``) and an optional ``variant`` to an NSAI model, and
    ``ServeConfig`` field overrides to an LM model.  The NSAI serving
    configuration is derived, not hand-set, and so is the mesh (see the
    module docstring).  ``device``: None means ``"cuda"`` (raises without
    CUDA; the pool is then every visible card); ``"cpu"`` serves on the
    plain versions, and a pool of ``Budget.devices`` CPU devices.  ``preflight``: ``"error"`` (default),
    ``"warn"`` or ``"off"`` (see the module docstring)."""
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
    _refuse_backend(backend)
    dev = registry.resolve_device(device)
    lowering_plan = registry.negotiate(dev)
    visible = cbase.device_pool() if dev.type == "cuda" else (str(dev),)
    ndev = budget.devices or len(visible)
    pool = tuple(visible[i % len(visible)] for i in range(ndev))
    tp_eff = budget.tp or 1

    engines: dict[str, Any] = {}
    classes: dict[str, str] = {}
    designs: dict[str, Any] = {}
    plans: dict[str, Any] = {}
    configs: dict[str, Any] = {}
    variants: dict[str, str | None] = {}
    mesh: dict[str, Any] = {}
    replicas: dict[str, int] = {}
    for i, m in enumerate(models):
        opts = dict(options.get(m, {}))
        gen = torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))
        if m not in cbase.REASON_WORKLOADS:
            # resolve_models validated every name, so this is an LM arch:
            # no design point, the budget's slot pool and the options; the
            # mesh co-search pins the model axis to budget.tp, with the KV
            # term of the arch config (bytes per resident token across
            # every layer's K+V, f32 smoke params)
            from repro_torch.configs.registry import get_arch

            if tp_eff > ndev:
                raise ValueError(
                    f"Budget(tp={tp_eff}) exceeds the device pool of {ndev} "
                    f"{pool}: set Budget(devices=) to at least {tp_eff} (a "
                    "pool larger than the visible devices wraps round-robin)")
            scfg = dataclasses.replace(
                ServeConfig(max_slots=budget.max_slots,
                            max_len=budget.max_len,
                            decode_block=budget.decode_block,
                            max_new_tokens=budget.max_new_tokens), **opts)
            arch = get_arch(m)
            mcfg = arch.make_smoke()
            kv_bytes = (getattr(mcfg, "n_layers", 1) * 2
                        * getattr(mcfg, "n_kv_heads", getattr(mcfg, "n_heads", 1))
                        * getattr(mcfg, "head_dim", 64) * 4.0)
            r, point = _mesh_plan(
                float(cbase.param_count(arch, mcfg)), getattr(mcfg, "d_model", 128),
                getattr(mcfg, "n_layers", 1), seq=budget.max_len,
                batch=budget.max_slots, ndev=ndev, replicas=budget.replicas,
                tp=tp_eff, kv_bytes_per_tok=kv_bytes)
            engines[m], configs[m] = cbase.lm_engine_pool(
                m, scfg, key=gen, replicas=r, tp=tp_eff,
                device=dev if tp_eff == 1 else None, devices=pool)
            classes[m], designs[m], plans[m], variants[m] = \
                "lm", None, None, None
            mesh[m], replicas[m] = point, r
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
        # mesh co-search (serving mode): staged pipelines serve one whole
        # pipeline per device, so the model axis is pinned to 1 and the
        # winner's data axis is the engine replica count
        n_params = sum(t.numel() for t in tree_leaves(consts)
                       if isinstance(t, torch.Tensor))
        r, point = _mesh_plan(
            float(n_params), getattr(cfg, "d", 128),
            max(1, len(entry.stage_specs(cfg, variant))), seq=1,
            batch=budget.max_batch, ndev=ndev, replicas=budget.replicas, tp=1)
        eng = cbase.reason_engine_pool(
            m, cfg,
            ReasonConfig(batch_size=plan.batch_size, schedule=plan.schedule,
                         variant=variant, max_inflight=plan.max_inflight,
                         buckets=plan.buckets),
            consts=consts, variants=(variant,), replicas=r, device=dev)
        # one call per group where the fused callable is negotiated exact
        # (replicas share the compiled schedules, each keeps its own cfg)
        subs = eng.replicas if hasattr(eng, "replicas") else [eng]
        if plan.schedule == "overlap" and subs[0].schedules[variant].fused_ok:
            for sub in subs:
                sub.cfg.schedule = "fused"
        engines[m], designs[m], plans[m] = eng, design, plan
        configs[m], variants[m], classes[m] = cfg, variant, "reason"
        mesh[m], replicas[m] = point, r

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
    dep = Deployment(engines=engines, door=door, classes=classes,
                     designs=designs, plans=plans, configs=configs,
                     variants=variants, traffic=traffic, budget=budget,
                     seed=seed, controller=controller, backend=lowering_plan,
                     options={m: dict(options.get(m, {})) for m in models
                              if options.get(m)},
                     mesh=mesh, replicas=replicas)
    # the preflight gate: the cheap tier over the schedules the engines
    # serve (a pool's first replica's; on meta, so nothing launches), the
    # memoized serving lint and the static registry checks
    if preflight != "off":
        from repro_torch.analyze.findings import PreflightError
        from repro_torch.analyze.preflight import preflight as run_preflight

        dep.analysis = run_preflight(
            [(dep._base(m).schedules[variants[m]], configs[m],
              cbase.REASON_WORKLOADS[m], variants[m])
             for m in models if classes[m] == "reason"])
        if preflight == "error" and not dep.analysis.ok:
            raise PreflightError(dep.analysis)
    return dep
