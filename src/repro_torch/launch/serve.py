"""Serving launcher: ``python -m repro_torch.launch.serve --workload <class>``.

The port of ``repro.launch.serve``, with the reference's flags and two of
its own: ``--device`` (``cuda``, the default, or ``cpu`` for the plain
versions) and ``--devices``, the device pool that ``--tp`` and
``--replicas`` take from (a comma list; default every visible CUDA
device, or the CPU).  ``--tp N`` serves the LM tensor-parallel over the
pool's first N devices (``distributed.world``): ``--devices
cuda:0,cuda:0`` runs two ranks on one card, ``--devices cpu,cpu`` two on
the CPU.

The traffic classes (and their model lists) derive from the serving
runtime registry — ``repro_torch.serve.runtime.TRAFFIC_CLASSES`` — not a
hand-listed tuple; adding a workload/arch there is all it takes to show
up here:

- ``--workload lm`` (default): continuous-batching generation with the
  slot-pool engine (smoke-scale models).
- ``--workload reason``: batched NSAI reasoning through the generic
  N-stage ReasonEngine.  ``--model`` choices derive from the workload
  registry (``configs.base.REASON_WORKLOADS``: nvsa, prae, mimonet, lvrf);
  the pipeline is compiled by ``serve.schedule``, with the
  overlap/sequential/fused schedule and Tab. IV precision knobs exposed,
  and a per-stage timing breakdown printed for the sequential schedule.
- ``--workload frontdoor``: *online mixed* serving through
  ``repro_torch.serve.deploy`` — any mix of LM archs and NSAI workloads
  (``--models stablelm-3b,nvsa,mimonet``) behind one deadline-batched,
  shape-bucketed front-door fed by per-model Poisson arrival streams at
  ``--rate`` req/s.  The NSAI engines' serving knobs (batch buckets,
  in-flight depth, schedule) are DSE-derived from each workload's traced
  dataflow graph under ``--max-pes``; the report covers both request
  classes (tokens/s for LM rows, problems/s for NSAI rows) plus
  per-model p50/p95/p99 queueing + service latency and bucket usage.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base as cbase
from repro_torch.serve import runtime as rt


def device_pool(args) -> tuple:
    """The pool ``--tp`` / ``--replicas`` take from: ``--devices``, else
    every visible CUDA device (``--device cuda``) or the CPU."""
    if args.devices:
        return tuple(d.strip() for d in args.devices.split(",") if d.strip())
    if torch.device(args.device).type == "cuda":
        return cbase.device_pool()
    return (args.device,)


def _require_devices(n: int, what: str, pool: tuple):
    """Mesh flags need that many devices in the pool; fail with the escape
    hatch."""
    if n > len(pool):
        raise SystemExit(
            f"{what}={n} needs {n} devices but the device pool has {len(pool)} "
            f"{pool} — pass --devices with {n} entries (--devices "
            f"{','.join(['cuda:0'] * n)} over-subscribes one card, --devices "
            f"{','.join(['cpu'] * n)} runs on the CPU)")


def serve_reason(args):
    from repro_torch.serve.reason import ReasonConfig
    from repro_torch.serve.replica import ReplicaPool

    entry = cbase.REASON_WORKLOADS[args.model]
    cfg = entry.make_config(d=args.d, nn_precision=args.nn_precision,
                            symb_precision=args.symb_precision)
    consts = entry.make_consts(cfg, torch.Generator().manual_seed(0))
    variant = "oracle" if args.oracle else entry.variants[0]
    if variant not in entry.variants:
        raise SystemExit(f"{args.model} has no {variant!r} variant "
                         f"(available: {entry.variants})")
    engine = cbase.reason_engine_pool(
        args.model, cfg,
        ReasonConfig(batch_size=args.batch_size, schedule=args.schedule,
                     variant=variant),
        consts=consts, variants=(variant,), replicas=args.replicas,
        device=args.device)
    base = engine.replicas[0] if isinstance(engine, ReplicaPool) else engine
    sched = base.schedules[variant]
    print(f"[serve] {args.model}: {sched.describe()}")
    if args.schedule == "fused":
        print(f"[serve] fused negotiation: ok={sched.fused_ok} "
              f"eq={sched.fused_equivalence} "
              f"lowering_diff={list(sched.fused_lowering_diff) or '-'}")

    stream, truth = entry.make_requests(cfg, args.requests, seed=0)
    t0 = time.time()
    results = engine.run(stream())
    dt = time.time() - t0
    acc = entry.score(results, truth())
    # report the config's *actual* precision — workloads without Tab. IV
    # knobs (mimonet, lvrf) ignore the CLI flags and run fp32
    nn_p = getattr(cfg, "nn_precision", "fp32")
    sy_p = getattr(cfg, "symb_precision", "fp32")
    if (nn_p, sy_p) != (args.nn_precision, args.symb_precision):
        print(f"[serve] note: {args.model} has no precision knobs; "
              f"requested nn:{args.nn_precision}/symb:{args.symb_precision} "
              "ignored")
    print(f"[serve] model={args.model} schedule={args.schedule} "
          f"variant={variant} precision=nn:{nn_p}/symb:{sy_p}")
    print(f"[serve] {args.requests} problems in {dt:.1f}s "
          f"({args.requests / dt:.1f} problems/s, "
          f"{engine.stats['batches']} batches), accuracy {acc:.3f}")
    if isinstance(engine, ReplicaPool):
        split = " ".join(f"r{r['replica']}:{r['groups']}g/{r['requests']}req"
                         for r in engine.per_replica())
        print(f"[serve] {len(engine)} replicas: {split}")
    if args.schedule == "sequential":
        for name, t in engine.stats["stage_time_s"].get(variant, {}).items():
            print(f"[serve]   stage {name:12s} {t:.3f}s")
    return results


def _parse_class_spec(flag: str, spec: str, scalar_ok: bool):
    """Parse ``60`` / ``interactive=60,standard=240`` style flags into a
    float or ``{class: float}`` mapping, with the error naming the flag
    and the offending token (class names validate against
    :data:`repro_torch.serve.slo.PRIORITIES`)."""
    from repro_torch.serve.slo import validate_priority

    spec = spec.strip()
    if "=" not in spec:
        if not scalar_ok:
            raise SystemExit(f"{flag}: expected a priority class or "
                             f"class=weight list, got {spec!r}")
        try:
            return float(spec)
        except ValueError:
            raise SystemExit(f"{flag}: expected a number or a "
                             f"class=value list, got {spec!r}") from None
    out = {}
    for part in spec.split(","):
        name, eq, val = part.partition("=")
        if not eq:
            raise SystemExit(f"{flag}: malformed entry {part!r} "
                             "(expected class=value)")
        try:
            out[validate_priority(name.strip())] = float(val)
        except ValueError as e:
            raise SystemExit(f"{flag}: {e}") from None
    return out


def serve_frontdoor(args):
    from repro_torch.serve import SHED_POLICIES, Budget, Traffic, deploy
    from repro_torch.serve.slo import PRIORITY_RANK

    models = rt.resolve_models(
        "frontdoor", [m.strip() for m in args.models.split(",") if m.strip()])
    nsai = {m for m in models if m in cbase.REASON_WORKLOADS}
    options = {m: {"d": args.d, "nn_precision": args.nn_precision,
                   "symb_precision": args.symb_precision,
                   **({"variant": "oracle"} if args.oracle else {})}
               for m in nsai}
    slo_ms = (None if args.slo_ms is None else
              _parse_class_spec("--slo-ms", args.slo_ms, scalar_ok=True))
    if args.shed_policy not in SHED_POLICIES:
        raise SystemExit(f"--shed-policy: unknown shed policy "
                         f"{args.shed_policy!r} (known: "
                         f"{', '.join(SHED_POLICIES)})")
    if args.queue_depth is not None and args.queue_depth < 1:
        raise SystemExit(f"--queue-depth: must be >= 1, "
                         f"got {args.queue_depth}")
    priorities = None
    if args.priority is not None:
        if "=" in args.priority:
            priorities = _parse_class_spec("--priority", args.priority,
                                           scalar_ok=False)
        elif args.priority in PRIORITY_RANK:
            priorities = args.priority
        else:
            raise SystemExit(f"--priority: unknown priority class "
                             f"{args.priority!r} (known: "
                             f"{', '.join(sorted(PRIORITY_RANK))})")
    deployment = deploy(
        models,
        traffic=Traffic(rate_rps=args.rate,
                        deadline_s=args.deadline_ms / 1e3),
        budget=Budget(max_pes=args.max_pes, max_batch=args.batch_size,
                      inflight_cap=args.max_inflight,
                      max_slots=args.slots, max_len=args.cache_len,
                      decode_block=args.decode_block,
                      max_new_tokens=args.max_new,
                      devices=len(device_pool(args)) if args.devices else None,
                      replicas=args.replicas if args.replicas != 1 else None,
                      tp=args.tp if args.tp != 1 else None,
                      slo_ms=slo_ms, queue_depth=args.queue_depth,
                      shed_policy=args.shed_policy),
        options=options, preflight=args.preflight, device=args.device)
    for line in deployment.summary().splitlines():
        print(f"[deploy] {line}")
    if deployment.analysis is not None:
        for f in deployment.analysis.findings:
            print(f"[preflight] {f.render()}")
    deployment.warmup()  # compile every serving shape before taking latencies
    print(f"[frontdoor] {len(models)} models x {args.requests} requests, "
          f"poisson {args.rate:.1f} req/s each, deadline "
          f"{args.deadline_ms:.0f}ms")
    arrivals, truths = deployment.synthetic_traffic(args.requests,
                                                    priorities=priorities)
    report = deployment.serve(arrivals)
    for line in report.summary().splitlines():
        print(f"[frontdoor] {line}")
    for model in sorted(truths):
        acc = cbase.REASON_WORKLOADS[model].score(report.results[model],
                                                  truths[model]())
        print(f"[frontdoor] {model} accuracy {acc:.3f}")
    deployment.close()
    return report


def serve_lm(args):
    from repro_torch.serve.engine import Request, ServeConfig

    eng, cfg = cbase.lm_engine_pool(
        args.arch,
        ServeConfig(max_new_tokens=args.max_new, max_slots=args.slots,
                    max_len=args.cache_len, decode_block=args.decode_block,
                    temperature=args.temperature, top_k=args.top_k,
                    eos_id=args.eos_id),
        replicas=args.replicas, tp=args.tp,
        device=args.device if args.tp == 1 else None,
        devices=device_pool(args) if args.tp > 1 or args.devices else None)
    # (stateful_prefill for rwkv/griffin is forced by the serve_fns tag)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, (args.prompt_len,)).astype(np.int32))
        for i in range(args.requests)]
    t0 = time.time()
    results = eng.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.tokens) for r in results.values())
    print(f"[serve] arch={args.arch} requests={args.requests} "
          f"slots={args.slots} prompt={args.prompt_len} new={args.max_new}")
    from repro_torch.serve.replica import ReplicaPool
    if isinstance(eng, ReplicaPool):
        util = " ".join(f"r{i}:{e.utilization():.0%}"
                        for i, e in enumerate(eng.replicas))
    else:
        util = f"{eng.utilization():.0%}"
    print(f"[serve] {dt:.1f}s total, {toks/dt:.1f} tok/s, "
          f"slot utilization {util} (smoke config)")
    if args.tp > 1:
        devs = " ".join(f"r{i}:{d}" for i, d in enumerate(eng.devices))
        print(f"[serve] tensor-parallel over {args.tp} ranks: {devs}; "
              f"collectives on rank 0: "
              f"{ {k: n for k, (n, _) in eng.collectives.items()} }")
        eng.close()
    print(f"[serve] sample output ids: {results[0].tokens[:12].tolist()}")
    return results


def main():
    ap = argparse.ArgumentParser()
    # traffic classes + per-class model lists derive from the runtime
    # registry (repro_torch.serve.runtime.TRAFFIC_CLASSES)
    ap.add_argument("--workload", default="lm",
                    choices=sorted(rt.TRAFFIC_CLASSES))
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=sorted(rt.TRAFFIC_CLASSES["lm"].models()))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--decode-block", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--eos-id", type=int, default=None)
    # reasoning workload knobs (--model choices derive from the registry)
    ap.add_argument("--model", default="nvsa",
                    choices=sorted(rt.TRAFFIC_CLASSES["reason"].models()))
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--schedule", default="overlap",
                    choices=("overlap", "sequential", "fused"))
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--nn-precision", default="fp32",
                    choices=("fp32", "bf16", "int8", "int4"))
    ap.add_argument("--symb-precision", default="fp32",
                    choices=("fp32", "bf16", "int8", "int4"))
    ap.add_argument("--oracle", action="store_true",
                    help="ground-truth perception (symbolic stream only)")
    # online front-door knobs (--workload frontdoor, served via deploy())
    ap.add_argument("--models", default="nvsa,mimonet,lvrf",
                    help="comma list of workloads (NSAI and/or LM archs) "
                         "multiplexed behind the front-door")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="per-model Poisson offered load, req/s")
    ap.add_argument("--deadline-ms", type=float, default=20.0,
                    help="admission-group deadline after first arrival")
    ap.add_argument("--max-inflight", type=int, default=4,
                    help="cap on the DSE-derived in-flight window depth")
    ap.add_argument("--max-pes", type=int, default=4096,
                    help="AdArray PE budget handed to the DSE")
    # devices and mesh knobs: data-parallel engine replicas + LM tensor
    # parallelism over the device pool
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (the plain versions)")
    ap.add_argument("--devices", default=None,
                    help="the device pool, a comma list, e.g. cuda:0,cuda:0 "
                         "(default: every visible CUDA device, or the CPU)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas per model "
                         "(each replica's consts/params on its own device)")
    ap.add_argument("--tp", type=int, default=1,
                    help="LM tensor-parallel degree (a world of tp processes, "
                         "each holding its cut of the params by "
                         "distributed.sharding_rules)")
    ap.add_argument("--preflight", default="error",
                    choices=("error", "warn", "off"),
                    help="static-analysis gate before serving: fail the "
                         "deploy on error findings (default), report only, "
                         "or skip")
    # overload control plane (--workload frontdoor; see repro_torch.serve.control)
    ap.add_argument("--slo-ms", default=None,
                    help="total-latency p99 SLO: a scalar (interactive "
                         "target; standard gets 4x, batch best-effort) or "
                         "a class=ms list, e.g. interactive=60,standard=240."
                         "  Attaches the feedback controller")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="bound each model's pending queue; arrivals "
                         "beyond it shed by --shed-policy instead of "
                         "growing the queue without bound")
    ap.add_argument("--shed-policy", default="lowest-priority",
                    help="lowest-priority (evict newest lowest-class "
                         "queued work) or tail-drop (reject the arrival)")
    ap.add_argument("--priority", default=None,
                    help="traffic-class stamp for synthetic arrivals: one "
                         "class name or a class=weight mix, e.g. "
                         "interactive=3,standard=5,batch=2")
    args = ap.parse_args()

    if args.replicas < 1 or args.tp < 1:
        raise SystemExit(f"--replicas/--tp must be >= 1 "
                         f"(got {args.replicas}/{args.tp})")
    pool = device_pool(args)
    _require_devices(args.replicas, "--replicas", pool)
    _require_devices(args.tp, "--tp", pool)
    if args.workload == "reason":
        return serve_reason(args)
    if args.workload == "frontdoor":
        return serve_frontdoor(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
