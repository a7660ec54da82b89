"""Preflight CLI: ``python -m repro_torch.analyze [--workload all]
[--device cuda|cpu] [--format json]``.

The port of ``python -m repro.analyze``.  Runs the *full* static-analysis
matrix: every requested NSAI workload x variant is compiled across the
declared batch buckets on ``--device`` (constants drawn for their shapes;
the checks run on ``meta``), then checked for precision flow, host syncs,
retrace hazards (including double-trace determinism), registry
consistency (including the kernel probes on ``--device``), dispatch
floors, and the AST lint.  Exit code 0 iff no error-severity finding
survives; warnings never fail the run.

The reference's ``--plans`` becomes ``--device``: the port's lowering is
what the device selects (``backend/registry.py``), so a second plan is a
second device.  ``--device cuda`` (the default) raises without CUDA; on
the CPU the probes hold each kernel's plain version against its gather
lowering, on the card each kernel against its plain version.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPRO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    from repro_torch.analyze.preflight import preflight, reason_subjects
    from repro_torch.backend import registry
    from repro_torch.configs.base import REASON_WORKLOADS

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="Preflight static analysis over the port's serving stack")
    p.add_argument("--workload", default="all",
                   help="comma list of NSAI workloads, or 'all' "
                        "(default), or 'none' for lint+registry only")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--out", default=None,
                   help="also write the JSON findings to this path")
    p.add_argument("--d", type=int, default=32,
                   help="block dim for the compiled configs (default 32)")
    p.add_argument("--buckets", default="1,2,4",
                   help="batch-size buckets to compile (default 1,2,4)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device the schedules compile for and the kernel "
                        "probes run on (default cuda; raises without it)")
    p.add_argument("--lint-root", default=_REPRO_ROOT,
                   help="source tree for the AST lint (default: the "
                        "repro_torch package)")
    p.add_argument("--no-probe", action="store_true",
                   help="skip the empirical kernel probes")
    p.add_argument("--no-double-trace", action="store_true",
                   help="skip the double-trace determinism proof")
    args = p.parse_args(argv)

    def log(msg):
        if args.format == "text":
            print(f"[analyze] {msg}", file=sys.stderr)

    if args.workload == "all":
        models = list(REASON_WORKLOADS)
    elif args.workload == "none":
        models = []
    else:
        models = [m.strip() for m in args.workload.split(",") if m.strip()]
        unknown = [m for m in models if m not in REASON_WORKLOADS]
        if unknown:
            p.error(f"unknown workload(s) {unknown}; "
                    f"available: {tuple(REASON_WORKLOADS)}")
    device = registry.resolve_device(args.device)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    subjects = reason_subjects(models, args.d, buckets, device, log)
    report = preflight(subjects, lint_root=args.lint_root,
                       probe=not args.no_probe,
                       double_trace=not args.no_double_trace, device=device)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report.to_json(indent=2))
    if args.format == "json":
        print(report.to_json(indent=2))
    else:
        print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
