"""The orchestrated preflight pass: what ``deploy()`` and the CLI run.

The port of ``repro.analyze.preflight``.  :func:`preflight` composes the
four check families over a set of *subjects* (compiled schedules with
their configs / workload entries) plus the AST lint and the registry
checks.  Two cost tiers share this one entry point:

* ``deploy()`` runs the cheap tier on every deployment: the per-stage op
  checks over the schedules it just compiled (on ``meta``: no device
  works), the (mtime-memoized) lint over ``serve/``, and the static
  registry checks.  No kernel launches.
* the CLI (``python -m repro_torch.analyze``) runs the full tier: every
  declared (workload x variant x bucket) combination, double-trace
  determinism, and the empirical kernel probes on ``device``.
"""

from __future__ import annotations

import os
from typing import Iterable

from repro_torch.analyze import lint as lint_mod
from repro_torch.analyze import registry_check
from repro_torch.analyze.artifacts import check_schedule
from repro_torch.analyze.findings import AnalysisReport
from repro_torch.analyze.retrace import check_retrace

_REPRO_ROOT = os.path.normpath(
    os.path.join(os.path.dirname(__file__), os.pardir))
_SERVE_DIR = os.path.join(_REPRO_ROOT, "serve")


def preflight(subjects: Iterable = (), *, lint_root: str | None = None,
              probe: bool = False, double_trace: bool = False,
              device=None) -> AnalysisReport:
    """Run every preflight family and return the merged report.

    ``subjects``: iterables of ``(sched, cfg, entry, variant)``; ``cfg``
    / ``entry`` / ``variant`` may be None (the op checks still run; the
    cross-bucket spec check needs the entry).  ``lint_root`` defaults to
    the serving sources.  ``probe`` / ``double_trace`` enable the
    expensive tier (empirical kernel probes on ``device``, None =
    ``"cuda"``, which raises without CUDA; double-trace determinism).
    """
    report = AnalysisReport()
    report.merge(lint_mod.lint_tree(lint_root or _SERVE_DIR))
    report.merge(registry_check.check_registry(probe=probe, device=device))
    for subject in subjects:
        sched, cfg, entry, variant = (tuple(subject) + (None,) * 4)[:4]
        report.merge(check_schedule(sched, cfg=cfg))
        report.merge(check_retrace(sched, entry=entry, cfg=cfg,
                                   variant=variant,
                                   double_trace=double_trace))
        report.covered("schedules")
    return report


def reason_subjects(models: Iterable[str], d: int, buckets: tuple[int, ...],
                    device=None, log=None) -> list[tuple]:
    """``(sched, cfg, entry, variant)`` for every variant of each NSAI
    workload in ``models``, compiled at block dim ``d`` over ``buckets`` on
    ``device`` (None = ``"cuda"``).  Constants are drawn for their shapes
    only: the checks run on ``meta``."""
    from repro_torch.configs.base import (REASON_WORKLOADS,
                                          compile_reason_schedule)

    subjects = []
    for model in models:
        entry = REASON_WORKLOADS[model]
        cfg = entry.make_config(d=d)
        for variant in entry.variants:
            if log is not None:
                log(f"compiling {model}/{variant} on {device} "
                    f"(buckets {buckets})")
            sched = compile_reason_schedule(model, cfg, variant,
                                            batch_size=buckets, device=device)
            subjects.append((sched, cfg, entry, variant))
    return subjects
