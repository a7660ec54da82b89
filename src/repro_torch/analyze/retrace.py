"""Retrace-hazard detection over bucketed schedules (NSF005).

The port of ``repro.analyze.retrace``.  The serving stack's latency model
assumes a *closed* signature set: every admissible admission-group size
maps onto a compiled bucket, every bucket's specs differ from its
siblings only in the batch axis, and running a stage twice runs the same
ops.  Those are also what a CUDA graph captured per (variant, bucket)
needs: a stage whose op sequence changes from call to call, or whose
shapes follow the group size outside the batch axis, cannot be replayed.
Three checks:

* **bucket closure**: ``covering_bucket(n)`` must resolve inside the
  declared bucket set for every group size up to the largest bucket;
* **batch-axis invariance**: across buckets, each input-spec leaf may
  vary only in axis 0 (and axis 0 must equal the bucket); leaves are
  named by their path, as ``jax.tree_util.keystr`` names them;
* **double-trace determinism** (``double_trace=True``, the CLI/test
  mode): each stage is recorded twice on ``meta`` with
  ``artifacts.trace_stage`` and the two op sequences (name, shapes,
  dtypes, non-tensor arguments, object addresses masked) and
  ``registry.record_kernels()`` lists compared; any Python-side state
  leaking into a stage (a counter, a host RNG draw) shows up as a diff.
"""

from __future__ import annotations

from repro_torch.analyze.artifacts import trace_stage
from repro_torch.analyze.findings import AnalysisReport, finding
from repro_torch.common.tree import keystr, tree_flatten_with_path


def check_bucket_closure(sched, where) -> list:
    out = []
    buckets = tuple(sched.batch_buckets)
    if not buckets:
        return out
    for n in range(1, max(buckets) + 1):
        try:
            b = sched.covering_bucket(n)
        except Exception as e:  # noqa: BLE001 - any raise is the finding
            out.append(finding(
                "NSF005", where,
                f"covering_bucket({n}) raises ({e}): admission groups of "
                f"{n} have no compiled bucket in {buckets}"))
            continue
        if b not in buckets:
            out.append(finding(
                "NSF005", where,
                f"covering_bucket({n}) = {b} is not a declared bucket "
                f"{buckets}: the group would run a fresh signature"))
    return out


def check_bucket_specs(entry, cfg, variant, buckets, where) -> list:
    """Batch-axis invariance of ``entry.input_specs`` across buckets."""
    out = []
    if not buckets:
        return out
    per_bucket = {}
    for b in buckets:
        specs = entry.input_specs(cfg, b, variant)
        per_bucket[b] = {keystr(path): leaf
                         for path, leaf in tree_flatten_with_path(specs)}
    keys = {b: set(m) for b, m in per_bucket.items()}
    if len({frozenset(k) for k in keys.values()}) != 1:
        out.append(finding(
            "NSF005", where,
            f"input-spec structure differs across buckets {buckets}: "
            "the stage signature set is not closed"))
        return out
    b0 = buckets[0]
    for key, leaf0 in per_bucket[b0].items():
        for b in buckets:
            leaf = per_bucket[b][key]
            if leaf.dtype != leaf0.dtype:
                out.append(finding(
                    "NSF005", f"{where}{key}",
                    f"dtype varies across buckets ({leaf0.dtype} at "
                    f"bucket {b0}, {leaf.dtype} at {b})"))
                break
            if not leaf.shape or leaf.shape[0] != b:
                out.append(finding(
                    "NSF005", f"{where}{key}",
                    f"leading axis {leaf.shape} at bucket {b} is not the "
                    "bucket size: the batch axis contract is broken"))
                break
            if leaf.shape[1:] != leaf0.shape[1:]:
                out.append(finding(
                    "NSF005", f"{where}{key}",
                    f"non-batch axes vary with the bucket "
                    f"({leaf0.shape} at {b0} vs {leaf.shape} at {b}): "
                    "group size leaks into a non-batch dimension, so the "
                    "signature set is unbounded"))
                break
    return out


def _signature(tr) -> tuple:
    return tuple(op.signature() for op in tr.ops), tuple(tr.kernels)


def check_trace_determinism(sched, where) -> list:
    """Record every stage twice; differing op sequences = a stage that
    runs differently per group."""
    out = []
    if sched.input_specs is None or sched.consts_spec is None:
        return out
    specs = sched.input_specs
    for stage in sched.stages:
        first = trace_stage(stage, sched.consts_spec, specs)
        second = trace_stage(stage, sched.consts_spec, specs)
        if _signature(first) != _signature(second):
            out.append(finding(
                "NSF005", f"{where}/{stage.name}",
                f"stage {stage.name!r} runs differently on consecutive "
                "traces: Python-side state leaks into its ops, so no "
                "signature (or captured graph) holds across groups"))
        if first.out_specs is None:
            break
        specs = first.out_specs
    return out


def check_retrace(sched, entry=None, cfg=None, variant: str | None = None,
                  double_trace: bool = False) -> AnalysisReport:
    """All retrace-hazard checks for one compiled schedule.

    ``entry``/``cfg`` (a ``REASON_WORKLOADS`` entry and its config)
    enable the cross-bucket spec check; ``double_trace`` adds the
    determinism proof (CLI/tests: deploy()'s cheap preflight skips it).
    """
    report = AnalysisReport()
    where = f"{sched.workload}/{sched.variant}"
    report.extend(check_bucket_closure(sched, where))
    report.covered("bucket_closure")
    if entry is not None and cfg is not None and sched.batch_buckets:
        report.extend(check_bucket_specs(
            entry, cfg, variant or sched.variant,
            tuple(sched.batch_buckets), where))
        report.covered("bucket_specs")
    if double_trace:
        report.extend(check_trace_determinism(sched, where))
        report.covered("double_trace")
    return report
