"""Finding/report datatypes + the preflight rule catalog.

The port of ``repro.analyze.findings``, with the reference's rule IDs,
severities and report surface.  Every check in ``repro_torch.analyze``
emits :class:`Finding`\\ s with a stable rule ID (``NSF0xx`` = artifact
analysis over compiled schedules / the aten ops of each stage / the kernel
registry, ``NSF1xx`` = AST lint over the serving sources).  IDs are
append-only: a retired rule keeps its number so historical JSON artifacts
stay interpretable.  NSF004 (fused-pipeline donation) is kept although the
port never emits it: its ``StagedSchedule`` has no jitted fused callable
and nothing to donate (see ``artifacts``).

:class:`AnalysisReport` is the aggregation every entry point returns:
the CLI (``python -m repro_torch.analyze``), ``deploy(preflight=...)``
and the tests all consume the same structure.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

SEVERITIES = ("error", "warning", "info")

# rule id -> (default severity, one-line description).  The catalog is the
# single source of truth the README table and the CLI listing render from.
RULES: dict[str, tuple[str, str]] = {
    "NSF001": ("error",
               "precision flow: silent f64 upcast, or a float downcast "
               "inside an int-quantized symbolic stage"),
    "NSF002": ("warning",
               "fake_quant amax reductions of equal rank disagree on axes "
               "within one stage (mixed global/per-problem scales)"),
    "NSF003": ("error",
               "host sync (.item(), a copy to another device, a "
               "data-dependent shape) inside a hot stage body"),
    "NSF004": ("error",
               "fused-pipeline donation disagrees with the schedule's "
               "platform (missing donor annotation off-CPU, or a CPU "
               "schedule that donates)"),
    "NSF005": ("error",
               "retrace hazard: bucket set not closed over admissible "
               "group sizes, non-batch shape variation across buckets, "
               "or a nondeterministic stage trace"),
    "NSF006": ("error",
               "registry capability predicate disagrees with the kernel "
               "(unregistered kernel dir, over-strict shape predicate, "
               "epsilon class tighter than observed error)"),
    "NSF007": ("warning",
               "dispatch_min_size floor with no dispatch-level call site "
               "(or a dispatch call site on a floorless kernel)"),
    "NSF101": ("error",
               "raw wall-clock call (time.*) outside an injectable "
               "clock/wall parameter default"),
    "NSF102": ("error",
               "host materialization (.item() / .cpu() / np.asarray / "
               "torch.cuda.synchronize) inside a stage body or a _make_* "
               "hot function"),
    "NSF103": ("error",
               "generator seeded without deriving the seed from the "
               "request in the same scope (requests would share one "
               "stream)"),
    "NSF104": ("error",
               "EngineProtocol implementation never stamps dispatch_t, or "
               "blocks before stamping it in submit()"),
    "NSF105": ("error",
               "overload-control hygiene: a queue append in serve/ not "
               "dominated by a bound check in the same function, or any "
               "time.* reference in a control-plane module (control/slo/"
               "sim must take explicit clocks)"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One preflight finding.

    ``where`` is a stable location string: ``path:line`` for lint rules,
    ``workload/variant[/stage]`` for artifact rules, ``kernel/lowering``
    for registry rules.
    """

    rule: str
    severity: str
    where: str
    message: str

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.rule} [{self.severity}] {self.where}: {self.message}"


def finding(rule: str, where: str, message: str,
            severity: str | None = None) -> Finding:
    """Build a finding at the rule's default severity (overridable)."""
    default = RULES.get(rule, ("error",))[0]  # Finding validates the rule
    return Finding(rule=rule, severity=severity or default,
                   where=where, message=message)


class PreflightError(RuntimeError):
    """Raised by ``deploy(preflight="error")`` when errors survive.

    Carries the full :class:`AnalysisReport` as ``.report`` so callers
    (and tests) can inspect exactly which rules fired without reparsing
    the exception text.
    """

    def __init__(self, report: "AnalysisReport"):
        self.report = report
        super().__init__("preflight failed:\n" + report.render())


@dataclasses.dataclass
class AnalysisReport:
    """Aggregated preflight outcome (what every entry point returns)."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    # what was covered: check names -> how many subjects each examined
    # (schedules traced, files linted, lowerings probed) so "no findings"
    # is distinguishable from "nothing ran"
    coverage: dict = dataclasses.field(default_factory=dict)

    def extend(self, more: Iterable[Finding]):
        self.findings.extend(more)

    def merge(self, other: "AnalysisReport") -> "AnalysisReport":
        self.findings.extend(other.findings)
        for k, v in other.coverage.items():
            self.coverage[k] = self.coverage.get(k, 0) + v
        return self

    def covered(self, check: str, n: int = 1):
        self.coverage[check] = self.coverage.get(check, 0) + n

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        """True when no error-severity finding survived."""
        return not self.errors

    def by_rule(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "coverage": dict(self.coverage),
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def render(self) -> str:
        """Human-readable multi-line rendering (the CLI text format)."""
        lines = []
        for f in sorted(self.findings,
                        key=lambda f: (SEVERITIES.index(f.severity), f.rule,
                                       f.where)):
            lines.append(f.render())
        cov = ", ".join(f"{k}={v}" for k, v in sorted(self.coverage.items()))
        verdict = "PASS" if self.ok else "FAIL"
        lines.append(f"preflight {verdict}: {len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s) [{cov}]")
        return "\n".join(lines)
