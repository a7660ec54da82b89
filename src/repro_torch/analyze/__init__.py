"""Preflight static analysis over the port's serving stack.

The port of ``repro.analyze``.  Two halves:

* artifact analysis over what the stack already produces: per-stage
  aten-op checks on ``meta`` (:mod:`repro_torch.analyze.artifacts`),
  retrace-hazard proofs (:mod:`repro_torch.analyze.retrace`),
  registry-vs-kernel consistency and kernel probes
  (:mod:`repro_torch.analyze.registry_check`);
* a repo-specific AST lint over the sources
  (:mod:`repro_torch.analyze.lint`).

Entry points: :func:`preflight` (what ``deploy()`` runs), the CLI
``python -m repro_torch.analyze`` (the full matrix incl. the kernel
probes on the card and double-trace determinism), and the individual
check modules.
"""

from repro_torch.analyze.findings import (AnalysisReport, Finding,
                                          PreflightError, RULES, finding)
from repro_torch.analyze.lint import lint_file, lint_tree
from repro_torch.analyze.preflight import preflight

__all__ = ["AnalysisReport", "Finding", "PreflightError", "RULES",
           "finding", "lint_file", "lint_tree", "preflight"]
