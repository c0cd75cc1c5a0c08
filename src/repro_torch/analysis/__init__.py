"""Static analysis of the port: invariant linter + schedule conformance.

Port of ``repro.analysis``.  ``python -m repro_torch.analysis`` runs the
linter (rules R1, R2, R3, R5 over ``src/repro_torch``) and exits nonzero
on violations; ``python -m repro_torch.analysis conformance`` runs every
registry cell on stacked ranks and holds its collective log to the
family's published schedule (:mod:`repro_torch.analysis.conformance`).

The package root imports no torch, so pure-AST callers can lint without
the numeric stack: ``conformance`` is a submodule import away, and rule
R5 imports the registry only when it runs.
"""
from repro_torch.analysis.findings import (AllowEntry, Finding,
                                           apply_allowlist, load_report,
                                           parse_allowlist, violations,
                                           write_report)
from repro_torch.analysis.lint import (default_src_root, iter_sources,
                                       lint_file, render_findings, run_lint)

__all__ = [
    "AllowEntry", "Finding", "apply_allowlist", "parse_allowlist",
    "violations", "load_report", "write_report",
    "default_src_root", "iter_sources", "lint_file", "render_findings",
    "run_lint",
]
