"""AST invariant linter over ``src/repro_torch`` (rules R1, R2, R3, R5).

Port of ``repro.analysis.lint``: :func:`iter_sources` walks the port's
package by default.

Per-file rules parse each source once and run every applicable rule's
AST check; repo-level rules (R5) probe the live registry.  Findings
matched by a rule's allowlist are *marked*, not dropped - they stay in
the report with the suppression reason, so the evidence and the excuse
travel together.  ``run_lint`` is pure (no process exit, no printing);
the CLI in ``__main__`` layers exit codes on top.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import (Finding, apply_allowlist,
                                         lint_report, violations)
from repro_torch.analysis.rules import Rule, all_rules

__all__ = ["default_src_root", "iter_sources", "lint_file", "run_lint",
           "render_findings", "violations"]


PACKAGE = "repro_torch"


def default_src_root() -> str:
    """The ``src`` directory containing the ``repro_torch`` package."""
    here = os.path.dirname(os.path.abspath(__file__))   # src/repro_torch/analysis
    return os.path.dirname(os.path.dirname(here))


def iter_sources(src_root: str, package: str = PACKAGE) -> List[str]:
    """All ``<package>/**/*.py`` paths under ``src_root``, relative to
    it (posix separators)."""
    out = []
    pkg_root = os.path.join(src_root, package)
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), src_root)
                out.append(rel.replace(os.sep, "/"))
    return out


def lint_file(path: str, source: str,
              rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run every applicable per-file rule over one source blob.

    ``path`` is the repo-relative posix path the rules filter on; the
    file need not exist on disk (tests feed synthetic snippets).
    """
    active = list(rules) if rules is not None else \
        list(all_rules().values())
    tree = ast.parse(source, filename=path)
    findings: List[Finding] = []
    for rule in active:
        if rule.check is None or not rule.applies(path):
            continue
        findings.extend(rule.check(tree, path, source))
    return findings


def run_lint(src_root: Optional[str] = None,
             rules: Optional[Dict[str, Rule]] = None,
             allow_dir: Optional[str] = None,
             with_registry: bool = True,
             ) -> Tuple[List[Finding], int]:
    """Lint the whole tree; returns (findings, files_scanned).

    Findings are allowlist-marked and sorted (path, line, rule).
    ``with_registry=False`` skips repo-level rules (R5 imports the
    registry, which pulls in torch - pure-AST callers can opt out).
    """
    root = src_root or default_src_root()
    table = rules if rules is not None else all_rules()
    findings: List[Finding] = []
    paths = iter_sources(root)
    for rel in paths:
        with open(os.path.join(root, rel)) as fh:
            source = fh.read()
        findings.extend(lint_file(rel, source, rules=table.values()))
    if with_registry:
        for rule in table.values():
            if rule.check_repo is not None:
                findings.extend(rule.check_repo())
    for rule in table.values():
        entries = rule.allowlist(allow_dir)
        if entries:
            apply_allowlist([f for f in findings if f.rule == rule.id],
                            entries)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings, len(paths)


def render_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "lint: clean"
    lines = [f.render() for f in findings]
    bad = violations(findings)
    lines.append(f"lint: {len(bad)} violation(s), "
                 f"{len(findings) - len(bad)} allowlisted")
    return "\n".join(lines)


def make_lint_report(findings: Sequence[Finding],
                     files_scanned: int) -> Dict[str, object]:
    return lint_report(findings, files_scanned)
