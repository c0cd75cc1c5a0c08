"""Structured findings + allowlists shared by the linter and conformance.

Port of ``repro.analysis.findings``, the same code (it uses no JAX).

A :class:`Finding` is one violation: rule id, repo-relative path,
1-based line, message, and an optional ``symbol`` (dotted context such
as ``SparseResult.to_dense``) that allowlists can match on.

Allowlists are plain-text files (one per rule, under
``repro_torch/analysis/rules/allow/``).  Each non-comment line is::

    <path-glob>[::<symbol-substring>]  --  <reason>

A finding is *allowlisted* (reported but not a failure) when its path
matches the glob (``fnmatch`` on the repo-relative posix path) and, if
the entry names a symbol, that substring occurs in the finding's
symbol.  The reason travels with the finding into the report so every
suppression stays self-documenting.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, Iterable, List, Optional, Sequence


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str            # repo-relative posix path
    line: int
    message: str
    symbol: str = ""     # dotted context, e.g. "SparseResult.to_dense"
    allowlisted: bool = False
    note: str = ""       # allowlist reason when allowlisted

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Finding":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})

    def render(self) -> str:
        tail = f"  [allowlisted: {self.note}]" if self.allowlisted else ""
        sym = f" ({self.symbol})" if self.symbol else ""
        return f"{self.rule} {self.location}{sym}: {self.message}{tail}"


@dataclasses.dataclass
class AllowEntry:
    """One allowlist line: path glob, optional symbol substring, reason."""

    path_glob: str
    symbol: str
    reason: str

    def matches(self, finding: Finding) -> bool:
        if not fnmatch.fnmatch(finding.path, self.path_glob):
            return False
        if self.symbol and self.symbol not in finding.symbol:
            return False
        return True


def parse_allowlist(text: str) -> List[AllowEntry]:
    entries: List[AllowEntry] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "--" in line:
            pattern, reason = line.split("--", 1)
        else:
            pattern, reason = line, ""
        pattern = pattern.strip()
        if "::" in pattern:
            glob, symbol = pattern.split("::", 1)
        else:
            glob, symbol = pattern, ""
        entries.append(AllowEntry(glob.strip(), symbol.strip(),
                                  reason.strip()))
    return entries


def apply_allowlist(findings: Iterable[Finding],
                    entries: Sequence[AllowEntry]) -> List[Finding]:
    """Mark (not drop) findings matched by allowlist entries."""
    out = []
    for f in findings:
        for e in entries:
            if e.matches(f):
                f.allowlisted = True
                f.note = e.reason or "allowlisted"
                break
        out.append(f)
    return out


def violations(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.allowlisted]


def lint_report(findings: Sequence[Finding],
                files_scanned: int) -> Dict[str, object]:
    return {
        "files_scanned": files_scanned,
        "violations": len(violations(findings)),
        "allowlisted": sum(1 for f in findings if f.allowlisted),
        "findings": [f.to_dict() for f in findings],
    }


def write_report(report: Dict[str, object], path: str) -> str:
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def load_report(path: str) -> Dict[str, object]:
    with open(path) as fh:
        return json.load(fh)


def findings_from_report(report: Dict[str, object]) -> List[Finding]:
    lint = report.get("lint", report)
    raw: Optional[List[Dict[str, object]]] = lint.get("findings")  # type: ignore[union-attr]
    return [Finding.from_dict(d) for d in (raw or [])]
