"""R2 - round boundaries: DistProblem executors consult guard + tracer.

Port of the reference's rule, the same check over the port's tree.

Every executor round boundary (``DistProblem.sddmm/spmm/spmm_t/
fusedmm``) is where fault injection fires and where the observability
tracer opens its round span; a method that skips either check silently
opts that op out of the fault-recovery contract and the
cost-model drift gate (``repro_torch.obs``).  The rule requires each
executor method body to contain both a ``faults.guard(...)`` call (any
call whose dotted name ends in ``guard``) and a tracer consult (any
call whose dotted name mentions ``tracer``, which covers both the
direct ``obs_tracer.active()`` form and the lazy ``_tracer_active()``
helper).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import Rule, dotted_name

EXECUTOR_METHODS = ("sddmm", "spmm", "spmm_t", "fusedmm")


def _applies(path: str) -> bool:
    return path.endswith(".py")


def _calls(node: ast.AST) -> List[str]:
    return [dotted_name(c.func) for c in ast.walk(node)
            if isinstance(c, ast.Call)]


def _check(tree: ast.Module, path: str, source: str) -> List[Finding]:
    del source
    findings = []
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef) and cls.name == "DistProblem"):
            continue
        for meth in cls.body:
            if not isinstance(meth, ast.FunctionDef):
                continue
            if meth.name not in EXECUTOR_METHODS:
                continue
            names = _calls(meth)
            sym = f"DistProblem.{meth.name}"
            if not any(n.split(".")[-1] == "guard" for n in names):
                findings.append(Finding(
                    rule="R2", path=path, line=meth.lineno, symbol=sym,
                    message=(f"executor round boundary '{meth.name}' never "
                             f"calls faults.guard; fault injection cannot "
                             f"fire for this op")))
            if not any("tracer" in n for n in names):
                findings.append(Finding(
                    rule="R2", path=path, line=meth.lineno, symbol=sym,
                    message=(f"executor round boundary '{meth.name}' never "
                             f"consults the obs tracer; rounds for this op "
                             f"are invisible to the drift gate")))
    return findings


RULE = Rule(
    id="R2",
    title="DistProblem executor rounds consult faults.guard and the tracer",
    applies=_applies,
    check=_check,
)
