"""R1 - layering: core/kernels must not eagerly import upper layers.

Port of the reference's rule over the port's tree.  ``repro_torch.core``
and ``repro_torch.kernels`` are the foundation every other subsystem
builds on; an eager (module-scope) import of ``repro_torch.training``,
``repro_torch.serving`` or ``repro_torch.obs`` from them inverts the
dependency graph, makes the kernels unimportable without the full
stack, and reintroduces the import cycles the lazy helpers in
``core/api.py`` (``_tracer_active``, ``_metrics_active``) exist to
prevent.  Function-scoped (lazy) imports are fine - that is the
sanctioned escape hatch.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import Rule

FOUNDATION = ("repro_torch/core/", "repro_torch/kernels/")
FORBIDDEN = ("repro_torch.training", "repro_torch.serving", "repro_torch.obs")


def _applies(path: str) -> bool:
    return any(seg in path for seg in FOUNDATION)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".")
               for f in FORBIDDEN)


def _eager_imports(node: ast.AST) -> List[ast.stmt]:
    """Imports executed at module import time: module scope, class
    bodies, and top-level if/try arms - everything except function
    bodies."""
    out: List[ast.stmt] = []
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        if isinstance(child, (ast.Import, ast.ImportFrom)):
            out.append(child)
        else:
            out.extend(_eager_imports(child))
    return out


def _check(tree: ast.Module, path: str, source: str) -> List[Finding]:
    del source
    findings = []
    for node in _eager_imports(tree):
        if isinstance(node, ast.Import):
            targets = [a.name for a in node.names]
        else:
            assert isinstance(node, ast.ImportFrom)
            targets = [node.module] if node.module else []
        for mod in targets:
            if _forbidden(mod):
                findings.append(Finding(
                    rule="R1", path=path, line=node.lineno, symbol=mod,
                    message=(f"eager import of upper layer '{mod}' from "
                             f"foundation module; use a function-scoped "
                             f"(lazy) import instead")))
    return findings


RULE = Rule(
    id="R1",
    title="core/kernels must not eagerly import training/serving/obs",
    applies=_applies,
    check=_check,
)
