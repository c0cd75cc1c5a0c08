"""R3 - no dense full-shape materialization in hot paths.

Port of the reference's rule over the port's tree, with torch's idioms.
The paper's whole point is that the m x n sparse matrix never exists
densely on any rank; an ``np.zeros((m, n))`` / ``torch.zeros(m, n)`` /
``.to_dense()`` in an executor or kernel hot path silently
re-introduces the O(m*n) memory the 1.5D/2.5D decompositions exist to
avoid, and scales catastrophically past toy sizes.  The rule flags,
inside ``repro_torch/core``, ``repro_torch/kernels`` and
``repro_torch/serving``:

* any ``.todense()`` / ``.toarray()`` / ``.to_dense()`` call, and
* ``zeros/ones/empty/full``-style allocations (numpy's, torch's and
  torch's ``new_*`` methods) whose shape is one m-like and one n-like
  problem dimension (terminal attribute or bare name ``m``/``n``, in
  either order), as a 2-tuple or, torch's form, as the first two
  positional arguments - the ``np.zeros((prob.m, prob.n))`` idiom.

Documented debug-only views (e.g. ``SparseResult.to_dense``) are
allowlisted with a reason rather than rewritten.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import Rule, dotted_name

HOT_DIRS = ("repro_torch/core/", "repro_torch/kernels/",
            "repro_torch/serving/")
ALLOC_NAMES = ("zeros", "ones", "empty", "full", "new_zeros", "new_ones",
               "new_empty", "new_full")
DENSIFY_ATTRS = ("todense", "toarray", "to_dense")


def _applies(path: str) -> bool:
    return any(seg in path for seg in HOT_DIRS)


def _dim_letter(node: ast.expr) -> Optional[str]:
    """'m' or 'n' when the expression is an m/n problem dimension."""
    if isinstance(node, ast.Name) and node.id in ("m", "n"):
        return node.id
    if isinstance(node, ast.Attribute) and node.attr in ("m", "n"):
        return node.attr
    return None


def _enclosing(tree: ast.Module, target: ast.AST) -> str:
    """Dotted class/function context of a node (for the finding symbol)."""
    path: List[str] = []

    def visit(node: ast.AST, ctx: List[str]) -> bool:
        if node is target:
            path.extend(ctx)
            return True
        name = getattr(node, "name", None) if isinstance(
            node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
        ) else None
        nxt = ctx + [name] if name else ctx
        return any(visit(c, nxt) for c in ast.iter_child_nodes(node))

    visit(tree, [])
    return ".".join(path)


def _check(tree: ast.Module, path: str, source: str) -> List[Finding]:
    del source
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func)
        leaf = fname.split(".")[-1]
        if leaf in DENSIFY_ATTRS and isinstance(node.func, ast.Attribute):
            findings.append(Finding(
                rule="R3", path=path, line=node.lineno,
                symbol=_enclosing(tree, node),
                message=(f".{leaf}() densifies a sparse operand to the "
                         f"full problem shape in a hot path")))
            continue
        if leaf in ALLOC_NAMES and node.args:
            shape = node.args[0]
            if isinstance(shape, (ast.Tuple, ast.List)):
                elts = shape.elts
            else:                           # torch.zeros(m, n)
                elts = node.args[:2]
            if len(elts) == 2:
                dims = {_dim_letter(e) for e in elts}
                if dims == {"m", "n"}:
                    findings.append(Finding(
                        rule="R3", path=path, line=node.lineno,
                        symbol=_enclosing(tree, node),
                        message=(f"{fname}((m, n)) materializes the full "
                                 f"dense problem shape in a hot path")))
    return findings


RULE = Rule(
    id="R3",
    title="no dense full-shape materialization in executor/kernel hot paths",
    applies=_applies,
    check=_check,
)
