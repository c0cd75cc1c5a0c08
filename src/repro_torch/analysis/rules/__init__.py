"""Repo-specific invariant rules over ``src/repro_torch``.

Port of ``repro.analysis.rules``: R1 (layering), R2 (round guards), R3
(no dense m x n in hot paths) and R5 (every registry cell answers its
schedule), each checking the port's tree.  The reference's R4 (no
mutable module state captured by a ``jax.pure_callback`` closure) has no
counterpart: eager torch has no host callbacks inside a traced program,
so there is nothing for it to check, and it is not ported empty.
:func:`all_rules` lists four rules.

Each rule module exports a :class:`Rule`.  AST rules implement
``check(tree, path, source)`` over one file (``applies`` filters
paths); repo-level rules implement ``check_repo()`` instead.  Every
rule has a plain-text allowlist at ``rules/allow/<id>.txt`` whose
entries mark findings as accepted without deleting the evidence.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.findings import AllowEntry, Finding, parse_allowlist

_ALLOW_DIR = os.path.join(os.path.dirname(__file__), "allow")


@dataclasses.dataclass
class Rule:
    """One invariant: per-file AST check or repo-level check."""

    id: str
    title: str
    applies: Callable[[str], bool]
    check: Optional[Callable[[ast.Module, str, str], List[Finding]]] = None
    check_repo: Optional[Callable[[], List[Finding]]] = None

    def allowlist(self, allow_dir: Optional[str] = None) -> List[AllowEntry]:
        path = os.path.join(allow_dir or _ALLOW_DIR,
                            f"{self.id.lower()}.txt")
        if not os.path.exists(path):
            return []
        with open(path) as fh:
            return parse_allowlist(fh.read())


def all_rules() -> Dict[str, Rule]:
    from repro_torch.analysis.rules import (r1_layering, r2_round_guards,
                                            r3_dense_materialization,
                                            r5_registry_cells)
    mods = (r1_layering, r2_round_guards, r3_dense_materialization,
            r5_registry_cells)
    return {m.RULE.id: m.RULE for m in mods}


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of a Name/Attribute chain ('' otherwise)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("<expr>")
    return ".".join(reversed(parts))
