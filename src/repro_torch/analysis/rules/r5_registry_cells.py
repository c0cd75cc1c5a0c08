"""R5 - every registry cell has schedule_events/schedule_words.

Port of the reference's rule, probing the port's registry.  The
registry (``repro_torch.core.api.ALGORITHMS``) declares the cell grid
(family x op x elision) the whole stack iterates over - fault
injection, the obs drift gate, the conformance verifier, serving.  All
of them assume each family's schedule module answers
``schedule_events(grid, op, elision)`` with a non-empty ordered
(point, phase) list and exposes a matching ``schedule_words``.  A cell
registered without its schedule silently falls out of every one of
those contracts, so the rule probes each declared cell through the
same entry points the runtime uses (with a stub grid - no devices).
"""
from __future__ import annotations

import inspect
import os
import types
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import Rule

OPS = ("sddmm", "spmm", "spmm_t", "fusedmm")
_STUB_GRID = types.SimpleNamespace(L=4, G=2, c=2, p=8)


def _mod_path(mod: object) -> str:
    try:
        f = inspect.getsourcefile(mod) or ""
    except TypeError:
        f = ""
    f = f.replace(os.sep, "/")
    if "/src/" in f:
        return f.split("/src/", 1)[1]
    return f or "<registry>"


def check_registry(algorithms: Optional[Dict[str, object]] = None
                   ) -> List[Finding]:
    """Probe every declared (family x op x elision) cell.

    ``algorithms`` defaults to the live registry; tests inject fake
    registries to exercise each failure mode without touching it.
    """
    if algorithms is None:
        from repro_torch.core import api
        algorithms = api.ALGORITHMS
    findings: List[Finding] = []
    for name in sorted(algorithms):
        alg = algorithms[name]
        sched = getattr(alg, "_sched_mod", None)
        path = _mod_path(sched if sched is not None else type(alg))
        if sched is None:
            findings.append(Finding(
                rule="R5", path=path, line=1, symbol=name,
                message=f"registry family '{name}' has no schedule module"))
            continue
        events = getattr(sched, "schedule_events", None)
        words = getattr(sched, "schedule_words", None)
        if not callable(events):
            findings.append(Finding(
                rule="R5", path=path, line=1, symbol=name,
                message=(f"family '{name}' schedule module lacks a "
                         f"callable schedule_events")))
            continue
        if not callable(words):
            findings.append(Finding(
                rule="R5", path=path, line=1, symbol=name,
                message=(f"family '{name}' schedule module lacks a "
                         f"callable schedule_words")))
        else:
            params = set(inspect.signature(words).parameters)
            missing = {"grid", "plan", "op"} - params
            if missing:
                findings.append(Finding(
                    rule="R5", path=path, line=1, symbol=name,
                    message=(f"family '{name}' schedule_words signature "
                             f"missing {sorted(missing)}")))
        elisions = tuple(getattr(alg, "elisions", ()) or ("none",))
        for op in OPS:
            cell_elisions = elisions if op == "fusedmm" else ("none",)
            for el in cell_elisions:
                cell = f"{name}.{op}[{el}]"
                try:
                    ev = events(_STUB_GRID, op, el)
                except Exception as exc:   # noqa: BLE001 - reported
                    findings.append(Finding(
                        rule="R5", path=path, line=1, symbol=cell,
                        message=(f"schedule_events raised for declared "
                                 f"cell {cell}: {exc!r}")))
                    continue
                ok = (isinstance(ev, list) and ev
                      and all(isinstance(e, tuple) and len(e) == 2
                              for e in ev))
                if not ok:
                    findings.append(Finding(
                        rule="R5", path=path, line=1, symbol=cell,
                        message=(f"schedule_events({cell}) must return a "
                                 f"non-empty list of (point, phase) "
                                 f"tuples, got {type(ev).__name__}")))
    return findings


RULE = Rule(
    id="R5",
    title="every registry cell has schedule_events/schedule_words",
    applies=lambda path: False,        # repo-level, not per-file
    check_repo=check_registry,
)
