"""Schedule conformance over the collective log.

Port of ``repro.analysis.conformance``.  The reference lowers each
registry cell (family x op x elision x comm x session) to HLO and reads
the compiled collectives; the port runs eagerly, so it runs each cell
once and reads the moves its collective layer logged
(``DistProblem.last_collectives``), which follow program order.  Then:

1. **Sequence** (dense cells) - the log, with the moves of one kind
   tagged with one schedule point folded into one event, equals the
   wire-visible events of ``schedule_words`` event by event: the same
   kinds in the same order and the same words, exactly.  This is
   stricter than the reference's comparison of maximal same-kind runs,
   which the compiler's reordering of permutes forces on the reference.
   A schedule event that moves as several collectives (s25's FusedMM
   reduce: a reduce-scatter, then an all-gather of the values) is
   declared in the family's ``WIRE_EXPANSIONS``, as in the reference.
2. **Groups** - each move's groups come from the grid's axes and the
   move's axis: an all-gather or reduce-scatter over "fiber" runs in the
   fibers, which must partition ``0..p-1`` into equal disjoint groups; a
   permute by ``offset`` on an axis pairs rank i with the rank ``offset``
   further on that axis, which must be a permutation.
3. **Rendezvous** - an SPMD simulation over per-rank queues: a
   collective fires only when every member of its group has it at the
   head of its queue.  A stacked run's per-rank programs are its log
   mapped onto each rank's groups; a run over a process group gathers
   every rank's own log (:func:`gather_logs`).  The cell passes only if
   every queue drains: an omission, a duplicate or a cross-rank
   reordering deadlocks.

``comm="sparse"`` cells have data-dependent words (``schedule_words`` is
None), so they get the structural checks (2) and (3) only, with
``mode="structural"``.

This is the static complement of the drift gate in ``repro_torch.obs``:
the tracer holds a round's measured words to the model, this holds the
structure - kind, order, groups, deadlock-freedom.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ExpectedEvent", "Collective", "CellVerdict",
           "expected_collectives", "log_collectives", "fold_moves",
           "match_sequence", "check_groups", "rank_programs",
           "rank_programs_from_logs", "simulate_rendezvous", "gather_logs",
           "verify_cell", "conformance_cells", "run_conformance",
           "write_report", "load_report"]

GATHERLIKE = ("all-gather", "reduce-scatter", "all-reduce")


# ---------------------------------------------------------------------------
# Expected sequence from the family's published schedule
# ---------------------------------------------------------------------------

class ExpectedEvent(tuple):
    """(point, phase, kind, words) of one wire-visible schedule event."""

    __slots__ = ()

    def __new__(cls, point: str, phase: int, kind: str, words: float):
        return tuple.__new__(cls, (point, phase, kind, words))

    point = property(lambda self: self[0])
    phase = property(lambda self: self[1])
    kind = property(lambda self: self[2])
    words = property(lambda self: self[3])


def expected_collectives(prob, op: str, elision: str = "none",
                         session=None) -> Optional[List[ExpectedEvent]]:
    """Wire-visible events of one cell, in schedule order.

    Derived from ``Algorithm.schedule_words``: events with ``kind=None``
    (compute phases) or zero words (dead shifts) move nothing and are
    dropped; an event the family's ``WIRE_EXPANSIONS`` maps to several
    kinds becomes one event per kind, its words split evenly.  None for
    support-pruned plans (``schedule_words`` contract)."""
    words = prob.alg.schedule_words(prob, op, elision, session=session)
    if words is None:
        return None
    expansions = getattr(prob.alg._sched_mod, "WIRE_EXPANSIONS", {})
    out: List[ExpectedEvent] = []
    for point, phase, kind, w in words:
        if kind is None or w <= 0:
            continue
        kinds = expansions.get((op, point), (kind,))
        for k in kinds:
            out.append(ExpectedEvent(point, phase, k, w / len(kinds)))
    return out


# ---------------------------------------------------------------------------
# The log's collectives, with their groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Collective:
    """One move of the log that crosses ranks, with its group structure
    (``groups`` for a gather-like move, ``pairs`` for a permute), in
    flat rank numbers (row-major over the grid's shape)."""
    name: str
    kind: str
    axis: str
    words: float
    point: Optional[Tuple[str, int]]
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    pairs: Optional[Tuple[Tuple[int, int], ...]] = None


def _flat(shape, coords) -> int:
    return int(np.ravel_multi_index(coords, shape))


def _axis_groups(shape, d: int) -> Tuple[Tuple[int, ...], ...]:
    """The ranks that differ only in axis ``d``, one group each."""
    rest = [range(s) for i, s in enumerate(shape) if i != d]
    out = []
    for other in itertools.product(*rest):
        grp = []
        for k in range(shape[d]):
            co = list(other)
            co.insert(d, k)
            grp.append(_flat(shape, co))
        out.append(tuple(grp))
    return tuple(out)


def _permute_pairs(shape, d: int, offset: int):
    out = []
    for co in itertools.product(*(range(s) for s in shape)):
        to = list(co)
        to[d] = (co[d] + offset) % shape[d]
        out.append((_flat(shape, co), _flat(shape, to)))
    return tuple(out)


def log_collectives(grid, log) -> List["Collective"]:
    """The moves of ``log`` that cross ranks (an axis of more than one
    rank; a permute by a nonzero offset on it), in issue order."""
    out = []
    shape = tuple(grid.shape)
    for i, e in enumerate(log):
        d = grid.dim(e.axis)
        if shape[d] == 1:
            continue
        name = f"{e.kind}.{i}"
        if e.kind == "collective-permute":
            if e.offset is None or e.offset % shape[d] == 0:
                continue
            out.append(Collective(name, e.kind, e.axis, e.words, e.point,
                                  pairs=_permute_pairs(shape, d, e.offset)))
        else:
            out.append(Collective(name, e.kind, e.axis, e.words, e.point,
                                  groups=_axis_groups(shape, d)))
    return out


def fold_moves(colls: Sequence[Collective]) -> List[Tuple[str, float]]:
    """(kind, words) per schedule event, in issue order: the moves of one
    kind tagged with one schedule point count as one event, where the
    first of them was (a traveling pack and its partial dots, a Cannon
    carry, the values a fused cell's second round ships at the same
    shift event), as ``Backend.words`` folds them; untagged moves stand
    alone."""
    out: List[Tuple[str, float]] = []
    at: Dict[tuple, int] = {}
    for c in colls:
        key = None if c.point is None else (tuple(c.point), c.kind)
        if key is not None and key in at:
            kind, w = out[at[key]]
            out[at[key]] = (kind, w + c.words)
            continue
        if key is not None:
            at[key] = len(out)
        out.append((c.kind, c.words))
    return out


# ---------------------------------------------------------------------------
# Sequence matching, event by event
# ---------------------------------------------------------------------------

def match_sequence(expected: Sequence[Tuple[str, float]],
                   got: Sequence[Tuple[str, float]]) -> List[str]:
    """Errors from comparing the schedule's (kind, words) events with the
    log's, event by event: the same kinds in the same order and the same
    words, exactly."""
    errors: List[str] = []
    ek = [k for k, _ in expected]
    gk = [k for k, _ in got]
    if ek != gk:
        errors.append(f"collective kind sequence mismatch: schedule "
                      f"promises {ek}, the log holds {gk}")
        return errors
    for i, ((kind, ew), (_, gw)) in enumerate(zip(expected, got)):
        if ew != gw:
            errors.append(f"event {i} ({kind}) words: modeled {ew!r} != "
                          f"logged {gw!r}")
    return errors


# ---------------------------------------------------------------------------
# Group soundness
# ---------------------------------------------------------------------------

def check_groups(colls: Sequence[Collective], p: int) -> List[str]:
    """Mesh-partition errors of every collective's group structure."""
    errors: List[str] = []
    for c in colls:
        if c.kind in GATHERLIKE:
            groups = c.groups
            if not groups:
                errors.append(f"{c.name}: no groups")
                continue
            flat = [r for g in groups for r in g]
            sizes = {len(g) for g in groups}
            if len(sizes) != 1:
                errors.append(f"{c.name}: unequal group sizes {sizes}")
            if len(flat) != len(set(flat)):
                errors.append(f"{c.name}: overlapping groups")
            if set(flat) != set(range(p)):
                errors.append(f"{c.name}: groups cover "
                              f"{sorted(set(flat))}, not the full mesh "
                              f"0..{p - 1}")
        elif c.kind == "collective-permute":
            pairs = c.pairs
            if not pairs:
                errors.append(f"{c.name}: no source-target pairs")
                continue
            srcs = [s for s, _ in pairs]
            tgts = [t for _, t in pairs]
            if len(srcs) != len(set(srcs)) or len(tgts) != len(set(tgts)):
                errors.append(f"{c.name}: source-target pairs not a "
                              f"permutation")
            bad = [x for x in srcs + tgts if not 0 <= x < p]
            if bad:
                errors.append(f"{c.name}: pair ranks {sorted(set(bad))} "
                              f"outside mesh 0..{p - 1}")
    return errors


# ---------------------------------------------------------------------------
# SPMD rendezvous simulation
# ---------------------------------------------------------------------------

def _parts(c: Collective, p: int) -> List[Tuple[int, ...]]:
    if c.kind in GATHERLIKE and c.groups:
        return [tuple(sorted(g)) for g in c.groups]
    if c.kind == "collective-permute" and c.pairs:
        return [tuple(sorted({x for pr in c.pairs for x in pr}))]
    return [tuple(range(p))]           # conservative: a global barrier


def rank_programs(colls: Sequence[Collective], p: int
                  ) -> Dict[int, List[tuple]]:
    """Per-rank collective queues of a stacked run, in issue order: the
    one log mapped onto each rank's groups.  Each entry is a collective
    id ``(index, group, kind)`` shared by exactly its group's members:
    one id per group of a gather-like move, one per permute covering
    its pairs' endpoints."""
    prog: Dict[int, List[tuple]] = {r: [] for r in range(p)}
    for idx, c in enumerate(colls):
        for group in _parts(c, p):
            for r in group:
                if 0 <= r < p:
                    prog[r].append((idx, group, c.kind))
    return prog


def rank_programs_from_logs(logs: Dict[int, Sequence[Collective]], p: int
                            ) -> Dict[int, List[tuple]]:
    """Per-rank queues of a run over a process group: each rank's own log,
    each collective mapped to the group holding that rank."""
    prog: Dict[int, List[tuple]] = {}
    for r, colls in logs.items():
        prog[r] = []
        for idx, c in enumerate(colls):
            mine = [g for g in _parts(c, p) if r in g]
            prog[r].append((idx, mine[0] if mine else (r,), c.kind))
    return prog


def simulate_rendezvous(prog: Dict[int, List[tuple]]) -> Dict[str, object]:
    """Drain per-rank queues under the SPMD rendezvous rule.

    A collective id fires only when every rank in its group (``cid[1]``)
    has that id at the head of its queue; firing pops it everywhere at
    once.  Returns ``{"ok", "fired", "stuck"}``, ``stuck`` mapping each
    undrained rank to its blocking head entry: non-empty exactly when
    the program can deadlock (a rank that never posts, posts twice, or
    posts out of order relative to a peer)."""
    pos = {r: 0 for r in prog}
    fired: List[tuple] = []
    while True:
        progressed = False
        for r in sorted(prog):
            if pos[r] >= len(prog[r]):
                continue
            cid = prog[r][pos[r]]
            group = cid[1]
            ready = all(
                g in prog and pos[g] < len(prog[g])
                and prog[g][pos[g]] == cid
                for g in group)
            if ready:
                for g in group:
                    pos[g] += 1
                fired.append(cid)
                progressed = True
        if not progressed:
            break
    stuck = {r: repr(prog[r][pos[r]]) for r in sorted(prog)
             if pos[r] < len(prog[r])}
    return {"ok": not stuck, "fired": len(fired), "stuck": stuck}


def gather_logs(grid, log) -> Dict[int, List[Collective]]:
    """Every rank's collectives of one call over a process group, on
    every rank (``all_gather_object`` on the grid's group: gloo on the
    CPU, NCCL on the cards); a collective."""
    import torch.distributed as dist
    mine = log_collectives(grid, log)
    out: List[Optional[list]] = [None] * grid.p
    dist.all_gather_object(out, mine, group=grid.group)
    return dict(enumerate(out))


# ---------------------------------------------------------------------------
# Per-cell verification
# ---------------------------------------------------------------------------

class CellVerdict(dict):
    """Report row for one verified cell (plain dict, JSON-ready)."""

    @property
    def ok(self) -> bool:
        return self["verdict"] == "pass"


def cell_name(family, op, elision, comm, session: bool) -> str:
    return (f"{family}.{op}" + (f"[{elision}]" if op == "fusedmm" else "")
            + f"[{comm}]" + ("+sess" if session else ""))


def run_cell(prob, op: str, elision: str, session, X, Y):
    """Run one cell (its result is dropped); its log is the problem's
    ``last_collectives``."""
    if op == "sddmm":
        prob.sddmm(X, Y, session=session)
    elif op == "spmm":
        prob.spmm(Y, session=session)
    elif op == "spmm_t":
        prob.spmm_t(X, session=session)
    elif op == "fusedmm":
        prob.fusedmm(X, Y, elision=elision, session=session)
    else:
        raise ValueError(f"unknown op {op!r}")
    return prob.last_collectives.log


def verify_cell(prob, op: str, elision: str, session, X, Y, *,
                expected_override: Optional[Sequence[ExpectedEvent]] = None,
                logs: Optional[Dict[int, Sequence[Collective]]] = None
                ) -> CellVerdict:
    """Run one registry cell and hold its log to the schedule.

    Under a process group every rank calls this together and every rank
    gets the verdict of all ranks' logs.  ``expected_override`` and
    ``logs`` substitute the schedule's events and the per-rank logs
    (tests corrupt them to show the checks notice)."""
    p = int(prob.p)
    cell = cell_name(prob.alg.name, op, elision, prob.comm,
                     session is not None)
    checks: Dict[str, str] = {}
    errors: List[str] = []
    log = run_cell(prob, op, elision, session, X, Y)
    colls = log_collectives(prob.grid, log)
    if logs is None and prob.grid.group is not None:
        logs = gather_logs(prob.grid, log)

    expected = expected_override
    if expected is None:
        expected = expected_collectives(prob, op, elision, session=session)
    mode = "structural" if expected is None else "full"
    if expected is not None:
        seq_errors = match_sequence([(e.kind, e.words) for e in expected],
                                    fold_moves(colls))
        checks["sequence"] = "fail" if seq_errors else "pass"
        errors.extend(seq_errors)

    group_errors = check_groups(colls, p)
    checks["groups"] = "fail" if group_errors else "pass"
    errors.extend(group_errors)

    prog = rank_programs(colls, p) if logs is None \
        else rank_programs_from_logs(logs, p)
    sim = simulate_rendezvous(prog)
    checks["rendezvous"] = "pass" if sim["ok"] else "fail"
    if not sim["ok"]:
        errors.append(f"rendezvous deadlock: stuck ranks {sim['stuck']}")

    return CellVerdict(
        cell=cell, family=prob.alg.name, op=op, elision=elision,
        comm=prob.comm, session=session is not None, p=p, mode=mode,
        collectives=len(colls),
        modeled_words=(None if expected is None
                       else float(sum(e.words for e in expected))),
        measured_words=float(sum(c.words for c in colls)),
        rendezvous_fired=sim["fired"],
        checks=checks, errors=errors,
        verdict="fail" if errors else "pass")


# ---------------------------------------------------------------------------
# Registry sweep
# ---------------------------------------------------------------------------

def conformance_cells(family_filter: Optional[str] = None,
                      comms: Tuple[str, ...] = ("dense", "sparse"),
                      ) -> List[dict]:
    """The registry's cell grid as keyword sets for :func:`verify_cell`,
    each with and without a Session (:func:`run_conformance` skips the
    Session variant where the schedule does not change with one)."""
    from repro_torch.core import api

    cells: List[dict] = []
    for family in sorted(api.ALGORITHMS):
        if family_filter and family != family_filter:
            continue
        alg = api.ALGORITHMS[family]
        ops = [("sddmm", ("none",)), ("spmm", ("none",)),
               ("spmm_t", ("none",)), ("fusedmm", alg.elisions)]
        for comm in comms:
            for op, elisions in ops:
                for el in elisions:
                    for sess in (False, True):
                        cells.append(dict(family=family, comm=comm, op=op,
                                          elision=el, session=sess))
    return cells


def session_sensitive(prob, op: str, elision: str) -> bool:
    """Does the cell's schedule change with a Session?"""
    from repro_torch.core import api

    base = prob.alg.schedule_words(prob, op, elision, session=None)
    sess = prob.alg.schedule_words(prob, op, elision,
                                   session=api.Session())
    return base != sess


def make_cell_problem(family: str, comm: str, *, m: int, n: int, r: int,
                      c: int, nnz_row: int, devices=None, group=None):
    """The reference's sweep problem (its matrix and integer values)."""
    from repro_torch.core import api, sparse

    rows, cols, _ = sparse.erdos_renyi(m, n, nnz_row, seed=0)
    rng = np.random.default_rng(0)
    vals = rng.integers(1, 5, rows.shape[0]).astype(np.float32)
    return api.make_problem(rows, cols, vals, (m, n), r, algorithm=family,
                            c=c, comm=comm, devices=devices, group=group)


def run_conformance(family: Optional[str] = None,
                    comms: Tuple[str, ...] = ("dense", "sparse"), *,
                    m: int = 64, n: int = 64, r: int = 16, c: int = 2,
                    nnz_row: int = 4, p: int = 8, devices=None,
                    group=None, progress=None) -> Dict[str, object]:
    """Verify the whole registry grid; returns the report dict.

    One problem per (family, comm) at the reference's smoke shape, on
    ``p`` stacked ranks of ``devices`` (default: the card), or one rank
    a process over ``group`` (every rank calls this).  Operands are
    seeded integers; Session sensitivity is probed on the dense
    problem, so the sparse grid keeps the same Session axis."""
    from repro_torch.core import api
    from repro_torch.core import device as _device

    if group is None:
        dev = _device.resolve(devices[0] if devices else None)
        devices = list(devices) if devices else [dev] * p
        p = len(devices)
    else:
        import torch.distributed as dist
        p = dist.get_world_size(group)
    rng = np.random.default_rng(1)
    X = rng.integers(-3, 4, (m, r)).astype(np.float32)
    Y = rng.integers(-3, 4, (n, r)).astype(np.float32)
    probs: Dict[Tuple[str, str], object] = {}
    rows: List[CellVerdict] = []
    for spec in conformance_cells(family, comms):
        for comm in (spec["comm"], "dense"):
            key = (spec["family"], comm)
            if key not in probs:
                probs[key] = make_cell_problem(
                    *key, m=m, n=n, r=r, c=c, nnz_row=nnz_row,
                    devices=devices, group=group)
        prob = probs[(spec["family"], spec["comm"])]
        if spec["session"] and not session_sensitive(
                probs[(spec["family"], "dense")], spec["op"],
                spec["elision"]):
            continue   # the same program; the plain cell covers it
        session = api.Session() if spec["session"] else None
        try:
            row = verify_cell(prob, spec["op"], spec["elision"], session,
                              X, Y)
        except Exception as exc:   # noqa: BLE001 - recorded per cell
            if group is not None:
                raise              # the other ranks would wait on this one
            row = CellVerdict(
                cell=cell_name(spec["family"], spec["op"], spec["elision"],
                               spec["comm"], spec["session"]),
                family=spec["family"], op=spec["op"],
                elision=spec["elision"], comm=spec["comm"],
                session=spec["session"], p=p, mode="error",
                collectives=0, modeled_words=None, measured_words=None,
                rendezvous_fired=0, checks={},
                errors=[f"verification raised: {exc!r}"], verdict="fail")
        rows.append(row)
        if progress is not None:
            progress(row)
    return {
        "schema": 1,
        "p": p,
        "shape": {"m": m, "n": n, "r": r, "c": c, "nnz_row": nnz_row},
        "cells": [dict(r) for r in rows],
        "pass": sum(1 for r in rows if r.ok),
        "fail": sum(1 for r in rows if not r.ok),
        "structural": sum(1 for r in rows if r["mode"] == "structural"),
    }


def write_report(report: Dict[str, object], path: str) -> str:
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def load_report(path: str) -> Dict[str, object]:
    with open(path) as fh:
        return json.load(fh)
