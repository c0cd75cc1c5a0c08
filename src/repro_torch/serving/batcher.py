"""Continuous batcher: coalesce a tick's tickets into few kernel rounds.

Port of ``repro.serving.batcher``.  Two coalescing transforms, each
bitwise identical to running every request alone:

* **Union-of-patterns SDDMM** for score requests: all (i, j) pairs of a
  merge unit are concatenated, deduplicated (``np.unique`` over
  ``i * n + j``, whose inverse scatters the samples back) and run as ONE
  sampled round through :meth:`DistProblem.with_pattern`.  A sample's
  dot runs over the operand width only, in an order no other sample
  changes, so adding samples to the pattern changes no sample.
* **Batched-RHS SpMM** for aggregate requests sharing a values key:
  column-concatenated through :meth:`DistProblem.spmm_batched`, whose
  output columns are independent, and zero-padded to a power-of-two
  bucket of the family's r-multiple, so the widths a server plans for
  (each a pack of the whole matrix) stay few.

Score merge rule (the group already fixed the Y operand and width):
requests with the SAME ``x_key`` share the operand; requests with
DIFFERENT X operands merge only when their queried row sets are
disjoint (a sample (i, j) reads row ``X[i]`` only), through one X built
on the device from each member's queried rows.  Others start a new
unit.

Every round runs through the deployment's :class:`api.ElasticProblem`
(``run_round``), whose round function receives the CURRENT problem: a
``DeviceLost`` mid-round re-plans the deployment and the union problem
is rebuilt on the degraded grid before the retry.  Results stay on the
deployment's device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List

import numpy as np
import torch

from repro_torch.serving.requests import Ticket

__all__ = ["ScoreUnit", "execute_aggregate_group", "execute_score_unit",
           "execute_solo", "plan_aggregate_groups", "plan_score_units"]


def _roundup(w: int, mult: int) -> int:
    return -(-w // mult) * mult


def _pattern_key(u_key: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(u_key).tobytes(),
                           digest_size=16).hexdigest()


def _union(reqs, n: int):
    """(unique rows, unique cols, pattern digest, inverse) of the
    requests' (i, j) pairs."""
    key = np.concatenate([r.rows.astype(np.int64) * n + r.cols
                          for r in reqs])
    u_key, inv = np.unique(key, return_inverse=True)
    return u_key // n, u_key % n, _pattern_key(u_key), inv.reshape(-1)


def _score_width(prob, w: int) -> int:
    """The query width padded to the family's r-multiple on ``prob``'s
    grid (a degraded grid's may differ)."""
    mult = prob.alg.min_r_multiple(prob.grid)
    return max(_roundup(w, mult), mult)


@dataclasses.dataclass
class ScoreUnit:
    """One union-of-patterns SDDMM round in the making."""
    m: int
    tickets: List[Ticket] = dataclasses.field(default_factory=list)
    x_key: str = ""
    scatter: bool = False
    _used: np.ndarray = None   # bool mask over m: rows any member queries

    def try_add(self, t: Ticket) -> bool:
        r = t.request
        if not self.tickets:
            self.tickets.append(t)
            self.x_key = r.x_key
            self._used = np.zeros(self.m, bool)
            self._used[r.rows] = True
            return True
        if not self.scatter and r.x_key == self.x_key:
            self.tickets.append(t)
            self._used[r.rows] = True
            return True
        # a different X: only on disjoint queried rows, so the combined X
        # carries each member's rows unclobbered
        if self._used[r.rows].any():
            return False
        self.tickets.append(t)
        self._used[r.rows] = True
        self.scatter = True
        return True


def plan_score_units(tickets: List[Ticket]) -> List[ScoreUnit]:
    """Group score tickets into merge units: by (deployment, y_key,
    width), then greedy first-fit into :class:`ScoreUnit` under the X
    merge rule."""
    groups: dict = {}
    for t in tickets:
        r = t.request
        groups.setdefault((id(r.deployment), r.y_key, r.width),
                          []).append(t)
    units: List[ScoreUnit] = []
    for group in groups.values():
        g_units: List[ScoreUnit] = []
        for t in group:
            if not any(u.try_add(t) for u in g_units):
                u = ScoreUnit(m=t.request.deployment.problem.m)
                u.try_add(t)
                g_units.append(u)
        units.extend(g_units)
    return units


def _scattered_x(dep, reqs, w: int) -> torch.Tensor:
    """One (m, w) X on the deployment's device holding each member's
    queried rows of its own X (a per-tick operand)."""
    dev = dep.problem.grid.device
    X = torch.zeros((dep.problem.m, w), dtype=torch.float32, device=dev)
    for r in reqs:
        qr = np.unique(r.rows)
        idx = torch.from_numpy(qr).to(dev)
        if isinstance(r.X, torch.Tensor):
            X[idx] = r.X[idx.to(r.X.device)].to(dev)
        else:
            X[idx] = torch.from_numpy(r.X[qr]).to(dev)
    return X


def _fulfill_scores(tickets, vals: torch.Tensor, inv: np.ndarray):
    inv = torch.from_numpy(inv).to(vals.device)
    off = 0
    for t in tickets:
        k = len(t.request.rows)
        t.batched_with = len(tickets) - 1
        t.fulfill(vals[inv[off:off + k]])
        off += k


def execute_score_unit(unit: ScoreUnit, *, use_session: bool = True) -> int:
    """Run one union round and fulfill every member ticket; returns the
    rounds run (1).  The round function derives the padded width, the
    operands and the union problem from the problem it is HANDED, so a
    retry after ``DeviceLost`` rebuilds them on the degraded grid."""
    dep = unit.tickets[0].request.deployment
    reqs = [t.request for t in unit.tickets]
    w = reqs[0].width
    u_rows, u_cols, pkey, inv = _union(reqs, dep.problem.n)
    if unit.scatter:
        X, x_key = _scattered_x(dep, reqs, w), None
    else:
        X, x_key = reqs[0].X, reqs[0].x_key
    session = dep.session if use_session else None

    def round_fn(prob):
        w_pad = _score_width(prob, w)
        qp = dep.pattern_problem(u_rows, u_cols, w_pad, pkey)
        Xp = dep.padded(X, w_pad, key=x_key)
        Yp = dep.padded(reqs[0].Y, w_pad, key=reqs[0].y_key)
        return qp.sddmm(Xp, Yp, session=session).values_tensor()

    vals = dep.elastic.run_round("serve.score", round_fn)
    _fulfill_scores(unit.tickets, vals, inv)
    return 1


def plan_aggregate_groups(tickets: List[Ticket]) -> List[List[Ticket]]:
    """Group aggregate tickets by (deployment, values key): each group is
    one batched-RHS SpMM round whatever its members' widths."""
    groups: dict = {}
    for t in tickets:
        r = t.request
        groups.setdefault((id(r.deployment), r.vals_key), []).append(t)
    return list(groups.values())


def _aggregate_width(prob, total: int) -> int:
    """A batched round's width: the summed widths rounded up to the
    family's r-multiple on ``prob``'s grid times a power of two.  Each
    new width packs the whole matrix on the host, so the buckets bound
    the widths a long-running server plans for to one per octave."""
    mult = prob.alg.min_r_multiple(prob.grid)
    units = -(-max(total, 1) // mult)
    return mult << (units - 1).bit_length()


def execute_aggregate_group(group: List[Ticket]) -> int:
    """One batched-RHS SpMM round for a values-keyed group, at its
    bucketed width, through the deployment's elastic facade and
    Session."""
    dep = group[0].request.deployment
    Ys = [t.request.Y for t in group]
    vals = group[0].request.vals
    total = sum(t.request.width for t in group)
    outs = dep.elastic.run_round(
        "spmm_batched", lambda prob: prob.spmm_batched(
            Ys, vals=vals, session=dep.session,
            pad_to=_aggregate_width(prob, total)))
    for t, out in zip(group, outs):
        t.batched_with = len(group) - 1
        t.fulfill(out)
    return 1


def execute_solo(t: Ticket, *, use_session: bool = False) -> int:
    """The per-request path: one round per ticket at the request's own
    width, no coalescing and no pattern or padding caches: the baseline
    the batched engine is timed against and the reference its answers
    equal bit for bit."""
    r = t.request
    dep = r.deployment
    session = dep.session if use_session else None
    if r.kind == "score":
        u_rows, u_cols, _, inv = _union([r], dep.problem.n)

        def round_fn(prob):
            w_pad = _score_width(prob, r.width)
            qp = prob.with_pattern(u_rows, u_cols).with_r(w_pad)
            Xp = dep.padded(r.X, w_pad)
            Yp = dep.padded(r.Y, w_pad)
            return qp.sddmm(Xp, Yp, session=session).values_tensor()

        _fulfill_scores([t], dep.elastic.run_round("serve.score", round_fn),
                        inv)
    else:
        t.fulfill(dep.elastic.run_round(
            "serve.aggregate", lambda prob: prob.spmm_batched(
                [r.Y], vals=r.vals, session=session)[0]))
    return 1
