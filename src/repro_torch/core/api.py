"""Unified distributed-algorithm API: Algorithm registry, DistProblem,
Session (paper §V + §VI-E applications).

Port of ``repro.core.api``: the registry holds all four families of the
reference (d15, s15, d25, s25), so ``algorithm="auto"`` ranks the same
(family, elision, c) cells by the same Table-III words and chooses what
the reference chooses.

* **Algorithm** -- registry entry binding a family's planner and its
  sddmm/spmm/fusedmm executors to a shared signature with *FusedMMA
  semantics*: ``fusedmm(S, X, Y) = (S * (X @ Y.T)) @ Y``, output
  ``(m, r)``.  The "reuse" cell runs the FusedMMB executor on the
  transpose pack with swapped operands.
* **DistProblem** -- owns the host COO of S, the grid, and the packs in
  every orientation the chosen strategies need (built lazily).
* **Session** -- caches the fiber-gathered copy of a dense operand
  across calls, keyed by content; cached calls equal uncached ones bit
  for bit.  Each family has its own gathered layout (d15: rows over
  the layer axis; s15: column slabs over the layer axis; d25: rows over
  the grid row axis); s25 replicates nothing dense, so a Session changes
  nothing there.

Dense results come back as torch tensors on the grid's device (the
reference assembles numpy on the host); sampled results are
:class:`SparseResult` with host (numpy) COO views.  Every executor call
records its collectives in ``DistProblem.last_collectives``.  Every call
passes the fault guard first (``repro_torch.distributed.faults``), then
opens a round span when an obs tracer is armed (``repro_torch.obs``);
with none armed that costs one attribute read.  :func:`activate` routes
``repro_torch.kernels.ops`` calls on a bound local pack through a
problem (mesh-active mode).

**Elastic recovery** (reference ``api.py``'s last part): :class:`
ElasticProblem` retries a call that dies with a retryable fault on the
same grid, and after a lost rank re-plans the problem from its host COO
onto the largest feasible degraded grid (:func:`degrade`);
:meth:`DistProblem.meta_dict` and :func:`problem_from_meta` carry a
problem through a checkpoint.  Under a process group every process runs
the same recovery: the guard fires on the host, before any collective,
at the same coordinate on every rank, and :func:`degrade` makes the
smaller group on every process of the old one.

``make_problem(..., group=pg)`` builds this process's rank of a problem
over a ``torch.distributed`` process group (one rank per process: NCCL
across cards, gloo on the CPU; every process of the group makes the same
call).  Each rank keeps only its own blocks of the plans and operands;
a dense result is this rank's :class:`RankBlock`, and
:meth:`RankBlock.gather` assembles the global result (the stacked run's,
bit for bit) on every rank.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel, d15, d25, s15, s25, sparse
from repro_torch.core import device as _device
from repro_torch.core.collectives import Backend, coll_for
from repro_torch.core.grid import make_grid15, make_grid25
from repro_torch.distributed import faults

__all__ = [
    "ALGORITHMS", "Algorithm", "DistProblem", "RankBlock", "Session",
    "SparseResult", "gathered", "make_problem", "sddmm", "spmm", "spmm_t",
    "spmm_batched", "fusedmm", "ElasticProblem", "RetryPolicy",
    "FaultRecoveryError", "RankRetired", "RETRYABLE_ERRORS",
    "problem_from_meta", "degrade", "activate",
]


def _tracer_active():
    """The armed obs tracer, or None.

    The import is inside the function by design (lint rule R1):
    ``repro_torch.core`` is the foundation layer and stays importable
    without the obs stack; resolving through ``sys.modules`` per call
    also keeps the tests' monkeypatching of the module visible."""
    from repro_torch.obs import tracer as obs_tracer
    return obs_tracer.active()


def _metrics_active():
    """The armed obs metrics registry, or None (lazy, as above)."""
    from repro_torch.obs import metrics as obs_metrics
    return obs_metrics.active()

# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

def _match_coo(sorted_keys, order, keys):
    """Locate query coordinate keys (r*n + c) in a problem's COO.

    Returns (positions into the problem's COO order, mask of keys that
    occur there).  O(q log nnz); never materializes a dense matrix.
    """
    if len(order) == 0:
        return (np.zeros(len(keys), np.int64),
                np.zeros(len(keys), bool))
    pos = np.minimum(np.searchsorted(sorted_keys, keys), len(order) - 1)
    idx = order[pos]
    return idx, sorted_keys[pos] == keys


def _flat(x) -> torch.Tensor:
    """A tensor, or a tuple of them (d15's phases), as one flat tensor."""
    if isinstance(x, tuple):
        return torch.cat([t.reshape(-1) for t in x])
    return x.reshape(-1)


@dataclasses.dataclass
class SparseResult:
    """Sampled (SDDMM-shaped) output in its family's home layout.

    ``raw`` keeps the device tensors exactly as the executor returned
    them (one (L, c, nb_t, k) tensor per phase for d15, one tensor in
    the family's home layout for the others; this rank's blocks under a
    process group), laid out as the value slots of the problem's
    ``orient`` plan; ``_triples`` assembles the flat global COO view of
    the stacked values on the host.  Under a process group
    :meth:`to_coo`, :meth:`values`, :meth:`values_tensor` and
    :meth:`to_dense` are collectives: every rank calls them together.
    """
    problem: "DistProblem"
    raw: object
    _triples: Callable[[Any], tuple]
    orient: str = "normal"
    _coo: Optional[tuple] = None
    _vals: Optional[np.ndarray] = None

    def to_coo(self):
        """Flat global (rows, cols, vals) numpy, padding filtered."""
        if self._coo is None:
            self._coo = self._triples(
                self.problem.grid.gather_stacked(self.raw))
        return self._coo

    def to_dense(self) -> np.ndarray:
        """Dense (m, n) numpy matrix -- small/debug problems only."""
        r, c, v = self.to_coo()
        out = np.zeros((self.problem.m, self.problem.n), np.float64)
        np.add.at(out, (r, c), v)
        return out.astype(np.float32)

    def values(self) -> np.ndarray:
        """Values aligned with the problem's host COO (rows, cols) order."""
        if self._vals is None:
            prob = self.problem
            r, c, v = self.to_coo()
            sk, order = prob.coo_sort()
            idx, ok = _match_coo(sk, order, r * prob.n + c)
            out = np.zeros(prob.nnz, np.float64)
            np.add.at(out, idx[ok], v[ok])
            self._vals = out.astype(np.float32)
        return self._vals

    def values_tensor(self) -> torch.Tensor:
        """:meth:`values` as a float32 tensor on the grid's device, found
        there: each position's pack slot, by an index built on the device
        once per orientation, so no value crosses to the host.  Bitwise
        equal to :meth:`values` (each position has one slot, and a zero
        the host path filters as padding comes out +0.0 here too).  Where
        a coordinate repeats, the host path sums the repeats into the
        first one's position; this takes that sum from :meth:`values`."""
        prob = self.problem
        idx = prob._value_index(self.orient)
        if idx is None:
            return torch.from_numpy(self.values()).to(prob.grid.device)
        flat = _flat(prob.grid.gather_stacked(self.raw))
        return torch.index_select(flat, 0, idx) + 0.0


@dataclasses.dataclass(frozen=True)
class RankBlock:
    """This rank's share of a dense result computed over a process group.

    ``local`` is the executor's output held here, with the grid's rank
    dimensions (each of size 1): the stacked run's block of this rank,
    bit for bit.  :meth:`gather` assembles the global result on every
    rank (a collective: every rank of the group calls it)."""
    grid: Any
    local: torch.Tensor
    assemble: Callable

    def gather(self) -> torch.Tensor:
        g = self.grid
        return self.assemble(g.stacked(), g.gather_stacked(self.local))


def gathered(x):
    """A dense api result as one global tensor: a :class:`RankBlock`
    gathered (a collective: every rank calls it), a tensor as it is."""
    return x.gather() if isinstance(x, RankBlock) else x


def _assembled(grid, assemble):
    """The post step of a dense result: ``assemble(stacked grid, stacked
    output)`` gives the global result; under a process group the call
    returns this rank's :class:`RankBlock` instead."""
    if grid.group is None:
        return lambda x: assemble(grid, x)
    return lambda x: RankBlock(grid, x, assemble)


# ---------------------------------------------------------------------------
# Algorithm registry
# ---------------------------------------------------------------------------

ALGORITHMS: Dict[str, "Algorithm"] = {}


class Algorithm:
    """Registry entry: one distributed algorithm family behind the shared
    plan/sddmm/spmm/fusedmm signature."""

    name: str = ""
    elisions: Tuple[str, ...] = ()
    auto_elisions: Tuple[str, ...] = ()
    _sched_mod: Any = None

    def make_grid(self, c: int, devices, group=None):
        raise NotImplementedError

    def make_plan(self, prob, orient: str):
        raise NotImplementedError

    def feasible(self, *, m: int, n: int, r: int, p: int, c: int) -> bool:
        return costmodel.family_feasible(self.name, m=m, n=n, r=r, p=p, c=c)

    def min_r_multiple(self, grid) -> int:
        return 1

    def schedule_events(self, prob, op: str, elision: str = "none"):
        """This family's ordered (point, phase) fault boundaries for one
        ``op`` round: the coordinates ``repro_torch.distributed.faults``
        scripts failures at."""
        return self._sched_mod.schedule_events(prob.grid, op, elision)

    def schedule_words(self, prob, op: str, elision: str = "none",
                       session: Optional["Session"] = None):
        """Modeled per-device wire words for each schedule event, aligned
        1:1 with :meth:`schedule_events`; ``session`` models the
        pre-gathered program.  None for a support-pruned
        (``comm="sparse"``) plan, whose words depend on the data: its
        log is the dense one plus the plan's ``SparseMeta`` delta."""
        plan, pre = self._words_plan(prob, op, elision, session)
        if plan.smeta is not None:
            return None
        return self._sched_mod.schedule_words(prob.grid, plan, op,
                                              elision=elision,
                                              pre_gathered=pre)

    def _words_plan(self, prob, op, elision, session):
        raise NotImplementedError

    def replicate(self, prob, full: torch.Tensor, slot: str):
        """The gathered layout of a replicated-slot operand, from ``full``
        (float32 on the grid's device, owned by the Session's cache)."""
        raise NotImplementedError

    def _gathered(self, prob, arr, slot, session):
        """A replicated-slot operand and whether it is pre-gathered: from
        the session's cache, else in the shard layout (the executor
        gathers it)."""
        if session is not None:
            return session.replicate(prob, arr, slot), True
        return self.shard_x(prob, arr), False

    def _run(self, prob, call, backend):
        """Run one executor call on its collective backend: the round's
        (a ``coll`` in the call's keywords, which a tracer supplies),
        else a fresh one for the grid."""
        fn, args, kwargs, post = call
        kwargs = dict(kwargs)
        coll = coll_for(prob.grid, kwargs.pop("coll", None))
        res = fn(*args, **kwargs, coll=coll, backend=backend)
        prob.last_collectives = coll
        return post(res)

    def sddmm(self, prob, X, Y, session=None, backend=None,
              coll=None) -> SparseResult:
        return self._run(prob, _on(self._sddmm_call(prob, X, Y, session),
                                   coll), backend)

    def spmm(self, prob, Y, vals=None, session=None, backend=None,
             coll=None):
        return self._run(prob, _on(self._spmm_call(prob, Y, vals, session),
                                   coll), backend)

    def spmm_t(self, prob, A, vals=None, session=None, backend=None,
               coll=None):
        return self._run(prob, _on(self._spmm_t_call(prob, A, vals,
                                                     session), coll),
                         backend)

    def fusedmm(self, prob, X, Y, elision: str,
                session: Optional["Session"], backend=None, coll=None):
        return self._run(prob, _on(self._fusedmm_call(prob, X, Y, elision,
                                                      session), coll),
                         backend)

    def _sddmm_call(self, prob, X, Y, session):
        raise NotImplementedError

    def _spmm_call(self, prob, Y, vals, session):
        raise NotImplementedError

    def _spmm_t_call(self, prob, A, vals, session):
        raise NotImplementedError

    def _fusedmm_call(self, prob, X, Y, elision, session):
        raise NotImplementedError


def _on(call, coll):
    """An executor call that runs on the collective backend ``coll``
    (None: a fresh one)."""
    if coll is None:
        return call
    fn, args, kwargs, post = call
    return fn, args, dict(kwargs, coll=coll), post


def register(cls):
    alg = cls()
    ALGORITHMS[alg.name] = alg
    return cls


def _dense(prob, x) -> torch.Tensor:
    """A float32 tensor on the grid's device (numpy input is copied)."""
    dev = prob.grid.device
    if isinstance(x, torch.Tensor):
        t = x.detach().to(device=dev, dtype=torch.float32).contiguous()
    else:
        t = torch.from_numpy(np.array(x, np.float32)).to(dev)
    if t.dim() != 2:
        raise ValueError(f"a dense operand is (rows, r), got shape "
                         f"{tuple(t.shape)}")
    return t


def _sampled(prob, orient, rv) -> SparseResult:
    """R values ``rv`` in the value slots of ``prob``'s ``orient`` plan."""
    plan = prob.plan(orient)

    def triples(v):
        rl, cl, tb = prob.grid.gather_stacked((plan.rows_local, plan.cols,
                                               plan.tile_base))
        return plan.meta.block_meta.to_triples(rl, cl, v, tb)

    return SparseResult(prob, rv, triples, orient)


# ---------------------------------------------------------------------------
# 1.5D dense shifting
# ---------------------------------------------------------------------------

@register
class _D15(Algorithm):
    name = "d15"
    elisions = ("none", "reuse", "fused")
    auto_elisions = ("none", "reuse", "fused")
    _sched_mod = d15

    def make_grid(self, c, devices, group=None):
        return make_grid15(c, devices=devices, group=group)

    def make_plan(self, prob, orient):
        kw = dict(row_tile=prob.row_tile, nz_block=prob.nz_block,
                  comm=prob.comm, compress=prob.compress)
        if orient == "normal":
            return d15.plan_d15(prob.grid, prob.rows, prob.cols, prob.vals,
                                prob.m, prob.n, prob.r, **kw)
        return d15.plan_d15(prob.grid, prob.cols, prob.rows, prob.vals,
                            prob.n, prob.m, prob.r, transpose=True, **kw)

    def shard_x(self, prob, X):
        return prob.grid.stack(_dense(prob, X))

    shard_y = shard_x   # same layout, different row count

    def replicate(self, prob, full, slot):
        g = prob.grid
        lay = full.reshape(g.L, 1, full.shape[0] // g.L, full.shape[1])
        return g.local(lay.expand(g.L, g.c, *lay.shape[2:]))

    def _words_plan(self, prob, op, elision, session):
        pre = session is not None
        if op == "spmm":
            return prob.plan("normal"), False   # nothing inbound replicated
        if op == "spmm_t":
            return prob.transposed().plan("transpose"), pre
        if op == "fusedmm" and elision == "reuse":
            return prob.plan("transpose"), pre
        return prob.plan("normal"), pre

    def _sddmm_call(self, prob, X, Y, session):
        plan = prob.plan("normal")
        a, pre = self._gathered(prob, X, "x", session)
        return (d15.sddmm_d15, (prob.grid, plan, a, self.shard_y(prob, Y)),
                dict(pre_gathered=pre),
                lambda rv: _sampled(prob, "normal", rv))

    def _spmm_call(self, prob, Y, vals, session):
        # B shifts and the output reduce-scatters: nothing inbound is
        # replicated, so there is no gather for a session to serve
        plan = prob.injected_plan("normal", vals)
        return (d15.spmma_d15, (prob.grid, plan, self.shard_y(prob, Y)),
                {}, _assembled(prob.grid, lambda g, x: g.unstack(x)))

    def _spmm_t_call(self, prob, A, vals, session):
        # spmmb on S's transpose pack, which is the TRANSPOSED problem's
        # "transpose" orientation; the gather of A is Session-replayable
        plan = prob.transposed().injected_plan("transpose", vals)
        a, pre = self._gathered(prob, A, "x", session)
        return (d15.spmmb_d15, (prob.grid, plan, a),
                dict(pre_gathered=pre),
                _assembled(prob.grid, lambda g, x: g.unstack(x)))

    def _fusedmm_call(self, prob, X, Y, elision, session):
        grid = prob.grid
        if elision == "reuse":
            # FusedMMA(S, X, Y) = FusedMMB(S^T, Y, X): Y takes the
            # replicated slot, X the shifting slot, on the S^T pack.
            orient, a_host, slot = "transpose", Y, "y"
            b = self.shard_x(prob, X)
        else:
            orient, a_host, slot = "normal", X, "x"
            b = self.shard_y(prob, Y)
        plan = prob.plan(orient)
        a, pre = self._gathered(prob, a_host, slot, session)
        dense = _assembled(grid, lambda g, x: g.unstack(x))

        def post(res):
            out, rvals = res
            return dense(out), _sampled(prob, orient, rvals)

        return (d15.fusedmm_d15, (grid, plan, a, b),
                dict(elision=elision, pre_gathered=pre), post)


# ---------------------------------------------------------------------------
# 1.5D sparse shifting
# ---------------------------------------------------------------------------

def _columns(x: torch.Tensor, n_slabs: int) -> torch.Tensor:
    """(rows, r) -> (n_slabs, rows, r / n_slabs): slab i holds the i-th
    run of r / n_slabs columns."""
    return x.reshape(x.shape[0], n_slabs, -1).transpose(0, 1).contiguous()


@register
class _S15(Algorithm):
    name = "s15"
    elisions = ("none", "reuse", "fused")
    auto_elisions = ("fused", "reuse", "none")
    _sched_mod = s15

    def make_grid(self, c, devices, group=None):
        return make_grid15(c, devices=devices, group=group)

    def make_plan(self, prob, orient):
        if orient != "normal":
            raise ValueError("s15 keeps S stationary-by-row: the normal "
                             "orientation only")
        return s15.plan_s15(prob.grid, prob.rows, prob.cols, prob.vals,
                            prob.m, prob.n, prob.r,
                            row_tile=prob.row_tile, nz_block=prob.nz_block,
                            comm=prob.comm, compress=prob.compress)

    def min_r_multiple(self, grid):
        return grid.p

    def shard_x(self, prob, X):
        # rank (u, v) holds the (u*c + v)-th column slice of width r/p
        g = prob.grid
        cols = _columns(_dense(prob, X), g.p)
        return g.local(cols.reshape(g.L, g.c, *cols.shape[1:]))

    shard_y = shard_x

    def replicate(self, prob, full, slot):
        # the gathered layout: layer u's column slab of width r*c/p,
        # shared by its fiber
        g = prob.grid
        slabs = _columns(full, g.L)
        return g.local(slabs[:, None].expand(g.L, g.c, *slabs.shape[1:]))

    def _words_plan(self, prob, op, elision, session):
        pre = session is not None
        if op == "spmm_t":
            # A lands in the single-gather (B) slot of the transposed
            # problem's plan, as in _spmm_t_call
            return prob.transposed().plan("normal"), (False, pre)
        if op == "spmm":
            return prob.plan("normal"), (False, pre)
        return prob.plan("normal"), (pre, pre)

    def _both(self, prob, X, Y, session):
        (a, pre_a), (b, pre_b) = (self._gathered(prob, X, "x", session),
                                  self._gathered(prob, Y, "y", session))
        return a, b, (pre_a, pre_b)

    def _sddmm_call(self, prob, X, Y, session):
        plan = prob.plan("normal")
        a, b, pre = self._both(prob, X, Y, session)
        return (s15.sddmm_s15, (prob.grid, plan, a, b),
                dict(pre_gathered=pre),
                lambda rv: _sampled(prob, "normal", rv))

    def _spmm_call(self, prob, Y, vals, session):
        plan = prob.injected_plan("normal", vals)
        b, pre = self._gathered(prob, Y, "y", session)
        return (s15.spmma_s15, (prob.grid, plan, b),
                dict(pre_gathered=pre),
                _assembled(prob.grid, lambda g, slabs:
                           s15.assemble_spmm_out(g, plan, slabs)))

    def _spmm_t_call(self, prob, A, vals, session):
        # S stays stationary-by-row, so the transpose runs on the S^T
        # problem (same grid); its gather of A is Session-replayable
        tp = prob.transposed()
        plan = tp.injected_plan("normal", vals)
        a, pre = self._gathered(tp, A, "x", session)
        return (s15.spmma_s15, (tp.grid, plan, a), dict(pre_gathered=pre),
                _assembled(tp.grid, lambda g, slabs:
                           s15.assemble_spmm_out(g, plan, slabs)))

    def _fusedmm_call(self, prob, X, Y, elision, session):
        grid = prob.grid
        plan = prob.plan("normal")
        a, b, pre = self._both(prob, X, Y, session)
        dense = _assembled(grid, lambda g, slabs:
                           s15.assemble_spmm_out(g, plan, slabs))

        def post(res):
            slabs, rvals = res
            return dense(slabs), _sampled(prob, "normal", rvals)

        return (s15.fusedmm_s15, (grid, plan, a, b),
                dict(elision=elision, pre_gathered=pre), post)


# ---------------------------------------------------------------------------
# 2.5D dense replicating
# ---------------------------------------------------------------------------

@register
class _D25(Algorithm):
    name = "d25"
    elisions = ("none", "reuse", "fused")
    auto_elisions = ("fused", "reuse", "none")
    _sched_mod = d25

    def make_grid(self, c, devices, group=None):
        return make_grid25(c, devices=devices, group=group)

    def make_plan(self, prob, orient):
        kw = dict(row_tile=prob.row_tile, nz_block=prob.nz_block,
                  comm=prob.comm, compress=prob.compress)
        if orient == "normal":
            return d25.plan_d25(prob.grid, prob.rows, prob.cols, prob.vals,
                                prob.m, prob.n, prob.r, **kw)
        return d25.plan_d25(prob.grid, prob.cols, prob.rows, prob.vals,
                            prob.n, prob.m, prob.r, transpose=True, **kw)

    def min_r_multiple(self, grid):
        return grid.G

    def shard_x(self, prob, X):
        # the replicated slot's layout; the shifting operand is skewed
        # with d25.skew_b at the call sites below
        return d25.shard_rows(prob.grid, _dense(prob, X))

    shard_y = shard_x

    def replicate(self, prob, full, slot):
        return d25.replicate_rows(prob.grid, full)

    def _words_plan(self, prob, op, elision, session):
        pre = session is not None
        if op == "spmm":
            return prob.plan("normal"), False   # Cannon-shifts, no gather
        if op == "spmm_t":
            return prob.transposed().plan("transpose"), pre
        if op == "fusedmm" and elision == "reuse":
            return prob.plan("transpose"), pre
        return prob.plan("normal"), pre

    def _sddmm_call(self, prob, X, Y, session):
        plan = prob.plan("normal")
        a, pre = self._gathered(prob, X, "x", session)
        return (d25.sddmm_d25,
                (prob.grid, plan, a, d25.skew_b(prob.grid,
                                                _dense(prob, Y))),
                dict(pre_gathered=pre),
                lambda rv: _sampled(prob, "normal", rv))

    def _spmm_call(self, prob, Y, vals, session):
        # B Cannon-shifts and the output reduce-scatters: no inbound
        # replication for a session to serve
        plan = prob.injected_plan("normal", vals)
        return (d25.spmma_d25,
                (prob.grid, plan, d25.skew_b(prob.grid, _dense(prob, Y))),
                {}, _assembled(prob.grid, d25.unshard_rows))

    def _spmm_t_call(self, prob, A, vals, session):
        # the FusedMMB half on S's transpose pack, which is the
        # TRANSPOSED problem's "transpose" orientation
        plan = prob.transposed().injected_plan("transpose", vals)
        a, pre = self._gathered(prob, A, "x", session)
        return (d25.spmmb_d25, (prob.grid, plan, a),
                dict(pre_gathered=pre),
                _assembled(prob.grid, lambda g, out:
                           d25.unskew_out(g, plan, out)))

    def _fusedmm_call(self, prob, X, Y, elision, session):
        grid = prob.grid
        if elision == "reuse":
            # FusedMMA(S, X, Y) = FusedMMB(S^T, Y, X)
            orient, a_host, slot, b_host = "transpose", Y, "y", X
        else:
            orient, a_host, slot, b_host = "normal", X, "x", Y
        plan = prob.plan(orient)
        a, pre = self._gathered(prob, a_host, slot, session)
        b = d25.skew_b(grid, _dense(prob, b_host))
        dense = _assembled(grid, (lambda g, out: d25.unskew_out(g, plan, out))
                           if elision == "reuse" else d25.unshard_rows)

        def post(res):
            out, rvals = res
            return dense(out), _sampled(prob, orient, rvals)

        return (d25.fusedmm_d25, (grid, plan, a, b),
                dict(elision=elision, pre_gathered=pre), post)


# ---------------------------------------------------------------------------
# 2.5D sparse replicating
# ---------------------------------------------------------------------------

@register
class _S25(Algorithm):
    name = "s25"
    # "fused" is structurally impossible here: the cross-fiber partial-sum
    # reduction separates the SDDMM and SpMM halves, and the stationary S
    # ships no structure to elide.
    elisions = ("none", "reuse")
    auto_elisions = ("reuse", "none")
    _sched_mod = s25

    def make_grid(self, c, devices, group=None):
        return make_grid25(c, devices=devices, group=group)

    def make_plan(self, prob, orient):
        if orient != "normal":
            raise ValueError("s25 replicates the structure: the normal "
                             "orientation only")
        return s25.plan_s25(prob.grid, prob.rows, prob.cols, prob.vals,
                            prob.m, prob.n, prob.r,
                            row_tile=prob.row_tile, nz_block=prob.nz_block,
                            comm=prob.comm, compress=prob.compress)

    def min_r_multiple(self, grid):
        return grid.G * grid.c

    def shard_x(self, prob, X):
        return s25.skew_dense(prob.grid, _dense(prob, X), along="row")

    def shard_y(self, prob, Y):
        return s25.skew_dense(prob.grid, _dense(prob, Y), along="col")

    # nothing dense is replicated: Session caching changes nothing here
    def replicate(self, prob, full, slot):
        return self.shard_x(prob, full) if slot == "x" \
            else self.shard_y(prob, full)

    @staticmethod
    def _result(prob, rv):
        plan = prob.plan("normal")

        def triples(full):
            # the fiber's value shards hold the (x, y) block's slots in
            # order: the layer-0 copy of the shared structure labels them
            G = prob.grid.G
            rl, cl, tb = prob.grid.gather_stacked(
                (plan.rows_local, plan.cols, plan.tile_base))
            full = full.reshape(G, G, rl.shape[3], full.shape[-1])
            return plan.meta.block_meta.to_triples(
                rl[:, :, 0], cl[:, :, 0], full, tb[:, :, 0])
        return SparseResult(prob, rv, triples)

    def _words_plan(self, prob, op, elision, session):
        del elision, session            # Session-inert, values-only fiber
        if op == "spmm_t":
            return prob.transposed().plan("normal"), False
        return prob.plan("normal"), False

    def _sddmm_call(self, prob, X, Y, session):
        # nothing dense is replicated: session accepted and ignored
        plan = prob.plan("normal")
        return (s25.sddmm_s25,
                (prob.grid, plan, self.shard_x(prob, X),
                 self.shard_y(prob, Y)), {},
                lambda rv: self._result(prob, rv))

    def _spmm_call(self, prob, Y, vals, session):
        plan = prob.injected_plan("normal", vals)
        return (s25.spmma_s25, (prob.grid, plan, self.shard_y(prob, Y)),
                {}, _assembled(prob.grid, lambda g, out:
                               s25.unskew_out(g, plan, out)))

    def _spmm_t_call(self, prob, A, vals, session):
        # spmm on the transposed problem (structure re-replicated on the
        # same grid); no gather for a Session to replay
        tp = prob.transposed()
        plan = tp.injected_plan("normal", vals)
        return (s25.spmma_s25, (tp.grid, plan, self.shard_y(tp, A)), {},
                _assembled(tp.grid, lambda g, out:
                           s25.unskew_out(g, plan, out)))

    def _fusedmm_call(self, prob, X, Y, elision, session):
        grid = prob.grid
        plan = prob.plan("normal")
        dense = _assembled(grid, lambda g, out: s25.unskew_out(g, plan, out))

        def post(res):
            out, rvals = res
            return dense(out), self._result(prob, rvals)

        return (s25.fusedmm_s25, (grid, plan, self.shard_x(prob, X),
                                  self.shard_y(prob, Y)),
                dict(elision=elision), post)


# ---------------------------------------------------------------------------
# DistProblem
# ---------------------------------------------------------------------------

_COST_NAME = costmodel.ELISION_COST_NAME

#: widths a problem keeps derived problems for (:meth:`DistProblem.with_r`)
DERIVED_R_MAX = 4


@dataclasses.dataclass
class DistProblem:
    """A packed sparse matrix + dense layouts bound to one algorithm/grid.

    Plans are built lazily per orientation and cached, so repeated calls
    pay the host packing once, like the paper's preprocessing.  Each
    orientation is packed once with position codes (:meth:`_posplan`);
    its plan, the plans of every problem :meth:`with_values` derives
    from it, and every :meth:`injected_plan` put values into those slots
    on the device, with no packing."""
    alg: Algorithm
    grid: Any
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    m: int
    n: int
    r: int
    row_tile: int = 32
    nz_block: int = 32
    comm: str = "dense"
    compress: Optional[str] = None
    _plans: dict = dataclasses.field(default_factory=dict)
    _derived_r: dict = dataclasses.field(default_factory=dict)
    # the structure's: shared by every problem with_values derives
    _posmaps: dict = dataclasses.field(default_factory=dict)
    _value_idx: dict = dataclasses.field(default_factory=dict)
    _coo_sort: Optional[tuple] = None
    _transposed: Optional["DistProblem"] = None
    #: a transposed problem's weak reference to the problem it was
    #: derived from (a strong one would tie the two into a cycle that
    #: only the cyclic collector frees)
    _origin: Optional[weakref.ref] = None
    _ones: Optional["DistProblem"] = None
    _vals_dev: Optional[torch.Tensor] = None
    #: the collective log of the last executor call on this problem
    last_collectives: Optional[Backend] = None

    # -- metadata ------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(len(self.vals))

    @property
    def phi(self) -> float:
        return self.nnz / (self.n * self.r)

    @property
    def p(self) -> int:
        return self.grid.p

    @property
    def c(self) -> int:
        return self.grid.c

    def _derive(self, **changes) -> "DistProblem":
        base = dict(_plans={}, _derived_r={}, _posmaps={}, _value_idx={},
                    _transposed=None, _origin=None, _ones=None,
                    _vals_dev=None, last_collectives=None)
        base.update(changes)
        return dataclasses.replace(self, **base)

    # -- planning ------------------------------------------------------------
    def plan(self, orient: str = "normal"):
        """This orientation's plan (cached): this problem's values in the
        slots of the position-coded plan."""
        if orient not in self._plans:
            self._plans[orient] = self._inject(orient, self.device_vals())
        return self._plans[orient]

    def _posplan(self, orient: str):
        """This orientation packed once with position codes, cached: entry
        i of the host COO carries the integer i + 1, padding 0.  Packing
        moves values and never reads them, so the structure is the plan's
        for any values, and the value slots map each pack slot to its
        host-COO position, exactly at any nonzero count.

        Every plan of this problem is this one with values injected, so
        under ``comm="sparse"`` the support sets are built here, on the
        position-coded copy, once per orientation (the reference plans
        its position map with the dense wire and each value plan with the
        problem's own); they depend on the coordinates only."""
        if orient not in self._posmaps:
            dt = np.int32 if self.nnz < np.iinfo(np.int32).max else np.int64
            tmp = self._derive(vals=np.arange(1, self.nnz + 1, dtype=dt))
            plan = self.alg.make_plan(tmp, orient)
            # a phase none of whose packs holds an entry (a small pattern
            # on many ranks) packs float zeros: padding, position 0
            tdt = torch.int32 if dt is np.int32 else torch.int64
            vals = (tuple(v.to(tdt) for v in plan.vals)
                    if isinstance(plan.vals, tuple) else plan.vals.to(tdt))
            self._posmaps[orient] = dataclasses.replace(plan, vals=vals)
        return self._posmaps[orient]

    def _inject(self, orient: str, vals: torch.Tensor):
        """The position-coded plan with ``vals`` (host COO order, on the
        grid's device) gathered into its value slots (padding 0.0)."""
        base = self._posplan(orient)
        lookup = torch.cat([vals.new_zeros(1), vals])

        def inject(pos):
            return torch.index_select(lookup, 0, pos.reshape(-1)) \
                .reshape(pos.shape)

        new_vals = (tuple(inject(p) for p in base.vals)
                    if isinstance(base.vals, tuple) else inject(base.vals))
        return dataclasses.replace(base, vals=new_vals)

    def _value_vector(self, vals) -> torch.Tensor:
        """Values in host COO order as float32 (nnz,) on the grid's
        device (numpy is cast as the reference casts it)."""
        if isinstance(vals, torch.Tensor):
            v = vals.detach()
        else:
            v = torch.from_numpy(np.asarray(vals, np.float32))
        v = v.to(device=self.grid.device, dtype=torch.float32).reshape(-1)
        if v.numel() != self.nnz:
            raise ValueError(f"{v.numel()} values for a pattern of "
                             f"{self.nnz} nonzeros")
        return v

    def device_vals(self) -> torch.Tensor:
        """S's sample values (host COO order) on the grid's device."""
        if self._vals_dev is None:
            self._vals_dev = self._value_vector(self.vals)
        return self._vals_dev

    def injected_plan(self, orient: str, vals=None):
        """This orientation's plan with ``vals`` (host COO order: numpy,
        or a tensor, which stays on the device) in the value slots: only
        values move, the structure is packed once."""
        if vals is None:
            return self.plan(orient)
        return self._inject(orient, self._value_vector(vals))

    def _value_index(self, orient: str):
        """int64 (nnz,) on the grid's device: the slot of each host-COO
        position in the flat stacked values of this orientation's plan;
        None where a coordinate repeats (cached; a collective under a
        process group)."""
        if orient not in self._value_idx:
            idx = None
            dev = self.grid.device
            key = (torch.from_numpy(self.rows.astype(np.int64)).to(dev)
                   * self.n + torch.from_numpy(self.cols).to(dev))
            if torch.unique(key).numel() == self.nnz:
                pos = _flat(self.grid.gather_stacked(
                    self._posplan(orient).vals)).long()
                slots = torch.nonzero(pos).reshape(-1)
                idx = torch.empty(self.nnz, dtype=torch.int64, device=dev)
                idx[pos[slots] - 1] = slots
            self._value_idx[orient] = idx
        return self._value_idx[orient]

    def coo_sort(self):
        """(sorted coordinate keys, argsort order), cached."""
        if self._coo_sort is None:
            key = self.rows.astype(np.int64) * self.n + self.cols
            order = sparse.stable_order(key)
            if order is None:
                order = np.arange(len(key))
            self._coo_sort = (key[order], order)
        return self._coo_sort

    # -- derived problems ----------------------------------------------------
    def with_values(self, vals) -> "DistProblem":
        """Same structure, new sample values: shares this problem's
        position-coded plans, so it packs nothing."""
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().numpy()
        vals = np.asarray(vals, np.float32)
        if vals.shape != self.rows.shape:
            raise ValueError(f"vals of shape {vals.shape} for a pattern of "
                             f"{self.rows.shape[0]} nonzeros")
        return self._derive(vals=vals, _posmaps=self._posmaps,
                            _value_idx=self._value_idx)

    def ones(self) -> "DistProblem":
        """The unit-valued problem on S's pattern (cached): the sampling
        mask, whose ``sddmm(X, Y)`` gives the raw dots at nnz(S), as the
        backward of a values-differentiable SpMM needs (core/grads)."""
        if self._ones is None:
            self._ones = self if bool(np.all(self.vals == 1.0)) \
                else self.with_values(np.ones_like(self.vals))
        return self._ones

    def with_r(self, r: int) -> "DistProblem":
        """Same sparse matrix, different dense-operand width (cached, the
        DERIVED_R_MAX most recently used widths: each derived problem
        packs and holds its own plans)."""
        if r == self.r:
            return self
        prob = self._derived_r.pop(r, None)
        if prob is None:
            mult = self.alg.min_r_multiple(self.grid)
            if r % mult:
                raise ValueError(f"r={r} must be a multiple of {mult} "
                                 f"for {self.alg.name} on this grid")
            prob = self._derive(r=r)
        self._derived_r[r] = prob
        while len(self._derived_r) > DERIVED_R_MAX:
            del self._derived_r[next(iter(self._derived_r))]
        return prob

    def transposed(self) -> "DistProblem":
        """The S^T problem on the same grid (cached, round-trips).

        The S^T problem refers back to this one weakly: while this
        problem lives, ``transposed()`` of its transpose returns it;
        after, it derives S again.  So no pair of problems forms a
        reference cycle, and a problem's packs are freed with its last
        reference (the reference's pair waits for the collector)."""
        if self._transposed is None:
            origin = self._origin() if self._origin is not None else None
            if origin is not None:
                return origin
            if not self.alg.feasible(m=self.n, n=self.m, r=self.r,
                                     p=self.p, c=self.c):
                raise ValueError(f"{self.alg.name} infeasible for the "
                                 f"transposed shape ({self.n}, {self.m})")
            tp = self._derive(rows=self.cols, cols=self.rows, m=self.n,
                              n=self.m, _coo_sort=None)
            tp._origin = weakref.ref(self)
            self._transposed = tp
        return self._transposed

    def with_pattern(self, rows, cols, vals=None, *, m: int | None = None,
                     n: int | None = None) -> "DistProblem":
        """Another sparse pattern on the SAME grid object, family, wire
        format and tiling: the serving tick's union-of-patterns entry
        point.  Sharing the grid object lets the Session's replication
        of the deployed operands (keyed by the grid's identity and the
        operand's content) serve every tick's pattern.  Nothing cached
        of this problem is inherited (plans, position-coded packs, value
        indices, device values, the sorted COO): each would answer for
        this problem's pattern.  ``vals=None`` installs unit samples (the
        SDDMM mask).  The shape defaults to this problem's ``(m, n)``; a
        different one is checked against the family's feasibility."""
        m = self.m if m is None else int(m)
        n = self.n if n is None else int(n)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if rows.ndim != 1 or rows.shape != cols.shape:
            raise ValueError("pattern rows/cols must be matching 1-D "
                             f"arrays, got {rows.shape} / {cols.shape}")
        if len(rows) == 0:
            raise ValueError("empty query pattern")
        vals = (np.ones(len(rows), np.float32) if vals is None
                else np.asarray(vals, np.float32))
        if vals.shape != rows.shape:
            raise ValueError(f"vals length {vals.shape} != pattern "
                             f"length {rows.shape}")
        if (int(rows.min()) < 0 or int(rows.max()) >= m
                or int(cols.min()) < 0 or int(cols.max()) >= n):
            raise ValueError(f"pattern coordinates outside ({m}, {n})")
        if (m, n) != (self.m, self.n) and not self.alg.feasible(
                m=m, n=n, r=self.r, p=self.p, c=self.c):
            raise ValueError(f"{self.alg.name} infeasible for pattern "
                             f"shape ({m}, {n}) on this grid")
        return self._derive(rows=rows, cols=cols, vals=vals, m=m, n=n,
                            _coo_sort=None)

    def spmm_batched(self, Ys, vals=None,
                     session: Optional["Session"] = None,
                     pad_to: int | None = None) -> List[torch.Tensor]:
        """One SpMM round over column-concatenated right-hand sides.

        ``Ys`` are ``(n, r_i)`` operands (numpy or tensors).  They are
        concatenated along columns on the grid's device, zero-padded to
        the summed widths rounded up to the family's r-multiple (or to
        ``pad_to``, a bucket that bounds the widths a long-running
        server plans for), run as ONE :meth:`spmm` on the problem of
        that width, and split back: a list of ``(m, r_i)`` views of one
        tensor.  Output columns are independent (``out[:, j]`` reads
        only ``Y[:, j]``, and no kernel's sum order depends on the
        width), so each equals its RHS run alone bit for bit.  ``vals``
        and ``session`` as for :meth:`spmm`; under a process group the
        result is gathered (every rank calls this)."""
        Ys = [Y if isinstance(Y, torch.Tensor) else np.asarray(Y, np.float32)
              for Y in Ys]
        if not Ys:
            return []
        for Y in Ys:
            if Y.ndim != 2 or Y.shape[0] != self.n:
                raise ValueError(f"every RHS must be (n={self.n}, r_i), "
                                 f"got {tuple(Y.shape)}")
        widths = [int(Y.shape[1]) for Y in Ys]
        mult = self.alg.min_r_multiple(self.grid)
        r_tot = -(-max(sum(widths), 1) // mult) * mult
        if pad_to is not None:
            if pad_to < r_tot or pad_to % mult:
                raise ValueError(f"pad_to={pad_to} must be a multiple of "
                                 f"{mult} and >= {r_tot}")
            r_tot = pad_to
        cat = torch.zeros((self.n, r_tot), dtype=torch.float32,
                          device=self.grid.device)
        off = 0
        for Y, w in zip(Ys, widths):
            cat[:, off:off + w] = _dense(self, Y)
            off += w
        prob = self.with_r(r_tot)
        out = gathered(prob.spmm(cat, vals=vals, session=session))
        outs, off = [], 0
        for w in widths:
            outs.append(out[:, off:off + w])
            off += w
        return outs

    # -- elastic recovery ----------------------------------------------------
    def replan(self, *, devices=None, group=None, algorithm: str = "auto",
               c: int | None = None) -> "DistProblem":
        """Re-plan this problem from its host COO onto a (possibly
        different) set of ranks: ``devices`` (stacked), or ``group`` (a
        process group; ``devices`` then names each rank's device).
        ``algorithm="auto"`` re-runs the Table-III dispatch at the new p
        (family, elision candidates and c may all change); a family name
        pins it.  With neither, it re-plans on this problem's own ranks.
        Packs are rebuilt lazily on first use, as for a fresh problem."""
        if devices is None and group is None:
            devices, group = list(self.grid.devices), self.grid.group
        return make_problem(self.rows, self.cols, self.vals,
                            (self.m, self.n), self.r, algorithm=algorithm,
                            c=c, devices=devices, group=group,
                            row_tile=self.row_tile, nz_block=self.nz_block,
                            comm=self.comm, compress=self.compress)

    def coo_digest(self) -> str:
        """Content digest of the host COO (structure + values): the
        reference's bytes (int64 rows and cols, float32 values, int64
        [m, n, r]) under blake2b-128, so one COO has one digest in both
        packages and a checkpoint's metadata crosses between them."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(self.rows.astype(np.int64)))
        h.update(np.ascontiguousarray(self.cols.astype(np.int64)))
        h.update(np.ascontiguousarray(self.vals.astype(np.float32)))
        h.update(np.int64([self.m, self.n, self.r]).tobytes())
        return h.hexdigest()

    def meta_dict(self) -> dict:
        """JSON-able metadata for distributed checkpoints, key for key
        the reference's: enough to rebuild an equivalent problem (same p
        -> the same family, c and packs; another p -> cost-model
        re-dispatch) via :func:`problem_from_meta`."""
        return dict(family=self.alg.name, p=self.p, c=self.c, m=self.m,
                    n=self.n, r=self.r, nnz=self.nnz,
                    row_tile=self.row_tile, nz_block=self.nz_block,
                    comm=self.comm, compress=self.compress,
                    coo_digest=self.coo_digest())

    def release(self) -> None:
        """Drop this problem's device state: plans, position-coded
        packs, value indices, device values and derived problems (each
        rebuilt lazily if the problem is used again).  :func:`degrade`
        calls it on the problem it replaces, so the degraded plan's
        memory peak is not the sum of two problems'."""
        self._plans, self._derived_r, self._posmaps = {}, {}, {}
        self._value_idx = {}
        self._transposed = self._ones = self._vals_dev = None
        self.last_collectives = None

    # -- elision resolution --------------------------------------------------
    def resolve_elision(self, elision: str = "auto",
                        session: Optional["Session"] = None) -> str:
        """Resolve ``elision="auto"`` by the Table-III words of this
        family's candidates at (p, c, phi) -- steady-state (cached) words
        with a Session; validate an explicit elision."""
        if elision != "auto":
            if elision not in self.alg.elisions:
                raise ValueError(f"{self.alg.name} supports "
                                 f"{self.alg.elisions}, got {elision!r}")
            return elision
        cost_fn = (costmodel.words_fusedmm_cached if session is not None
                   else costmodel.words_fusedmm)

        def words(el):
            return cost_fn(_COST_NAME[(self.alg.name, el)], p=self.p,
                           c=self.c, n=self.n, r=self.r,
                           nnz=self.nnz).words

        return min(self.alg.auto_elisions, key=words)

    # -- the shared-signature executors --------------------------------------
    def sddmm(self, X, Y, session: Optional["Session"] = None, *,
              backend: str | None = None) -> SparseResult:
        """R = S * (X @ Y.T) sampled at nnz(S); X (m, r), Y (n, r)."""
        faults.guard("sddmm", self)
        tr = _tracer_active()
        if tr is None:
            return self.alg.sddmm(self, X, Y, session=session,
                                  backend=backend)
        with tr.round(self, "sddmm", session=session) as coll:
            return self.alg.sddmm(self, X, Y, session=session,
                                  backend=backend, coll=coll)

    def spmm(self, Y, vals=None, session: Optional["Session"] = None, *,
             backend: str | None = None) -> torch.Tensor:
        """out = S(vals) @ Y, (m, r) on the grid's device; Y is (n, r)."""
        faults.guard("spmm", self)
        tr = _tracer_active()
        if tr is None:
            return self.alg.spmm(self, Y, vals=vals, session=session,
                                 backend=backend)
        with tr.round(self, "spmm", session=session) as coll:
            return self.alg.spmm(self, Y, vals=vals, session=session,
                                 backend=backend, coll=coll)

    def spmm_t(self, A, vals=None, session: Optional["Session"] = None, *,
               backend: str | None = None) -> torch.Tensor:
        """out = S(vals)^T @ A, (n, r) on the grid's device; A is (m, r)."""
        faults.guard("spmm_t", self)
        tr = _tracer_active()
        if tr is None:
            return self.alg.spmm_t(self, A, vals=vals, session=session,
                                   backend=backend)
        with tr.round(self, "spmm_t", session=session) as coll:
            return self.alg.spmm_t(self, A, vals=vals, session=session,
                                   backend=backend, coll=coll)

    def fusedmm(self, X, Y, elision: str = "auto",
                session: Optional["Session"] = None, *,
                backend: str | None = None):
        """out = (S * (X @ Y.T)) @ Y, (m, r) on the grid's device.

        Returns (out, SparseResult of the intermediate R).  ``backend``
        ("cuda" or "ref") picks the local kernels; None is the default
        of :mod:`repro_torch.kernels.ops`."""
        el = self.resolve_elision(elision, session)
        faults.guard("fusedmm", self, elision=el)
        tr = _tracer_active()
        if tr is None:
            return self.alg.fusedmm(self, X, Y, el, session,
                                    backend=backend)
        with tr.round(self, "fusedmm", elision=el, session=session) as coll:
            return self.alg.fusedmm(self, X, Y, el, session,
                                    backend=backend, coll=coll)

    def schedule_words(self, op: str, elision: str = "auto",
                       session: Optional["Session"] = None):
        """Modeled per-device wire words of one ``op`` round."""
        el = (self.resolve_elision(elision, session)
              if op == "fusedmm" else "none")
        return self.alg.schedule_words(self, op, el, session=session)


# ---------------------------------------------------------------------------
# Session: across-call replication reuse
# ---------------------------------------------------------------------------

class Session:
    """Caches fiber-replicated dense operands across executor calls.

    Keyed by operand CONTENT: an operand hits the entry of any operand
    with the same grid, family, wire format, slot, shape and dtype whose
    bytes are equal.  The bytes are compared on the grid's device (an
    integer sum of the bits first, then every bit of the entries whose
    sum agrees), so no operand is copied to the host to be keyed.  An
    identity memo skips the comparison for the same object: tensors are
    re-verified by their in-place version counter, numpy arrays by a sum
    fingerprint.  Each entry keeps its own copy of the operand (what
    later operands are compared with; the caller's in-place changes
    cannot reach it).  LRU-bounded, as the reference's.  Cached and
    uncached calls are bitwise identical."""

    def __init__(self, max_entries: int = 16):
        # key -> (copy, its bit sum, replica)
        self._cache = collections.OrderedDict()
        self._id_memo = collections.OrderedDict()
        self._max_entries = max_entries
        self._serial = itertools.count()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _cheap_fp(arr):
        if isinstance(arr, np.ndarray):
            return (arr.shape, str(arr.dtype),
                    float(arr.sum(dtype=np.float64)))
        if isinstance(arr, torch.Tensor):
            return (tuple(arr.shape), str(arr.dtype), arr._version)
        return None

    @staticmethod
    def _bit_sum(full: torch.Tensor) -> int:
        return int(full.view(torch.int32).sum(dtype=torch.int64))

    def _find(self, meta, full: torch.Tensor, bit_sum: int):
        """The key of an entry of ``meta`` holding ``full``'s bytes."""
        bits = full.view(torch.int32)
        for key, (own, own_sum, _) in self._cache.items():
            if key[:-1] == meta and own_sum == bit_sum \
                    and torch.equal(own.view(torch.int32), bits):
                return key
        return None

    def replicate(self, problem: "DistProblem", arr, slot: str):
        dtype = str(arr.dtype).replace("torch.", "") \
            if hasattr(arr, "dtype") else None
        meta = (id(problem.grid), problem.alg.name, problem.comm, slot,
                tuple(np.shape(arr)), dtype)
        memo_k = meta[:4] + (id(arr),)
        memo = self._id_memo.get(memo_k)
        fp = self._cheap_fp(arr)
        key = None
        if memo is not None and memo[0]() is arr and memo[2] == fp:
            self._id_memo.move_to_end(memo_k)
            key = memo[1]
        if key not in self._cache:
            full = _dense(problem, arr)
            bit_sum = self._bit_sum(full)
            key = self._find(meta, full, bit_sum)
        if key is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            rep = self._cache[key][2]
        else:
            own = full.clone() if isinstance(arr, torch.Tensor) else full
            rep = problem.alg.replicate(problem, own, slot)
            key = meta + (next(self._serial),)
            self._cache[key] = (own, bit_sum, rep)
            self.misses += 1
            while len(self._cache) > self._max_entries:
                self._cache.popitem(last=False)
        try:
            self._id_memo[memo_k] = (weakref.ref(arr), key, fp)
        except TypeError:
            pass                           # un-weakref-able: no memo
        while len(self._id_memo) > 4 * self._max_entries:
            self._id_memo.popitem(last=False)
        return rep

    def invalidate(self, problem: "DistProblem") -> int:
        """Drop every cached replication bound to ``problem``'s grid.

        The recovery path after an executor fault: a failed collective
        leaves no trustworthy device state, and after a re-plan the old
        grid's entries could never be consumed again anyway (keys lead
        with the grid's identity).  Returns the number of evicted
        entries."""
        gid = id(problem.grid)
        doomed = [k for k in self._cache if k[0] == gid]
        for k in doomed:
            del self._cache[k]
        for k in [k for k in self._id_memo if k[0] == gid]:
            del self._id_memo[k]
        return len(doomed)

    def stats(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    entries=len(self._cache), capacity=self._max_entries)

    def clear(self):
        """Drop every cached replication and the identity memo."""
        self._cache.clear()
        self._id_memo.clear()

    def __len__(self):
        return len(self._cache)


# ---------------------------------------------------------------------------
# Construction + module-level conveniences
# ---------------------------------------------------------------------------

def make_problem(rows, cols, vals, shape: Tuple[int, int], r: int, *,
                 algorithm: str = "auto", c: int | None = None,
                 devices=None, group=None, row_tile: int = 32,
                 nz_block: int = 32, comm: str = "dense",
                 compress: Optional[str] = None) -> DistProblem:
    """Build a DistProblem, dispatching the algorithm by the cost model.

    ``devices=None`` means one CUDA device (raises without one); pass
    ``[torch.device("cpu")] * p`` for p stacked ranks on the CPU.
    ``group``: a ``torch.distributed`` process group of p processes, each
    of which makes this call with the same arguments and gets its own
    rank's problem; ``devices`` then names each rank's device (default:
    every process's current card; NCCL for cards, gloo for the CPU).
    algorithm="auto" ranks every feasible (family, elision, c) of the
    four families by Table III at p, as the reference does; a family
    name pins the family and picks its best feasible c (or the caller's
    ``c``).

    ``comm`` is the wire format of the dense-operand movements: "dense",
    "sparse" (support-pruned sends of the rows the receivers' nonzeros
    read; results bit for bit those of "dense") or "auto"
    (:func:`costmodel.choose_comm` on the matrix's row and column
    support).  ``compress="bf16"`` ships the pruned payloads as bfloat16:
    half their bytes, and lossy, where ``comm="sparse"`` alone is exact.
    """
    m, n = shape
    if comm not in ("auto", "dense", "sparse"):
        raise ValueError(f"comm must be 'auto'|'dense'|'sparse', "
                         f"got {comm!r}")
    if compress not in (None, "bf16"):
        raise ValueError(f"compress must be None or 'bf16', "
                         f"got {compress!r}")
    if comm == "auto":
        comm = costmodel.choose_comm(rows, cols, m, n)
    if algorithm != "auto" and algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; registered: "
                         f"{sorted(ALGORITHMS)}")
    grid_devices = list(devices) if devices is not None else None
    if group is not None:
        import torch.distributed as dist
        p = dist.get_world_size(group)
    else:
        p = len(grid_devices) if grid_devices is not None else 1
    alg, c = _dispatch(m, n, len(vals), r, p, algorithm, c)
    grid = alg.make_grid(c, grid_devices, group)
    return DistProblem(alg, grid, np.asarray(rows), np.asarray(cols),
                       np.asarray(vals, np.float32), m, n, r,
                       row_tile=row_tile, nz_block=nz_block, comm=comm,
                       compress=compress)


def _dispatch(m: int, n: int, nnz: int, r: int, p: int, algorithm: str,
              c: int | None):
    """(registry entry, c) of a problem at p ranks: the cost model's
    choice among ``algorithm``'s families (all four for "auto")."""
    families = costmodel.FAMILIES if algorithm == "auto" else (algorithm,)
    choice = costmodel.choose_algorithm(m=m, n=n, nnz=nnz, r=r, p=p, c=c,
                                        families=families)
    return ALGORITHMS[choice.family], choice.c


def sddmm(problem: DistProblem, X, Y, session: Optional[Session] = None,
          *, backend: str | None = None) -> SparseResult:
    """Distributed SDDMM: ``R = S * (X @ Y.T)`` sampled at nnz(S)."""
    return problem.sddmm(X, Y, session=session, backend=backend)


def spmm(problem: DistProblem, Y, vals=None,
         session: Optional[Session] = None, *,
         backend: str | None = None) -> torch.Tensor:
    """Distributed SpMM: ``out = S(vals) @ Y``, ``(m, r)``."""
    return problem.spmm(Y, vals=vals, session=session, backend=backend)


def spmm_t(problem: DistProblem, A, vals=None,
           session: Optional[Session] = None, *,
           backend: str | None = None) -> torch.Tensor:
    """Distributed SpMM-transpose: ``out = S(vals)^T @ A``, ``(n, r)``."""
    return problem.spmm_t(A, vals=vals, session=session, backend=backend)


def spmm_batched(problem: DistProblem, Ys, vals=None,
                 session: Optional[Session] = None,
                 pad_to: int | None = None) -> List[torch.Tensor]:
    """One SpMM round over many right-hand sides, the serving batcher's
    aggregation primitive: see :meth:`DistProblem.spmm_batched`."""
    return problem.spmm_batched(Ys, vals=vals, session=session,
                                pad_to=pad_to)


def fusedmm(problem: DistProblem, X, Y, elision: str = "auto",
            session: Optional[Session] = None, *,
            backend: str | None = None):
    """Distributed FusedMM with FusedMMA semantics,
    ``out = (S * (X @ Y.T)) @ Y``; returns ``(out, SparseResult R)``.
    d15, s15 and d25 honour the elisions none, reuse and fused, s25 none
    and reuse; "auto" ranks a family's cells by the Table-III words
    (steady-state words with a ``session``)."""
    return problem.fusedmm(X, Y, elision=elision, session=session,
                           backend=backend)


# ---------------------------------------------------------------------------
# Elastic recovery: typed retry, backoff, degrade-and-re-plan
# ---------------------------------------------------------------------------

def _runtime_error_types():
    # what torch raises when a collective or a peer fails; import-guarded
    # so the api layer does not depend on the distributed package's layout
    out = []
    try:
        import torch.distributed as dist
    except ImportError:
        return ()
    for name in ("DistBackendError", "DistNetworkError"):
        err = getattr(dist, name, None)
        if isinstance(err, type) and err not in out:
            out.append(err)
    return tuple(out)


#: Errors worth retrying: scripted faults from the injection harness and
#: the failures of a collective or a peer.  A bare RuntimeError is not in
#: this set: a kernel that fails to build or launch, or a sticky CUDA
#: error, propagates on the first attempt, as do caller bugs (TypeError,
#: ValueError, ...).
RETRYABLE_ERRORS: Tuple[type, ...] = (
    (faults.TransientFault,) + _runtime_error_types())


class FaultRecoveryError(RuntimeError):
    """Recovery budget exhausted: carries the per-attempt fault history
    so post-mortems see every coordinate that fired."""

    def __init__(self, msg: str, history: Optional[list] = None):
        super().__init__(msg)
        self.history = history or []


class RankRetired(RuntimeError):
    """This process holds no rank of the degraded grid: it is the lost
    rank, or a survivor beyond the largest feasible p.  Raised by
    :func:`degrade` under a process group after the new group exists
    (every process of the old group takes part in making it), so this
    process leaves the recovery loop without waiting in a collective or
    computing.  ``rank`` is this process's rank in the old grid, ``p``
    the degraded grid's size, ``lost_rank`` the rank that was dropped."""

    def __init__(self, msg: str, rank: int, p: int, lost_rank: int):
        super().__init__(msg)
        self.rank, self.p, self.lost_rank = int(rank), int(p), lost_rank


@dataclasses.dataclass
class RetryPolicy:
    """Typed retry/backoff policy for the elastic executors.

    Exponential backoff with *deterministic, seedable* jitter: the delay
    sequence is a pure function of ``seed``, so a recovery trace replays
    exactly (tests inject ``sleep`` to run instantly).  The first retry
    fires after about ``base_delay``; each later delay multiplies by
    ``factor``, capped at ``max_delay``; jitter stretches each delay by
    up to ``jitter`` of itself."""
    max_retries: int = 3
    base_delay: float = 0.0          # seconds; 0 disables sleeping
    factor: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep

    def delays(self):
        """The policy's full backoff schedule (len == max_retries)."""
        rng = np.random.default_rng(self.seed)
        d = self.base_delay
        for _ in range(self.max_retries):
            yield min(d, self.max_delay) * (1.0 + self.jitter
                                            * float(rng.uniform()))
            d = d * self.factor if d else 0.0


def problem_from_meta(meta: dict, rows, cols, vals, *, devices=None,
                      group=None) -> DistProblem:
    """Rebuild a checkpointed problem from its :meth:`DistProblem.meta_dict`.

    The host COO is supplied by the caller (checkpoints store metadata,
    not the matrix) and verified against the saved content digest: a
    mismatched matrix raises ``ValueError``.  At the checkpoint's rank
    count the saved (family, c) is pinned, so the rebuilt packs are the
    same; at another (degraded) count the cost model re-dispatches
    ``algorithm="auto"``.  ``devices`` / ``group`` as for
    :func:`make_problem` (default: one card)."""
    if group is not None:
        import torch.distributed as dist
        p = dist.get_world_size(group)
    else:
        devices = list(devices) if devices is not None \
            else [_device.resolve(None)]
        p = len(devices)
    same = p == meta["p"]
    prob = make_problem(rows, cols, vals, (meta["m"], meta["n"]), meta["r"],
                        algorithm=meta["family"] if same else "auto",
                        c=meta["c"] if same else None, devices=devices,
                        group=group, row_tile=meta["row_tile"],
                        nz_block=meta["nz_block"],
                        comm=meta.get("comm", "dense"),
                        compress=meta.get("compress"))
    digest = prob.coo_digest()
    if digest != meta["coo_digest"]:
        raise ValueError(
            f"checkpointed problem metadata does not match the supplied "
            f"COO (digest {digest} != saved {meta['coo_digest']}) -- "
            f"wrong matrix for this checkpoint")
    return prob


def _largest_feasible(problem: DistProblem, n: int, algorithm: str):
    """(p, grid shape) of the largest rank count up to ``n`` at which
    ``problem`` can be planned: the cost model's dispatch and the grid's
    shape checks, on stacked devices, so nothing here makes a process
    group.  Raises ValueError with the constraint trail if none can."""
    errors = []
    for p in range(n, 0, -1):
        try:
            alg, c = _dispatch(problem.m, problem.n, problem.nnz, problem.r,
                               p, algorithm, None)
            return p, alg.make_grid(c, [problem.grid.device] * p).shape
        except ValueError as e:
            errors.append(f"p={p}: {e}")
    raise ValueError("no feasible degraded grid for "
                     f"({problem.m}x{problem.n}, r={problem.r}) on {n} "
                     "surviving ranks:\n  " + "\n  ".join(errors))


def degrade(problem: DistProblem, lost_rank: Optional[int] = None, *,
            devices=None, algorithm: str = "auto") -> DistProblem:
    """Re-plan ``problem`` onto a degraded grid after a lost rank.

    Drops ``lost_rank`` (flat schedule-order rank of the grid), or takes
    an explicit surviving ``devices`` list (stacked grids), then picks
    the **largest rank count the cost model can dispatch**: the
    planners' divisibility constraints rarely admit p - 1, so the grid
    shrinks to the nearest feasible size.  Raises ``ValueError`` with
    the constraint trail if no count up to the survivors' works, or for
    a ``lost_rank`` outside the grid.  The old problem's device state is
    released first (:meth:`DistProblem.release`).

    Under a process group every process of the old group calls this
    with the same ``lost_rank`` (the fault harness raises the same fault
    on every rank).  The search makes no group; then every process of
    the old group makes the new group with the surviving global ranks
    (``grid.new_group``, which first agrees on its name).  The first p
    survivors get the re-planned problem; the lost rank and the
    survivors beyond p raise :class:`RankRetired`.  A process that has
    really died cannot take part: a fresh rendezvous is not covered."""
    grid = problem.grid
    if lost_rank is not None and not 0 <= lost_rank < grid.p:
        raise ValueError(f"lost_rank {lost_rank} outside the grid's "
                         f"{grid.p} ranks")
    if grid.group is None:
        devs = list(grid.devices) if devices is None else list(devices)
        if devices is None and lost_rank is not None:
            del devs[lost_rank]
        p_new, _ = _largest_feasible(problem, len(devs), algorithm)
        problem.release()
        return problem.replan(devices=devs[:p_new], algorithm=algorithm)
    if devices is not None:
        raise ValueError("under a process group degrade drops lost_rank; "
                         "it takes no devices")
    from repro_torch.core import grid as _grid
    keep = [i for i in range(grid.p) if i != lost_rank]
    p_new, _ = _largest_feasible(problem, len(keep), algorithm)
    ranks = keep[:p_new]
    members = [grid.global_ranks[i] for i in ranks]
    problem.release()
    new = _grid.new_group(members, grid)
    if grid.rank not in ranks:
        raise RankRetired(f"rank {grid.rank} holds no rank of the degraded "
                          f"grid of {p_new} (lost rank {lost_rank})",
                          grid.rank, p_new, lost_rank)
    return problem.replan(devices=[grid.devices[i] for i in ranks],
                          group=new, algorithm=algorithm)


class ElasticProblem:
    """Fault-tolerant facade over a :class:`DistProblem`.

    Mirrors the executor entry points; every call runs under the typed
    retry loop:

    * :class:`repro_torch.distributed.faults.TransientFault`, or a failed
      collective -> invalidate the Session entries bound to the
      problem's grid (a failed collective leaves no trustworthy
      replication state), back off per :class:`RetryPolicy`, retry the
      round on the same grid;
    * :class:`repro_torch.distributed.faults.DeviceLost` -> additionally
      re-plan the problem from its host COO onto the largest feasible
      degraded grid (:func:`degrade`, cost-model re-dispatched), then
      retry there; under a process group the processes without a rank
      there leave with :class:`RankRetired`;
    * anything else (caller bugs, kernel failures) propagates at once.

    A recovered call is bitwise identical to a fault-free one on the same
    grid, and value-identical after a re-plan wherever the accumulations
    are exact.  ``recoveries`` records every handled fault;
    :class:`FaultRecoveryError` (with that history) is raised when
    ``policy.max_retries`` is exhausted.
    """

    def __init__(self, problem: DistProblem,
                 session: Optional[Session] = None,
                 policy: Optional[RetryPolicy] = None):
        self.problem = problem
        self.session = session
        self.policy = policy or RetryPolicy()
        self.recoveries: List[dict] = []

    def _run(self, label: str, fn):
        attempt = 0
        delays = self.policy.delays()
        while True:
            try:
                return fn(self.problem)
            except RETRYABLE_ERRORS as e:
                e = faults.unwrap(e)
                attempt += 1
                rec = dict(op=label, attempt=attempt, error=repr(e),
                           family=self.problem.alg.name,
                           p=self.problem.p,
                           coord=getattr(e, "coord", None))
                self.recoveries.append(rec)
                reg = _metrics_active()
                if reg is not None:
                    reg.inc("elastic.faults", 1, op=label,
                            kind=type(e).__name__)
                    reg.inc("elastic.retries", 1, op=label)
                if self.session is not None:
                    rec["evicted"] = self.session.invalidate(self.problem)
                if attempt > self.policy.max_retries:
                    if reg is not None:
                        reg.inc("elastic.exhausted", 1, op=label)
                    raise FaultRecoveryError(
                        f"{label} failed after {attempt} attempts "
                        f"(budget {self.policy.max_retries}): {e}",
                        history=list(self.recoveries)) from e
                if isinstance(e, faults.DeviceLost):
                    self.problem = degrade(self.problem, e.rank)
                    rec["remeshed_to_p"] = self.problem.p
                    rec["family_after"] = self.problem.alg.name
                    if reg is not None:
                        reg.inc("elastic.degrades", 1, op=label)
                        reg.gauge("elastic.p", self.problem.p)
            # outside the handler: a generator resumed inside one keeps
            # the exception, and with it the failed call's frames
            delay = next(delays, self.policy.max_delay)
            if delay:
                self.policy.sleep(delay)

    # -- the shared-signature executors, resiliently -------------------------
    def sddmm(self, X, Y) -> SparseResult:
        return self._run("sddmm",
                         lambda p: p.sddmm(X, Y, session=self.session))

    def spmm(self, Y, vals=None):
        return self._run("spmm", lambda p: p.spmm(Y, vals=vals,
                                                  session=self.session))

    def spmm_t(self, A, vals=None):
        return self._run("spmm_t",
                         lambda p: p.spmm_t(A, vals=vals,
                                            session=self.session))

    def fusedmm(self, X, Y, elision: str = "auto"):
        return self._run("fusedmm",
                         lambda p: p.fusedmm(X, Y, elision=elision,
                                             session=self.session))

    def spmm_batched(self, Ys, vals=None, pad_to: int | None = None):
        return self._run(
            "spmm_batched",
            lambda p: p.spmm_batched(Ys, vals=vals, session=self.session,
                                     pad_to=pad_to))

    # -- derived-problem rounds, resiliently ---------------------------------
    def run_round(self, label: str, fn):
        """Run one round of ``fn(problem)`` under the typed retry loop.

        ``fn`` receives the CURRENT problem: after a ``DeviceLost`` the
        facade degrades ``self.problem`` onto the surviving grid and
        calls ``fn`` again with the re-planned problem, so ``fn`` must
        derive any per-round state from its argument rather than close
        over a pre-fault derivation."""
        return self._run(label, fn)


# ---------------------------------------------------------------------------
# Local-kernel routing (repro_torch.kernels.ops)
# ---------------------------------------------------------------------------

class _Router:
    """Routes ``ops.sddmm/spmm/fusedmm`` calls on a bound RowTiledCOO
    pack to the active DistProblem.  Only exact pack identity routes
    (and, for SpMM and FusedMM, the problem's row count); other packs
    and shapes fall through to the local kernels.  While a routed call
    runs nothing routes, so the problem's own executors, which call
    ``ops`` on their packs, never come back here.  (The reference also
    lets traced arguments fall through; eager torch has no tracers.)"""

    def __init__(self, problem: DistProblem, pack):
        self.problem, self.pack = problem, pack
        self.routed = 0            # calls routed so far
        self._busy = False
        self._slots = None

    def _owns(self, S, m=None) -> bool:
        return (S is self.pack and not self._busy
                and (m is None or m == self.problem.m))

    @contextlib.contextmanager
    def _routing(self):
        self._busy = True
        self.routed += 1
        try:
            yield
        finally:
            self._busy = False

    def _slot_index(self):
        """(position in the problem's COO, holds a nonzero) of every slot
        of the bound pack, matched on the host (:meth:`DistProblem.
        coo_sort`, :func:`_match_coo`) once and kept on the pack's
        device.  Padding slots point at (tile_base, 0), which may
        collide with a real nonzero, so a slot whose pack value is 0
        holds none."""
        if self._slots is None:
            S, prob = self.pack, self.problem
            key = (S.rows_global().reshape(-1).cpu().numpy().astype(np.int64)
                   * prob.n + S.cols.reshape(-1).cpu().numpy())
            idx, ok = _match_coo(*prob.coo_sort(), key)
            dev = S.vals.device
            ok = torch.from_numpy(ok).to(dev) & (S.vals.reshape(-1) != 0)
            self._slots = (torch.from_numpy(idx).to(dev), ok)
        return self._slots

    def _sample(self, result: SparseResult):
        """A distributed result re-injected into the bound pack's slots,
        in the dtype and on the device of the local kernel's result."""
        S = self.pack
        idx, ok = self._slot_index()
        vals = result.values_tensor().to(S.vals.device)
        out = torch.where(ok, torch.index_select(vals, 0, idx),
                          vals.new_zeros(()))
        return S.with_vals(out.reshape(S.vals.shape).to(S.vals.dtype))

    def sddmm(self, A, B, S):
        if not self._owns(S):
            return NotImplemented
        with self._routing():
            return self._sample(self.problem.sddmm(A, B))

    def spmm(self, S, B, m):
        if not self._owns(S, m):
            return NotImplemented
        with self._routing():
            out = gathered(self.problem.spmm(B))
        return out.to(device=B.device, dtype=B.dtype)

    def fusedmm(self, A, B, S, m):
        if not self._owns(S, m):
            return NotImplemented
        with self._routing():
            out, R = self.problem.fusedmm(A, B)
            R = self._sample(R)
        return gathered(out).to(device=B.device, dtype=B.dtype), R


@contextlib.contextmanager
def activate(problem: DistProblem, local_pack):
    """Route ``repro_torch.kernels.ops`` calls on ``local_pack`` through
    the distributed problem while the context is live (mesh-active
    mode); yields the router, whose ``routed`` counts the routed calls.
    An explicit ``backend=`` always runs the local kernels."""
    from repro_torch.kernels import ops
    prev = ops._DIST_ROUTER
    router = _Router(problem, local_pack)
    ops._DIST_ROUTER = router
    try:
        yield router
    finally:
        ops._DIST_ROUTER = prev
