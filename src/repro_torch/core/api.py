"""Unified distributed-algorithm API: Algorithm registry, DistProblem,
Session (paper §V + §VI-E applications).

Port of ``repro.core.api``, d15 slice: the registry holds the 1.5D
dense-shifting family only (s15, d25 and s25 come with later slices), so
``algorithm="auto"`` ranks the registered families alone.

* **Algorithm** -- registry entry binding a family's planner and its
  sddmm/spmm/fusedmm executors to a shared signature with *FusedMMA
  semantics*: ``fusedmm(S, X, Y) = (S * (X @ Y.T)) @ Y``, output
  ``(m, r)``.  The "reuse" cell runs the FusedMMB executor on the
  transpose pack with swapped operands.
* **DistProblem** -- owns the host COO of S, the grid, and the packs in
  every orientation the chosen strategies need (built lazily).
* **Session** -- caches the fiber-gathered copy of a dense operand
  across calls, keyed by content; cached calls equal uncached ones bit
  for bit.

Dense results come back as torch tensors on the grid's device (the
reference assembles numpy on the host); sampled results are
:class:`SparseResult` with host (numpy) COO views.  Every executor call
records its collectives in ``DistProblem.last_collectives``.  The fault
guard and the tracer hooks of the reference come with their slices.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import costmodel, d15
from repro_torch.core.collectives import Stacked
from repro_torch.core.grid import make_grid15

__all__ = [
    "ALGORITHMS", "Algorithm", "DistProblem", "Session", "SparseResult",
    "make_problem", "sddmm", "spmm", "spmm_t", "fusedmm",
]

_LATER = ("the {} family is not ported yet: the registry of this slice "
          "holds d15 only")


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


@dataclasses.dataclass
class SparseResult:
    """Sampled (SDDMM-shaped) output in its family's home layout.

    ``raw`` keeps the device tensors exactly as the executor returned
    them (one (L, c, nb_t, k) tensor per phase for d15); ``_triples``
    assembles the flat global COO view on the host.
    """
    problem: "DistProblem"
    raw: object
    _triples: Callable[[], tuple]
    _coo: Optional[tuple] = None
    _vals: Optional[np.ndarray] = None

    def to_coo(self):
        """Flat global (rows, cols, vals) numpy, padding filtered."""
        if self._coo is None:
            self._coo = self._triples()
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

    def make_grid(self, c: int, devices):
        raise NotImplementedError

    def make_plan(self, prob, orient: str):
        raise NotImplementedError

    def feasible(self, *, m: int, n: int, r: int, p: int, c: int) -> bool:
        return costmodel.family_feasible(self.name, m=m, n=n, r=r, p=p, c=c)

    def min_r_multiple(self, grid) -> int:
        return 1

    def schedule_words(self, prob, op: str, elision: str = "none",
                       session: Optional["Session"] = None):
        """Modeled per-device wire words for each schedule event, aligned
        1:1 with :meth:`schedule_events`; ``session`` models the
        pre-gathered program."""
        plan, pre = self._words_plan(prob, op, elision, session)
        return self._sched_mod.schedule_words(prob.grid, plan, op,
                                              elision=elision,
                                              pre_gathered=pre)

    def _words_plan(self, prob, op, elision, session):
        raise NotImplementedError

    def _run(self, prob, call, backend):
        fn, args, kwargs, post = call
        coll = Stacked(prob.grid)
        res = fn(*args, **kwargs, coll=coll, backend=backend)
        prob.last_collectives = coll
        return post(res)

    def sddmm(self, prob, X, Y, session=None, backend=None) -> SparseResult:
        return self._run(prob, self._sddmm_call(prob, X, Y, session),
                         backend)

    def spmm(self, prob, Y, vals=None, session=None, backend=None):
        return self._run(prob, self._spmm_call(prob, Y, vals, session),
                         backend)

    def spmm_t(self, prob, A, vals=None, session=None, backend=None):
        return self._run(prob, self._spmm_t_call(prob, A, vals, session),
                         backend)

    def fusedmm(self, prob, X, Y, elision: str,
                session: Optional["Session"], backend=None):
        return self._run(prob, self._fusedmm_call(prob, X, Y, elision,
                                                  session), backend)

    def _sddmm_call(self, prob, X, Y, session):
        raise NotImplementedError

    def _spmm_call(self, prob, Y, vals, session):
        raise NotImplementedError

    def _spmm_t_call(self, prob, A, vals, session):
        raise NotImplementedError

    def _fusedmm_call(self, prob, X, Y, elision, session):
        raise NotImplementedError


def register(cls):
    alg = cls()
    ALGORITHMS[alg.name] = alg
    return cls


def _dense(prob, x) -> torch.Tensor:
    """A float32 tensor on the grid's device (numpy input is copied)."""
    dev = prob.grid.device
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


# ---------------------------------------------------------------------------
# 1.5D dense shifting
# ---------------------------------------------------------------------------

@register
class _D15(Algorithm):
    name = "d15"
    elisions = ("none", "reuse", "fused")
    auto_elisions = ("none", "reuse", "fused")
    _sched_mod = d15

    def make_grid(self, c, devices):
        return make_grid15(c, devices=devices)

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

    def replicate(self, prob, arr, slot):
        g = prob.grid
        full = _dense(prob, arr)
        if isinstance(arr, torch.Tensor):
            full = full.clone()     # the cache owns its copy
        lay = full.reshape(g.L, 1, full.shape[0] // g.L, full.shape[1])
        return lay.expand(g.L, g.c, *lay.shape[2:])

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
        if session is not None:
            a, pre = session.replicate(prob, X, "x"), True
        else:
            a, pre = self.shard_x(prob, X), False

        def post(rv):
            return SparseResult(prob, rv,
                                lambda: plan.meta.block_meta.to_triples(
                                    plan.rows_local, plan.cols, rv,
                                    plan.tile_base))

        return (d15.sddmm_d15, (prob.grid, plan, a, self.shard_y(prob, Y)),
                dict(pre_gathered=pre), post)

    def _spmm_call(self, prob, Y, vals, session):
        # B shifts and the output reduce-scatters: nothing inbound is
        # replicated, so there is no gather for a session to serve
        plan = prob.injected_plan("normal", vals)
        return (d15.spmma_d15, (prob.grid, plan, self.shard_y(prob, Y)),
                {}, prob.grid.unstack)

    def _spmm_t_call(self, prob, A, vals, session):
        # spmmb on S's transpose pack, which is the TRANSPOSED problem's
        # "transpose" orientation; the gather of A is Session-replayable
        plan = prob.transposed().injected_plan("transpose", vals)
        if session is not None:
            a, pre = session.replicate(prob, A, "x"), True
        else:
            a, pre = self.shard_x(prob, A), False
        return (d15.spmmb_d15, (prob.grid, plan, a),
                dict(pre_gathered=pre), prob.grid.unstack)

    def _fusedmm_call(self, prob, X, Y, elision, session):
        grid = prob.grid
        if elision == "reuse":
            # FusedMMA(S, X, Y) = FusedMMB(S^T, Y, X): Y takes the
            # replicated slot, X the shifting slot, on the S^T pack.
            plan = prob.plan("transpose")
            a_host, slot = Y, "y"
            b = self.shard_x(prob, X)
        else:
            plan = prob.plan("normal")
            a_host, slot = X, "x"
            b = self.shard_y(prob, Y)
        if session is not None:
            a, pre = session.replicate(prob, a_host, slot), True
        else:
            a, pre = self.shard_x(prob, a_host), False

        def post(res):
            out, rvals = res
            return grid.unstack(out), SparseResult(
                prob, rvals, lambda: plan.meta.block_meta.to_triples(
                    plan.rows_local, plan.cols, rvals, plan.tile_base))

        return (d15.fusedmm_d15, (grid, plan, a, b),
                dict(elision=elision, pre_gathered=pre), post)


# ---------------------------------------------------------------------------
# DistProblem
# ---------------------------------------------------------------------------

_COST_NAME = costmodel.ELISION_COST_NAME


@dataclasses.dataclass
class DistProblem:
    """A packed sparse matrix + dense layouts bound to one algorithm/grid.

    Plans are built lazily per orientation and cached, so repeated calls
    pay the host packing once, like the paper's preprocessing."""
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
    _posmaps: dict = dataclasses.field(default_factory=dict)
    _coo_sort: Optional[tuple] = None
    _transposed: Optional["DistProblem"] = None
    #: the collective log of the last executor call on this problem
    last_collectives: Optional[Stacked] = None

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
        base = dict(_plans={}, _derived_r={}, _posmaps={}, _transposed=None,
                    last_collectives=None)
        base.update(changes)
        return dataclasses.replace(self, **base)

    # -- planning ------------------------------------------------------------
    def plan(self, orient: str = "normal"):
        if orient not in self._plans:
            self._plans[orient] = self.alg.make_plan(self, orient)
        return self._plans[orient]

    def _posmap(self, orient: str):
        """Pack-slot -> host-COO-position map for one orientation, from a
        position-coded plan (entry i carries i+1; padding stays 0)."""
        if orient not in self._posmaps:
            posvals = np.arange(1, self.nnz + 1, dtype=np.float32)
            tmp = self._derive(vals=posvals)
            pv = self.alg.make_plan(tmp, orient).vals
            self._posmaps[orient] = tuple(
                a.cpu().numpy().astype(np.int64) for a in pv)
        return self._posmaps[orient]

    def injected_plan(self, orient: str, vals=None):
        """This orientation's plan with ``vals`` (host COO order)
        substituted into the value slots: only values move, the structure
        is packed once.  Re-packs above 2^24 nonzeros, where float32
        position coding would alias."""
        if vals is None:
            return self.plan(orient)
        vals = np.asarray(vals, np.float32)
        if self.nnz >= (1 << 24):
            return self.with_values(vals).plan(orient)
        base = self.plan(orient)
        pos = self._posmap(orient)
        lookup = np.concatenate([np.zeros(1, np.float32), vals])
        new_vals = tuple(torch.from_numpy(lookup[p]).to(o.device)
                         for p, o in zip(pos, base.vals))
        return dataclasses.replace(base, vals=new_vals)

    def coo_sort(self):
        """(sorted coordinate keys, argsort order), cached."""
        if self._coo_sort is None:
            key = self.rows.astype(np.int64) * self.n + self.cols
            order = np.argsort(key, kind="stable")
            self._coo_sort = (key[order], order)
        return self._coo_sort

    # -- derived problems ----------------------------------------------------
    def with_values(self, vals) -> "DistProblem":
        """Same structure, new sample values (re-packs on first use)."""
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().numpy()
        vals = np.asarray(vals, np.float32)
        if vals.shape != self.rows.shape:
            raise ValueError(f"vals of shape {vals.shape} for a pattern of "
                             f"{self.rows.shape[0]} nonzeros")
        return self._derive(vals=vals, _posmaps=self._posmaps)

    def with_r(self, r: int) -> "DistProblem":
        """Same sparse matrix, different dense-operand width (cached)."""
        if r == self.r:
            return self
        if r not in self._derived_r:
            mult = self.alg.min_r_multiple(self.grid)
            if r % mult:
                raise ValueError(f"r={r} must be a multiple of {mult} "
                                 f"for {self.alg.name} on this grid")
            self._derived_r[r] = self._derive(r=r)
        return self._derived_r[r]

    def transposed(self) -> "DistProblem":
        """The S^T problem on the same grid (cached, round-trips)."""
        if self._transposed is None:
            if not self.alg.feasible(m=self.n, n=self.m, r=self.r,
                                     p=self.p, c=self.c):
                raise ValueError(f"{self.alg.name} infeasible for the "
                                 f"transposed shape ({self.n}, {self.m})")
            tp = self._derive(rows=self.cols, cols=self.rows, m=self.n,
                              n=self.m, _coo_sort=None)
            tp._transposed = self
            self._transposed = tp
        return self._transposed

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
        return self.alg.sddmm(self, X, Y, session=session, backend=backend)

    def spmm(self, Y, vals=None, session: Optional["Session"] = None, *,
             backend: str | None = None) -> torch.Tensor:
        """out = S(vals) @ Y, (m, r) on the grid's device; Y is (n, r)."""
        return self.alg.spmm(self, Y, vals=vals, session=session,
                             backend=backend)

    def spmm_t(self, A, vals=None, session: Optional["Session"] = None, *,
               backend: str | None = None) -> torch.Tensor:
        """out = S(vals)^T @ A, (n, r) on the grid's device; A is (m, r)."""
        if vals is not None:
            vals = np.asarray(vals, np.float32)
        return self.alg.spmm_t(self, A, vals=vals, session=session,
                               backend=backend)

    def fusedmm(self, X, Y, elision: str = "auto",
                session: Optional["Session"] = None, *,
                backend: str | None = None):
        """out = (S * (X @ Y.T)) @ Y, (m, r) on the grid's device.

        Returns (out, SparseResult of the intermediate R).  ``backend``
        ("cuda" or "ref") picks the local kernels; None is the default
        of :mod:`repro_torch.kernels.ops`."""
        el = self.resolve_elision(elision, session)
        return self.alg.fusedmm(self, X, Y, el, session, backend=backend)

    def schedule_words(self, op: str, elision: str = "auto",
                       session: Optional["Session"] = None):
        """Modeled per-device wire words of one ``op`` round."""
        el = (self.resolve_elision(elision, session)
              if op == "fusedmm" else "none")
        return self.alg.schedule_words(self, op, el, session=session)


# ---------------------------------------------------------------------------
# Session: across-call replication reuse
# ---------------------------------------------------------------------------

def _host_bytes(arr) -> Tuple[tuple, str, bytes]:
    if isinstance(arr, torch.Tensor):
        a = arr.detach().cpu().numpy()
    else:
        a = np.asarray(arr)
    return a.shape, str(a.dtype), a.tobytes()


class Session:
    """Caches fiber-replicated dense operands across executor calls.

    Keyed by operand CONTENT (grid, family, slot, shape, dtype, byte
    digest), so a stationary operand hits on every call while a changed
    one is replicated fresh.  An identity memo skips the digest for the
    same object: numpy operands are re-verified by a sum fingerprint,
    tensors by their in-place version counter.  LRU-bounded."""

    def __init__(self, max_entries: int = 16):
        self._cache = collections.OrderedDict()
        self._id_memo = collections.OrderedDict()
        self._max_entries = max_entries
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(problem: "DistProblem", arr, slot: str):
        shape, dtype, data = _host_bytes(arr)
        digest = hashlib.blake2b(data, digest_size=16).hexdigest()
        return (id(problem.grid), problem.alg.name, problem.comm, slot,
                shape, dtype, digest)

    @staticmethod
    def _cheap_fp(arr):
        if isinstance(arr, np.ndarray):
            return (arr.shape, str(arr.dtype),
                    float(arr.sum(dtype=np.float64)))
        if isinstance(arr, torch.Tensor):
            return (tuple(arr.shape), str(arr.dtype), arr._version)
        return None

    def _content_key(self, problem: "DistProblem", arr, slot: str):
        memo_k = (id(problem.grid), problem.alg.name, problem.comm, slot,
                  id(arr))
        memo = self._id_memo.get(memo_k)
        fp = self._cheap_fp(arr)
        if memo is not None and memo[0]() is arr and memo[2] == fp:
            self._id_memo.move_to_end(memo_k)
            return memo[1]
        key = self._key(problem, arr, slot)
        try:
            ref = weakref.ref(arr)
        except TypeError:
            return key                     # un-weakref-able: no memo
        self._id_memo[memo_k] = (ref, key, fp)
        while len(self._id_memo) > 4 * self._max_entries:
            self._id_memo.popitem(last=False)
        return key

    def replicate(self, problem: "DistProblem", arr, slot: str):
        key = self._content_key(problem, arr, slot)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return hit
        rep = problem.alg.replicate(problem, arr, slot)
        self._cache[key] = rep
        self.misses += 1
        while len(self._cache) > self._max_entries:
            self._cache.popitem(last=False)
        return rep

    def stats(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    entries=len(self._cache), capacity=self._max_entries)

    def __len__(self):
        return len(self._cache)


# ---------------------------------------------------------------------------
# Construction + module-level conveniences
# ---------------------------------------------------------------------------

def make_problem(rows, cols, vals, shape: Tuple[int, int], r: int, *,
                 algorithm: str = "auto", c: int | None = None,
                 devices=None, row_tile: int = 32,
                 nz_block: int = 32, comm: str = "dense",
                 compress: Optional[str] = None) -> DistProblem:
    """Build a DistProblem, dispatching the algorithm by the cost model.

    ``devices=None`` means one CUDA device (raises without one); pass
    ``[torch.device("cpu")] * p`` for p stacked ranks on the CPU.
    algorithm="auto" ranks the registered families' feasible (family,
    elision, c) by Table III; a family name pins it.  Only the dense wire
    format is ported.
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
    if comm == "sparse" or compress is not None:
        raise NotImplementedError(
            "comm='sparse' and compress= are not ported yet; they come "
            "with the comm='sparse' slice")
    if algorithm != "auto" and algorithm not in ALGORITHMS:
        if algorithm in costmodel.FAMILIES:
            raise NotImplementedError(_LATER.format(algorithm))
        raise ValueError(f"unknown algorithm {algorithm!r}; registered: "
                         f"{sorted(ALGORITHMS)}")
    grid_devices = list(devices) if devices is not None else None
    p = len(grid_devices) if grid_devices is not None else 1
    families = tuple(ALGORITHMS) if algorithm == "auto" else (algorithm,)
    choice = costmodel.choose_algorithm(m=m, n=n, nnz=len(vals), r=r, p=p,
                                        c=c, families=families)
    alg = ALGORITHMS[choice.family]
    grid = alg.make_grid(choice.c, grid_devices)
    return DistProblem(alg, grid, np.asarray(rows), np.asarray(cols),
                       np.asarray(vals, np.float32), m, n, r,
                       row_tile=row_tile, nz_block=nz_block, comm=comm,
                       compress=compress)


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


def fusedmm(problem: DistProblem, X, Y, elision: str = "auto",
            session: Optional[Session] = None, *,
            backend: str | None = None):
    """Distributed FusedMM with FusedMMA semantics,
    ``out = (S * (X @ Y.T)) @ Y``; returns ``(out, SparseResult R)``.
    d15 honours the elisions none, reuse and fused; "auto" ranks them by
    the Table-III words (steady-state words with a ``session``)."""
    return problem.fusedmm(X, Y, elision=elision, session=session,
                           backend=backend)
