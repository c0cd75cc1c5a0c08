"""1.5D dense-shifting, dense-replicating algorithms (paper Algorithm 1).

Port of ``repro.core.d15`` over the collective layer
(``core/collectives.py``: stacked, or one rank per process).

Grid: ("layer" = p/c, "fiber" = c).  The sparse matrix S is STATIONARY
(block (u, j) lives on rank (u, j % c)), one dense matrix is REPLICATED
along the fiber (all-gather input / reduce-scatter output), the other
PROPAGATES via cyclic shifts within each layer.

Block schedule: A row-block i lives on rank (i // c, i % c).  B row-block
j starts on rank (j // c, j % c); after t shifts rank (u, v) holds B
block ((u - t) mod L) * c + v.  The planner packs, for every (rank,
phase), the RowTiledCOO of the S block the local kernel needs, padded
per phase, plus a static kernel tiling chosen from the pack statistics.

Executors take and return tensors with leading (L, c) rank axes (the
blocks this process holds, ``Grid15.stack``): a pre-gathered operand is
(L, c, c * rows, r), and sampled values come back as one (L, c, nb_t, k)
tensor per phase.  Each phase runs the local kernel once per rank held.
The phase loops keep the reference's issue order: with ``overlap=True``
the shift of the *next* B is issued before the current phase's kernel
(in flight beside it under the torch.distributed backend; on the
stacked one only the order changes), and a traveling accumulator
precomputes the next phase's contribution while its shift is in
flight.  Shifts whose result no one reads (the
cycle-closing ones the reference's compiler drops) are not issued, so
the collective log equals :func:`schedule_words` event for event.

``comm="sparse"`` (support-pruned communication) replaces the fiber
all-gather with pruned permutes of the rows the receiver's blocks read,
and the B ring with direct pruned sends of each phase's chunk from its
home layer, where the plan's crossover says so (``PlanD15.smeta``).  The
"none" cell's replay round sends its chunks again, and the log counts
both rounds.  The traveling accumulators and the reduce-scatter stay
dense, so the results equal ``comm="dense"``'s bit for bit.

Modes (unified, per the paper's SpMM<->SDDMM conversion):
  sddmm_d15   : R = S * (A @ B.T)          A replicated-in, B shifts
  spmma_d15   : A = S @ B                  A replicated-out, B shifts
  spmmb_d15   : B = S.T @ A                A replicated-in, B shifts+accum
  fusedmm_d15 : FusedMM, elision in {"auto", "none", "reuse", "fused"}
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import common, costmodel
from repro_torch.core.collectives import (Backend, Ring, acc, coll_for,
                                          on_ranks)
from repro_torch.core.grid import Grid15
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PlanD15:
    """Per-(rank, phase) packs of S (or S^T) on the grid's device.

    Each field is a tuple with one stacked tensor per phase; block counts
    may differ across phases (per-phase padding).
    """
    rows_local: Tuple[torch.Tensor, ...]   # T x (L, c, nb_t, k) int32
    cols: Tuple[torch.Tensor, ...]
    vals: Tuple[torch.Tensor, ...]
    tile_base: Tuple[torch.Tensor, ...]    # T x (L, c, nb_t)
    m: int
    n: int
    r: int
    row_tile: int
    transpose: bool
    tiling: costmodel.Tiling
    meta: "MetaD15"
    # comm="sparse" support index sets: (gather_send, gather_recv,
    # shift_send, shift_recv), each a tuple of (L, c, w) int32 tensors
    # (per fiber offset / per phase); empty for dense plans
    sup: tuple = ()
    smeta: Optional[common.SparseMeta] = None
    #: (phase, L, c) nested tuples: each phase pack's real block count
    nreal: Optional[tuple] = None

    @property
    def block_shape(self) -> Tuple[int, int]:
        # (rows of the replicated/gathered matrix, rows of one B block)
        if self.transpose:
            return (self.nB, self.cmA)
        return (self.cmA, self.nB)

    @property
    def cmA(self):
        return self.meta.cmA

    @property
    def nB(self):
        return self.meta.nB


@dataclasses.dataclass(frozen=True, eq=False)
class MetaD15:
    cmA: int
    nB: int
    block_meta: common.BlockMeta


def plan_d15(grid: Grid15, rows, cols, vals, m: int, n: int, r: int, *,
             transpose: bool = False, row_tile: int = 256,
             nz_block: int = 256, group: int = 1, comm: str = "dense",
             compress=None) -> PlanD15:
    """Pack S for the 1.5D dense-shifting schedule (host, amortized).

    transpose=True packs S^T blocks (needed by replication-reuse FusedMM
    and by SpMMB).  ``group`` pads window runs so ``blocks_per_step`` up
    to ``group`` stays feasible.

    comm="sparse" also derives, from the same block structure, the
    per-rank support sets that let the executors prune the fiber
    all-gather (rows of the gathered operand any resident block reads)
    and the traveling B chunks (each phase's column support of the
    resident block); ``compress="bf16"`` ships those pruned payloads as
    bfloat16.
    """
    L, c, p = grid.L, grid.c, grid.p
    if m % p or n % p:
        raise ValueError(f"d15 needs p={p} to divide m={m} and n={n}")
    mA, nB = m // p, n // p
    cmA = c * mA
    blk_shape = (nB, cmA) if transpose else (cmA, nB)
    row_tile = common.choose_row_tile(blk_shape[0], row_tile)

    part = common.block_partition(np.asarray(rows), np.asarray(cols),
                                  np.asarray(vals), cmA, nB, p)
    rls, cls, vls, tbs, tilings, nreal = [], [], [], [], [], []
    row_off = np.zeros((L, L, c), np.int64)   # (phase, layer, fiber)
    col_off = np.zeros((L, L, c), np.int64)
    n_dense = cmA if transpose else nB        # rows of the gathered/shifted
    for t in range(L):                        # dense operand fed to kernels
        blocks = []
        for u in range(L):
            for v in range(c):
                j = ((u - t) % L) * c + v
                br, bc, bv = part.get((u, j), common.EMPTY)
                if transpose:
                    br, bc = bc, br
                    row_off[t, u, v], col_off[t, u, v] = j * nB, u * cmA
                else:
                    row_off[t, u, v], col_off[t, u, v] = u * cmA, j * nB
                blocks.append((br, bc, bv))
        rl, cl, vl, tb, nr = common.pack_block_list(
            blocks, blk_shape, row_tile, nz_block, group=group)
        nreal.append(nr.reshape(grid.shape))
        tilings.append(common.plan_tiling(tb, n_b=n_dense, r=r,
                                          k=nz_block, row_tile=row_tile))
        rls.append(common.put_ranks(rl, grid))
        cls.append(common.put_ranks(cl, grid))
        vls.append(common.put_ranks(vl, grid))
        tbs.append(common.put_ranks(tb, grid))

    meta = MetaD15(cmA, nB, common.BlockMeta(
        row_off, col_off, (n, m) if transpose else (m, n)))
    sup, smeta = ((), None) if comm != "sparse" else _sparse_sup(
        grid, rows, cols, mA, nB, compress)
    return PlanD15(tuple(rls), tuple(cls), tuple(vls), tuple(tbs),
                   m, n, r, row_tile, transpose,
                   common.merge_tilings(tilings), meta, sup, smeta,
                   common.count_table(np.stack(nreal)))


def _supports(grid: Grid15, rows, cols, cmA: int, nB: int):
    """The support sets, in pre-swap coordinates (the gathered operand is
    indexed by S's row axis, the traveling B chunk by its column axis,
    whichever orientation is packed): ``a[u * c + v]``, the block-local
    rows [0, cmA) that rank (u, v)'s blocks read over all phases (blocks
    (u, j) with j = v mod c), and ``b[u * p + j]``, the local columns
    [0, nB) of block (u, j).  Sorted; numpy passes over the nonzeros."""
    L, c, p = grid.L, grid.c, grid.p
    rows = np.asarray(rows).astype(np.int64)
    cols = np.asarray(cols).astype(np.int64)
    bu, lr = np.divmod(rows, cmA)
    bj, lc = np.divmod(cols, nB)
    a = common.split_sets(common.unique_sorted(
        (bu * c + bj % c) * cmA + lr, L * c * cmA), L * c, cmA)
    b = common.split_sets(common.unique_sorted(
        (bu * p + bj) * nB + lc, L * p * nB), L * p, nB)
    return a, b


def _sparse_sup(grid: Grid15, rows, cols, mA: int, nB: int, compress):
    """Pad and align the comm="sparse" support sets on the grid's device.

    Gather channel (offset d, rank (u, v)): as a *sender* it ships the
    slab-local rows of its own A slab that receiver (u, (v+d) % c)'s
    support touches; as a *receiver* it scatters at the absolute rows of
    its support falling in sender (v-d) % c's slab.  Shift channel
    (phase t >= 1): the home layer of the chunk rank (u, v) reads at
    phase t is (u-t) % L, so sender i ships to (i+t) % L the column
    support of the receiver's phase-t resident block.  Per channel: if
    the padded support words are not under SPARSE_CROSSOVER x the dense
    words, the channel stays dense (flag off).
    """
    L, c, p = grid.L, grid.c, grid.p
    cmA = c * mA
    cross = costmodel.SPARSE_CROSSOVER
    a, b = _supports(grid, rows, cols, cmA, nB)
    g_send, g_recv, wg, gather = (), (), 0, False
    if c > 1:
        send_sets = np.empty((c - 1, L, c), object)
        recv_sets = np.empty((c - 1, L, c), object)
        w = 1
        for d in range(1, c):
            for u in range(L):
                for v in range(c):
                    rcv = a[u * c + (v + d) % c]
                    send_sets[d - 1, u, v] = (
                        rcv[(rcv >= v * mA) & (rcv < (v + 1) * mA)] - v * mA)
                    own = a[u * c + v]
                    sv = (v - d) % c
                    recv_sets[d - 1, u, v] = \
                        own[(own >= sv * mA) & (own < (sv + 1) * mA)]
                    w = max(w, send_sets[d - 1, u, v].size)
        gather = w <= cross * mA
        if gather:
            wg = w
            g_send = tuple(common.put_sets(send_sets[d], wg, 0, grid)
                           for d in range(c - 1))
            g_recv = tuple(common.put_sets(recv_sets[d], wg, cmA, grid)
                           for d in range(c - 1))
    s_send, s_recv, ws, shift = (), (), (), False
    if L > 1:
        widths, sends, recvs = [], [], []
        for t in range(1, L):
            ssend = np.empty((L, c), object)
            srecv = np.empty((L, c), object)
            w = 1
            for i in range(L):
                for v in range(c):
                    ssend[i, v] = b[((i + t) % L) * p + i * c + v]
                    srecv[i, v] = b[i * p + ((i - t) % L) * c + v]
                    w = max(w, srecv[i, v].size)
            widths.append(w)
            sends.append(ssend)
            recvs.append(srecv)
        shift = sum(widths) <= cross * (L - 1) * nB
        if shift:
            ws = tuple(widths)
            s_send = tuple(common.put_sets(sends[i], ws[i], 0, grid)
                           for i in range(L - 1))
            s_recv = tuple(common.put_sets(recvs[i], ws[i], nB, grid)
                           for i in range(L - 1))
    sup = (g_send, g_recv, s_send, s_recv)
    return sup, common.SparseMeta(gather=gather, shift=shift, wg=wg, ws=ws,
                                  compress=compress)


def _coo(grid, plan: PlanD15, t: int, u: int, v: int, vals=None):
    """Rank (u, v)'s phase-t pack, optionally with new values."""
    i = grid.at(u, v)
    return common.coo_of(plan.rows_local[t][i], plan.cols[t][i],
                         plan.vals[t][i] if vals is None else vals[i],
                         plan.tile_base[t][i], plan.block_shape,
                         plan.row_tile, plan.tiling,
                         common.real_blocks(plan.nreal, (t, u, v)))


def _shift_sparse(plan: PlanD15) -> bool:
    return plan.smeta is not None and plan.smeta.shift


def _b_ring(coll, plan: PlanD15, B, n_shifts, overlap):
    """B phase by phase: the dense ring of ``n_shifts`` shifts, or, where
    the plan prunes the shift channel, phase t's chunk by a direct pruned
    send from its home layer (t = 1 .. L-1; phase 0's is local, and B
    stays home)."""
    if not _shift_sparse(plan):
        return Ring(coll, lambda y, k: coll.shift(y), B, n_shifts, overlap)
    _, _, send, recv = plan.sup
    return common.pruned_ring(coll, B, send, recv, coll.grid.layer, 1,
                              plan.nB, compress=plan.smeta.compress,
                              overlap=overlap)


def _sddmm_phase(grid, plan, t, T, B_t, swap, tk):
    def one(u, v):
        i = grid.at(u, v)
        args = (B_t[i], T[i]) if swap else (T[i], B_t[i])
        return ops.sddmm(*args, _coo(grid, plan, t, u, v), **tk).vals
    return on_ranks(grid, one)


def _spmm_phase(grid, plan, t, vals, D, m, tk):
    def one(u, v):
        i = grid.at(u, v)
        return ops.spmm(_coo(grid, plan, t, u, v, vals), D[i], m=m, **tk)
    return on_ranks(grid, one)


def _sddmm_phases(grid, coll, plan, T, B0, overlap, tk, swap=False,
                  keep_home=False):
    """L SDDMM phases against a shifting B; returns (vals list, B home).

    ``keep_home`` issues the L-th shift, which brings B back home for a
    second round; otherwise the round's final position is dead.  (Pruned
    chunks leave B home.)"""
    ring = _b_ring(coll, plan, B0, grid.L if keep_home else grid.L - 1,
                   overlap)
    vals_out = []
    for t in range(grid.L):
        vals_out.append(_sddmm_phase(grid, plan, t, T, ring.cur, swap, tk))
        ring.advance()
    if not keep_home:
        return vals_out, None
    return vals_out, B0 if _shift_sparse(plan) else ring.cur


def _gather(coll, plan: PlanD15, A, pre_gathered):
    """Fiber replication of the stationary operand, pruned where the plan
    says so; a pre-gathered operand passes through."""
    if pre_gathered:
        return A
    sm = plan.smeta
    if sm is None or not sm.gather:
        return coll.all_gather(A)
    send, recv = plan.sup[:2]
    return common.pruned_gather_rows(coll, A, send, recv,
                                     compress=sm.compress,
                                     point=("gather", 0))


def _phase_shift(n_phases: int, start: int = 0):
    out = []
    for t in range(start, start + n_phases):
        out += [("phase", t), ("shift", t)]
    return out


def schedule_events(grid: Grid15, op: str, elision: str = "none"):
    """Ordered (point, phase) boundaries of one executor round: an
    optional fiber all-gather, L phase/shift pairs per structure pass
    (two passes for the unfused/reuse FusedMM cells), and a terminal
    reduce-scatter where the output is replicated-out."""
    L = grid.L
    if op == "sddmm":
        return [("gather", 0)] + _phase_shift(L)
    if op == "spmm":
        return _phase_shift(L) + [("reduce", L - 1)]
    if op == "spmm_t":                       # spmmb: AG in, B accumulates
        return [("gather", 0)] + _phase_shift(L)
    if op == "fusedmm":
        if elision == "reuse":               # FusedMMB: single AG, 2 passes
            return [("gather", 0)] + _phase_shift(2 * L)
        if elision == "fused":               # one structure pass
            return [("gather", 0)] + _phase_shift(L) + [("reduce", L - 1)]
        return ([("gather", 0)] + _phase_shift(2 * L)
                + [("reduce", 2 * L - 1)])
    raise ValueError(f"unknown op {op!r}")


def schedule_words(grid: Grid15, plan: PlanD15, op: str,
                   elision: str = "none", pre_gathered: bool = False):
    """Per-device wire words for each schedule event.

    Returns ``(point, phase, kind, words)`` tuples aligned 1:1 with
    :func:`schedule_events`; ``kind`` names the collective (None for
    compute phases), and a cycle-closing shift whose result no one reads
    costs 0 words.  The executors' collective log (``log`` of either
    backend in ``collectives``) holds exactly the events with words.
    """
    L, c, p = grid.L, grid.c, grid.p
    ag = 0.0 if pre_gathered else float((c - 1) * (plan.m // p) * plan.r)
    rs = float((c - 1) * (plan.m // p) * plan.r)
    sh = float((plan.n // p) * plan.r)
    if op in ("sddmm", "spmm"):
        dead = {L - 1}              # result of the cycle-closing shift
    elif op == "spmm_t":
        dead = set()                # the traveling buffer IS the output
    elif op == "fusedmm":
        el = resolve_elision(elision, plan.transpose)
        dead = {2 * L - 1} if el == "none" else {L - 1}
    else:
        raise ValueError(f"unknown op {op!r}")
    out = []
    for point, t in schedule_events(grid, op, elision):
        if point == "gather":
            out.append((point, t, "all-gather", ag))
        elif point == "reduce":
            out.append((point, t, "reduce-scatter", rs))
        elif point == "shift":
            out.append((point, t, "collective-permute",
                        0.0 if t in dead else sh))
        else:
            out.append((point, t, None, 0.0))
    return out


def resolve_elision(elision: str, transpose: bool) -> str:
    """Resolve ``"auto"`` for the pack in hand: a transpose pack admits
    replication reuse (FusedMMB) alone; for a normal pack local fusion
    beats the unoptimized sequence at every c (Table III)."""
    if elision != "auto":
        return elision
    return "reuse" if transpose else "fused"


# ---------------------------------------------------------------------------
# Unified Algorithm 1: SDDMM / SpMMA / SpMMB
# ---------------------------------------------------------------------------


def sddmm_d15(grid: Grid15, plan: PlanD15, A, B, overlap: bool = True,
              pre_gathered: bool = False, *, coll: Backend | None = None,
              backend: str | None = None):
    """R = S * (A @ B.T); returns per-phase vals, T x (L, c, nb_t, k).

    pre_gathered=True: A arrives already fiber-replicated, (L, c, c * m/p,
    r), and the all-gather is skipped."""
    coll = coll_for(grid, coll)
    T = _gather(coll, plan, A, pre_gathered)                     # (c m/p, r)
    r_vals, _ = _sddmm_phases(grid, coll, plan, T, B, overlap,
                              common.kernel_kwargs(plan, backend))
    return tuple(r_vals)


def spmma_d15(grid: Grid15, plan: PlanD15, B, overlap: bool = True, *,
              coll: Backend | None = None, backend: str | None = None):
    """A = S @ B with A replicated as output, reduce-scattered at the end."""
    coll = coll_for(grid, coll)
    tk = common.kernel_kwargs(plan, backend)
    ring = _b_ring(coll, plan, B, grid.L - 1, overlap)
    T = None
    for t in range(grid.L):
        T = acc(T, _spmm_phase(grid, plan, t, None, ring.cur, plan.cmA,
                                tk))
        ring.advance()
    return coll.psum_scatter(T)


def spmmb_d15(grid: Grid15, plan: PlanD15, A, overlap: bool = True,
              pre_gathered: bool = False, *, coll: Backend | None = None,
              backend: str | None = None):
    """B = S.T @ A: A replicated-in; the shifting B buffer accumulates.

    The traveling buffer is an accumulator, so its shift depends on the
    local kernel; overlap instead precomputes the *next* phase's local
    contribution before the current shift."""
    if not plan.transpose:
        raise ValueError("spmmb_d15 needs a transpose-packed plan")
    coll = coll_for(grid, coll)
    tk = common.kernel_kwargs(plan, backend)
    T = _gather(coll, plan, A, pre_gathered)
    return _traveling_spmm(grid, coll, plan, T, None, overlap, tk)


def _traveling_spmm(grid, coll, plan, T, r_vals, overlap, tk):
    """L phases of S^T-pack SpMM against T whose (nB, r) output travels
    the ring and arrives home after the full cycle."""
    L = grid.L

    def contrib(t):
        return _spmm_phase(grid, plan, t,
                           None if r_vals is None else r_vals[t], T,
                           plan.nB, tk)

    B_cur = None
    if overlap:
        nxt = contrib(0)
        for t in range(L):
            B_cur, works = coll.issue(lambda: coll.shift(acc(B_cur, nxt)))
            if t + 1 < L:
                nxt = contrib(t + 1)
            coll.wait(works)
    else:
        for t in range(L):
            B_cur = coll.shift(acc(B_cur, contrib(t)))
    return B_cur


# ---------------------------------------------------------------------------
# FusedMM with the paper's three strategies
# ---------------------------------------------------------------------------

def fusedmm_d15(grid: Grid15, plan: PlanD15, A, B, elision: str = "auto",
                overlap: bool = True, pre_gathered: bool = False, *,
                coll: Backend | None = None, backend: str | None = None):
    """FusedMM on the 1.5D dense-shifting grid.

    elision="auto"  : resolve via the cost model (see resolve_elision)
    elision="none"  : FusedMMA, SDDMM then SpMMA (2 rounds, AG + RS)
    elision="reuse" : FusedMMB on the S^T pack (2 rounds, single AG)
    elision="fused" : FusedMMA via the fused local kernel (1 round, AG + RS)

    pre_gathered=True: the first dense operand arrives already replicated
    along the fiber and the all-gather is skipped (Session reuse).

    Returns (stacked out, per-phase R vals tuple).
    """
    elision = resolve_elision(elision, plan.transpose)
    coll = coll_for(grid, coll)
    tk = common.kernel_kwargs(plan, backend)
    L = grid.L

    if elision == "none":
        if plan.transpose:
            raise ValueError("elision='none' needs a normal-packed plan")
        T = _gather(coll, plan, A, pre_gathered)
        r_vals, B_home = _sddmm_phases(grid, coll, plan, T, B, overlap, tk,
                                       keep_home=True)
        ring = _b_ring(coll, plan, B_home, L - 1, overlap)
        T2 = None
        for t in range(L):
            T2 = acc(T2, _spmm_phase(grid, plan, t, r_vals[t], ring.cur,
                                      plan.cmA, tk))
            ring.advance()
        return coll.psum_scatter(T2), tuple(r_vals)

    if elision == "reuse":
        # FusedMMB: replicate A once; it serves the SDDMM *and* the SpMMB.
        if not plan.transpose:
            raise ValueError("elision='reuse' needs a transpose-packed plan")
        T = _gather(coll, plan, A, pre_gathered)                 # single AG
        r_vals, _ = _sddmm_phases(grid, coll, plan, T, B, overlap, tk,
                                  swap=True)
        out = _traveling_spmm(grid, coll, plan, T, r_vals, overlap, tk)
        return out, tuple(r_vals)

    if elision == "fused":
        if plan.transpose:
            raise ValueError("elision='fused' needs a normal-packed plan")
        T = _gather(coll, plan, A, pre_gathered)
        ring = _b_ring(coll, plan, B, L - 1, overlap)
        T2, r_vals = None, []
        for t in range(L):
            contrib, R_t = on_ranks(grid, lambda u, v: _fused_local(
                grid, plan, t, u, v, T, ring.cur, tk))
            T2 = acc(T2, contrib)
            r_vals.append(R_t)
            ring.advance()
        return coll.psum_scatter(T2), tuple(r_vals)

    raise ValueError(f"unknown elision {elision!r}")


def _fused_local(grid, plan, t, u, v, T, B_t, tk):
    i = grid.at(u, v)
    out, R = ops.fusedmm(T[i], B_t[i], _coo(grid, plan, t, u, v),
                         m=plan.cmA, **tk)
    return out, R.vals
