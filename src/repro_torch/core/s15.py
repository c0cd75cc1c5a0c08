"""1.5D sparse-shifting, dense-replicating algorithms (paper §V-B).

Port of ``repro.core.s15`` over the collective layer
(``core/collectives.py``: stacked, or one rank per process).

Grid: ("layer" = p/c, "fiber" = c).  The DENSE matrices are stationary,
column-split across ranks and replicated (all-gathered) along the fiber;
the SPARSE matrix propagates: row-blocks of S cyclically shift within
each layer, carrying partially accumulated sample values.

Layout: rank (u, v) at rest holds
  A[:, W_u,v], B[:, W_u,v]   column slices of width r/p, stacked
                             (L, c, rows, r/p)
  S row-block b = u*c + v    (height m/p), row-tiled pack

After the fiber all-gather each rank holds the full-height slices
A[:, W_u], B[:, W_u] of width r*c/p, stacked (L, c, rows, r*c/p) (a
view shared by the fiber).  A nonzero's dot product accumulates as its
block visits every layer position u (covering all r columns); the block
returns home after a full cycle, where the partial dots are scaled by
the original sample values.  The SpMM round shifts the (now final)
values again, emitting per-phase output slabs out[rows(b_t), W_u],
stacked (L, c, L, m/p, r*c/p) and reassembled by
:func:`assemble_spmm_out`.

Every shift is issued after the kernel that reads the current pack (the
serial form of the reference's double buffer; on one stream the order
changes nothing), and a shift whose result no one reads is not issued,
so the collective log equals :func:`schedule_words` event for event.
``tile_base`` travels only when a block has more than one row window, as
in the reference's compiled program.

``comm="sparse"``: rank (u, v) only reads the A rows and B rows its
resident blocks touch -- blocks b = v (mod c), the same for every layer
position u -- so each fiber all-gather of a dense column slab ships only
those rows, where the plan's crossover says so (``PlanS15.smeta``).  The
COO propagation is the sparse payload itself and stays as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import common, costmodel
from repro_torch.core.collectives import Backend, coll_for, on_ranks
from repro_torch.core.grid import Grid15
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PlanS15:
    rows_local: torch.Tensor   # (L, c, nb, k) int32, one home block a rank
    cols: torch.Tensor
    vals: torch.Tensor         # original sample values (stay home)
    tile_base: torch.Tensor    # (L, c, nb)
    m: int
    n: int
    r: int
    row_tile: int
    tiling: costmodel.Tiling
    meta: "MetaS15"
    # comm="sparse" support index sets: (a_send, (a_recv,), b_send,
    # (b_recv,)), (L, c, w) int32 tensors, a_send/b_send one per fiber
    # offset; empty for dense plans
    sup: tuple = ()
    smeta: Optional[common.SparseMeta] = None
    #: (L, c) nested tuples: each home pack's real block count
    nreal: Optional[tuple] = None

    @property
    def mS(self):
        return self.meta.mS

    @property
    def rc(self):
        return self.meta.rc   # r*c/p: gathered dense slice width


@dataclasses.dataclass(frozen=True, eq=False)
class MetaS15:
    mS: int
    rc: int
    block_meta: common.BlockMeta


def plan_s15(grid: Grid15, rows, cols, vals, m: int, n: int, r: int, *,
             row_tile: int = 256, nz_block: int = 256, group: int = 1,
             comm: str = "dense", compress=None) -> PlanS15:
    """Pack one home row-block per rank (host, amortized), tiled for the
    gathered width r*c/p.

    comm="sparse": the dense column slabs are full height, and rank
    (u, v) only reads the rows its resident blocks touch; the planner
    records the two unions (A rows, B columns) of each fiber position so
    the fiber all-gathers ship only supported rows."""
    L, c, p = grid.L, grid.c, grid.p
    if m % p or r % p:
        raise ValueError(f"s15 needs p={p} to divide m={m} and r={r}")
    mS = m // p
    row_tile = common.choose_row_tile(mS, row_tile)
    part = common.block_partition(np.asarray(rows), np.asarray(cols),
                                  np.asarray(vals), mS, n, 1)
    blocks = [part.get((b, 0), common.EMPTY) for b in range(p)]
    rl, cl, vl, tb, nreal = common.pack_block_list(
        blocks, (mS, n), row_tile, nz_block, group=group)
    tiling = common.plan_tiling(tb, n_b=n, r=r * c // p, k=nz_block,
                                row_tile=row_tile)
    meta = MetaS15(mS, r * c // p, common.BlockMeta(
        (np.arange(p) * mS).reshape(L, c), np.zeros((L, c), np.int64),
        (m, n)))
    sup, smeta = ((), None) if comm != "sparse" else _sparse_sup(
        grid, rows, cols, m, n, compress)
    put = common.put_ranks
    return PlanS15(put(rl, grid), put(cl, grid), put(vl, grid),
                   put(tb, grid), m, n, r, row_tile, tiling, meta, sup,
                   smeta, common.count_table(nreal.reshape(grid.shape)))


def _sparse_sup(grid: Grid15, rows, cols, m: int, n: int, compress):
    """Pad and align the comm="sparse" support sets on the grid's device.

    Slabs are full height, so the support is receiver-determined: per
    offset d the sender at fiber v ships rows R[(v+d) % c] of its own
    column slab, and scatters arrivals at its constant R[v].  One
    channel per dense operand (A rows, B columns), each with its own
    crossover against the dense slab height.
    """
    L, c, p = grid.L, grid.c, grid.p
    cross = costmodel.SPARSE_CROSSOVER
    rows = np.asarray(rows).astype(np.int64)
    cols = np.asarray(cols).astype(np.int64)
    fib = (rows // (m // p)) % c          # fiber of each nonzero's block
    a_sets = common.split_sets(common.unique_sorted(fib * m + rows, c * m),
                               c, m)
    b_sets = common.split_sets(common.unique_sorted(fib * n + cols, c * n),
                               c, n)

    def grid_sets(pick):
        out = np.empty((L, c), object)
        for u in range(L):
            for v in range(c):
                out[u, v] = pick(v)
        return out

    def channel(sets, height):
        w = max(1, max(s.size for s in sets))
        if c == 1 or w > cross * height:
            return (), (), 0, False
        send = tuple(common.put_sets(grid_sets(lambda v: sets[(v + d) % c]),
                                     w, 0, grid) for d in range(1, c))
        recv = common.put_sets(grid_sets(lambda v: sets[v]), w, height, grid)
        return send, (recv,), w, True

    a_send, a_recv, wa, ga = channel(a_sets, m)
    b_send, b_recv, wb, gb = channel(b_sets, n)
    sup = (a_send, a_recv, b_send, b_recv)
    return sup, common.SparseMeta(gather=ga, gather_b=gb, wg=wa, wg_b=wb,
                                  compress=compress)


def _tb_travels(plan: PlanS15) -> bool:
    # with one row window per block every tile_base is 0: nothing to ship
    return plan.row_tile < plan.mS


def _coo(grid, plan, struct, u, v, t, vals):
    """The pack resident at rank (u, v) in phase t of a round: home
    rank ((u - t) mod L, v)'s, whose real block count it carries."""
    rl, cl, tb = struct
    i = grid.at(u, v)
    return common.coo_of(rl[i], cl[i], vals[i], tb[i], (plan.mS, plan.n),
                         plan.row_tile, plan.tiling,
                         common.real_blocks(plan.nreal,
                                            ((u - t) % grid.L, v)))


def _shift_pack(coll, plan, xs, t):
    """One shift event of the traveling pack: every array of ``xs`` but
    an untraveling ``tile_base`` (the last) moves on the layer ring."""
    *moving, tb = xs
    moved = [coll.shift(x, point=("shift", t)) for x in moving]
    if _tb_travels(plan):
        tb = coll.shift(tb, point=("shift", t))
    return (*moved, tb)


def _gather(coll, plan, x, pre, side, point):
    """Fiber all-gather of column slices, (L, c, rows, r/p) ->
    (L, c, rows, r*c/p), support-pruned where the plan says so for this
    ``side`` (0: A, 1: B); a pre-gathered operand passes through."""
    if pre:
        return x
    sm = plan.smeta
    if sm is None or not (sm.gather_b if side else sm.gather):
        return coll.all_gather(x, cols=True, point=("gather", point))
    send, (recv,) = plan.sup[2 * side:2 * side + 2]
    return common.pruned_gather_cols(coll, x, send, recv,
                                     compress=sm.compress,
                                     point=("gather", point))


def _sddmm_round(grid, coll, plan, T_A, T_B, tk, keep_struct):
    """One propagation round accumulating partial sampled dots.

    Returns the partial dots home (unscaled by the original values), the
    structure after the round (home; None unless ``keep_struct``), and
    the per-phase resident structures (local references, replayed by the
    "fused" cell's SpMM round)."""
    L, c, mS = grid.L, grid.c, plan.mS
    struct = (plan.rows_local, plan.cols, plan.tile_base)
    ones = torch.ones_like(plan.vals[0, 0])
    ones = ones.expand(*grid.local_shape, *ones.shape)
    partial, structs = None, []

    def one(u, v):
        i = grid.at(u, v)
        off = (((u - t) % L) * c + v) * mS   # resident block's rows
        return ops.sddmm(T_A[i][off:off + mS], T_B[i],
                         _coo(grid, plan, struct, u, v, t, ones),
                         **tk).vals

    for t in range(L):
        structs.append(struct)
        dots = on_ranks(grid, one)
        partial = coll.shift(dots if partial is None else partial + dots,
                             point=("shift", t))
        if t < L - 1 or keep_struct:
            struct = _shift_pack(coll, plan, struct, t)
    return partial, struct if keep_struct else None, structs


def _spmm_round(grid, coll, plan, T_B, pack, tk, start=0):
    """Propagation round for SpMMA: the pack (rows, cols, vals,
    tile_base) travels; returns the per-phase output slabs stacked
    (L, c, L, mS, rc).  The final position is dead."""
    L = grid.L
    slabs = []
    for t in range(L):
        rl, cl, vl, tb = pack
        slabs.append(on_ranks(grid, lambda u, v: ops.spmm(
            _coo(grid, plan, (rl, cl, tb), u, v, t, vl),
            T_B[grid.at(u, v)], m=plan.mS, **tk)))
        if t < L - 1:
            pack = _shift_pack(coll, plan, pack, start + t)
    return _stack_phases(slabs)


def _spmm_round_cached(grid, coll, plan, T_B, vals, structs, tk):
    """SpMM round replaying the structures cached in the SDDMM round
    (the "fused" one-structure-pass cell): only the final sample values
    travel, on the SDDMM round's schedule points.  Kernel operands are
    value-identical to :func:`_spmm_round`'s, hence equal slabs."""
    L = grid.L
    slabs = []
    for t in range(L):
        slabs.append(on_ranks(grid, lambda u, v: ops.spmm(
            _coo(grid, plan, structs[t], u, v, t, vals),
            T_B[grid.at(u, v)], m=plan.mS, **tk)))
        if t < L - 1:
            vals = coll.shift(vals, point=("shift", t))
    return _stack_phases(slabs)


def _stack_phases(slabs):
    """(L, c, L, mS, rc) from the L per-phase (L, c, mS, rc) slabs (a
    view when there is one phase)."""
    if len(slabs) == 1:
        return slabs[0].unsqueeze(2)
    return torch.stack(slabs, dim=2)


def schedule_events(grid: Grid15, op: str, elision: str = "none"):
    """Ordered (point, phase) boundaries of one executor round: fiber
    gathers of the dense column slabs (one per dense operand) and L
    phase/shift pairs per structure pass; the "fused" cell ships the
    structure once, the others twice, and "none" re-gathers B between
    its passes.  There is no terminal reduce."""
    L = grid.L

    def passes(n, start=0):
        out = []
        for t in range(start, start + n * L):
            out += [("phase", t), ("shift", t)]
        return out

    if op == "sddmm":
        return [("gather", 0), ("gather", 1)] + passes(1)
    if op in ("spmm", "spmm_t"):     # spmm_t = spmm on the S^T problem
        return [("gather", 0)] + passes(1)
    if op == "fusedmm":
        head = [("gather", 0), ("gather", 1)]
        if elision == "fused":
            return head + passes(1)
        if elision == "none":
            return (head + passes(1) + [("gather", 2)]
                    + passes(1, start=L))
        return head + passes(2)      # reuse: replayed, no re-gather
    raise ValueError(f"unknown op {op!r}")


#: schedule events that move as several collectives, (op, point) ->
#: kinds in issue order (the analysis layer splits the event's words
#: evenly over them), as in the reference
WIRE_EXPANSIONS: dict = {}


def schedule_words(grid: Grid15, plan: PlanS15, op: str,
                   elision: str = "none", pre_gathered=(False, False)):
    """Per-device wire words for each schedule event, aligned 1:1 with
    :func:`schedule_events` (the reference's model, see
    ``d15.schedule_words``).  A shift carries a partial/value payload
    (nb*k words) and a structure payload (2*nb*k, plus the tile map when
    ``tile_base`` travels)."""
    L, c, p = grid.L, grid.c, grid.p
    nb, k = plan.rows_local.shape[-2:]
    e = float(nb * k)
    b = float(nb) if plan.row_tile < plan.mS else 0.0
    ga = float((c - 1) * plan.m * (plan.r // p))
    gb = float((c - 1) * plan.n * (plan.r // p))
    pre_a, pre_b = pre_gathered
    if op == "sddmm":
        gathers = [0.0 if pre_a else ga, 0.0 if pre_b else gb]

        def shift_w(t):
            return e + ((2 * e + b) if t < L - 1 else 0.0)
    elif op in ("spmm", "spmm_t"):
        gathers = [0.0 if pre_b else gb]

        def shift_w(t):
            return (3 * e + b) if t < L - 1 else 0.0
    elif op == "fusedmm":
        el = "fused" if elision == "auto" else elision
        gathers = [0.0 if pre_a else ga, 0.0 if pre_b else gb]
        if el == "none":
            gathers.append(gb)   # the re-gather, never session-elided
        if el == "fused":
            # one structure pass: partial, values and structure travel
            # together; the final shift brings the partial home alone
            def shift_w(t):
                return e + ((3 * e + b) if t < L - 1 else 0.0)
        else:
            # round 1's final structure shift feeds round 2, so only the
            # very last shift dies
            def shift_w(t):
                return (3 * e + b) if t < 2 * L - 1 else 0.0
    else:
        raise ValueError(f"unknown op {op!r}")
    out, gi = [], iter(gathers)
    for point, t in schedule_events(grid, op, elision):
        if point == "gather":
            out.append((point, t, "all-gather", next(gi)))
        elif point == "shift":
            out.append((point, t, "collective-permute", float(shift_w(t))))
        else:
            out.append((point, t, None, 0.0))
    return out


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------

def sddmm_s15(grid: Grid15, plan: PlanS15, A, B,
              pre_gathered: tuple = (False, False), *,
              coll: Backend | None = None, backend: str | None = None):
    """R = S * (A @ B.T); R values return home, (L, c, nb, k).

    A, B: column slices (L, c, rows, r/p), or with ``pre_gathered``
    (a, b) the corresponding operand already fiber-replicated, (L, c,
    rows, r*c/p), and its all-gather skipped (Session reuse)."""
    coll = coll_for(grid, coll)
    pre_a, pre_b = pre_gathered
    T_A = _gather(coll, plan, A, pre_a, 0, 0)
    T_B = _gather(coll, plan, B, pre_b, 1, 1)
    partial, _, _ = _sddmm_round(grid, coll, plan, T_A, T_B,
                                 common.kernel_kwargs(plan, backend),
                                 keep_struct=False)
    return plan.vals * partial       # scale by original samples (home)


def spmma_s15(grid: Grid15, plan: PlanS15, B, pre_gathered: bool = False,
              *, coll: Backend | None = None, backend: str | None = None):
    """A = S @ B; output slabs stacked by phase, (L, c, L, mS, r*c/p).

    pre_gathered=True: B's column slices arrive already fiber-replicated
    and the all-gather is skipped."""
    coll = coll_for(grid, coll)
    T_B = _gather(coll, plan, B, pre_gathered, 1, 0)
    pack = (plan.rows_local, plan.cols, plan.vals, plan.tile_base)
    return _spmm_round(grid, coll, plan, T_B, pack,
                       common.kernel_kwargs(plan, backend))


def fusedmm_s15(grid: Grid15, plan: PlanS15, A, B, elision: str = "auto",
                pre_gathered: tuple = (False, False), *,
                coll: Backend | None = None, backend: str | None = None):
    """FusedMMA = SpMMA(SDDMM(A, B, S), B) with sparse shifting.

    elision="auto" : resolves to "fused"
    elision="fused": one structure pass -- the SpMM round replays the
                     per-phase structures cached in the SDDMM round, so
                     only the final sample values travel in round 2
    elision="reuse": the fiber all-gathers are done once and serve both
                     rounds (replication reuse)
    elision="none" : B is re-gathered between the rounds, as two
                     independent calls would

    pre_gathered=(a, b): the corresponding operand arrives already
    fiber-replicated and its all-gather is skipped (Session reuse).
    Returns (slabs (L, c, L, mS, r*c/p), R values (L, c, nb, k)).
    """
    if elision == "auto":
        elision = "fused"
    if elision not in ("none", "reuse", "fused"):
        raise ValueError(f"unknown elision {elision!r}")
    coll = coll_for(grid, coll)
    tk = common.kernel_kwargs(plan, backend)
    pre_a, pre_b = pre_gathered
    T_A = _gather(coll, plan, A, pre_a, 0, 0)
    T_B = _gather(coll, plan, B, pre_b, 1, 1)
    partial, struct, structs = _sddmm_round(
        grid, coll, plan, T_A, T_B, tk, keep_struct=elision != "fused")
    r_vals = plan.vals * partial
    if elision == "fused":
        slabs = _spmm_round_cached(grid, coll, plan, T_B, r_vals, structs,
                                   tk)
        return slabs, r_vals
    if elision == "none":
        # the unoptimized baseline: each rank takes its own slice back
        # out of the gathered buffer and the fiber gathers it again
        w = T_B.shape[-1] // grid.c
        B_back = on_ranks(grid, lambda u, v:
                          T_B[grid.at(u, v)][:, v * w:(v + 1) * w])
        T_B = _gather(coll, plan, B_back, False, 1, 2)
    rl, cl, tb = struct
    slabs = _spmm_round(grid, coll, plan, T_B, (rl, cl, r_vals, tb), tk,
                        start=grid.L)
    return slabs, r_vals


def assemble_spmm_out(grid: Grid15, plan: PlanS15, slabs) -> torch.Tensor:
    """Reassemble phase-stacked SpMM slabs into (m, r) on their device:
    slab (u, v, t) covers rows of block ((u - t) mod L)*c + v and the
    columns W_u."""
    L, c, mS, w = grid.L, grid.c, plan.mS, plan.rc
    if grid.p == 1:
        return slabs.reshape(plan.m, plan.r)
    out = torch.empty((plan.m, plan.r), dtype=slabs.dtype,
                      device=slabs.device)
    for u in range(L):
        for t in range(L):
            bu = (u - t) % L          # layer-row of the resident blocks
            out[bu * c * mS:(bu + 1) * c * mS, u * w:(u + 1) * w] = \
                slabs[u, :, t].reshape(c * mS, w)
    return out
