"""2.5D dense-replicating algorithms (paper Algorithm 2).

Port of ``repro.core.d25`` over the collective layer
(``core/collectives.py``: stacked, or one rank per process).

Grid: ("row" = G, "col" = G, "fiber" = c) with p = G^2 c.  Each fiber
layer runs a concurrent Cannon pass on its G x G grid: the sparse matrix
S travels along the col axis, dense matrix B along the row axis (both
i -> i-1), and dense matrix A is replicated along the fiber (all-gather
input / reduce-scatter output).

Blocking (rank (x, y, z)), stacked (G, G, c, ...):
  A block (i = x*c + z, y):  (m/(Gc), r/G)   -> fiber AG gives T = A[X_x, W_y]
  S block (x, j_t):          (m/G,  n/(Gc))  travels along the col axis
  B block (j_t, y):          (n/(Gc), r/G)   travels along the row axis
with the Cannon alignment j_t = ((x + y + t) mod G)*c + z.  The planner
pre-skews S, and :func:`skew_b` B, into their start positions.

SDDMM sample values accumulate inside the traveling S pack (partial dots
over each visited column slice W_y) and are scaled by the original
values once the pack returns home.

``overlap=True`` issues the shift of the next phase's S pack and B block
before the local kernel runs on the current ones, in the reference's
order; the accumulating buffers (traveling partial dots, FusedMMB
output) shift behind the kernel that feeds them.  ``overlap=False`` is
the serial schedule; the two are equal bit for bit.  A shift whose
result no one reads is not issued, so the collective log equals
:func:`schedule_words` event for event.

``comm="sparse"``: rank (x, y, z) only touches S blocks (x, g*c + z), so
the fiber all-gather of A ships the union of their row supports, and the
B chunk of phase t comes by a direct pruned send from its home grid row
(x+t) mod G with the column support of that phase's resident block, in
place of the Cannon B ring, where the plan's crossover says so
(``PlanD25.smeta``).  The traveling pack, partial dots and output chunks
and the reduce-scatter stay dense: they carry the accumulation order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import common, costmodel
from repro_torch.core.collectives import (Backend, Ring, acc, cannon_ring,
                                          coll_for, on_ranks)
from repro_torch.core.grid import Grid25
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PlanD25:
    rows_local: torch.Tensor   # (G, G, c, nb, k) int32, pre-skewed
    cols: torch.Tensor
    vals: torch.Tensor
    tile_base: torch.Tensor    # (G, G, c, nb)
    m: int
    n: int
    r: int
    row_tile: int
    transpose: bool
    tiling: costmodel.Tiling
    meta: "MetaD25"
    # comm="sparse" support index sets: (gather_send, gather_recv,
    # shift_send, shift_recv), each a tuple of (G, G, c, w) int32 tensors
    # (per fiber offset / per phase); empty for dense plans
    sup: tuple = ()
    smeta: Optional[common.SparseMeta] = None
    #: (G, G, c) nested tuples: each home pack's real block count
    nreal: Optional[tuple] = None

    @property
    def block_shape(self) -> Tuple[int, int]:
        if self.transpose:
            return (self.meta.nS, self.meta.mS)
        return (self.meta.mS, self.meta.nS)


@dataclasses.dataclass(frozen=True, eq=False)
class MetaD25:
    mS: int    # m/G    (S block rows, T rows)
    nS: int    # n/(Gc) (S block cols, B block rows)
    mA: int    # m/(Gc) (A block rows at rest)
    rW: int    # r/G    (dense column-slice width)
    block_meta: common.BlockMeta


def plan_d25(grid: Grid25, rows, cols, vals, m: int, n: int, r: int, *,
             transpose: bool = False, row_tile: int = 256,
             nz_block: int = 256, group: int = 1, comm: str = "dense",
             compress=None) -> PlanD25:
    """Pack S pre-skewed for the Cannon schedule (host, amortized).

    transpose=True packs S^T blocks (the FusedMMB "reuse" cell and
    SpMMB).  comm="sparse" also derives the support sets of the pruned A
    gather and B chunks (see :func:`_sparse_sup`)."""
    G, c = grid.G, grid.c
    if m % (G * c) or n % (G * c) or r % G:
        raise ValueError(f"d25 needs G*c={G * c} to divide m={m} and "
                         f"n={n}, and G={G} to divide r={r}")
    mS, nS, mA, rW = m // G, n // (G * c), m // (G * c), r // G
    blk_shape = (nS, mS) if transpose else (mS, nS)
    row_tile = common.choose_row_tile(blk_shape[0], row_tile)
    part = common.block_partition(np.asarray(rows), np.asarray(cols),
                                  np.asarray(vals), mS, nS, G * c)
    blocks, row_off, col_off = [], [], []
    for x, y, z in grid.all_ranks():
        j = ((x + y) % G) * c + z              # Cannon pre-skew
        br, bc, bv = part.get((x, j), common.EMPTY)
        if transpose:
            br, bc = bc, br
            row_off.append(j * nS), col_off.append(x * mS)
        else:
            row_off.append(x * mS), col_off.append(j * nS)
        blocks.append((br, bc, bv))
    rl, cl, vl, tb, nreal = common.pack_block_list(
        blocks, blk_shape, row_tile, nz_block, group=group)
    tiling = common.plan_tiling(tb, n_b=mS if transpose else nS, r=rW,
                                k=nz_block, row_tile=row_tile)
    meta = MetaD25(mS, nS, mA, rW, common.BlockMeta(
        np.array(row_off).reshape(G, G, c),
        np.array(col_off).reshape(G, G, c),
        (n, m) if transpose else (m, n)))
    sup, smeta = ((), None) if comm != "sparse" else _sparse_sup(
        grid, rows, cols, meta, compress)
    put = common.put_ranks
    return PlanD25(put(rl, grid), put(cl, grid), put(vl, grid),
                   put(tb, grid), m, n, r, row_tile, transpose, tiling,
                   meta, sup, smeta,
                   common.count_table(nreal.reshape(grid.shape)))


def _sparse_sup(grid: Grid25, rows, cols, meta: MetaD25, compress):
    """Pad and align the comm="sparse" support sets on the grid's device.

    Supports are in *pre-swap* coordinates (the gathered operand T is
    indexed by S's row axis, [0, mS), and the traveling B chunk by its
    column axis, [0, nS)), so one support serves both pack orientations.
    Gather: per fiber offset d, sender z ships the slab-local rows of
    receiver (z+d) % c's union support (which depends on (x, z) only).
    Shift: phase t's B chunk is shipped directly from its home grid row
    (x+t) % G, pruned to the column support of the block the receiver
    holds that phase.  Each channel has its own crossover.
    """
    G, c = grid.G, grid.c
    mS, nS, mA = meta.mS, meta.nS, meta.mA
    cross = costmodel.SPARSE_CROSSOVER
    rows = np.asarray(rows).astype(np.int64)
    cols = np.asarray(cols).astype(np.int64)
    bx, lr = np.divmod(rows, mS)
    bj, lc = np.divmod(cols, nS)
    # ra[x * c + z]: rows of row block x read by blocks j = z (mod c);
    # ub[x * G * c + j]: the columns of block (x, j)
    ra = common.split_sets(common.unique_sorted(
        (bx * c + bj % c) * mS + lr, G * c * mS), G * c, mS)
    ub = common.split_sets(common.unique_sorted(
        (bx * G * c + bj) * nS + lc, G * G * c * nS), G * G * c, nS)

    g_send, g_recv, wg, gather = (), (), 0, False
    if c > 1:
        send_sets = np.empty((c - 1, G, G, c), object)
        recv_sets = np.empty((c - 1, G, G, c), object)
        w = 1
        for d in range(1, c):
            for x in range(G):
                for y in range(G):
                    for z in range(c):
                        rcv = ra[x * c + (z + d) % c]
                        send_sets[d - 1, x, y, z] = (
                            rcv[(rcv >= z * mA) & (rcv < (z + 1) * mA)]
                            - z * mA)
                        own = ra[x * c + z]
                        zs = (z - d) % c
                        recv_sets[d - 1, x, y, z] = \
                            own[(own >= zs * mA) & (own < (zs + 1) * mA)]
                        w = max(w, send_sets[d - 1, x, y, z].size)
        gather = w <= cross * mA
        if gather:
            wg = w
            g_send = tuple(common.put_sets(send_sets[d], wg, 0, grid)
                           for d in range(c - 1))
            g_recv = tuple(common.put_sets(recv_sets[d], wg, mS, grid)
                           for d in range(c - 1))

    s_send, s_recv, ws, shift = (), (), (), False
    if G > 1:
        widths, sends, recvs = [], [], []
        for t in range(1, G):
            ssend = np.empty((G, G, c), object)
            srecv = np.empty((G, G, c), object)
            w = 1
            for x in range(G):
                for y in range(G):
                    for z in range(c):
                        ssend[x, y, z] = ub[((x - t) % G) * G * c
                                            + ((x + y) % G) * c + z]
                        srecv[x, y, z] = ub[x * G * c
                                            + ((x + y + t) % G) * c + z]
                        w = max(w, srecv[x, y, z].size)
            widths.append(w)
            sends.append(ssend)
            recvs.append(srecv)
        shift = sum(widths) <= cross * (G - 1) * nS
        if shift:
            ws = tuple(widths)
            s_send = tuple(common.put_sets(sends[i], ws[i], 0, grid)
                           for i in range(G - 1))
            s_recv = tuple(common.put_sets(recvs[i], ws[i], nS, grid)
                           for i in range(G - 1))
    sup = (g_send, g_recv, s_send, s_recv)
    return sup, common.SparseMeta(gather=gather, shift=shift, wg=wg, ws=ws,
                                  compress=compress)


def _skew_index(grid: Grid25, device):
    """(j, y) of the B block of every rank held: j = ((x + y) mod G)*c +
    z."""
    G, c = grid.G, grid.c
    x, y, z = grid.held_coords(device)
    return ((x + y) % G) * c + z, y


def skew_b(grid: Grid25, B: torch.Tensor) -> torch.Tensor:
    """Pre-skew B (n, r) into its Cannon start position, on its device:
    (G, G, c, n/(Gc), r/G), rank (x, y, z) holding B[j-th row block,
    y-th column slice] (the blocks this process holds)."""
    G, c = grid.G, grid.c
    n, r = B.shape
    blocks = B.reshape(G * c, n // (G * c), G, r // G).transpose(1, 2)
    j, y = _skew_index(grid, B.device)
    return blocks[j, y]


def unskew_out(grid: Grid25, plan: PlanD25, stacked) -> torch.Tensor:
    """Invert the skew for B-shaped outputs (FusedMMB): -> (n, r)."""
    G, c = grid.G, grid.c
    nS, rW = plan.meta.nS, plan.meta.rW
    out = torch.empty((G * c, G, nS, rW), dtype=stacked.dtype,
                      device=stacked.device)
    j, y = _skew_index(grid, stacked.device)
    out[j, y] = stacked
    return out.transpose(1, 2).reshape(plan.n, plan.r)


def shard_rows(grid: Grid25, X: torch.Tensor) -> torch.Tensor:
    """(m, r) -> the replicated slot's layout (G, G, c, m/(Gc), r/G):
    rank (x, y, z) holds A[(x*c + z)-th row block, y-th column slice]
    (the blocks this process holds)."""
    G, c = grid.G, grid.c
    m, r = X.shape
    return grid.local(X.reshape(G, c, m // (G * c), G, r // G)
                      .permute(0, 3, 1, 2, 4)).contiguous()


def unshard_rows(grid: Grid25, x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`shard_rows`: the replicated-out output -> (m, r)."""
    G, c = grid.G, grid.c
    return x.permute(0, 2, 3, 1, 4).reshape(G * c * x.shape[3],
                                            G * x.shape[4])


def replicate_rows(grid: Grid25, X: torch.Tensor) -> torch.Tensor:
    """(m, r) -> the gathered layout (G, G, c, m/G, r/G): rows split over
    the grid row axis, columns over the col axis, shared by the fiber
    (the blocks this process holds)."""
    G, c = grid.G, grid.c
    m, r = X.shape
    lay = X.reshape(G, m // G, G, r // G).transpose(1, 2).contiguous()
    return grid.local(lay[:, :, None].expand(G, G, c, m // G, r // G))


def _tb_travels(plan: PlanD25) -> bool:
    # with one row window per block every tile_base is 0: nothing to ship
    return plan.row_tile < plan.block_shape[0]


def _coo(grid, plan, struct, vals, rank, hop):
    """The pack resident at ``rank`` (x, y, z) after ``hop`` shifts back
    along col: home rank (x, (y + hop) mod G, z)'s, whose real block
    count it carries."""
    rl, cl, tb = struct
    x, y, z = rank
    i = grid.at(*rank)
    return common.coo_of(rl[i], cl[i], vals[i], tb[i], plan.block_shape,
                         plan.row_tile, plan.tiling,
                         common.real_blocks(plan.nreal,
                                            (x, (y + hop) % grid.G, z)))


def _pack_ring(coll, plan, pack, n_shifts, overlap, start=0):
    """A traveling pack (rows, cols[, vals], tile_base) moving back along
    the col axis; ``tile_base`` ships only when it travels."""
    def move(pk, k):
        pt = ("shift", start + k)
        *arrs, tb = pk
        if _tb_travels(plan):
            tb = coll.shift(tb, "col", back=True, point=pt)
        return (*(coll.shift(a, "col", back=True, point=pt)
                  for a in arrs), tb)
    return Ring(coll, move, pack, n_shifts, overlap)


def _gather(coll, plan: PlanD25, A, pre_gathered):
    """Fiber all-gather of the replicated operand, pruned where the plan
    says so; a pre-gathered operand passes through."""
    if pre_gathered:
        return A
    sm = plan.smeta
    if sm is None or not sm.gather:
        return coll.all_gather(A, point=("gather", 0))
    send, recv = plan.sup[:2]
    return common.pruned_gather_rows(coll, A, send, recv,
                                     compress=sm.compress,
                                     point=("gather", 0))


def _shift_sparse(plan: PlanD25) -> bool:
    return plan.smeta is not None and plan.smeta.shift


def _b_ring(coll, plan: PlanD25, B0, n_shifts, overlap, start=0):
    """B phase by phase: the Cannon ring (``n_shifts`` shifts back along
    the row axis), or, where the plan prunes the shift channel, phase t's
    chunk by a direct pruned send from grid row (x+t) mod G (t = 1 ..
    G-1, on the schedule's shift event ``start + t - 1``; phase 0's is
    local, and B stays home)."""
    if not _shift_sparse(plan):
        return cannon_ring(coll, B0, "row", n_shifts, overlap=overlap,
                           start=start)
    _, _, send, recv = plan.sup
    return common.pruned_ring(coll, B0, send, recv, "row", -1, plan.meta.nS,
                              compress=plan.smeta.compress, overlap=overlap,
                              start=start)


def _sddmm_round(grid, coll, plan, T, B0, overlap, tk, keep_struct=False,
                 keep_b=False):
    """Cannon round accumulating partial dots in the traveling S pack.

    For a normal pack the kernel samples <T_i, B_j>; for a transpose pack
    the dense operands swap.  Returns (partial dots home, structure home,
    B home, per-phase structures, per-phase B chunks); the structure and
    B come home only when asked (``keep_*``), else None.  The per-phase
    lists are local references, replayed by the "fused" cell."""
    G = grid.G
    ones = torch.ones_like(plan.vals[0, 0, 0]).expand(plan.vals.shape)
    struct = _pack_ring(coll, plan,
                        (plan.rows_local, plan.cols, plan.tile_base),
                        G if keep_struct else G - 1, overlap)
    bring = _b_ring(coll, plan, B0, G if keep_b else G - 1, overlap)
    partial, structs, bchunks = None, [], []
    for t in range(G):
        st, Bt = struct.cur, bring.cur
        structs.append(st)
        bchunks.append(Bt)

        def one(x, y, z):
            i = grid.at(x, y, z)
            dense = (Bt[i], T[i]) if plan.transpose else (T[i], Bt[i])
            return ops.sddmm(*dense, _coo(grid, plan, st, ones, (x, y, z),
                                          t), **tk).vals

        dots = on_ranks(grid, one)
        partial = coll.shift(acc(partial, dots), "col", back=True,
                             point=("shift", t))
        struct.advance()
        bring.advance()
    B_home = B0 if _shift_sparse(plan) else bring.cur
    return partial, struct.cur, B_home, structs, bchunks


def _spmm_phase(grid, plan, struct, vals, D, m, tk, hop):
    def one(x, y, z):
        i = grid.at(x, y, z)
        return ops.spmm(_coo(grid, plan, struct, vals, (x, y, z), hop),
                        D[i], m=m, **tk)
    return on_ranks(grid, one)


def _cannon_spmm(grid, coll, plan, pack, B0, overlap, tk, start=0):
    """SpMMA Cannon round: the pack travels along col, B along row (both
    final positions dead); returns the summed (mS, rW) partials."""
    G = grid.G
    pring = _pack_ring(coll, plan, pack, G - 1, overlap, start)
    bring = _b_ring(coll, plan, B0, G - 1, overlap, start)
    T2 = None
    for t in range(G):
        rl, cl, vl, tb = pring.cur
        T2 = acc(T2, _spmm_phase(grid, plan, (rl, cl, tb), vl, bring.cur,
                                 plan.meta.mS, tk, t))
        pring.advance()
        bring.advance()
    return T2


def _traveling_spmm(grid, coll, plan, T, pack, overlap, tk, start=0):
    """SpMMB round on a transpose pack: the output chunk travels along
    the row axis and accumulates (every hop live, home at the end), the
    pack along col (final position dead)."""
    G = grid.G
    pring = _pack_ring(coll, plan, pack, G - 1, overlap, start)

    def contrib(hop):
        rl, cl, vl, tb = pring.cur
        return _spmm_phase(grid, plan, (rl, cl, tb), vl, T, plan.meta.nS,
                           tk, hop)

    out, c_t = None, contrib(0)
    for t in range(G):
        # the accumulator's shift is in flight while the next phase's
        # contribution is computed (when overlapping)
        def move():
            return coll.shift(acc(out, c_t), "row", back=True,
                              point=("shift", start + t))
        out, works = coll.issue(move) if overlap else (move(), ())
        if t + 1 < G:
            pring.advance()
            c_t = contrib(t + 1)
        coll.wait(works)
    return out


def schedule_events(grid: Grid25, op: str, elision: str = "none"):
    """Ordered (point, phase) boundaries of one executor round: an
    optional fiber all-gather of the replicated operand, G phase/shift
    pairs per structure pass (two for the unfused and reuse FusedMM
    cells), and a terminal fiber reduce-scatter where the output is
    replicated-out."""
    G = grid.G

    def passes(n, start=0):
        out = []
        for t in range(start, start + n * G):
            out += [("phase", t), ("shift", t)]
        return out

    if op == "sddmm":
        return [("gather", 0)] + passes(1)
    if op == "spmm":
        return passes(1) + [("reduce", G - 1)]
    if op == "spmm_t":                       # spmmb on the S^T pack
        return [("gather", 0)] + passes(1)
    if op == "fusedmm":
        if elision == "reuse":
            return [("gather", 0)] + passes(2)
        if elision == "fused":               # one structure pass
            return [("gather", 0)] + passes(1) + [("reduce", G - 1)]
        return [("gather", 0)] + passes(2) + [("reduce", 2 * G - 1)]
    raise ValueError(f"unknown op {op!r}")


#: schedule events that move as several collectives, (op, point) ->
#: kinds in issue order (the analysis layer splits the event's words
#: evenly over them), as in the reference
WIRE_EXPANSIONS: dict = {}


def schedule_words(grid: Grid25, plan: PlanD25, op: str,
                   elision: str = "none", pre_gathered: bool = False):
    """Per-device wire words for each schedule event, aligned 1:1 with
    :func:`schedule_events` (the reference's model).  A Cannon shift
    carries up to three channels -- the partial/value payload (nb*k), the
    structure (2*nb*k, plus the tile map when it travels) and the B
    chunk (n/(Gc) * r/G) -- whose liveness differs per cell."""
    G, c = grid.G, grid.c
    meta = plan.meta
    nb, k = plan.rows_local.shape[-2:]
    e = float(nb * k)
    b = float(nb) if plan.row_tile < plan.block_shape[0] else 0.0
    chunk = float(meta.nS * meta.rW)
    ag = 0.0 if pre_gathered else float((c - 1) * meta.mA * meta.rW)
    rs = float((c - 1) * meta.mS * meta.rW / c)
    if op == "sddmm":
        def shift_w(t):
            return e + ((2 * e + b + chunk) if t < G - 1 else 0.0)
    elif op == "spmm":
        def shift_w(t):
            return (3 * e + b + chunk) if t < G - 1 else 0.0
    elif op == "spmm_t":
        def shift_w(t):
            return chunk + ((3 * e + b) if t < G - 1 else 0.0)
    elif op == "fusedmm":
        el = resolve_elision(elision, plan.transpose)
        if el == "none":
            def shift_w(t):
                if t < G:
                    return 3 * e + b + chunk
                return (3 * e + b + chunk) if t < 2 * G - 1 else 0.0
        elif el == "fused":
            def shift_w(t):
                return e + ((3 * e + b + chunk) if t < G - 1 else 0.0)
        else:
            def shift_w(t):
                if t < G:
                    return 3 * e + b + (chunk if t < G - 1 else 0.0)
                return chunk + ((3 * e + b) if t - G < G - 1 else 0.0)
    else:
        raise ValueError(f"unknown op {op!r}")
    out = []
    for point, t in schedule_events(grid, op, elision):
        if point == "gather":
            out.append((point, t, "all-gather", ag))
        elif point == "reduce":
            out.append((point, t, "reduce-scatter", rs))
        elif point == "shift":
            out.append((point, t, "collective-permute", float(shift_w(t))))
        else:
            out.append((point, t, None, 0.0))
    return out


def resolve_elision(elision: str, transpose: bool) -> str:
    """Resolve ``"auto"`` for the pack in hand: "reuse" (FusedMMB) on a
    transpose pack, the one-structure-pass "fused" cell otherwise."""
    if elision != "auto":
        return elision
    return "reuse" if transpose else "fused"


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------

def sddmm_d25(grid: Grid25, plan: PlanD25, A, B_sk, overlap: bool = True,
              pre_gathered: bool = False, *, coll: Backend | None = None,
              backend: str | None = None):
    """R = S * (A @ B.T); values return to the skewed-home layout,
    (G, G, c, nb, k).

    A: (G, G, c, m/(Gc), r/G) (:func:`shard_rows`), or with
    ``pre_gathered`` already fiber-replicated, (G, G, c, m/G, r/G)
    (:func:`replicate_rows`), and the all-gather skipped."""
    coll = coll_for(grid, coll)
    T = _gather(coll, plan, A, pre_gathered)
    partial, *_ = _sddmm_round(grid, coll, plan, T, B_sk, overlap,
                               common.kernel_kwargs(plan, backend))
    return plan.vals * partial


def spmma_d25(grid: Grid25, plan: PlanD25, B_sk, overlap: bool = True, *,
              coll: Backend | None = None, backend: str | None = None):
    """A = S @ B, the output reduce-scattered over the fiber:
    (G, G, c, m/(Gc), r/G) (:func:`unshard_rows`)."""
    coll = coll_for(grid, coll)
    pack = (plan.rows_local, plan.cols, plan.vals, plan.tile_base)
    T2 = _cannon_spmm(grid, coll, plan, pack, B_sk, overlap,
                      common.kernel_kwargs(plan, backend))
    return coll.psum_scatter(T2, point=("reduce", grid.G - 1))


def spmmb_d25(grid: Grid25, plan: PlanD25, A, overlap: bool = True,
              pre_gathered: bool = False, *, coll: Backend | None = None,
              backend: str | None = None):
    """B = S.T @ A on a transpose pack: AG(A) in, the output travels home
    with the propagated pack.  Returns output chunks (G, G, c, n/(Gc),
    r/G) in skewed-home layout (:func:`unskew_out`)."""
    if not plan.transpose:
        raise ValueError("spmmb_d25 needs a transpose-packed plan")
    coll = coll_for(grid, coll)
    T = _gather(coll, plan, A, pre_gathered)
    pack = (plan.rows_local, plan.cols, plan.vals, plan.tile_base)
    return _traveling_spmm(grid, coll, plan, T, pack, overlap,
                           common.kernel_kwargs(plan, backend))


def fusedmm_d25(grid: Grid25, plan: PlanD25, A, B_sk, elision: str = "auto",
                overlap: bool = True, pre_gathered: bool = False, *,
                coll: Backend | None = None, backend: str | None = None):
    """FusedMM on the 2.5D dense-replicating grid.

    elision="auto" : resolve by the pack (see resolve_elision)
    elision="none" : FusedMMA -- AG(A), two Cannon rounds, RS(out); a
                     normal pack.  Returns (out (G, G, c, m/(Gc), r/G),
                     R values).
    elision="reuse": FusedMMB -- one AG(A), the output travels home with
                     the propagated pack, no reduce-scatter; a transpose
                     pack.  Returns (out skewed (G, G, c, n/(Gc), r/G),
                     R values).
    elision="fused": one structure pass -- round 2 replays the per-phase
                     structures and B chunks cached in the SDDMM round,
                     so only the final values travel; a normal pack, the
                     same returns and the same bits as "none".

    pre_gathered=True: A arrives already fiber-replicated and the
    all-gather is skipped (Session reuse).
    """
    elision = resolve_elision(elision, plan.transpose)
    if elision not in ("none", "reuse", "fused"):
        raise ValueError(f"unknown elision {elision!r}")
    if (elision == "reuse") != plan.transpose:
        raise ValueError(f"elision={elision!r} needs a "
                         f"{'transpose' if elision == 'reuse' else 'normal'}"
                         f"-packed plan")
    coll = coll_for(grid, coll)
    tk = common.kernel_kwargs(plan, backend)
    G = grid.G
    T = _gather(coll, plan, A, pre_gathered)
    partial, struct, B_home, structs, bchunks = _sddmm_round(
        grid, coll, plan, T, B_sk, overlap, tk,
        keep_struct=elision != "fused", keep_b=elision == "none")
    r_vals = plan.vals * partial
    if elision == "none":
        rl, cl, tb = struct
        T2 = _cannon_spmm(grid, coll, plan, (rl, cl, r_vals, tb), B_home,
                          overlap, tk, start=G)
        return coll.psum_scatter(T2, point=("reduce", 2 * G - 1)), r_vals
    if elision == "fused":
        vring = cannon_ring(coll, r_vals, "col", G - 1, overlap=overlap)
        T2 = None
        for t in range(G):
            T2 = acc(T2, _spmm_phase(grid, plan, structs[t], vring.cur,
                                     bchunks[t], plan.meta.mS, tk, t))
            vring.advance()
        return coll.psum_scatter(T2, point=("reduce", G - 1)), r_vals
    rl, cl, tb = struct
    out = _traveling_spmm(grid, coll, plan, T, (rl, cl, r_vals, tb),
                          overlap, tk, start=G)
    return out, r_vals
