"""2.5D sparse-replicating algorithms (paper §V-D).

Port of ``repro.core.s25`` over the collective layer
(``core/collectives.py``: stacked, or one rank per process).

Grid: ("row" = G, "col" = G, "fiber" = c), p = G^2 c.  The sparse matrix
is STATIONARY and structure-replicated along the fiber; only its VALUES
move along the fiber (all-gather / reduce-scatter).  Both dense matrices
propagate within each layer, split into r-chunks of width r/(Gc):

  rank (x, y, z) holds, at phase t, stacked (G, G, c, ...):
    S block (x, y):            (m/G, n/G)  structure replicated over z (a
                               broadcast view), values fiber-sharded by
                               nonzero-block, (nb/c, k)
    A chunk A[X_x, w_{k_t,z}]: (m/G, r/(Gc))  travels along the col axis
    B chunk B[Y_y, w_{k_t,z}]: (n/G, r/(Gc))  travels along the row axis
  with Cannon alignment k_t = (x + y + t) mod G (:func:`skew_dense`).

SDDMM: each phase adds the partial dots over the resident r-chunk into a
local accumulator; after the round the partials are summed across the
fiber (reduce-scatter to the home value shards) and scaled by the
original sample values.  SpMM: output chunks travel along the col axis
and accumulate R @ B contributions from every column block.  FusedMM
admits B-chunk reuse ("reuse": the SpMM round replays the B chunks of
the SDDMM round); local fusion is impossible (the cross-fiber sum
separates the halves), so "fused" is refused.

Every shift is issued after the kernel that reads the current chunk (the
serial form of the reference's double buffer), and a shift whose result
no one reads is not issued, so the collective log equals
:func:`schedule_words` event for event.

``comm="sparse"``: the stationary block (x, y) reads its A r-chunks only
at its row support and its B r-chunks only at its column support, both
the same in every phase, so each phase's chunk comes by a direct pruned
send from its home position in place of the Cannon ring, where the
plan's crossover says so (``PlanS25.smeta``).  The fiber value traffic
and the traveling output chunks stay dense.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import common, costmodel
from repro_torch.core.collectives import (Backend, acc, cannon_ring,
                                          coll_for, on_ranks)
from repro_torch.core.grid import Grid25
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PlanS25:
    rows_local: torch.Tensor   # (G, G, c, nb, k), one block shared over z
    cols: torch.Tensor         # (G, G, c, nb, k)
    vals: torch.Tensor         # (G, G, c, nb/c, k), fiber-sharded by block
    tile_base: torch.Tensor    # (G, G, c, nb)
    m: int
    n: int
    r: int
    row_tile: int
    tiling: costmodel.Tiling
    meta: "MetaS25"
    # comm="sparse" support index sets: (a_send, (a_recv,), b_send,
    # (b_recv,)), (G, G, c, w) int32 tensors, a_send/b_send one per
    # phase t >= 1; empty for dense plans
    sup: tuple = ()
    smeta: Optional[common.SparseMeta] = None
    #: (G, G) nested tuples: each (x, y) block's real block count
    nreal: Optional[tuple] = None

    @property
    def mS(self):
        return self.meta.mS

    @property
    def nS(self):
        return self.meta.nS

    @property
    def rc(self):
        return self.meta.rc


@dataclasses.dataclass(frozen=True, eq=False)
class MetaS25:
    mS: int   # m/G
    nS: int   # n/G
    rc: int   # r/(Gc)
    block_meta: common.BlockMeta


def plan_s25(grid: Grid25, rows, cols, vals, m: int, n: int, r: int, *,
             row_tile: int = 256, nz_block: int = 256, group: int = 1,
             comm: str = "dense", compress=None) -> PlanS25:
    """Pack the stationary S block per layer position (host, amortized).

    comm="sparse": the stationary block (x, y) reads its A r-chunks only
    at its row support and its B r-chunks only at its column support,
    both the same in every phase; each phase's chunk ships directly from
    its home position, pruned to the receiver's support."""
    G, c = grid.G, grid.c
    if m % G or n % G or r % (G * c):
        raise ValueError(f"s25 needs G={G} to divide m={m} and n={n}, and "
                         f"G*c={G * c} to divide r={r}")
    mS, nS, rc = m // G, n // G, r // (G * c)
    row_tile = common.choose_row_tile(mS, row_tile)
    part = common.block_partition(np.asarray(rows), np.asarray(cols),
                                  np.asarray(vals), mS, nS, G)
    blocks = [part.get((x, y), common.EMPTY)
              for x in range(G) for y in range(G)]
    rl, cl, vl, tb, nreal = common.pack_block_list(
        blocks, (mS, nS), row_tile, nz_block, group=group)
    nb = rl.shape[1]
    if nb % c:                       # pad so the value shards split evenly
        pad = c - nb % c
        rl = np.pad(rl, ((0, 0), (0, pad), (0, 0)))
        cl = np.pad(cl, ((0, 0), (0, pad), (0, 0)))
        vl = np.pad(vl, ((0, 0), (0, pad), (0, 0)))
        tb = np.pad(tb, ((0, 0), (0, pad)), mode="edge")
        nb += pad
    tiling = common.plan_tiling(tb, n_b=nS, r=rc, k=nz_block,
                                row_tile=row_tile)
    dev = grid.device

    def shared(a):   # one block per (x, y), the same on every fiber rank
        a = a.reshape(G, G, 1, *a.shape[1:])
        if grid.group is not None:   # this process's (x, y) block alone
            x, y, _ = grid.coords
            a = a[x:x + 1, y:y + 1]
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t.expand(*grid.local_shape, *a.shape[3:])

    meta = MetaS25(mS, nS, rc, common.BlockMeta(
        (np.arange(G) * mS)[:, None].repeat(G, 1),
        (np.arange(G) * nS)[None, :].repeat(G, 0), (m, n)))
    vshard = torch.from_numpy(np.ascontiguousarray(grid.local(
        vl.reshape(G, G, c, nb // c, vl.shape[-1])))).to(dev)
    sup, smeta = ((), None) if comm != "sparse" else _sparse_sup(
        grid, rows, cols, mS, nS, compress)
    return PlanS25(shared(rl), shared(cl), vshard, shared(tb), m, n, r,
                   row_tile, tiling, meta, sup, smeta,
                   common.count_table(nreal.reshape(G, G)))


def _sparse_sup(grid: Grid25, rows, cols, mS: int, nS: int, compress):
    """Pad and align the comm="sparse" support sets on the grid's device.

    Chunks are full height within their layer block, so the support is
    receiver-determined and the same in every phase: at phase t rank
    (x, y, z) receives its A chunk from grid column (y+t) % G pruned to
    the row support of block (x, y), and its B chunk from grid row
    (x+t) % G pruned to the block's column support.  One channel per
    traveling operand, each with its own crossover.
    """
    G, c = grid.G, grid.c
    cross = costmodel.SPARSE_CROSSOVER
    rows = np.asarray(rows).astype(np.int64)
    cols = np.asarray(cols).astype(np.int64)
    blk = (rows // mS) * G + cols // nS          # block x * G + y
    rsup = common.split_sets(common.unique_sorted(
        blk * mS + rows % mS, G * G * mS), G * G, mS)
    csup = common.split_sets(common.unique_sorted(
        blk * nS + cols % nS, G * G * nS), G * G, nS)

    def channel(sup2, height, sender):
        w = max(1, max(s.size for s in sup2))
        if G == 1 or w > cross * height:
            return (), (), 0, False
        send = []
        for t in range(1, G):
            s_t = np.empty((G, G, c), object)
            for x, y, z in grid.all_ranks():
                sx, sy = sender(x, y, t)
                s_t[x, y, z] = sup2[sx * G + sy]
            send.append(common.put_sets(s_t, w, 0, grid))
        recv = np.empty((G, G, c), object)
        for x, y, z in grid.all_ranks():
            recv[x, y, z] = sup2[x * G + y]
        return (tuple(send), (common.put_sets(recv, w, height, grid),), w,
                True)

    a_send, a_recv, wa, sa = channel(
        rsup, mS, lambda x, y, t: (x, (y - t) % G))
    b_send, b_recv, wb, sb = channel(
        csup, nS, lambda x, y, t: ((x - t) % G, y))
    sup = (a_send, a_recv, b_send, b_recv)
    return sup, common.SparseMeta(shift=sa, shift_b=sb,
                                  ws=(wa,) if sa else (),
                                  ws_b=(wb,) if sb else (),
                                  compress=compress)


def _skew_index(grid: Grid25, along: str, device):
    """(row block, r-chunk) of the start chunk of every rank held."""
    G, c = grid.G, grid.c
    x, y, z = grid.held_coords(device)
    return (x if along == "row" else y), ((x + y) % G) * c + z


def skew_dense(grid: Grid25, X: torch.Tensor, along: str) -> torch.Tensor:
    """Pre-skew a dense (rows, r) matrix into Cannon start chunks on its
    device: (G, G, c, rows/G, r/(Gc)) (the chunks this process holds).

    along="row": X = A (rows follow the grid-row coordinate x)
    along="col": X = B (rows follow the grid-col coordinate y)
    """
    G, c = grid.G, grid.c
    nrows, r = X.shape
    chunks = X.reshape(G, nrows // G, G * c, r // (G * c)).transpose(1, 2)
    rows, kc = _skew_index(grid, along, X.device)
    return chunks[rows, kc]


def unskew_out(grid: Grid25, plan: PlanS25, stacked) -> torch.Tensor:
    """Reassemble A-shaped outputs whose chunks ended in skewed-home
    spots: out[X_x, w_{k,z}] += stacked[x, y, z] (each chunk once)."""
    G, c = grid.G, grid.c
    out = torch.zeros((G, G * c, plan.mS, plan.rc), dtype=stacked.dtype,
                      device=stacked.device)
    rows, kc = _skew_index(grid, "row", stacked.device)
    out.index_put_((rows, kc), stacked, accumulate=True)
    return out.transpose(1, 2).reshape(plan.m, plan.r)


def _coo(grid, plan, rl, cl, vl, tb, x, y, z):
    i = grid.at(x, y, z)
    return common.coo_of(rl[i], cl[i], vl[i], tb[i], (plan.mS, plan.nS),
                         plan.row_tile, plan.tiling,
                         common.real_blocks(plan.nreal, (x, y)))


def _chunk_ring(coll, plan, X0, side, n_shifts, start=0):
    """One traveling r-chunk phase by phase (``side`` 0: A along the col
    axis, 1: B along the row axis): the Cannon ring of ``n_shifts``
    shifts, or, where the plan prunes that channel, phase t's chunk by a
    direct pruned send from t positions up the axis (t = 1 .. G-1, on the
    schedule's shift event ``start + t - 1``; phase 0's is local, and the
    chunk stays home)."""
    axis = "row" if side else "col"
    sm = plan.smeta
    if sm is None or not (sm.shift_b if side else sm.shift):
        return cannon_ring(coll, X0, axis, n_shifts, start=start)
    send, (recv,) = plan.sup[2 * side:2 * side + 2]
    return common.pruned_ring(coll, X0, send, (recv,) * len(send), axis, -1,
                              plan.nS if side else plan.mS,
                              compress=sm.compress, start=start)


def _sddmm_round(grid, coll, plan, A0, B0, tk, keep_b=False):
    """Cannon round over r-chunks; returns the fiber-local partial dots
    (G, G, c, nb, k), B home (None unless ``keep_b``) and the per-phase
    resident B chunks (replayed by the "reuse" cell)."""
    G = grid.G
    rl, cl, tb = plan.rows_local, plan.cols, plan.tile_base
    ones = torch.ones(rl.shape[-2:], dtype=plan.vals.dtype,
                      device=rl.device).expand(rl.shape)
    aring = _chunk_ring(coll, plan, A0, 0, G - 1)
    bring = _chunk_ring(coll, plan, B0, 1, G if keep_b else G - 1)
    partial, bchunks = None, []
    for t in range(G):
        A_t, B_t = aring.cur, bring.cur
        bchunks.append(B_t)
        partial = acc(partial, on_ranks(grid, lambda x, y, z: ops.sddmm(
            A_t[grid.at(x, y, z)], B_t[grid.at(x, y, z)],
            _coo(grid, plan, rl, cl, ones, tb, x, y, z), **tk).vals))
        aring.advance()
        bring.advance()
    b_pruned = plan.smeta is not None and plan.smeta.shift_b
    return partial, B0 if b_pruned else bring.cur, bchunks


def _spmm_round(grid, coll, plan, vals, B0, tk, start=0, bchunks=None):
    """Cannon round for SpMM: the output chunk travels along col and
    accumulates (every hop live); B travels along row (final position
    dead) unless ``bchunks`` replays the SDDMM round's B chunks."""
    G = grid.G
    rl, cl, tb = plan.rows_local, plan.cols, plan.tile_base
    bring = None if bchunks is not None else _chunk_ring(
        coll, plan, B0, 1, G - 1, start)
    out = None
    for t in range(G):
        B_t = bchunks[t] if bchunks is not None else bring.cur
        contrib = on_ranks(grid, lambda x, y, z: ops.spmm(
            _coo(grid, plan, rl, cl, vals, tb, x, y, z),
            B_t[grid.at(x, y, z)], m=plan.mS, **tk))
        out = coll.shift(acc(out, contrib), "col", back=True,
                         point=("shift", start + t))
        if bring is not None:
            bring.advance()
    return out


def resolve_elision(elision: str) -> str:
    """``"auto"`` is B-chunk "reuse": the same fiber value traffic as
    "none", one fewer dense-chunk trip."""
    if elision != "auto":
        return elision
    return "reuse"


def schedule_events(grid: Grid25, op: str, elision: str = "none"):
    """Ordered (point, phase) boundaries of one executor round: no
    gather events (nothing dense is replicated), G phase/shift pairs per
    round, the SDDMM half ending in the cross-fiber partial-sum
    reduce-scatter."""
    G = grid.G

    def passes(n, start=0):
        out = []
        for t in range(start, start + n * G):
            out += [("phase", t), ("shift", t)]
        return out

    if op == "sddmm":
        return passes(1) + [("reduce", G - 1)]
    if op in ("spmm", "spmm_t"):     # spmm_t = spmm on the S^T problem
        return passes(1)
    if op == "fusedmm":              # SDDMM pass, RS barrier, SpMM pass
        return passes(1) + [("reduce", G - 1)] + passes(1, start=G)
    raise ValueError(f"unknown op {op!r}")


def schedule_words(grid: Grid25, plan: PlanS25, op: str,
                   elision: str = "none", pre_gathered: bool = False):
    """Per-device wire words for each schedule event, aligned 1:1 with
    :func:`schedule_events` (the reference's model).  ``pre_gathered``
    changes nothing: the fiber traffic is values only.  SpMM's opening
    value all-gather rides the first phase; FusedMM's reduce event
    carries the partial-sum reduce-scatter and the value re-broadcast."""
    del pre_gathered
    G, c = grid.G, grid.c
    nb, k = plan.rows_local.shape[-2:]
    fiber = float((c - 1) * (nb // c) * k)
    a_ch = float(plan.mS * plan.rc)    # A chunk / traveling output chunk
    b_ch = float(plan.nS * plan.rc)
    if op == "sddmm":
        def shift_w(t):
            return (a_ch + b_ch) if t < G - 1 else 0.0
    elif op in ("spmm", "spmm_t"):
        def shift_w(t):
            return a_ch + (b_ch if t < G - 1 else 0.0)
    elif op == "fusedmm":
        if resolve_elision(elision) == "none":
            def shift_w(t):
                if t < G:
                    return b_ch + (a_ch if t < G - 1 else 0.0)
                return a_ch + (b_ch if t - G < G - 1 else 0.0)
        else:
            def shift_w(t):
                if t < G:
                    return (a_ch + b_ch) if t < G - 1 else 0.0
                return a_ch
    else:
        raise ValueError(f"unknown op {op!r}")
    out = []
    for point, t in schedule_events(grid, op, elision):
        if point == "reduce":
            out.append((point, t, "reduce-scatter",
                        2 * fiber if op == "fusedmm" else fiber))
        elif point == "phase" and t == 0 and op in ("spmm", "spmm_t"):
            out.append((point, t, "all-gather", fiber))
        elif point == "shift":
            out.append((point, t, "collective-permute", float(shift_w(t))))
        else:
            out.append((point, t, None, 0.0))
    return out


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------

def sddmm_s25(grid: Grid25, plan: PlanS25, A_sk, B_sk, *,
              coll: Backend | None = None, backend: str | None = None):
    """R = S * (A @ B.T); values end fiber-sharded at home,
    (G, G, c, nb/c, k).  A_sk, B_sk from :func:`skew_dense`."""
    coll = coll_for(grid, coll)
    partial, _, _ = _sddmm_round(grid, coll, plan, A_sk, B_sk,
                                 common.kernel_kwargs(plan, backend))
    mine = coll.psum_scatter(partial, point=("reduce", grid.G - 1))
    return plan.vals * mine


def spmma_s25(grid: Grid25, plan: PlanS25, B_sk, *,
              coll: Backend | None = None, backend: str | None = None):
    """A = S @ B; output chunks end in skewed-home layout,
    (G, G, c, m/G, r/(Gc)) (:func:`unskew_out`)."""
    coll = coll_for(grid, coll)
    vals = coll.all_gather(plan.vals, point=("phase", 0))   # (nb, k)
    return _spmm_round(grid, coll, plan, vals, B_sk,
                       common.kernel_kwargs(plan, backend))


def fusedmm_s25(grid: Grid25, plan: PlanS25, A_sk, B_sk,
                elision: str = "auto", *, coll: Backend | None = None,
                backend: str | None = None):
    """FusedMMA on the 2.5D sparse-replicating grid.

    elision="auto" : resolves to "reuse"
    elision="none" : A and B travel in the SDDMM round, the output and B
                     in the SpMM round: 4 dense-chunk trips
    elision="reuse": the SpMM round replays the B chunks of the SDDMM
                     round: 3 trips, the same bits as "none"
    elision="fused": refused -- local fusion is impossible here.

    Returns (out chunks (G, G, c, m/G, r/(Gc)) skewed-home, R values
    fiber-sharded (G, G, c, nb/c, k)).
    """
    elision = resolve_elision(elision)
    if elision not in ("none", "reuse"):
        raise ValueError(f"s25 supports ('none', 'reuse'), got "
                         f"{elision!r} (local fusion is structurally "
                         f"impossible here)")
    coll = coll_for(grid, coll)
    tk = common.kernel_kwargs(plan, backend)
    G = grid.G
    partial, B_home, bchunks = _sddmm_round(grid, coll, plan, A_sk, B_sk,
                                            tk, keep_b=elision == "none")
    mine = coll.psum_scatter(partial, point=("reduce", G - 1))      # RS
    r_mine = plan.vals * mine
    r_vals = coll.all_gather(r_mine, point=("reduce", G - 1))       # AG
    out = _spmm_round(grid, coll, plan, r_vals, B_home, tk, start=G,
                      bchunks=bchunks if elision == "reuse" else None)
    return out, r_mine
