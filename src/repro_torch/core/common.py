"""Shared planner utilities for the distributed sparse algorithms.

Port of ``repro.core.common``.  Planners run once on the host in numpy
-- the analogue of the paper's amortized preprocessing -- and place
static-shape packs on the grid's device for the executors to consume
repeatedly.  Packs are padded per *phase* (1.5D dense shifting), and
each carries a static :class:`costmodel.Tiling` chosen at plan time from
the block structure.  The second half holds the support-pruned
communication of ``comm="sparse"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.collectives import Ring
from repro_torch.core.sparse import (RowTiledCOO, clamp_row_tile,
                                     pack_row_tiled_arrays, stable_order)
from repro_torch.training import compression


#: an empty COO block, for (row, col) blocks no nonzero falls in
EMPTY = (np.zeros(0, np.int32), np.zeros(0, np.int32),
         np.zeros(0, np.float32))


def put_ranks(a: np.ndarray, grid) -> torch.Tensor:
    """Per-rank host arrays stacked (p, ...) in rank order -> a tensor
    with the grid's rank axes in front, on the grid's device (this
    process's share under a process group)."""
    a = np.ascontiguousarray(grid.local(a.reshape(*grid.shape,
                                                  *a.shape[1:])))
    return torch.from_numpy(a).to(grid.device)


def block_partition(rows, cols, vals, row_size, col_size, n_col_blocks):
    """Group nonzeros by (row-block, col-block) in one O(nnz log nnz) pass.

    Returns {(bu, bj): (rows_rebased, cols_rebased, vals)}.
    """
    bid = (rows // row_size).astype(np.int64) * n_col_blocks \
        + (cols // col_size)
    order = stable_order(bid)
    if order is not None:
        rows, cols, vals, bid = (rows[order], cols[order], vals[order],
                                 bid[order])
    starts = np.flatnonzero(np.diff(bid, prepend=-1))   # bid is sorted
    uniq = bid[starts]
    ends = np.append(starts[1:], len(bid))
    out = {}
    for u, s, e in zip(uniq, starts, ends):
        bu, bj = int(u) // n_col_blocks, int(u) % n_col_blocks
        out[(bu, bj)] = (rows[s:e] - bu * row_size,
                         cols[s:e] - bj * col_size, vals[s:e])
    return out


def pack_block_list(blocks, shape, row_tile, nz_block, group: int = 1):
    """Pack a list of COO blocks to RowTiled arrays with a common nblocks.

    blocks: list of (rows, cols, vals) numpy triples, all logical `shape`.
    The common block count is the max over *this list only* (one phase).
    Returns stacked numpy arrays (N, nb, k), (N, nb, k), (N, nb, k), (N, nb);
    the values are float32, or integer if any block's are (position
    codes; an empty block packs float zeros, which are padding); and
    (N,) int64, each pack's real block count: the blocks after it are
    padding, which the kernels skip (:func:`coo_of`).
    """
    packs = [pack_row_tiled_arrays(r, c, v, shape, row_tile=row_tile,
                                   nz_block=nz_block, group=group)
             for (r, c, v) in blocks]
    nbmax = max(p[0].shape[0] for p in packs)
    nbmax = ((nbmax + group - 1) // group) * group
    rl = np.zeros((len(packs), nbmax, nz_block), np.int32)
    cl = np.zeros((len(packs), nbmax, nz_block), np.int32)
    ints = [p[2].dtype for p in packs if p[2].dtype.kind in "iu"]
    vl = np.zeros((len(packs), nbmax, nz_block),
                  ints[0] if ints else np.float32)
    tb = np.zeros((len(packs), nbmax), np.int32)
    for i, (prl, pcl, pvl, ptb, _) in enumerate(packs):
        nb = prl.shape[0]
        rl[i, :nb] = prl
        cl[i, :nb] = pcl
        vl[i, :nb] = pvl
        tb[i, :nb] = ptb
        tb[i, nb:] = ptb[nb - 1] if nb else 0   # keep bases monotone
    # an empty list still packs one padding block
    nreal = np.array([p[0].shape[0] if len(b[0]) else 0
                      for p, b in zip(packs, blocks)], np.int64)
    return rl, cl, vl, tb, nreal


def plan_tiling(tile_base: np.ndarray, *, n_b: int, r: int, k: int,
                row_tile: int) -> costmodel.Tiling:
    """Choose the kernel tiling for a stacked pack at plan time (host)."""
    nb = tile_base.shape[-1]
    return costmodel.choose_tiling(n_b=n_b, r=r, nb=nb, k=k,
                                   row_tile=row_tile, tile_base=tile_base)


def kernel_kwargs(plan, backend) -> dict:
    """The local kernels' keyword arguments: the plan's static tiling and
    the caller's backend."""
    return dict(plan.tiling.kernel_kwargs(), backend=backend)


def merge_tilings(tilings) -> costmodel.Tiling:
    """Conservative merge across phases: knobs every phase supports (a
    divisor of a group size every aligned run of which shares one row
    window is one too, so the gcd stays proved)."""
    tilings = list(tilings)
    r_tile = tilings[0].r_tile
    bps = tilings[0].blocks_per_step
    for t in tilings[1:]:
        r_tile = math.gcd(r_tile, t.r_tile)
        bps = math.gcd(bps, t.blocks_per_step)
    return costmodel.Tiling(r_tile=r_tile, blocks_per_step=bps)


def coo_of(rows_local, cols, vals, tile_base, shape, row_tile,
           tiling: costmodel.Tiling | None = None,
           real_blocks: int | None = None) -> RowTiledCOO:
    """Assemble a RowTiledCOO from raw per-rank tensors; ``tiling`` is
    the plan's, whose ``blocks_per_step`` the planner proved for every
    pack of the plan (so the kernel wrappers need not check it again);
    ``real_blocks`` the pack's real block count (its entry of the plan's
    ``nreal``), past which the kernels walk no padding."""
    return RowTiledCOO(rows_local, cols, vals, tile_base, shape, row_tile,
                       window_groups=1 if tiling is None
                       else tiling.blocks_per_step,
                       real_blocks=None if real_blocks is None
                       else int(real_blocks))


def count_table(a: np.ndarray) -> tuple:
    """A plan's table of real block counts (rank axes in front) as
    nested tuples: immutable, and compared by value like the plan's
    other host fields."""
    return tuple(count_table(x) for x in a) if a.ndim else int(a)


def real_blocks(nreal, index) -> int | None:
    """One pack's real block count from a plan's ``nreal`` table (None
    for a plan made without one)."""
    if nreal is None:
        return None
    for i in index:
        nreal = nreal[i]
    return int(nreal)


def choose_row_tile(height: int, want: int = 256) -> int:
    """Largest divisor of `height` that is <= want."""
    return clamp_row_tile(height, want)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True, eq=False)
class BlockMeta:
    """Host-side metadata to reassemble stacked sparse outputs.

    ``row_offsets``/``col_offsets`` carry one global offset per stacked
    block; for per-phase packs the *leading* axis is the phase and the
    block arrays arrive as a tuple with one stacked array per phase.
    """
    row_offsets: np.ndarray
    col_offsets: np.ndarray
    shape: Tuple[int, int]

    def to_triples(self, rows_local, cols, vals, tile_base):
        """Flat global COO (rows, cols, vals) of the stacked blocks, as
        numpy, padding (vals == 0) filtered out.  O(nnz)."""
        parts = []
        if isinstance(rows_local, (tuple, list)):   # per-phase ragged packs
            for t in range(len(rows_local)):
                parts.append(self._triples_of(
                    rows_local[t], cols[t], vals[t], tile_base[t],
                    self.row_offsets[t], self.col_offsets[t]))
        else:
            parts.append(self._triples_of(rows_local, cols, vals,
                                          tile_base, self.row_offsets,
                                          self.col_offsets))
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]))

    @staticmethod
    def _triples_of(rows_local, cols, vals, tile_base, row_off, col_off):
        rl, cl, vl, tb = (to_numpy(a) for a in (rows_local, cols, vals,
                                                 tile_base))
        flat_ro = np.asarray(row_off).reshape(-1).astype(np.int64)
        flat_co = np.asarray(col_off).reshape(-1).astype(np.int64)
        rl = rl.reshape(-1, *rl.shape[-2:])
        cl = cl.reshape(-1, *cl.shape[-2:])
        vl = vl.reshape(-1, *vl.shape[-2:])
        tb = tb.reshape(-1, tb.shape[-1])
        r = (rl.astype(np.int64) + tb[:, :, None]
             + flat_ro[:, None, None]).reshape(-1)
        c = (cl.astype(np.int64) + flat_co[:, None, None]).reshape(-1)
        v = vl.reshape(-1)
        keep = v != 0
        return r[keep], c[keep], v[keep]


# ---------------------------------------------------------------------------
# Support-pruned communication (comm="sparse")
# ---------------------------------------------------------------------------
#
# A dense *input* operand movement (fiber all-gather, traveling A/B chunk)
# only needs to deliver the rows the receiver's nonzeros read -- the
# pack's row/col support.  The planners precompute, per channel, the
# per-(rank, offset/phase) send and receive index sets, padded to a
# static width; the executors replace the dense collective with one
# permute of the packed rows per offset, scattered into a zero buffer at
# the receiver.  Rows outside the support stay zero but no local kernel
# reads them, so results equal the dense schedule's bit for bit.
# Traveling *accumulators* and reduce-scatters are never pruned: they
# carry partial sums whose addition order must be kept.
#
# Index sets carry the grid's rank axes in front, shaped like the
# reference's per-device arrays ((L, c, w) on a 1.5D grid, (G, G, c, w)
# on a 2.5D one), so ``x[send_idx]`` is a gather per rank.  torch has no
# scatter that drops out-of-bounds indices: receive buffers get one
# spare row, where the receivers' padding (one past the end) lands, and
# the spare row is sliced off.

@dataclasses.dataclass(frozen=True)
class SparseMeta:
    """Static per-plan record of which channels ship pruned (and how wide).

    ``gather``/``gather_b`` -- the fiber all-gather(s) of a dense operand;
    ``shift``/``shift_b`` -- the traveling dense input chunks.  A flag is
    False when the channel does not exist on this grid (c == 1, L == 1)
    or when its support is too dense to win
    (``costmodel.SPARSE_CROSSOVER``); that channel then keeps the dense
    schedule.  ``wg``/``wg_b`` are the padded per-offset gather widths,
    ``ws``/``ws_b`` the per-phase padded shift widths: the payload
    heights shipped.
    """
    gather: bool = False
    gather_b: bool = False
    shift: bool = False
    shift_b: bool = False
    wg: int = 0
    wg_b: int = 0
    ws: Tuple[int, ...] = ()
    ws_b: Tuple[int, ...] = ()
    compress: object = None     # None | "bf16": wire format of pruned sends


def unique_sorted(keys: np.ndarray, size: int) -> np.ndarray:
    """The distinct values of non-negative integer ``keys`` (all below
    ``size``), sorted, by one bitmap pass (no sort).  The planners' sizes
    are a few times a matrix height, so the bitmap costs less than one
    dense operand."""
    mark = np.zeros(size, bool)
    mark[np.asarray(keys)] = True
    return np.flatnonzero(mark)


def split_sets(sorted_keys: np.ndarray, n_sets: int, height: int):
    """Sorted keys ``g * height + i`` -> the ``n_sets`` sorted sets of
    ``i``, one per ``g``."""
    bounds = np.searchsorted(sorted_keys,
                             np.arange(n_sets + 1, dtype=np.int64) * height)
    return [sorted_keys[bounds[g]:bounds[g + 1]] - g * height
            for g in range(n_sets)]


def pad_sets(sets: np.ndarray, width: int, fill: int) -> np.ndarray:
    """Stack an object array of sorted index sets into (..., width) int32.

    Senders pad with 0 (a junk row that the receiver drops); receivers
    pad with an index one past the end (the receive buffer's spare row).
    """
    sets = np.asarray(sets, dtype=object)
    out = np.full(sets.shape + (width,), fill, np.int32)
    for idx in np.ndindex(sets.shape):
        s = np.asarray(sets[idx], np.int32)
        out[idx][:s.shape[0]] = s
    return out


def put_sets(sets: np.ndarray, width: int, fill: int, grid) -> torch.Tensor:
    """:func:`pad_sets` of a grid-shaped object array, on the grid's
    device (this process's share under a process group)."""
    padded = pad_sets(sets, width, fill)
    return put_ranks(padded.reshape(-1, width), grid)


def _wire(x, compress):
    return compression.to_bf16(x) if compress == "bf16" else x


def _unwire(x, dtype, compress):
    return compression.from_bf16(x, dtype) if compress == "bf16" else x


def _flat_rows(idx: torch.Tensor, height: int) -> torch.Tensor:
    """Per-rank row indices (*ranks, w) -> int64 indices into the ranks'
    rows laid end to end, ``height`` rows a rank."""
    n = idx.numel() // idx.shape[-1]
    base = torch.arange(n, device=idx.device, dtype=torch.int64) * height
    return (idx.reshape(n, -1).long() + base[:, None]).reshape(-1)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each rank's rows ``idx``: x (*ranks, H, ...), idx (*ranks, w) ->
    (*ranks, w, ...)."""
    nd = idx.ndim - 1
    rest = x.shape[nd + 1:]
    rows = torch.index_select(x.reshape(-1, *rest), 0,
                              _flat_rows(idx, x.shape[nd]))
    return rows.reshape(*idx.shape, *rest)


def put_rows(buf: torch.Tensor, idx: torch.Tensor,
             rows: torch.Tensor) -> None:
    """Write ``rows`` (*ranks, w, ...) at each rank's rows ``idx`` of the
    contiguous ``buf`` (*ranks, H, ...).  Indices are unique but for the
    padding, which all lands in one spare row."""
    nd = idx.ndim - 1
    rest = buf.shape[nd + 1:]
    buf.view(-1, *rest).index_copy_(0, _flat_rows(idx, buf.shape[nd]),
                                    rows.reshape(-1, *rest))


def _ship(coll, x, send_idx, axis, offset, buf, recv_idx, compress,
          point):
    """Rank i's rows ``send_idx`` of ``x`` to rank i + offset on ``axis``
    in the wire format, written, back in ``x``'s dtype, at the
    receiver's rows ``recv_idx`` of ``buf`` once they are in."""
    payload = _wire(take_rows(x, send_idx), compress)
    coll.permute(payload, axis, offset, point=point,
                 then=lambda arrived: put_rows(
                     buf, recv_idx, _unwire(arrived, x.dtype, compress)))


def pruned_permute(coll, x, send_idx, recv_idx, axis: str, offset: int,
                   out_rows: int, *, compress=None, point=None):
    """One support-pruned send: rank i ships ``x[send_idx]`` to rank
    i + offset on ``axis``, which scatters it at ``recv_idx``.

    x (*ranks, H, r) -> (*ranks, out_rows, r): zeros outside the
    support.  ``send_idx``/``recv_idx`` are equal-width per-rank index
    sets aligned element by element by the planner.  Inside the
    backend's ``issue`` the scatter waits with the send.
    """
    nd = send_idx.ndim - 1
    buf = x.new_zeros(*x.shape[:nd], out_rows + 1, *x.shape[nd + 1:])
    _ship(coll, x, send_idx, axis, offset, buf, recv_idx, compress, point)
    return buf.narrow(nd, 0, out_rows)


def pruned_ring(coll, x, send, recv, axis: str, step: int, out_rows: int,
                *, compress=None, overlap: bool = False, start=None) -> Ring:
    """A traveling dense input operand phase by phase, each phase's chunk
    by one direct support-pruned send instead of a ring hop: phase t's
    chunk comes from t hops away (rank i sends its ``x`` rows
    ``send[t - 1]`` to rank i + step * t on ``axis``, which scatters them
    at ``recv[t - 1]``); phase 0's is ``x`` itself, which stays home.
    ``start`` tags phase t's send as the schedule's shift event
    ``start + t - 1``.  ``overlap`` issues each send one phase ahead."""
    def chunk(_, k):                     # phase k + 1's chunk
        return pruned_permute(
            coll, x, send[k], recv[k], axis, step * (k + 1), out_rows,
            compress=compress,
            point=None if start is None else ("shift", start + k))
    return Ring(coll, chunk, x, len(send), overlap)


def _fiber_coord(coll, device) -> torch.Tensor:
    """The fiber coordinate of every rank this process holds, shaped
    like the grid's local rank axes."""
    return coll.grid.held_coords(device)[-1]


def pruned_gather_rows(coll, x, send, recv, *, compress=None, point=None):
    """Support-pruned row-tiled fiber all-gather: (*ranks, slot, r) ->
    (*ranks, c * slot, r).

    The own slab lands whole (free); every other slab arrives as one
    pruned permute per fiber offset d (``send[d - 1]``, ``recv[d - 1]``,
    the receivers' absolute rows).
    """
    g = coll.grid
    nd, c = g.ndim, g.c
    slot = x.shape[nd]
    buf = x.new_zeros(*x.shape[:nd], c * slot + 1, *x.shape[nd + 1:])
    own = _fiber_coord(coll, x.device)[..., None] * slot \
        + torch.arange(slot, device=x.device)
    put_rows(buf, own, x)
    for d in range(1, c):
        _ship(coll, x, send[d - 1], g.fiber, d, buf, recv[d - 1], compress,
              point)
    return buf.narrow(nd, 0, c * slot)


def pruned_gather_cols(coll, x, send, recv, *, compress=None, point=None):
    """Support-pruned column-slab fiber all-gather: (*ranks, m, w) ->
    (*ranks, m, c * w).

    Slabs are full height, so the receiver's row support ``recv`` is one
    set per rank (the union over its resident blocks), whatever the
    source: the sender at offset d ships the receiver's rows of its own
    slab (``send[d - 1]``), which lands in column block (v - d) mod c of
    receiver v.
    """
    g = coll.grid
    nd, c = g.ndim, g.c
    m, w = x.shape[nd], x.shape[nd + 1]
    lead = x.shape[:nd]
    buf = x.new_zeros(*lead, (m + 1) * c, w)   # (m + 1, c, w) a rank
    v = _fiber_coord(coll, x.device)[..., None]
    every = torch.arange(m, device=x.device).expand(*lead, m)
    put_rows(buf, every * c + v, x)
    for d in range(1, c):
        _ship(coll, x, send[d - 1], g.fiber, d, buf,
              recv.long() * c + (v - d) % c, compress, point)
    return buf.view(*lead, m + 1, c * w).narrow(nd, 0, m)
