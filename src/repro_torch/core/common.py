"""Shared planner utilities for the distributed sparse algorithms.

Port of ``repro.core.common`` (the ``comm="sparse"`` helpers come with a
later slice).  Planners run once on the host in numpy -- the analogue of
the paper's amortized preprocessing -- and place static-shape packs on
the grid's device for the executors to consume repeatedly.  Packs are
padded per *phase* (1.5D dense shifting), and each carries a static
:class:`costmodel.Tiling` chosen at plan time from the block structure.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.sparse import (RowTiledCOO, clamp_row_tile,
                                     pack_row_tiled_arrays)


#: an empty COO block, for (row, col) blocks no nonzero falls in
EMPTY = (np.zeros(0, np.int32), np.zeros(0, np.int32),
         np.zeros(0, np.float32))


def dense_comm_only(comm: str, compress) -> None:
    """Refuse the wire formats the port does not have yet."""
    if comm != "dense" or compress is not None:
        raise NotImplementedError(
            "comm='sparse' (support-pruned sends) and compress= are not "
            "ported yet; they come with the comm='sparse' slice")


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
    order = np.argsort(bid, kind="stable")
    rows, cols, vals, bid = (rows[order], cols[order], vals[order],
                             bid[order])
    uniq, starts = np.unique(bid, return_index=True)
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
    codes; an empty block packs float zeros, which are padding).
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
    return rl, cl, vl, tb


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
           tiling: costmodel.Tiling | None = None) -> RowTiledCOO:
    """Assemble a RowTiledCOO from raw per-rank tensors; ``tiling`` is
    the plan's, whose ``blocks_per_step`` the planner proved for every
    pack of the plan (so the kernel wrappers need not check it again)."""
    return RowTiledCOO(rows_local, cols, vals, tile_base, shape, row_tile,
                       window_groups=1 if tiling is None
                       else tiling.blocks_per_step)


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
