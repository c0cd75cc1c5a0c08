"""Carry packed state across from the reference, so both frameworks can
run the *same* pack.

The functions take the reference's objects by duck typing: any object
with the attributes of ``repro.core.sparse.RowTiledCOO`` or of a
family's plan (``repro.core.{d15,s15,d25,s25}.Plan*``) whose arrays
``numpy.asarray`` can read.
Nothing here imports the reference or its framework.  On a grid made
with a process group, each rank keeps its own share of the plan.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import common, costmodel, d15, d25, s15, s25
from repro_torch.core import device as _device
from repro_torch.core.sparse import RowTiledCOO


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def row_tiled_from_numpy(S, *, device=None) -> RowTiledCOO:
    """The port's RowTiledCOO holding the arrays of ``S`` (tile_base as
    row offsets, as both packers emit it)."""
    dev = _device.resolve(device)
    return RowTiledCOO(_tensor(S.rows_local, dev), _tensor(S.cols, dev),
                       _tensor(S.vals, dev), _tensor(S.tile_base, dev),
                       tuple(S.shape), int(S.row_tile))


def plan_d15_from_numpy(plan, grid) -> d15.PlanD15:
    """The port's PlanD15 holding the per-phase arrays of ``plan``, placed
    on ``grid``'s device (the grid must have the plan's (L, c); this
    process's share under a process group)."""
    def phases(field):
        arrs = [np.asarray(a) for a in getattr(plan, field)]
        if arrs[0].shape[:2] != (grid.L, grid.c):
            raise ValueError(f"plan is laid out for {tuple(arrs[0].shape[:2])}"
                             f" ranks, grid has ({grid.L}, {grid.c})")
        return tuple(_tensor(grid.local(a), grid.device) for a in arrs)

    meta = d15.MetaD15(int(plan.meta.cmA), int(plan.meta.nB),
                       _block_meta(plan))
    return d15.PlanD15(phases("rows_local"), phases("cols"), phases("vals"),
                       phases("tile_base"), int(plan.m), int(plan.n),
                       int(plan.r), int(plan.row_tile), bool(plan.transpose),
                       _tiling(plan, plan.tile_base), meta)


def _block_meta(plan) -> common.BlockMeta:
    bm = plan.meta.block_meta
    return common.BlockMeta(np.asarray(bm.row_offsets),
                            np.asarray(bm.col_offsets), tuple(bm.shape))


def _tiling(plan, tile_bases) -> costmodel.Tiling:
    """The plan's tiling, its ``blocks_per_step`` proved here, once, on
    every pack's host ``tile_base`` (the executors trust it)."""
    bps = int(plan.tiling.blocks_per_step)
    for tb in tile_bases:
        tb = np.asarray(tb)
        if bps > 1 and costmodel.groupable_blocks_per_step(
                tb, 1, cap=bps) != bps:
            raise ValueError(f"blocks_per_step={bps} infeasible for this "
                             f"pack (nblocks={tb.shape[-1]})")
    return costmodel.Tiling(r_tile=int(plan.tiling.r_tile),
                            blocks_per_step=bps)


def _pack(plan, grid):
    """The plan's four stacked arrays, checked against the grid's rank
    axes, on ``grid``'s device (this process's share under a process
    group)."""
    arrs = [np.asarray(getattr(plan, f))
            for f in ("rows_local", "cols", "vals", "tile_base")]
    if tuple(arrs[0].shape[:grid.ndim]) != tuple(grid.shape):
        raise ValueError(f"plan is laid out for "
                         f"{tuple(arrs[0].shape[:grid.ndim])} ranks, grid "
                         f"has {tuple(grid.shape)}")
    return [_tensor(grid.local(a), grid.device) for a in arrs]


def _common(plan):
    return int(plan.m), int(plan.n), int(plan.r), int(plan.row_tile)


def plan_s15_from_numpy(plan, grid) -> s15.PlanS15:
    """The port's PlanS15 holding the arrays of ``plan`` on ``grid``."""
    meta = s15.MetaS15(int(plan.meta.mS), int(plan.meta.rc),
                       _block_meta(plan))
    return s15.PlanS15(*_pack(plan, grid), *_common(plan),
                       _tiling(plan, [plan.tile_base]), meta)


def plan_d25_from_numpy(plan, grid) -> d25.PlanD25:
    """The port's PlanD25 holding the arrays of ``plan`` on ``grid``."""
    mt = plan.meta
    meta = d25.MetaD25(int(mt.mS), int(mt.nS), int(mt.mA), int(mt.rW),
                       _block_meta(plan))
    return d25.PlanD25(*_pack(plan, grid), *_common(plan),
                       bool(plan.transpose), _tiling(plan, [plan.tile_base]),
                       meta)


def plan_s25_from_numpy(plan, grid) -> s25.PlanS25:
    """The port's PlanS25 holding the arrays of ``plan`` on ``grid``."""
    mt = plan.meta
    meta = s25.MetaS25(int(mt.mS), int(mt.nS), int(mt.rc), _block_meta(plan))
    return s25.PlanS25(*_pack(plan, grid), *_common(plan),
                       _tiling(plan, [plan.tile_base]), meta)


def gat_params_from_numpy(W, a1, a2, *, device=None):
    """The port's :class:`apps.gat.GATParams` holding the arrays a
    reference ``GATParams`` holds (W (d_in, d_out), a1, a2 (d_out,)), as
    float32 on ``device`` (default: the card)."""
    from repro_torch.apps.gat import GATParams
    dev = _device.resolve(device)
    return GATParams(*(torch.from_numpy(np.array(a, np.float32)).to(dev)
                       for a in (W, a1, a2)))
