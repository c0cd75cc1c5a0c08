"""Carry packed state across from the reference, so both frameworks can
run the *same* pack.

The functions take the reference's objects by duck typing: any object
with the attributes of ``repro.core.sparse.RowTiledCOO`` or
``repro.core.d15.PlanD15`` whose arrays ``numpy.asarray`` can read.
Nothing here imports the reference or its framework.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import common, costmodel, d15
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
    on ``grid``'s device (the grid must have the plan's (L, c))."""
    dev = grid.device

    def phases(field):
        arrs = tuple(_tensor(a, dev) for a in getattr(plan, field))
        if arrs[0].shape[:2] != (grid.L, grid.c):
            raise ValueError(f"plan is laid out for {tuple(arrs[0].shape[:2])}"
                             f" ranks, grid has ({grid.L}, {grid.c})")
        return arrs

    bm = plan.meta.block_meta
    meta = d15.MetaD15(int(plan.meta.cmA), int(plan.meta.nB),
                       common.BlockMeta(np.asarray(bm.row_offsets),
                                        np.asarray(bm.col_offsets),
                                        tuple(bm.shape)))
    tiling = costmodel.Tiling(r_tile=int(plan.tiling.r_tile),
                              blocks_per_step=int(
                                  plan.tiling.blocks_per_step))
    return d15.PlanD15(phases("rows_local"), phases("cols"), phases("vals"),
                       phases("tile_base"), int(plan.m), int(plan.n),
                       int(plan.r), int(plan.row_tile), bool(plan.transpose),
                       tiling, meta)
