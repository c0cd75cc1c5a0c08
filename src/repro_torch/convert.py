"""Carry packed state and parameters across from the reference, so both
frameworks can run the *same* pack or model.

The functions take the reference's objects by duck typing: any object
with the attributes of ``repro.core.sparse.RowTiledCOO`` or of a
family's plan (``repro.core.{d15,s15,d25,s25}.Plan*``) whose arrays
``numpy.asarray`` can read; a comm="sparse" plan brings its support
sets (``sup``) and its ``SparseMeta`` across.  Nothing here imports the
reference or its framework.  On a grid made with a process group, each
rank keeps its own share of the plan.
"""
from __future__ import annotations

import dataclasses

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
                       _tiling(plan, plan.tile_base), meta,
                       *_support(plan, grid))


def _support(plan, grid):
    """``(sup, smeta)`` of a comm="sparse" plan: its support index sets,
    nested as the plan nests them, on ``grid``'s device (this process's
    share under a process group), and its SparseMeta; ``((), None)`` for
    a dense plan."""
    sm = getattr(plan, "smeta", None)
    if sm is None:
        return (), None

    def carry(x):
        if isinstance(x, (tuple, list)):
            return tuple(carry(a) for a in x)
        return _tensor(grid.local(np.asarray(x)), grid.device)

    fields = {f.name: getattr(sm, f.name)
              for f in dataclasses.fields(common.SparseMeta)}
    fields["ws"], fields["ws_b"] = (tuple(int(w) for w in fields[k])
                                    for k in ("ws", "ws_b"))
    return carry(plan.sup), common.SparseMeta(**fields)


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
                       _tiling(plan, [plan.tile_base]), meta,
                       *_support(plan, grid))


def plan_d25_from_numpy(plan, grid) -> d25.PlanD25:
    """The port's PlanD25 holding the arrays of ``plan`` on ``grid``."""
    mt = plan.meta
    meta = d25.MetaD25(int(mt.mS), int(mt.nS), int(mt.mA), int(mt.rW),
                       _block_meta(plan))
    return d25.PlanD25(*_pack(plan, grid), *_common(plan),
                       bool(plan.transpose), _tiling(plan, [plan.tile_base]),
                       meta, *_support(plan, grid))


def plan_s25_from_numpy(plan, grid) -> s25.PlanS25:
    """The port's PlanS25 holding the arrays of ``plan`` on ``grid``."""
    mt = plan.meta
    meta = s25.MetaS25(int(mt.mS), int(mt.nS), int(mt.rc), _block_meta(plan))
    return s25.PlanS25(*_pack(plan, grid), *_common(plan),
                       _tiling(plan, [plan.tile_base]), meta,
                       *_support(plan, grid))


def gat_params_from_numpy(W, a1, a2, *, device=None):
    """The port's :class:`apps.gat.GATParams` holding the arrays a
    reference ``GATParams`` holds (W (d_in, d_out), a1, a2 (d_out,)), as
    float32 on ``device`` (default: the card)."""
    from repro_torch.apps.gat import GATParams
    dev = _device.resolve(device)
    return GATParams(*(torch.from_numpy(np.array(a, np.float32)).to(dev)
                       for a in (W, a1, a2)))


def _lm_leaves(tree, prefix, out):
    """Flatten a reference parameter pytree (dicts, lists; leaves any
    array) into ``{dotted path: leaf}``."""
    if isinstance(tree, dict):
        for name, sub in tree.items():
            _lm_leaves(sub, f"{prefix}{name}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _lm_leaves(sub, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def _lm_flat(cfg, params):
    """``{port parameter name: float32 array}`` of a reference parameter
    pytree (or anything of its layout: an AdamW moment), each repeating
    segment's leading repeat axis unstacked; a missing or extra leaf, or
    a leaf of another shape, is refused."""
    from repro_torch.models import model as M
    segs = params.get("segments", ())
    if len(segs) != len(cfg.segments):
        raise ValueError(f"{len(segs)} segments for a config of "
                         f"{len(cfg.segments)}")
    flat = _lm_leaves({k: v for k, v in params.items() if k != "segments"},
                      "", {})
    for si, (seg, (_, cnt)) in enumerate(zip(segs, cfg.segments)):
        for name, leaf in _lm_leaves(seg, "", {}).items():
            arr = np.asarray(leaf, dtype=np.float32)
            if cnt == 1:
                flat[f"segments.{si}.0.{name}"] = arr
                continue
            if arr.shape[:1] != (cnt,):
                raise ValueError(f"segments.{si}.{name}: leading axis "
                                 f"{arr.shape[:1]} is not the segment's "
                                 f"{cnt} repeats")
            for ri in range(cnt):
                flat[f"segments.{si}.{ri}.{name}"] = arr[ri]
    want = {k: tuple(v.shape)
            for k, v in M.empty_model(cfg).state_dict().items()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter leaves missing {missing}, extra {extra}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(flat[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, the model's "
                             f"{shape}")
        out[name] = arr
    return out


def lm_params_from_numpy(cfg, params, *, device=None, dtype=None):
    """The port's LM (``models.model.Model``) holding the weights of a
    reference parameter pytree (``repro.models.model.init_params``'s
    layout, leaves as arrays ``numpy.asarray`` can read), as ``dtype``
    (default float32) on ``device`` (default: the card).

    A segment that repeats (``cnt > 1``) holds its leaves stacked on a
    leading repeat axis, which is unstacked into the segment's
    ``ModuleList``; a segment with ``cnt == 1`` has none.  The names map
    one to one (``blk{i}``, ``attn``/``mamba``/``mlp``/``moe``/
    ``shared``, ``norm1``/``norm2``, ``embed``/``head``/``final_norm``);
    a missing or extra leaf, or a leaf of another shape, is refused.
    """
    from repro_torch.models import model as M
    dev = _device.resolve(device)
    dtype = dtype or torch.float32
    state = {name: torch.from_numpy(np.array(arr)).to(device=dev,
                                                       dtype=dtype)
             for name, arr in _lm_flat(cfg, params).items()}
    model = M.empty_model(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    return model


def lm_opt_state_from_numpy(cfg, state, *, device=None):
    """The port's AdamW state (``training.optimizer.init_opt_state``'s
    layout: ``{"mu": {name: float32 tensor}, "nu": ..., "step": int32
    tensor}``) holding a reference state (``repro.training.optimizer``'s
    ``{"mu": params-like pytree, "nu": ..., "step": int}``), on
    ``device`` (default: the card); the moments map as
    :func:`lm_params_from_numpy` maps the weights."""
    dev = _device.resolve(device)

    def moments(tree):
        return {name: torch.from_numpy(np.array(arr)).to(dev)
                for name, arr in _lm_flat(cfg, tree).items()}
    return {"mu": moments(state["mu"]), "nu": moments(state["nu"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}
