"""Static-shape sparse formats for the SDDMM / SpMM / FusedMM kernels.

Port of ``repro.core.sparse``.  Every block of the sparse matrix ``S`` is
packed to a fixed nonzero capacity.  Padding entries carry ``val = 0``
and point at row/col 0, so SpMM contributions from padding vanish and
SDDMM outputs at padding are 0.

``PaddedCOO``   -- flat (rows, cols, vals), 3 words per nonzero.
``RowTiledCOO`` -- sorted by row and chunked into nonzero blocks of
                   ``nz_block`` entries whose rows all fall inside one
                   ``row_tile``-row window.  On Hopper the windows let one
                   thread block own a whole output window and accumulate
                   it without atomics.

Packing runs on the host in numpy (the paper's amortized reorder step).
:func:`pack_row_tiled_arrays` is vectorised — O(nnz log nnz) — and
element-equal to the reference packer, whose per-window loop is
quadratic at millions of nonzeros.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class PaddedCOO:
    """A fixed-capacity COO block of an (m x n) sparse matrix."""

    rows: torch.Tensor  # int32[cap]
    cols: torch.Tensor  # int32[cap]
    vals: torch.Tensor  # float[cap]  (0.0 at padding)
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.vals, accumulate=True)

    def with_vals(self, vals: torch.Tensor) -> "PaddedCOO":
        return PaddedCOO(self.rows, self.cols, vals, self.shape)


@dataclasses.dataclass(frozen=True)
class RowTiledCOO:
    """Row-sorted, window-aligned COO for the local kernels.

    Block ``b`` only touches rows in
    ``[tile_base[b], tile_base[b] + row_tile)``; ``rows_local`` stores
    the offset within that window.  ``tile_base`` is non-decreasing, so
    the blocks of one window are contiguous.  Padding entries have
    ``vals == 0`` and ``rows_local == 0``.
    """

    rows_local: torch.Tensor  # int32[nblocks, nz_block] in [0, row_tile)
    cols: torch.Tensor        # int32[nblocks, nz_block]
    vals: torch.Tensor        # float[nblocks, nz_block]
    tile_base: torch.Tensor   # int32[nblocks] multiples of row_tile
    shape: Tuple[int, int]
    row_tile: int
    #: every aligned run of this many blocks shares one tile_base, as
    #: proved on the host when the pack was planned (1: nothing proved)
    window_groups: int = 1
    #: the blocks before this are the pack's own, those after it padding
    #: to a common block count, which the kernels skip (None: all real)
    real_blocks: int | None = None

    @property
    def nblocks(self) -> int:
        return self.rows_local.shape[0]

    @property
    def nz_block(self) -> int:
        return self.rows_local.shape[1]

    def rows_global(self) -> torch.Tensor:
        return self.rows_local + self.tile_base[:, None]

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_put_((self.rows_global().reshape(-1).long(),
                               self.cols.reshape(-1).long()),
                              self.vals.reshape(-1), accumulate=True)

    def with_vals(self, vals: torch.Tensor) -> "RowTiledCOO":
        return dataclasses.replace(self, vals=vals)

    def to_padded_coo(self) -> PaddedCOO:
        return PaddedCOO(self.rows_global().reshape(-1),
                         self.cols.reshape(-1),
                         self.vals.reshape(-1), self.shape)


# ---------------------------------------------------------------------------
# Packing (numpy on the host, amortized preprocessing)
# ---------------------------------------------------------------------------

def stable_order(key: np.ndarray):
    """``np.argsort(key, kind="stable")``, the same permutation, or None
    for sorted keys (the identity, found in one pass); unsorted keys go
    through torch's parallel stable sort on the host (about ten times
    faster than numpy's at millions of keys)."""
    key = np.ascontiguousarray(key)
    if key.size < 2 or bool(np.all(key[1:] >= key[:-1])):
        return None
    return torch.sort(torch.from_numpy(key), stable=True)[1].numpy()


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def clamp_row_tile(height: int, row_tile: int) -> int:
    """Largest divisor of ``height`` that is <= ``row_tile``."""
    row_tile = min(row_tile, height)
    while height % row_tile:
        row_tile -= 1
    return row_tile


def pack_row_tiled_arrays(rows: np.ndarray, cols: np.ndarray,
                          vals: np.ndarray, shape: Tuple[int, int], *,
                          row_tile: int = 256, nz_block: int = 256,
                          nblocks: int | None = None, group: int = 1):
    """Sort by row, then emit nz blocks confined to row_tile windows.

    Returns numpy ``(rows_local, cols, vals, tile_base, row_tile)`` with
    the reference packer's exact layout: a block is flushed whenever it
    fills up or the next nonzero leaves the current (aligned) row window;
    ``group > 1`` pads every window's run of blocks, and the block count,
    to a multiple of ``group``; padding blocks after the last window
    inherit its base so ``tile_base`` stays non-decreasing.  ``row_tile``
    is clamped to the largest divisor of the row count.  Values pack as
    float32, except integer ones, which keep their type: packing only
    moves values, so integer position codes come out exact at any count.
    """
    row_tile = clamp_row_tile(shape[0], row_tile)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    # stable sort by (row, col): the reference's lexsort order
    key = rows.astype(np.int64) * shape[1] + cols
    order = stable_order(key)
    if order is not None:
        rows, cols, vals = rows[order], cols[order], vals[order]
    nnz = rows.shape[0]

    win = rows.astype(np.int64) // row_tile
    starts = np.flatnonzero(np.diff(win, prepend=-1)) if nnz \
        else np.zeros(0, np.int64)
    uniq = win[starts]
    counts = np.diff(np.append(starts, nnz))
    real = (counts + nz_block - 1) // nz_block
    per_win = ((real + group - 1) // group) * group    # group-padded runs
    first_blk = np.concatenate([[0], np.cumsum(per_win)[:-1]]) \
        if len(per_win) else np.zeros(0, np.int64)
    nb = int(per_win.sum())
    target = nblocks if nblocks is not None else max(nb, 1)
    target = _round_up(target, group)
    if nb > target:
        raise ValueError(f"needs {nb} blocks > target {target}")

    rl = np.zeros((target, nz_block), np.int32)
    cl = np.zeros((target, nz_block), np.int32)
    vl = np.zeros((target, nz_block),
                  vals.dtype if vals.dtype.kind in "iu" else np.float32)
    if nnz:
        # window w's entries fill its blocks' slots in order: flat slot
        # first_blk[w] * nz_block + (i - starts[w]) for its i-th entry
        flat = np.arange(nnz, dtype=np.int64) + np.repeat(
            first_blk * nz_block - starts, counts)
        rl.reshape(-1)[flat] = rows - np.repeat(uniq * row_tile, counts)
        cl.reshape(-1)[flat] = cols
        vl.reshape(-1)[flat] = vals
    bases = np.repeat(uniq * row_tile, per_win)
    pad_base = bases[-1] if nb else 0
    tb = np.full(target, pad_base, np.int32)
    tb[:nb] = bases
    return rl, cl, vl, tb, row_tile


def pack_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             shape: Tuple[int, int], capacity: int | None = None,
             pad_multiple: int = 8, *, device=None) -> PaddedCOO:
    """Raw COO triplets as a PaddedCOO of static capacity (the
    reference's), placed on ``device`` (default: cuda)."""
    nnz = int(rows.shape[0])
    cap = capacity if capacity is not None \
        else _round_up(max(nnz, 1), pad_multiple)
    if nnz > cap:
        raise ValueError(f"nnz={nnz} exceeds capacity={cap}")
    r = np.zeros(cap, np.int32)
    c = np.zeros(cap, np.int32)
    v = np.zeros(cap, np.float32)
    r[:nnz], c[:nnz], v[:nnz] = rows, cols, vals
    dev = _device.resolve(device)
    return PaddedCOO(torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev),
                     torch.from_numpy(v).to(dev), shape)


def pack_row_tiled(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   shape: Tuple[int, int], *, row_tile: int = 256,
                   nz_block: int = 256, nblocks: int | None = None,
                   group: int = 1, device=None) -> RowTiledCOO:
    """:func:`pack_row_tiled_arrays` placed on ``device`` (default: cuda)."""
    rl, cl, vl, tb, row_tile = pack_row_tiled_arrays(
        rows, cols, vals, shape, row_tile=row_tile, nz_block=nz_block,
        nblocks=nblocks, group=group)
    dev = _device.resolve(device)
    return RowTiledCOO(torch.from_numpy(rl).to(dev),
                       torch.from_numpy(cl).to(dev),
                       torch.from_numpy(vl).to(dev),
                       torch.from_numpy(tb).to(dev), shape, row_tile)


# ---------------------------------------------------------------------------
# Random sparse matrix generators (the paper's workloads).  The numpy
# streams are the reference's, draw for draw.
# ---------------------------------------------------------------------------

def erdos_renyi(m: int, n: int, nnz_per_row: int, seed: int = 0,
                dtype=np.float32):
    """Erdos-Renyi random sparse matrix, ~nnz_per_row nonzeros per row.

    Each row draws ``nnz_per_row`` columns uniformly (duplicates
    removed).  Returns (rows, cols, vals) numpy COO, sorted.
    """
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n, size=rows.shape[0], dtype=np.int64)
    key = rows * n + cols
    key = np.unique(key)
    rows = (key // n).astype(np.int32)
    cols = (key % n).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return rows, cols, vals


def random_problem(m: int, n: int, r: int, nnz_per_row: int, *,
                   seed: int = 0, scale: float = 1.0):
    """One seeded (rows, cols, vals, X, Y) bundle: the ER matrix plus
    dense ``X (m, r)`` / ``Y (n, r)`` float32 drawn from ``seed + 1``."""
    rows, cols, vals = erdos_renyi(m, n, nnz_per_row, seed=seed)
    rng = np.random.default_rng(seed + 1)
    X = (rng.standard_normal((m, r)) * scale).astype(np.float32)
    Y = (rng.standard_normal((n, r)) * scale).astype(np.float32)
    return rows, cols, vals, X, Y


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         dtype=np.float32):
    """RMAT power-law generator (surrogate for web/social graphs)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    ne = n * edge_factor
    rows = np.zeros(ne, np.int64)
    cols = np.zeros(ne, np.int64)
    for lvl in range(scale):
        u = rng.random(ne)
        right = u >= a + b
        down = ((u >= a) & (u < a + b)) | (u >= a + b + c)
        rows |= down.astype(np.int64) << lvl
        cols |= right.astype(np.int64) << lvl
    key = np.unique(rows * n + cols)
    rows = (key // n).astype(np.int32)
    cols = (key % n).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return rows, cols, vals


def powerlaw_problem(scale: int, r: int, *, edge_factor: int = 16,
                     seed: int = 0, a: float = 0.57, b: float = 0.19,
                     c: float = 0.19):
    """One seeded power-law (rows, cols, vals, X, Y) bundle (RMAT,
    m = n = 2**scale, unpermuted); dense operands draw from seed + 1."""
    rows, cols, vals = rmat(scale, edge_factor, seed=seed, a=a, b=b, c=c)
    m = n = 1 << scale
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((m, r)).astype(np.float32)
    Y = rng.standard_normal((n, r)).astype(np.float32)
    return rows, cols, vals, X, Y


def random_permute(rows: np.ndarray, cols: np.ndarray, m: int, n: int,
                   seed: int = 0):
    """Random row+col permutation for load balance (paper §VI)."""
    rng = np.random.default_rng(seed)
    pr = rng.permutation(m).astype(np.int32)
    pc = rng.permutation(n).astype(np.int32)
    return pr[rows], pc[cols]


def block_sparse_mask(seq: int, block: int, window_blocks: int,
                      global_blocks: int = 1):
    """Block-sparse attention mask (sliding window + global) as COO blocks.

    Returns (rows, cols) of *block* indices for a lower-triangular
    sliding-window + global-token pattern over seq/block block rows.
    Used by the block-sparse attention path (``core/sparse_attention``).
    """
    nb = seq // block
    rows, cols = [], []
    for i in range(nb):
        lo = max(0, i - window_blocks + 1)
        for j in range(lo, i + 1):
            rows.append(i)
            cols.append(j)
        for j in range(min(global_blocks, lo)):
            rows.append(i)
            cols.append(j)
    return np.asarray(rows, np.int32), np.asarray(cols, np.int32)
