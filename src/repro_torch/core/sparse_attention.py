"""Block-sparse attention as SDDMM -> row softmax -> SpMM.

Port of ``repro.core.sparse_attention`` over the port's local kernels
(``kernels/ops.py``).  A block-sparse causal mask (sliding window plus
global tokens) makes long-context attention a sparse kernel problem,
so the paper's distributed algorithms, and their communication in
phi = nnz / (S * hd), apply to the attention layer.

The row softmax is not a kernel of the reference; here it runs per row
in entry order (``torch.segment_reduce``), so its result and gradient
repeat bit for bit on the card, where ``index_add_`` adds with atomics
in no fixed order.  The GAT layer (``apps/gat.py``) uses it too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sparse
from repro_torch.core.sparse import RowTiledCOO
from repro_torch.kernels import ops


def build_causal_block_mask(seq: int, block: int, window_blocks: int,
                            global_blocks: int = 1, row_tile: int = 128,
                            nz_block: int = 256,
                            device=None) -> RowTiledCOO:
    """Element-level RowTiledCOO for a causal sliding-window+global mask
    (unit values) on ``device`` (default: the card)."""
    brows, bcols = sparse.block_sparse_mask(seq, block, window_blocks,
                                            global_blocks)
    rows_l, cols_l = [], []
    for br, bc in zip(brows, bcols):
        r0, c0 = br * block, bc * block
        r = np.repeat(np.arange(block), block) + r0
        c = np.tile(np.arange(block), block) + c0
        keep = r >= c              # causal inside diagonal blocks
        rows_l.append(r[keep].astype(np.int32))
        cols_l.append(c[keep].astype(np.int32))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    key = np.unique(rows.astype(np.int64) * seq + cols)
    rows = (key // seq).astype(np.int32)
    cols = (key % seq).astype(np.int32)
    vals = np.ones(len(rows), np.float32)
    return sparse.pack_row_tiled(rows, cols, vals, (seq, seq),
                                 row_tile=row_tile, nz_block=nz_block,
                                 device=device)


def softmax_sorted_rows(rows: torch.Tensor, vals: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """Softmax of ``vals`` over each row's entries; ``rows`` (integer, on
    ``vals``' device) must be non-decreasing.  Differentiable in
    ``vals``; the row maximum only shifts the exponent and carries no
    gradient."""
    rows = rows.long()
    if rows.numel() > 1 and not bool((rows[1:] >= rows[:-1]).all()):
        raise ValueError("softmax_sorted_rows: rows must be sorted")
    counts = torch.bincount(rows, minlength=n_rows)
    rmax = torch.segment_reduce(vals.detach(), "max", lengths=counts)
    rmax = torch.where(torch.isfinite(rmax), rmax, torch.zeros_like(rmax))
    ex = torch.exp(vals - rmax[rows])
    rsum = torch.segment_reduce(ex, "sum", lengths=counts)
    return ex / torch.clamp(rsum[rows], min=1e-30)


def row_softmax(S: RowTiledCOO) -> RowTiledCOO:
    """Softmax over each row's nonzero values (sparse, numerically safe);
    zeros are padding, as in the reference.  A pack's live entries are
    in row order, so they are softmaxed in place of a scatter."""
    vals = S.vals.reshape(-1)
    live = torch.nonzero(vals != 0).reshape(-1)
    rows = S.rows_global().reshape(-1)[live]
    out = torch.zeros_like(vals)
    out[live] = softmax_sorted_rows(rows, vals[live], S.shape[0])
    return S.with_vals(out.reshape(S.vals.shape))


def sparse_attention_head(q, k, v, mask: RowTiledCOO,
                          backend: str | None = None) -> torch.Tensor:
    """One attention head over a block-sparse mask.

    q (S, hd), k (S, hd), v (S, hd) -> (S, hd):
    scores = SDDMM(q, k, mask) / sqrt(hd); probs = row_softmax;
    out = SpMM(probs, v)."""
    hd = q.shape[-1]
    scores = ops.sddmm(q * (hd ** -0.5), k, mask, backend=backend)
    # mask vals are 1.0 -> scores are the raw sampled dots
    probs = row_softmax(scores)
    return ops.spmm(probs, v, m=q.shape[0], backend=backend)


def dense_reference(q, k, v, mask_dense) -> torch.Tensor:
    """The same head with a dense (S, S) mask: masked softmax, then P @ v."""
    hd = q.shape[-1]
    s = (q @ k.T) * (hd ** -0.5)
    s = torch.where(torch.as_tensor(mask_dense, device=s.device) != 0, s,
                    torch.full_like(s, -torch.inf))
    p = torch.nan_to_num(torch.softmax(s, dim=-1))
    return p @ v


def sparsity_stats(mask: RowTiledCOO, seq: int, hd: int) -> dict:
    nnz = int((mask.vals != 0).sum())
    return dict(nnz=nnz, dense=seq * seq,
                fraction=nnz / (seq * seq),
                phi=nnz / (seq * hd))
