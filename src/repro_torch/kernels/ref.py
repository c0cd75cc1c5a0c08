"""Plain PyTorch versions of the local SDDMM / SpMM / FusedMM kernels.

Port of ``repro.kernels.ref``: the ground truth the CUDA kernels are
held to, and what the wrappers run for tensors on the CPU.  Gathers and
``index_add_`` accumulate in float32 and cast once at the end.  The flat
work is cut into chunks of ``CHUNK`` nonzeros so that a problem of tens
of millions of nonzeros does not materialise an (nnz, r) gather at once;
on the CPU ``index_add_`` adds in entry order, so chunking does not
change a bit there.  (On the card ``index_add_`` uses atomics and its
order is not fixed: the plain version is a tolerance reference there,
not a bitwise one.)
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import RowTiledCOO

CHUNK = 1 << 22


# --- flat-COO versions ------------------------------------------------------

def sddmm_coo(A: torch.Tensor, B: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[k] = vals[k] * <A[rows[k]], B[cols[k]]> (f32 accumulation)."""
    out = torch.empty(vals.shape, dtype=torch.float32, device=vals.device)
    for s in range(0, vals.shape[0], CHUNK):
        e = min(s + CHUNK, vals.shape[0])
        a = A[rows[s:e].long()].float()
        b = B[cols[s:e].long()].float()
        out[s:e] = vals[s:e].float() * (a * b).sum(-1)
    return out.to(vals.dtype)


def spmm_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             B: torch.Tensor, m: int) -> torch.Tensor:
    """out[m, r] with out[rows[k]] += vals[k] * B[cols[k]]."""
    out = torch.zeros((m, B.shape[-1]), dtype=torch.float32,
                      device=B.device)
    for s in range(0, vals.shape[0], CHUNK):
        e = min(s + CHUNK, vals.shape[0])
        contrib = vals[s:e, None].float() * B[cols[s:e].long()].float()
        out.index_add_(0, rows[s:e].long(), contrib)
    return out.to(B.dtype)


def fusedmm_coo(A: torch.Tensor, B: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, vals: torch.Tensor, m: int):
    """FusedMMA: (SpMMA(SDDMM(A,B,S), B), sddmm_vals)."""
    r_vals = sddmm_coo(A, B, rows, cols, vals)
    out = spmm_coo(rows, cols, r_vals, B, m)
    return out, r_vals


# --- RowTiledCOO versions ---------------------------------------------------

def _flat(S: RowTiledCOO):
    return (S.rows_global().reshape(-1), S.cols.reshape(-1),
            S.vals.reshape(-1))


def sddmm(A: torch.Tensor, B: torch.Tensor, S: RowTiledCOO) -> RowTiledCOO:
    rows, cols, vals = _flat(S)
    out = sddmm_coo(A, B, rows, cols, vals)
    return S.with_vals(out.reshape(S.vals.shape))


def spmm(S: RowTiledCOO, B: torch.Tensor, m: int | None = None
         ) -> torch.Tensor:
    rows, cols, vals = _flat(S)
    return spmm_coo(rows, cols, vals, B, m if m is not None else S.shape[0])


def fusedmm(A: torch.Tensor, B: torch.Tensor, S: RowTiledCOO,
            m: int | None = None):
    rows, cols, vals = _flat(S)
    out, r_vals = fusedmm_coo(A, B, rows, cols, vals,
                              m if m is not None else S.shape[0])
    return out, S.with_vals(r_vals.reshape(S.vals.shape))
