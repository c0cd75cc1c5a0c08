"""Local SDDMM ``R = vals * <A[row], B[col]>`` over a RowTiledCOO pack.

``sddmm_cuda`` launches the Hopper kernel ``csrc/sddmm.cu`` (which
replaces ``repro.kernels.sddmm.sddmm_pallas``) for tensors on the card;
for tensors on the CPU it returns :func:`sddmm_plain`, the plain PyTorch
version.  ``sddmm_cuda.launches`` counts kernel launches and
``sddmm_cuda.last_form`` names the form of the last one ("bulk" or
"load", see ``_build.choose_form``); ``sddmm_cuda.forms`` counts the
launches of each form.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def sddmm_plain(tile_base, rows_local, cols, vals, A, B, *,
                row_tile: int) -> torch.Tensor:
    """The plain version: gather both rows, dot in float32, scale."""
    del row_tile
    rows = (rows_local + tile_base[:, None]).reshape(-1)
    out = ref.sddmm_coo(A, B, rows, cols.reshape(-1), vals.reshape(-1))
    return out.reshape(vals.shape)


def _fn():
    fn = _build.load("sddmm").rt_sddmm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, ctypes.c_longlong, I, I,
                       ctypes.c_longlong, I, I, I, I, P]
        fn.restype = I
    return fn


def sddmm_cuda(tile_base: torch.Tensor, rows_local: torch.Tensor,
               cols: torch.Tensor, vals: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, *, row_tile: int,
               r_tile: int | None = None, blocks_per_step: int = 1,
               real_blocks: int | None = None) -> torch.Tensor:
    """New sampled values, shape (nblocks, nz_block), in ``vals.dtype``.

    Dots accumulate in float32 over the whole width r in one pass;
    ``r_tile``/``blocks_per_step`` are checked and accepted for parity.
    Only the first ``real_blocks`` blocks are walked (None: all); the
    values of the others, padding, are 0.
    """
    live = _build.live_blocks(rows_local, real_blocks)
    if B.device.type == "cpu":
        out = vals.new_zeros(vals.shape)
        out[:live] = sddmm_plain(tile_base[:live], rows_local[:live],
                                 cols[:live], vals[:live], A, B,
                                 row_tile=row_tile)
        return out
    if B.device.type != "cuda":
        raise ValueError(f"sddmm: no kernel for device {B.device}")
    nb, k, r = _build.validate("sddmm", tile_base, rows_local, cols, vals,
                               [A, B], row_tile=row_tile, m=None,
                               r_tile=r_tile,
                               blocks_per_step=blocks_per_step)
    out = _build.zero_tail(
        torch.empty((nb, k), dtype=torch.float32, device=B.device), live)
    n_windows = A.shape[0] // row_tile
    form = _build.choose_form(
        "sddmm", r=r, k=k, row_tile=row_tile, dense_dtype=B.dtype,
        vals_dtype=vals.dtype,
        addresses=_build.addresses(rows_local, cols, vals, A, B),
        a_rows=A.shape[0], n_windows=n_windows)
    off = _build.window_offsets(tile_base[:live], row_tile, n_windows)
    fn = _fn()
    code = fn(_build.ptr(tile_base), _build.ptr(off),
              _build.ptr(rows_local), _build.ptr(cols), _build.ptr(vals),
              _build.ptr(A), _build.ptr(B), _build.ptr(out), live, k,
              row_tile, n_windows, r, _build.FORM_FLAG[form],
              _build.DTYPE_FLAG[vals.dtype], _build.DTYPE_FLAG[B.dtype],
              _build.stream(B.device))
    _build.check(_build.load("sddmm"), code, "sddmm")
    sddmm_cuda.launches += 1
    sddmm_cuda.last_form = form
    sddmm_cuda.forms[form] = sddmm_cuda.forms.get(form, 0) + 1
    return out.to(vals.dtype)


sddmm_cuda.launches = 0
sddmm_cuda.last_form = None
sddmm_cuda.forms = {}
