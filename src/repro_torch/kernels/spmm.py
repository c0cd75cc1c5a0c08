"""Local SpMM ``out (m, r) = S @ B`` over a RowTiledCOO pack.

``spmm_cuda`` launches the Hopper kernel ``csrc/spmm.cu`` (which
replaces ``repro.kernels.spmm.spmm_pallas``) for tensors on the card;
for tensors on the CPU it returns :func:`spmm_plain`, the plain PyTorch
version.  ``spmm_cuda.launches`` counts kernel launches and
``spmm_cuda.last_form`` names the form of the last one ("bulk" or
"load", see ``_build.choose_form``); ``spmm_cuda.forms`` counts the
launches of each form.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def spmm_plain(tile_base, rows_local, cols, vals, B, *, row_tile: int,
               m: int) -> torch.Tensor:
    """The plain version: gather, scale, ``index_add_`` in float32."""
    del row_tile
    rows = (rows_local + tile_base[:, None]).reshape(-1)
    return ref.spmm_coo(rows, cols.reshape(-1), vals.reshape(-1), B, m)


def _fn():
    fn = _build.load("spmm").rt_spmm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, ctypes.c_longlong, I, I, I, I, I,
                       I, I, P]
        fn.restype = I
    return fn


def spmm_cuda(tile_base: torch.Tensor, rows_local: torch.Tensor,
              cols: torch.Tensor, vals: torch.Tensor, B: torch.Tensor, *,
              row_tile: int, m: int, r_tile: int | None = None,
              blocks_per_step: int = 1) -> torch.Tensor:
    """out (m, r) = S @ B, float32 accumulation, in ``B.dtype``.

    ``tile_base`` holds row offsets (multiples of ``row_tile``, non-
    decreasing).  ``r_tile``/``blocks_per_step`` are checked and accepted
    for parity with the reference; the kernel's sum order does not depend
    on them.
    """
    if B.device.type == "cpu":
        return spmm_plain(tile_base, rows_local, cols, vals, B,
                          row_tile=row_tile, m=m)
    if B.device.type != "cuda":
        raise ValueError(f"spmm: no kernel for device {B.device}")
    nb, k, r = _build.validate("spmm", tile_base, rows_local, cols, vals,
                               [B], row_tile=row_tile, m=m, r_tile=r_tile,
                               blocks_per_step=blocks_per_step)
    out = torch.empty((m, r), dtype=B.dtype, device=B.device)
    form = _build.choose_form(
        "spmm", r=r, k=k, row_tile=row_tile, dense_dtype=B.dtype,
        vals_dtype=vals.dtype,
        addresses=_build.addresses(rows_local, cols, vals, B))
    off = _build.window_offsets(tile_base, row_tile, m // row_tile)
    fn = _fn()
    code = fn(_build.ptr(off), _build.ptr(rows_local), _build.ptr(cols),
              _build.ptr(vals), _build.ptr(B), _build.ptr(out), nb, k,
              row_tile, m, r, _build.FORM_FLAG[form],
              _build.DTYPE_FLAG[vals.dtype], _build.DTYPE_FLAG[B.dtype],
              _build.stream(B.device))
    _build.check(_build.load("spmm"), code, "spmm")
    spmm_cuda.launches += 1
    spmm_cuda.last_form = form
    spmm_cuda.forms[form] = spmm_cuda.forms.get(form, 0) + 1
    return out


spmm_cuda.launches = 0
spmm_cuda.last_form = None
spmm_cuda.forms = {}
