"""Local FusedMM (SDDMM then SpMM, fused) over a RowTiledCOO pack.

``fusedmm_cuda`` launches the Hopper kernel ``csrc/fusedmm.cu`` (which
replaces ``repro.kernels.fusedmm.fusedmm_pallas``) for tensors on the
card; for tensors on the CPU it returns :func:`fusedmm_plain`, the plain
PyTorch version.  ``fusedmm_cuda.launches`` counts calls that launched
the kernel (one or, on the two-pass route, two launches each), and
``fusedmm_cuda.last_form`` names the route of the last one: "bulk" or
"load" (the single pass, in the form ``_build.choose_form`` picked), or
"two_pass"; ``fusedmm_cuda.forms`` counts the calls of each route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def fusedmm_plain(tile_base, rows_local, cols, vals, A, B, *,
                  row_tile: int, m: int):
    """The plain version: sddmm then spmm with the sampled values."""
    del row_tile
    rows = (rows_local + tile_base[:, None]).reshape(-1)
    out, r_vals = ref.fusedmm_coo(A, B, rows, cols.reshape(-1),
                                  vals.reshape(-1), m)
    return out, r_vals.reshape(vals.shape)


def _fn():
    fn = _build.load("fusedmm").rt_fusedmm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, ctypes.c_longlong, I, I,
                       I, I, I, I, ctypes.POINTER(I), I, I, I, I, P]
        fn.restype = I
    return fn


def fusedmm_cuda(tile_base: torch.Tensor, rows_local: torch.Tensor,
                 cols: torch.Tensor, vals: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, *, row_tile: int, m: int,
                 r_tile: int | None = None, blocks_per_step: int = 1,
                 real_blocks: int | None = None):
    """Returns (out (m, r) in ``B.dtype``, R (nblocks, nz_block) in
    ``vals.dtype``).  Only the first ``real_blocks`` blocks are walked
    (None: all); the others are padding, with R 0 there.

    The single pass runs when ``r_tile`` is r (or None) and rows of up
    to 512 values are read four at a time; ``r_tile < r`` asks for the
    two-pass route, as the reference's two-phase kernel does.
    ``fusedmm_cuda.last_form`` records the route the last launch took,
    and ``fusedmm_cuda.last_two_pass`` whether it was the two-pass one.
    """
    live = _build.live_blocks(rows_local, real_blocks)
    if B.device.type == "cpu":
        r_vals = vals.new_zeros(vals.shape)
        out, r_vals[:live] = fusedmm_plain(
            tile_base[:live], rows_local[:live], cols[:live], vals[:live],
            A, B, row_tile=row_tile, m=m)
        return out, r_vals
    if B.device.type != "cuda":
        raise ValueError(f"fusedmm: no kernel for device {B.device}")
    nb, k, r = _build.validate("fusedmm", tile_base, rows_local, cols, vals,
                               [A, B], row_tile=row_tile, m=m,
                               r_tile=r_tile,
                               blocks_per_step=blocks_per_step)
    want_two = int(r_tile is not None and r_tile < r)
    out = torch.empty((m, r), dtype=B.dtype, device=B.device)
    r_vals = _build.zero_tail(
        torch.empty((nb, k), dtype=torch.float32, device=B.device), live)
    used = ctypes.c_int(-1)
    # the single pass, and the two-pass route's sddmm and spmm launches
    idx = _build.addresses(rows_local, cols)
    shape = dict(r=r, k=k, row_tile=row_tile, dense_dtype=B.dtype)
    form = _build.choose_form(
        "fusedmm", vals_dtype=vals.dtype,
        addresses=idx + _build.addresses(vals, B), **shape)
    sddmm_form = _build.choose_form(
        "sddmm", vals_dtype=vals.dtype, a_rows=A.shape[0],
        n_windows=m // row_tile,
        addresses=idx + _build.addresses(vals, A, B), **shape)
    spmm_form = _build.choose_form(
        "spmm", vals_dtype=torch.float32,
        addresses=idx + _build.addresses(r_vals, B), **shape)
    off = _build.window_offsets(tile_base[:live], row_tile, m // row_tile)
    fn = _fn()
    code = fn(_build.ptr(tile_base), _build.ptr(off),
              _build.ptr(rows_local), _build.ptr(cols), _build.ptr(vals),
              _build.ptr(A), _build.ptr(B), _build.ptr(out),
              _build.ptr(r_vals), live, k, row_tile, m, r,
              _build.FORM_FLAG[form], want_two, ctypes.byref(used),
              _build.FORM_FLAG[sddmm_form],
              _build.FORM_FLAG[spmm_form], _build.DTYPE_FLAG[vals.dtype],
              _build.DTYPE_FLAG[B.dtype], _build.stream(B.device))
    _build.check(_build.load("fusedmm"), code, "fusedmm")
    fusedmm_cuda.launches += 1
    fusedmm_cuda.last_form = _build.FUSED_ROUTE[used.value]
    fusedmm_cuda.forms[fusedmm_cuda.last_form] = \
        fusedmm_cuda.forms.get(fusedmm_cuda.last_form, 0) + 1
    fusedmm_cuda.last_two_pass = fusedmm_cuda.last_form == "two_pass"
    return out, r_vals.to(vals.dtype)


fusedmm_cuda.launches = 0
fusedmm_cuda.last_form = None
fusedmm_cuda.last_two_pass = False
fusedmm_cuda.forms = {}
