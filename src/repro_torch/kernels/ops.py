"""Public wrappers over the local kernels, with the plain versions behind
``backend="ref"``.

Port of ``repro.kernels.ops``.  ``backend="cuda"`` (the default) runs
the Hopper kernels for tensors on the card and their plain versions for
tensors on the CPU; ``backend="ref"`` runs the plain versions
(``kernels/ref.py``) wherever the tensors are.  The distributed
algorithms in ``repro_torch.core`` call these for every local kernel
invocation.

Tiling knobs: every wrapper accepts ``r_tile`` and ``blocks_per_step``.
Unset, they default through ``costmodel.choose_tiling`` as in the
reference, and the refusals stay: a non-divisor ``r_tile`` and a
``blocks_per_step`` that the pack's groups cannot honour raise.  A
``blocks_per_step`` that divides the pack's ``window_groups`` (proved on
the host when the plan was made) is not checked again, so the executors'
launches read nothing back from the card.

While ``repro_torch.core.api.activate(problem, S)`` is live, calls on
the bound pack ``S`` with no explicit ``backend`` run the distributed
problem instead (``_DIST_ROUTER``); the router answers NotImplemented
for anything it does not own, which falls through to the local kernels.
"""
from __future__ import annotations

from repro_torch.core import costmodel
from repro_torch.core.sparse import RowTiledCOO
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fusedmm import fusedmm_cuda
from repro_torch.kernels.sddmm import sddmm_cuda
from repro_torch.kernels.spmm import spmm_cuda

BACKENDS = ("cuda", "ref")
_DEFAULT_BACKEND = "cuda"
KERNELS = {"spmm": spmm_cuda, "sddmm": sddmm_cuda, "fusedmm": fusedmm_cuda}

#: the distributed routing hook, set by ``repro_torch.core.api.activate``
_DIST_ROUTER = None


def set_default_backend(backend: str) -> None:
    global _DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    _DEFAULT_BACKEND = backend


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def form_counts() -> dict:
    """Kernel launches per kernel and form (or FusedMM route) since the
    last reset."""
    return {name: dict(fn.forms) for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.forms = {}


def _backend(backend: str | None) -> str:
    backend = backend or _DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return backend


def _groups_share_window(S: RowTiledCOO, g: int) -> bool:
    """Does every aligned run of ``g`` blocks share one tile_base?  (One
    comparison on the pack's device, read back to the host.)"""
    if S.nblocks % g:
        return False
    groups = S.tile_base.reshape(-1, g)
    return bool((groups == groups[:, :1]).all())


def _resolve_tiling(S: RowTiledCOO, n_b: int, r: int,
                    r_tile: int | None, blocks_per_step: int | None):
    """Fill unset knobs from the cost model; refuse infeasible ones."""
    derived_bps = False
    if r_tile is None or blocks_per_step is None:
        t = costmodel.choose_tiling(
            n_b=n_b, r=r, nb=S.nblocks, k=S.nz_block, row_tile=S.row_tile,
            tile_base=S.tile_base.cpu().numpy())
        if r_tile is None:
            r_tile = t.r_tile
        if blocks_per_step is None:
            blocks_per_step = t.blocks_per_step
            derived_bps = True   # choose_tiling already proved feasibility
    if r % r_tile:
        raise ValueError(f"r_tile={r_tile} does not divide r={r}")
    if blocks_per_step > 1 and not derived_bps \
            and S.window_groups % blocks_per_step \
            and not _groups_share_window(S, blocks_per_step):
        # merging blocks is only sound when every aligned group shares one
        # row window -- a silently wrong answer otherwise, so refuse here
        feasible = costmodel.groupable_blocks_per_step(
            S.tile_base.cpu().numpy(), S.nz_block, cap=blocks_per_step)
        raise ValueError(
            f"blocks_per_step={blocks_per_step} infeasible for this pack "
            f"(nblocks={S.nblocks}, largest groupable step {feasible}); "
            f"repack with pack_row_tiled(..., group={blocks_per_step})")
    return r_tile, blocks_per_step


def sddmm(A, B, S: RowTiledCOO, backend: str | None = None, *,
          r_tile: int | None = None,
          blocks_per_step: int | None = None) -> RowTiledCOO:
    """R = S * (A @ B.T) sampled at nnz(S); returns S with new values."""
    if _DIST_ROUTER is not None and backend is None:
        routed = _DIST_ROUTER.sddmm(A, B, S)
        if routed is not NotImplemented:
            return routed
    if _backend(backend) == "ref":
        return _ref.sddmm(A, B, S)
    r_tile, bps = _resolve_tiling(S, B.shape[0], B.shape[-1], r_tile,
                                  blocks_per_step)
    vals = sddmm_cuda(S.tile_base, S.rows_local, S.cols, S.vals, A, B,
                      row_tile=S.row_tile, r_tile=r_tile,
                      blocks_per_step=bps, real_blocks=S.real_blocks)
    return S.with_vals(vals)


def spmm(S: RowTiledCOO, B, m: int | None = None,
         backend: str | None = None, *, r_tile: int | None = None,
         blocks_per_step: int | None = None):
    """out = S @ B (shape (m, r))."""
    m = m if m is not None else S.shape[0]
    if _DIST_ROUTER is not None and backend is None:
        routed = _DIST_ROUTER.spmm(S, B, m)
        if routed is not NotImplemented:
            return routed
    if _backend(backend) == "ref":
        return _ref.spmm(S, B, m)
    r_tile, bps = _resolve_tiling(S, B.shape[0], B.shape[-1], r_tile,
                                  blocks_per_step)
    return spmm_cuda(S.tile_base, S.rows_local, S.cols, S.vals, B,
                     row_tile=S.row_tile, m=m, r_tile=r_tile,
                     blocks_per_step=bps, real_blocks=S.real_blocks)


def fusedmm(A, B, S: RowTiledCOO, m: int | None = None,
            backend: str | None = None, *, r_tile: int | None = None,
            blocks_per_step: int | None = None):
    """FusedMMA: out = SDDMM(A,B,S) @ B; returns (out, R)."""
    m = m if m is not None else S.shape[0]
    if _DIST_ROUTER is not None and backend is None:
        routed = _DIST_ROUTER.fusedmm(A, B, S, m)
        if routed is not NotImplemented:
            return routed
    if _backend(backend) == "ref":
        return _ref.fusedmm(A, B, S, m)
    r_tile, bps = _resolve_tiling(S, B.shape[0], B.shape[-1], r_tile,
                                  blocks_per_step)
    out, r_vals = fusedmm_cuda(S.tile_base, S.rows_local, S.cols, S.vals,
                               A, B, row_tile=S.row_tile, m=m,
                               r_tile=r_tile, blocks_per_step=bps,
                               real_blocks=S.real_blocks)
    return out, S.with_vals(r_vals)
