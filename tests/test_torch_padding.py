"""The stacked ranks' pack padding on a power-law matrix.

Stacked ranks' packs are padded to the heaviest rank's block count, and
the padding blocks repeat the last window's base (the reference's pack
layout, which the port keeps element for element).  The planners record
each pack's real block count (``plan.nreal``) and the kernel wrappers
walk only those blocks, so no window's run holds the padding: on an
unpermuted R-MAT 2^14 at p = 8 (rows concentrate on the first row
blocks) each rank's last-window run must equal its own pack's, and the
results must not change.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import api, common, sparse
from repro_torch.kernels import _build, ops

CPU = torch.device("cpu")
SCALE, R = 14, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its ops are small, and beside
    the other test workers' default thread pools (one per core each)
    they crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rmat():
    rows, cols, vals = sparse.rmat(SCALE, 16, seed=7)
    m = 1 << SCALE
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((m, R)).astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal((m, R)).astype(np.float32))
    return rows, cols, vals, m, X, Y


def _packs(plan):
    """(tile_base, real block count) of every rank's pack of a stacked
    plan (d15: every phase's)."""
    tbs = plan.tile_base if isinstance(plan.tile_base, tuple) \
        else (plan.tile_base,)
    nreal = np.asarray(plan.nreal).reshape(len(tbs), -1)
    for t, tb in enumerate(tbs):
        flat = tb.reshape(-1, tb.shape[-1])
        for i in range(flat.shape[0]):
            yield flat[i], int(nreal[t, i])


def _runs(tb, row_tile, n_windows, live=None):
    off = _build.window_offsets(tb if live is None else tb[:live],
                                row_tile, n_windows)
    return (off[1:] - off[:-1]).numpy()


@pytest.mark.parametrize("family,c", [("s15", 2), ("d15", 2)])
def test_window_runs_capped_at_real_blocks(rmat, family, c):
    rows, cols, vals, m, *_ = rmat
    prob = api.make_problem(rows, cols, vals, (m, m), R, algorithm=family,
                            c=c, devices=[CPU] * 8)
    plan = prob.plan("normal")
    height = plan.mS if family == "s15" else plan.cmA
    n_windows = height // plan.row_tile
    worst_uncapped = worst_capped = 0
    for tb, live in _packs(plan):
        nb = tb.shape[0]
        assert 0 <= live <= nb
        # the blocks past the real count are padding: the last base
        # repeated (or 0 for an empty pack)
        pad = tb[live:]
        assert bool((pad == (tb[live - 1] if live else 0)).all())
        capped = _runs(tb, plan.row_tile, n_windows, live)
        assert capped.sum() == live
        # each window's run is its own blocks: those with its base
        bases = tb[:live].numpy() // plan.row_tile
        assert np.array_equal(capped, np.bincount(bases,
                                                  minlength=n_windows))
        worst_uncapped = max(worst_uncapped,
                             int(_runs(tb, plan.row_tile, n_windows).max()))
        worst_capped = max(worst_capped, int(capped.max()))
    # the defect the cap removes: some light rank's padding made one run
    # many times longer than any window's own blocks
    assert worst_uncapped > 4 * worst_capped


@pytest.mark.parametrize("family,c", [("s15", 2), ("d15", 2)])
def test_results_unchanged_by_the_cap(rmat, family, c):
    rows, cols, vals, m, X, Y = rmat
    prob = api.make_problem(rows, cols, vals, (m, m), R, algorithm=family,
                            c=c, devices=[CPU] * 8)
    uncapped = {}
    orig = common.real_blocks
    try:
        common.real_blocks = lambda nreal, index: None
        uncapped["out"], R_un = prob.fusedmm(X, Y, elision="fused")
        uncapped["r"] = R_un.values()
        uncapped["spmm"] = prob.spmm(Y)
    finally:
        common.real_blocks = orig
    out, R_cap = prob.fusedmm(X, Y, elision="fused")
    assert torch.equal(out, uncapped["out"])
    assert np.array_equal(R_cap.values(), uncapped["r"])
    assert torch.equal(prob.spmm(Y), uncapped["spmm"])
    # and against a float64 oracle
    want = np.zeros((m, R))
    np.add.at(want, rows, vals[:, None].astype(np.float64)
              * Y.numpy()[cols].astype(np.float64))
    assert np.allclose(prob.spmm(Y).numpy(), want, rtol=1e-4, atol=1e-3)


def test_wrappers_walk_only_the_live_blocks():
    """The wrappers' plain versions take the live blocks; sampled values
    past them come out exactly 0, and SpMM/FusedMM outputs equal the
    uncapped ones bit for bit."""
    rng = np.random.default_rng(3)
    m, n = 128, 96
    rows, cols, vals = sparse.erdos_renyi(m, n, 3, seed=3)
    rl, cl, vl, tb, rt = sparse.pack_row_tiled_arrays(
        rows, cols, vals, (m, n), row_tile=32, nz_block=16)
    nb = rl.shape[0]
    extra = 7                                   # stacked-rank padding
    pad = lambda a: np.concatenate([a, np.zeros((extra,) + a.shape[1:],
                                                a.dtype)])
    tbp = np.concatenate([tb, np.full(extra, tb[-1], tb.dtype)])
    S = sparse.RowTiledCOO(*(torch.from_numpy(pad(a)) for a in (rl, cl, vl)),
                           torch.from_numpy(tbp), (m, n), rt)
    Sc = S.__class__(**{**S.__dict__, "real_blocks": nb})
    A = torch.from_numpy(rng.standard_normal((m, 8)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    s_un, s_cap = ops.sddmm(A, B, S).vals, ops.sddmm(A, B, Sc).vals
    assert torch.equal(s_cap[:nb], s_un[:nb])
    assert bool((s_cap[nb:] == 0).all())
    assert torch.equal(ops.spmm(Sc, B, m), ops.spmm(S, B, m))
    (o_un, r_un), (o_cap, r_cap) = ops.fusedmm(A, B, S), ops.fusedmm(A, B, Sc)
    assert torch.equal(o_cap, o_un) and torch.equal(r_cap.vals[:nb],
                                                    r_un.vals[:nb])
    assert bool((r_cap.vals[nb:] == 0).all())
