"""Port's sparse formats, packer, generators and cost model vs ``repro``.

The port's vectorised packer must be element-equal to the reference's
``pack_row_tiled`` (dtypes, shapes, every slot), over row_tile, nz_block,
group and nblocks, including empty windows and unsorted input; the
generators must draw the same numpy streams; the cost-model copy must
give the same numbers.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import costmodel as jcost
from repro.core import sparse as jsparse
from repro_torch.core import costmodel as tcost
from repro_torch.core import sparse as tsparse
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

CPU = torch.device("cpu")

# (m, n, nnz_per_row, row_tile, nz_block, group, nblocks, seed)
PACKS = [
    (256, 192, 5, 32, 32, 1, None, 0),
    (384, 256, 3, 128, 32, 4, None, 1),
    (500, 300, 7, 64, 16, 2, None, 2),    # row_tile clamps to 50
    (512, 128, 0, 64, 32, 1, None, 3),    # no nonzeros at all
    (100, 100, 2, 30, 8, 3, 200, 4),      # explicit nblocks
    (64, 64, 40, 8, 8, 1, None, 5),       # dense windows
    (1024, 96, 1, 256, 64, 2, None, 6),
]


def _sample(m, n, k, seed):
    """ER entries with some rows (so some windows) emptied, shuffled."""
    rows, cols, vals = jsparse.erdos_renyi(m, n, k, seed=seed)
    keep = (rows % 97) < 60
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    perm = np.random.default_rng(seed).permutation(len(rows))
    return rows[perm], cols[perm], vals[perm]


@pytest.mark.parametrize("m,n,k,rt,nzb,g,nbk,seed", PACKS)
def test_pack_element_equal_to_reference(m, n, k, rt, nzb, g, nbk, seed):
    rows, cols, vals = _sample(m, n, k, seed)
    want = jsparse.pack_row_tiled(rows, cols, vals, (m, n), row_tile=rt,
                                  nz_block=nzb, group=g, nblocks=nbk)
    got = tsparse.pack_row_tiled(rows, cols, vals, (m, n), row_tile=rt,
                                 nz_block=nzb, group=g, nblocks=nbk,
                                 device=CPU)
    assert got.row_tile == want.row_tile
    assert got.shape == want.shape
    for name in ("rows_local", "cols", "vals", "tile_base"):
        w = np.asarray(getattr(want, name))
        t = getattr(got, name).numpy()
        assert t.dtype == w.dtype and t.shape == w.shape, name
        np.testing.assert_array_equal(t, w, err_msg=name)


def test_pack_refuses_too_few_blocks():
    rows, cols, vals = jsparse.erdos_renyi(128, 64, 8, seed=1)
    with pytest.raises(ValueError, match="blocks"):
        tsparse.pack_row_tiled_arrays(rows, cols, vals, (128, 64),
                                      row_tile=32, nz_block=32, nblocks=2)


def test_row_tiled_views_match_reference():
    rows, cols, vals = _sample(256, 160, 6, 9)
    J = jsparse.pack_row_tiled(rows, cols, vals, (256, 160), row_tile=64,
                               nz_block=32, group=2)
    T = tsparse.pack_row_tiled(rows, cols, vals, (256, 160), row_tile=64,
                               nz_block=32, group=2, device=CPU)
    np.testing.assert_array_equal(T.rows_global().numpy(),
                                  np.asarray(J.rows_global()))
    np.testing.assert_array_equal(T.to_dense().numpy(),
                                  np.asarray(J.to_dense()))
    pj, pt = J.to_padded_coo(), T.to_padded_coo()
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)))
    assert pt.capacity == pj.capacity
    np.testing.assert_array_equal(pt.to_dense().numpy(),
                                  np.asarray(pj.to_dense()))
    doubled = T.with_vals(T.vals * 2)
    assert doubled.tile_base is T.tile_base
    np.testing.assert_array_equal(doubled.to_dense().numpy(),
                                  2 * T.to_dense().numpy())


def test_pack_invariants():
    """Window confinement, non-decreasing bases, group feasibility and a
    lossless round trip (tests/test_kernels.py:226-270)."""
    rows, cols, vals = jsparse.erdos_renyi(512, 256, 3, seed=5)
    S = tsparse.pack_row_tiled(rows, cols, vals, (512, 256), row_tile=64,
                               nz_block=32, group=4, device=CPU)
    assert S.nblocks % 4 == 0
    tb = S.tile_base.numpy()
    for g in (2, 4):
        groups = tb.reshape(-1, g)
        assert (groups == groups[:, :1]).all()
    assert tcost.groupable_blocks_per_step(tb, S.nz_block, cap=4) == 4
    dense = np.zeros((512, 256), np.float32)
    dense[rows, cols] = vals
    np.testing.assert_array_equal(S.to_dense().numpy(), dense)
    rg = S.rows_global().numpy()
    mask = S.vals.numpy() != 0
    base = tb[:, None]
    assert np.all((rg >= base)[mask] & (rg < base + S.row_tile)[mask])
    assert np.all(np.diff(tb) >= 0)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    rows, cols, vals = jsparse.erdos_renyi(64, 64, 2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsparse.pack_row_tiled(rows, cols, vals, (64, 64))


@pytest.mark.parametrize("gen,args", [
    ("erdos_renyi", (300, 200, 7)),
    ("rmat", (9, 8)),
])
def test_generator_streams_equal(gen, args):
    for seed in (0, 3):
        want = getattr(jsparse, gen)(*args, seed=seed)
        got = getattr(tsparse, gen)(*args, seed=seed)
        for w, t in zip(want, got):
            assert w.dtype == t.dtype
            np.testing.assert_array_equal(t, w)


def test_problem_bundles_equal():
    for want, got in (
            (jsparse.random_problem(96, 80, 16, 4, seed=2, scale=0.5),
             tsparse.random_problem(96, 80, 16, 4, seed=2, scale=0.5)),
            (jsparse.powerlaw_problem(8, 16, edge_factor=4, seed=1),
             tsparse.powerlaw_problem(8, 16, edge_factor=4, seed=1))):
        for w, t in zip(want, got):
            assert w.dtype == t.dtype
            np.testing.assert_array_equal(t, w)
    rows, cols, _ = jsparse.erdos_renyi(64, 48, 3, seed=4)
    for w, t in zip(jsparse.random_permute(rows, cols, 64, 48, seed=7),
                    tsparse.random_permute(rows, cols, 64, 48, seed=7)):
        np.testing.assert_array_equal(t, w)


def _fields(obj):
    return dataclasses.astuple(obj)


def test_costmodel_copy_equals_reference():
    n, r = 1 << 14, 64
    for p in (1, 4, 8, 16, 64):
        for phi in (0.01, 0.5, 4.0):
            nnz = int(phi * n * r)
            for alg in jcost.ALGORITHMS:
                for c in jcost.feasible_cs(alg, p):
                    for fn in ("words_fusedmm", "words_fusedmm_cached",
                               "words_fusedmm_bwd", "words_trainstep"):
                        assert _fields(getattr(tcost, fn)(
                            alg, p=p, c=c, n=n, r=r, nnz=nnz)) == \
                            _fields(getattr(jcost, fn)(
                                alg, p=p, c=c, n=n, r=r, nnz=nnz)), \
                            (fn, alg, p, c)
                assert tcost.optimal_c(alg, p=p, phi=phi) == \
                    jcost.optimal_c(alg, p=p, phi=phi)
            for fam in jcost.FAMILIES:
                for c in range(1, p + 1):
                    kw = dict(m=n, n=n, r=r, p=p, c=c)
                    assert tcost.family_feasible(fam, **kw) == \
                        jcost.family_feasible(fam, **kw)
            for fams in (jcost.FAMILIES, ("d15",)):
                kw = dict(m=n, n=n, nnz=nnz, r=r, p=p, families=fams)
                assert _fields(tcost.choose_algorithm(**kw)) == \
                    _fields(jcost.choose_algorithm(**kw))
    rows, cols, _ = jsparse.erdos_renyi(512, 256, 3, seed=5)
    tb = np.asarray(jsparse.pack_row_tiled(rows, cols, _, (512, 256),
                                           row_tile=64, nz_block=32,
                                           group=4).tile_base)
    for kw in (dict(n_b=1 << 16, r=1024, nb=64, k=256, row_tile=256),
               dict(n_b=256, r=128, nb=tb.shape[0], k=32, row_tile=64,
                    tile_base=tb)):
        assert _fields(tcost.choose_tiling(**kw)) == \
            _fields(jcost.choose_tiling(**kw))
