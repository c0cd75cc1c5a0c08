"""The port's Matrix Market loader (core/mtx.py) and block mask
(sparse.block_sparse_mask) against the reference's (after
tests/test_mtx.py): loaded triples and masks equal the reference's
exactly."""
import os

import numpy as np
import pytest
import torch

from repro.core import mtx as jmtx
from repro.core import sparse as jsparse
from repro_torch.core import api, mtx, sparse

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny.mtx")
CPU = torch.device("cpu")

SYM = ("%%MatrixMarket matrix coordinate pattern symmetric\n"
       "3 3 3\n1 1\n2 1\n3 2\n")
SKEW = ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "2 2 1\n2 1 3.0\n")
DUP = ("%%MatrixMarket matrix coordinate real general\n"
       "2 2 3\n1 1 1.0\n1 1 2.0\n2 2 5.0\n")
INT = ("%%MatrixMarket matrix coordinate integer general\n"
       "% a comment\n3 4 3\n3 4 7\n1 2 -2\n2 2 9\n")


def _same(got, want):
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3]


def test_fixture_equals_reference_and_roundtrips(tmp_path):
    got = mtx.load_mtx(FIXTURE)
    _same(got, jmtx.load_mtx(FIXTURE))
    rows, cols, vals, shape = got
    assert shape == (64, 64) and len(vals) > 0 and rows.dtype == np.int32
    out = tmp_path / "copy.mtx"
    mtx.save_mtx(str(out), rows, cols, vals, shape)
    r2, c2, v2, s2 = mtx.load_mtx(str(out))
    assert s2 == shape
    np.testing.assert_array_equal(r2, rows)
    np.testing.assert_array_equal(c2, cols)
    np.testing.assert_allclose(v2, vals, rtol=1e-6)
    _same(mtx.load_mtx(str(out)), jmtx.load_mtx(str(out)))


@pytest.mark.parametrize("text", [SYM, SKEW, DUP, INT],
                         ids=["pattern-symmetric", "skew", "duplicates",
                              "integer"])
def test_small_files_equal_reference(tmp_path, text):
    p = tmp_path / "m.mtx"
    p.write_text(text)
    _same(mtx.load_mtx(str(p)), jmtx.load_mtx(str(p)))


def test_pattern_symmetric_and_skew(tmp_path):
    p = tmp_path / "sym.mtx"
    p.write_text(SYM)
    rows, cols, vals, shape = mtx.load_mtx(str(p))
    dense = np.zeros(shape)
    dense[rows, cols] = vals
    np.testing.assert_array_equal(
        dense, [[1, 1, 0], [1, 0, 1], [0, 1, 0]])
    p.write_text(SKEW)
    rows, cols, vals, _ = mtx.load_mtx(str(p))
    dense = np.zeros((2, 2))
    dense[rows, cols] = vals
    np.testing.assert_array_equal(dense, [[0, -3], [3, 0]])


def test_duplicates_summed(tmp_path):
    p = tmp_path / "dup.mtx"
    p.write_text(DUP)
    rows, cols, vals, _ = mtx.load_mtx(str(p))
    assert len(vals) == 2
    np.testing.assert_allclose(sorted(vals), [3.0, 5.0])


@pytest.mark.parametrize("text,match", [
    ("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
     "coordinate"),
    ("not a header\n", "MatrixMarket"),
    ("%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
     "field"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n",
     "promises"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",
     "outside")])
def test_rejects_what_the_reference_rejects(tmp_path, text, match):
    p = tmp_path / "bad.mtx"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        mtx.load_mtx(str(p))
    with pytest.raises(ValueError, match=match):
        jmtx.load_mtx(str(p))


def test_loader_feeds_the_api():
    rows, cols, vals, (m, n) = mtx.load_mtx(FIXTURE)
    prob = api.make_problem(rows, cols, vals, (m, n), 8, devices=[CPU] * 4)
    Sd = np.zeros((m, n), np.float32)
    Sd[rows, cols] = vals
    Y = np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32)
    np.testing.assert_allclose(api.gathered(prob.spmm(Y)).numpy(), Sd @ Y,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seq,block,w,g", [(256, 32, 2, 1), (512, 16, 4, 2),
                                           (64, 64, 1, 1), (96, 8, 5, 3)])
def test_block_sparse_mask_equals_reference(seq, block, w, g):
    got = sparse.block_sparse_mask(seq, block, w, g)
    want = jsparse.block_sparse_mask(seq, block, w, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
