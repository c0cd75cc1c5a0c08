"""The port's distributed api, d15 slice (the d15 subset of
tests/test_api.py), on stacked CPU ranks, plus the port's boundaries:
the card is the default device, and nothing in the port imports jax or
the reference package.
"""
import ast
import pathlib

import numpy as np
import pytest
import jax
import torch

from repro.core import api as japi
from repro_torch.core import api, costmodel, d15, sparse

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CELLS = ("none", "reuse", "fused")


def _problem_data(m=64, n=64, r=8, k=4, seed=0):
    rows, cols, vals, X, Y = sparse.random_problem(m, n, r, k, seed=seed)
    Sd = np.zeros((m, n), np.float32)
    Sd[rows, cols] = vals
    return rows, cols, vals, X, Y, Sd


def _make(rows, cols, vals, shape, r, p=1, **kw):
    return api.make_problem(rows, cols, vals, shape, r,
                            devices=[CPU] * p, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_registry_is_the_d15_slice():
    assert set(api.ALGORITHMS) == {"d15"}
    alg = api.ALGORITHMS["d15"]
    assert alg.elisions == CELLS and set(alg.auto_elisions) <= set(CELLS)
    cells = set(costmodel.FAMILY_ELISION.values())
    assert all(("d15", el) in cells for el in alg.elisions)
    rows, cols, vals, *_ = _problem_data()
    with pytest.raises(NotImplementedError, match="s15"):
        _make(rows, cols, vals, (64, 64), 8, algorithm="s15")
    with pytest.raises(ValueError, match="unknown algorithm"):
        _make(rows, cols, vals, (64, 64), 8, algorithm="nope")
    auto = _make(rows, cols, vals, (64, 64), 8, p=4)
    assert auto.alg.name == "d15"
    want = costmodel.choose_algorithm(m=64, n=64, nnz=len(vals), r=8, p=4,
                                      families=("d15",))
    assert auto.c == want.c


def test_comm_and_device_plumbing():
    rows, cols, vals, *_ = _problem_data(seed=12)
    with pytest.raises(ValueError, match="comm"):
        _make(rows, cols, vals, (64, 64), 8, comm="nope")
    with pytest.raises(ValueError, match="compress"):
        _make(rows, cols, vals, (64, 64), 8, compress="fp4")
    with pytest.raises(NotImplementedError, match="sparse"):
        _make(rows, cols, vals, (64, 64), 8, comm="sparse")
    assert _make(rows, cols, vals, (64, 64), 8, comm="auto").comm == "dense"
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        api.make_problem(rows, cols, vals, (64, 64), 8,
                         devices=[CPU, torch.device("meta")])


def test_make_problem_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    rows, cols, vals, *_ = _problem_data()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_problem(rows, cols, vals, (64, 64), 8, algorithm="d15")


@pytest.mark.parametrize("p", [1, 4])
def test_api_parity_vs_ref(p):
    rows, cols, vals, X, Y, Sd = _problem_data()
    prob = _make(rows, cols, vals, Sd.shape, X.shape[1], p=p,
                 algorithm="d15")
    wantR = Sd * (X @ Y.T)
    np.testing.assert_allclose(prob.sddmm(X, Y).to_dense(), wantR,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(prob.spmm(Y)), Sd @ Y, rtol=2e-4,
                               atol=2e-4)
    out = api.spmm(prob, torch.from_numpy(Y))
    assert out.device == CPU and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), Sd @ Y, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("el", CELLS)
def test_fusedmm_cells_vs_reference_api(el):
    """Every cell against the dense oracle and against the reference's
    api on one host device (Pallas in interpret mode)."""
    rows, cols, vals, X, Y, Sd = _problem_data()
    prob = _make(rows, cols, vals, Sd.shape, 8, algorithm="d15")
    jprob = japi.make_problem(rows, cols, vals, Sd.shape, 8,
                              algorithm="d15", devices=jax.devices()[:1])
    wantR = Sd * (X @ Y.T)
    out, R = api.fusedmm(prob, X, Y, elision=el)
    np.testing.assert_allclose(_np(out), wantR @ Y, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(R.to_dense(), wantR, rtol=2e-3, atol=2e-3)
    jout, jR = jprob.fusedmm(X, Y, elision=el)
    np.testing.assert_allclose(_np(out), jout, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(R.values(), jR.values(), rtol=2e-3,
                               atol=2e-3)
    assert prob.resolve_elision("auto") == jprob.resolve_elision("auto")


@pytest.mark.parametrize("el", CELLS)
def test_session_caching_bitwise(el):
    rows, cols, vals, X, Y, _ = _problem_data(seed=2)
    prob = _make(rows, cols, vals, (64, 64), 8, p=4, algorithm="d15", c=2)
    sess = api.Session()
    base, Rb = prob.fusedmm(X, Y, elision=el)
    one, R1 = prob.fusedmm(X, Y, elision=el, session=sess)
    two, R2 = prob.fusedmm(X, Y, elision=el, session=sess)
    assert torch.equal(base, one) and torch.equal(base, two)
    np.testing.assert_array_equal(Rb.values(), R2.values())
    assert sess.stats()["hits"] >= 1
    # a cached call ships no gather: the log shows it
    model = prob.schedule_words("fusedmm", el, session=sess)
    assert [(k, w) for (_, _, k, w) in model if k and w] == \
        [(k, w) for k, w in prob.last_collectives.words() if w]


def test_sparse_result_values_without_dense():
    rows, cols, vals, X, Y, Sd = _problem_data(seed=5)
    wantR = Sd * (X @ Y.T)
    prob = _make(rows, cols, vals, (64, 64), 8, p=2, algorithm="d15")
    res = prob.sddmm(X, Y)
    np.testing.assert_allclose(res.values(), wantR[rows, cols], rtol=2e-4,
                               atol=2e-4)
    r, c, v = res.to_coo()
    back = np.zeros((64, 64), np.float32)
    np.add.at(back, (r, c), v)
    np.testing.assert_allclose(back, wantR, rtol=2e-4, atol=2e-4)


def test_session_lru_bound_and_content_keys():
    rows, cols, vals, X, Y, _ = _problem_data(seed=6)
    prob = _make(rows, cols, vals, (64, 64), 8, algorithm="d15")
    base, _ = prob.fusedmm(X, Y, elision="reuse")
    sess = api.Session(max_entries=3)
    rng = np.random.default_rng(9)
    for _ in range(8):
        it = rng.standard_normal((64, 8)).astype(np.float32)
        prob.fusedmm(X, it, elision="reuse", session=sess)
    assert len(sess) <= 3
    out, _ = prob.fusedmm(X, Y, elision="reuse", session=sess)
    assert torch.equal(base, out)
    # a copy hits on content; an in-place change re-replicates
    misses = sess.misses
    prob.fusedmm(X.copy(), Y.copy(), elision="reuse", session=sess)
    assert sess.misses == misses
    Ymut = Y.copy()
    prob.fusedmm(X, Ymut, elision="reuse", session=sess)
    Ymut *= 0.5
    got, _ = prob.fusedmm(X, Ymut, elision="reuse", session=sess)
    want, _ = prob.fusedmm(X, Ymut, elision="reuse")
    assert torch.equal(got, want)
    # tensors are keyed by content too, and by their version counter
    T = torch.from_numpy(Y.copy())
    first, _ = prob.fusedmm(X, T, elision="reuse", session=sess)
    T.mul_(2.0)
    got, _ = prob.fusedmm(X, T, elision="reuse", session=sess)
    want, _ = prob.fusedmm(X, T, elision="reuse")
    assert torch.equal(got, want)
    # the cache owns its copies: the mutation did not reach them
    again, _ = prob.fusedmm(X, torch.from_numpy(Y.copy()), elision="reuse",
                            session=sess)
    assert torch.equal(again, first)


def test_session_aware_elision_ranking():
    rows, cols, vals, *_ = _problem_data()
    prob = _make(rows, cols, vals, (64, 64), 8, algorithm="d15")
    assert prob.resolve_elision("auto") == "fused"
    assert prob.resolve_elision("auto", api.Session()) == "fused"
    with pytest.raises(ValueError, match="supports"):
        prob.fusedmm(np.zeros((64, 8)), np.zeros((64, 8)), elision="pure")


def test_spmm_t_parity_and_vals_injection():
    rows, cols, vals, X, Y, Sd = _problem_data(seed=7)
    prob = _make(rows, cols, vals, Sd.shape, 8, p=2, algorithm="d15")
    g = np.random.default_rng(11).standard_normal((64, 8)).astype(
        np.float32)
    np.testing.assert_allclose(_np(prob.spmm_t(g)), Sd.T @ g, rtol=2e-4,
                               atol=2e-4)
    v2 = (np.arange(len(vals)) * 0.01).astype(np.float32)
    S2 = np.zeros(Sd.shape, np.float32)
    S2[rows, cols] = v2
    base = prob.spmm_t(g, vals=v2)
    np.testing.assert_allclose(_np(base), S2.T @ g, rtol=2e-4, atol=2e-4)
    sess = api.Session()
    assert torch.equal(base, prob.spmm_t(g, vals=v2, session=sess))
    assert torch.equal(base, prob.spmm_t(g, vals=v2, session=sess))


def test_injected_values_bitwise_vs_repack():
    rows, cols, vals, X, Y, Sd = _problem_data(seed=9)
    prob = _make(rows, cols, vals, Sd.shape, 8, p=4, algorithm="d15")
    v2 = np.random.default_rng(13).standard_normal(len(vals)).astype(
        np.float32)
    want = prob.with_values(v2).spmm(Y)
    got = prob.spmm(Y, vals=v2)
    assert torch.equal(want, got)
    n_plans = len(prob._plans)
    prob.spmm(Y, vals=v2 * 2.0)
    assert len(prob._plans) == n_plans
    assert prob.transposed() is prob.transposed()
    assert prob.transposed().transposed() is prob


def test_with_values_transposed_and_with_r():
    rows, cols, vals, X, Y, Sd = _problem_data()
    prob = _make(rows, cols, vals, (64, 64), 8, algorithm="d15")
    ones = prob.with_values(np.ones_like(vals))
    np.testing.assert_allclose(_np(ones.spmm(Y)),
                               (Sd != 0).astype(np.float32) @ Y,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(prob.transposed().spmm(X)), Sd.T @ X,
                               rtol=2e-4, atol=2e-4)
    assert prob.with_r(4).r == 4 and prob.with_r(4) is prob.with_r(4)
    assert prob.with_r(8) is prob
    assert api.ALGORITHMS["d15"].min_r_multiple(prob.grid) == 1


def test_schedule_events_match_reference():
    """The port's schedule is the reference's, event for event."""
    from repro.core import d15 as jd15
    import types
    for L, c in ((1, 1), (4, 2), (2, 4)):
        grid = types.SimpleNamespace(L=L, c=c, p=L * c)
        for op in ("sddmm", "spmm", "spmm_t"):
            assert d15.schedule_events(grid, op) == \
                jd15.schedule_events(grid, op)
        for el in CELLS:
            assert d15.schedule_events(grid, "fusedmm", el) == \
                jd15.schedule_events(grid, "fusedmm", el)


# ---------------------------------------------------------------------------
# The port's boundary: no jax, nothing of the reference package
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
