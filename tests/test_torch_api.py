"""The port's distributed api (after tests/test_api.py) on stacked CPU
ranks: the registry of all four families, algorithm="auto" choosing what
the reference's make_problem chooses (the reference runs in a subprocess
with 8 forced host devices, this file run as a script), Sessions and
spmm_t per family, plus the port's boundaries: the card is the default
device, and nothing in the port imports jax or the reference package.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from repro.core import api as japi
from repro_torch.core import api, costmodel, d15, sparse
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

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


def test_registry_holds_the_four_families():
    assert set(api.ALGORITHMS) == {"d15", "s15", "d25", "s25"}
    assert set(api.ALGORITHMS) == set(japi.ALGORITHMS)
    cells = set(costmodel.FAMILY_ELISION.values())
    for name, alg in api.ALGORITHMS.items():
        ref = japi.ALGORITHMS[name]
        assert alg.elisions == ref.elisions, name
        assert alg.auto_elisions == ref.auto_elisions, name
        assert all((name, el) in cells for el in alg.elisions)
    rows, cols, vals, *_ = _problem_data()
    with pytest.raises(ValueError, match="unknown algorithm"):
        _make(rows, cols, vals, (64, 64), 8, algorithm="nope")
    for name in api.ALGORITHMS:
        prob = _make(rows, cols, vals, (64, 64), 8, p=4, algorithm=name)
        assert prob.alg.name == name
        want = costmodel.choose_algorithm(m=64, n=64, nnz=len(vals), r=8,
                                          p=4, families=(name,))
        assert prob.c == want.c


# (m = n, nonzeros, r, p): low and high phi = nnz / (n r), r = 32 and
# 128; then sizes p does not divide, where only the 2.5D grids are
# feasible, so the choice is between d25 and s25
AUTO_CASES = ([(1 << 14, nnz, r, p) for nnz in (1 << 12, 1 << 16, 1 << 20)
               for r in (32, 128) for p in (1, 4, 8)]
              + [(16388, nnz, r, 8) for nnz in (1 << 12, 1 << 20)
                 for r in (32, 128)]
              + [(16386, nnz, 64, 4) for nnz in (1 << 12, 1 << 20)])


FAMILIES = ("d15", "s15", "d25", "s25")


def _family_elisions(make, session):
    """Per AUTO_CASES entry and family: (c, resolve_elision("auto"),
    resolve_elision("auto", Session())) of ``make(..., algorithm=family)``,
    or None where the family is infeasible there."""
    out = []
    for m, nnz, r, p in AUTO_CASES:
        z = np.zeros(nnz, np.int32)
        row = []
        for fam in FAMILIES:
            try:
                prob = make(z, z, np.ones(nnz, np.float32), (m, m), r, p,
                            algorithm=fam)
            except ValueError:
                row.append(None)
                continue
            row.append([prob.c, prob.resolve_elision("auto"),
                        prob.resolve_elision("auto", session())])
        out.append(row)
    return out


def _auto_choices():
    """Subprocess body: the reference's make_problem on 8 forced host
    devices: algorithm="auto"'s (family, elision, c) per AUTO_CASES
    entry, and each family's c and "auto" elisions (_family_elisions)."""
    def make(rows, cols, vals, shape, r, p, **kw):
        return japi.make_problem(rows, cols, vals, shape, r,
                                 devices=jax.devices()[:p], **kw)

    out = []
    for m, nnz, r, p in AUTO_CASES:
        z = np.zeros(nnz, np.int32)
        prob = make(z, z, np.ones(nnz, np.float32), (m, m), r, p)
        out.append([prob.alg.name, prob.resolve_elision("auto"), prob.c])
    return {"auto": out, "families": _family_elisions(make, japi.Session)}


@pytest.fixture(scope="module")
def reference_run():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference_choices(reference_run):
    return reference_run["auto"]


@pytest.mark.parametrize("case", range(len(AUTO_CASES)))
def test_auto_choice_matches_reference(reference_choices, case):
    m, nnz, r, p = AUTO_CASES[case]
    z = np.zeros(nnz, np.int32)
    prob = _make(z, z, np.ones(nnz, np.float32), (m, m), r, p=p)
    got = [prob.alg.name, prob.resolve_elision("auto"), prob.c]
    assert got == reference_choices[case], (m, nnz, r, p)


def test_family_auto_elision_matches_reference(reference_run):
    """For every family at every AUTO_CASES point: the c make_problem
    picks and resolve_elision("auto") with and without a Session are the
    reference's (None where the family is infeasible in both)."""
    def make(rows, cols, vals, shape, r, p, **kw):
        return _make(rows, cols, vals, shape, r, p=p, **kw)

    got = _family_elisions(make, api.Session)
    assert got == reference_run["families"]
    assert any(cell is not None and cell[1] != cell[2]
               for row in got for cell in row), "no Session flip covered"


def test_main_path_auto_is_s15_fused():
    """At the paper's Fig. 6 point (m = n = 2^22, 2^26 nonzeros) the
    cost model chooses s15 "fused" at r = 128 and d15 at r = 32, as the
    reference's does."""
    from repro.core import costmodel as jcost
    for r in (32, 128):
        for p in (1, 4, 8):
            kw = dict(m=1 << 22, n=1 << 22, nnz=1 << 26, r=r, p=p)
            got = costmodel.choose_algorithm(**kw)
            want = jcost.choose_algorithm(**kw)
            assert (got.family, got.elision, got.c) == \
                (want.family, want.elision, want.c), (r, p)
            if r == 128:
                assert (got.family, got.elision) == ("s15", "fused")
            if r == 128 and p == 1:
                assert got.c == 1
            if r == 32:
                assert got.family == "d15"


def test_comm_and_device_plumbing():
    rows, cols, vals, *_ = _problem_data(seed=12)
    with pytest.raises(ValueError, match="comm"):
        _make(rows, cols, vals, (64, 64), 8, comm="nope")
    with pytest.raises(ValueError, match="compress"):
        _make(rows, cols, vals, (64, 64), 8, compress="fp4")
    assert _make(rows, cols, vals, (64, 64), 8, comm="sparse").comm == \
        "sparse"
    assert _make(rows, cols, vals, (64, 64), 8, comm="auto").comm == "dense"
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        api.make_problem(rows, cols, vals, (64, 64), 8,
                         devices=[CPU, torch.device("meta")])


def test_comm_mode_plumbing():
    """comm/compress validate, "auto" resolves as the reference's does
    (dense on a uniform matrix, sparse on a skewed one), derived problems
    and their plans keep the wire format, and the Session keys on comm
    (the port's half of tests/test_api.py's test, without meta_dict)."""
    from repro.core import costmodel as jcost
    rows, cols, vals, X, Y, _ = _problem_data(seed=12)
    with pytest.raises(ValueError, match="comm"):
        _make(rows, cols, vals, (64, 64), 8, comm="nope")
    with pytest.raises(ValueError, match="compress"):
        _make(rows, cols, vals, (64, 64), 8, compress="fp4")
    prows, pcols, pvals, *_ = sparse.powerlaw_problem(8, 8, edge_factor=4,
                                                      seed=1)
    for r_, c_, shape in ((rows, cols, (64, 64)), (prows, pcols, (256, 256))):
        auto = _make(r_, c_, np.ones(len(r_), np.float32), shape, 8,
                     comm="auto")
        want = jcost.choose_comm(r_, c_, *shape)
        assert auto.comm == want == japi.make_problem(
            r_, c_, np.ones(len(r_), np.float32), shape, 8, comm="auto",
            devices=jax.devices()[:1]).comm
    assert auto.comm == "sparse"
    prob = _make(rows, cols, vals, (64, 64), 8, p=4, algorithm="d15", c=2,
                 comm="sparse", compress="bf16")
    for derived in (prob.transposed(), prob.with_values(vals * 2),
                    prob.with_r(4), prob.ones()):
        assert (derived.comm, derived.compress) == ("sparse", "bf16")
        assert derived.plan("normal").smeta.compress == "bf16"
    assert prob.injected_plan("normal", vals * 2).smeta == \
        prob.plan("normal").smeta
    assert prob.schedule_words("fusedmm", "fused") is None
    # sessions key on comm: the same operand under each mode is two
    # entries, and the second call under one of them a hit
    dense = _make(rows, cols, vals, (64, 64), 8, p=4, algorithm="d15", c=2)
    sess = api.Session()
    sess.replicate(dense, X, "x")
    sess.replicate(prob, X, "x")
    assert sess.stats() == dict(hits=0, misses=2, entries=2, capacity=16)
    sess.replicate(prob, X, "x")
    assert sess.stats()["hits"] == 1


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


@pytest.mark.parametrize("el,comm", [
    pytest.param(el, comm, id=el if comm == "dense" else f"{el}-{comm}")
    for comm in ("dense", "sparse") for el in CELLS])
def test_fusedmm_cells_vs_reference_api(el, comm):
    """Every cell against the dense oracle and against the reference's
    api on one host device (Pallas in interpret mode), under each wire
    format."""
    rows, cols, vals, X, Y, Sd = _problem_data()
    prob = _make(rows, cols, vals, Sd.shape, 8, algorithm="d15", comm=comm)
    jprob = japi.make_problem(rows, cols, vals, Sd.shape, 8,
                              algorithm="d15", comm=comm,
                              devices=jax.devices()[:1])
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


FAMILY_CELLS = [(f, el) for f in ("s15", "d25")
                for el in api.ALGORITHMS[f].elisions]


@pytest.mark.parametrize("family,el", FAMILY_CELLS)
def test_family_session_caching_bitwise(family, el):
    rows, cols, vals, X, Y, _ = _problem_data(seed=2)
    prob = _make(rows, cols, vals, (64, 64), 8, p=8, algorithm=family,
                 c=2)
    sess = api.Session()
    base, Rb = prob.fusedmm(X, Y, elision=el)
    one, _ = prob.fusedmm(X, Y, elision=el, session=sess)
    two, R2 = prob.fusedmm(X, Y, elision=el, session=sess)
    assert torch.equal(base, one) and torch.equal(base, two)
    np.testing.assert_array_equal(Rb.values(), R2.values())
    assert sess.stats()["hits"] >= 1
    model = prob.schedule_words("fusedmm", el, session=sess)
    assert [(k, w) for (_, _, k, w) in model if k and w] == \
        [(k, w) for k, w in prob.last_collectives.words() if w]
    base_s = prob.sddmm(X, Y)
    np.testing.assert_array_equal(base_s.values(),
                                  prob.sddmm(X, Y, session=sess).values())


@pytest.mark.parametrize("family", ["d15", "s15", "d25", "s25"])
def test_spmm_t_every_family(family):
    rows, cols, vals, X, Y, Sd = _problem_data(seed=7)
    prob = _make(rows, cols, vals, Sd.shape, 8, p=8, algorithm=family, c=2)
    g = np.random.default_rng(11).standard_normal((64, 8)).astype(
        np.float32)
    np.testing.assert_allclose(_np(prob.spmm_t(g)), Sd.T @ g, rtol=2e-4,
                               atol=2e-4)
    v2 = (np.arange(len(vals)) * 0.01).astype(np.float32)
    S2 = np.zeros(Sd.shape, np.float32)
    S2[rows, cols] = v2
    base = prob.spmm_t(g, vals=v2)
    np.testing.assert_allclose(_np(base), S2.T @ g, rtol=2e-4, atol=2e-4)
    model = prob.schedule_words("spmm_t")
    assert [(k, w) for (_, _, k, w) in model if k and w] == \
        [(k, w) for k, w in prob.last_collectives.words() if w]
    sess = api.Session()
    assert torch.equal(base, prob.spmm_t(g, vals=v2, session=sess))
    assert torch.equal(base, prob.spmm_t(g, vals=v2, session=sess))


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
    for fam in FAMILIES:
        prob = _make(rows, cols, vals, (64, 64), 8, algorithm=fam)
        jprob = japi.make_problem(rows, cols, vals, (64, 64), 8,
                                  algorithm=fam, devices=jax.devices()[:1])
        assert prob.resolve_elision("auto") == jprob.resolve_elision("auto")
        assert prob.resolve_elision("auto", api.Session()) == \
            jprob.resolve_elision("auto", japi.Session()), fam
    prob = _make(rows, cols, vals, (64, 64), 8, algorithm="d15")
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
    """The port's schedule is the reference's, event for event, for
    every family, op and cell the family honours, on 1.5D grids (L, c)
    or 2.5D grids (G, c)."""
    import importlib
    import types
    for fam in FAMILIES:
        mine = importlib.import_module(f"repro_torch.core.{fam}")
        ref = importlib.import_module(f"repro.core.{fam}")
        one_5d = fam in ("d15", "s15")
        shapes = ((1, 1), (4, 2), (2, 4), (8, 1), (1, 8)) if one_5d \
            else ((1, 1), (2, 2), (2, 1), (3, 2))
        for a, c in shapes:
            grid = types.SimpleNamespace(L=a, G=a, c=c,
                                         p=a * c if one_5d else a * a * c)
            for op in ("sddmm", "spmm", "spmm_t"):
                assert mine.schedule_events(grid, op) == \
                    ref.schedule_events(grid, op), (fam, a, c, op)
            for el in api.ALGORITHMS[fam].elisions:
                assert mine.schedule_events(grid, "fusedmm", el) == \
                    ref.schedule_events(grid, "fusedmm", el), (fam, a, c, el)


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


if __name__ == "__main__":
    print(json.dumps(_auto_choices()))
