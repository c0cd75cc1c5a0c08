"""The port's support-pruned communication (comm="sparse", and its
compress="bf16" wire) against the reference's, on the problem and grids
of tests/dist_scripts/check_comm_sparse.py.

The reference runs once in a subprocess with 8 forced host devices (this
file run as a script) and dumps, for each family and grid, its plans'
``SparseMeta`` and support arrays and the comm="sparse" (and bf16)
outputs of each op and cell through its api; it counts no wire words
(the compiled program's count is where that script fails: the replay
round of the "none" cell is dropped from it).  Here the port must give:

* the same ``SparseMeta`` flags and widths and element-equal support
  arrays, plan by plan;
* outputs equal to its own comm="dense" outputs bit for bit and to the
  reference's within tests/test_kernels.py's tolerances;
* a collective log equal to its dense log plus the plan's delta,
  computed from ``SparseMeta`` alone (the "none" replay round included),
  and with bf16 half the pruned words;
* Session-cached == uncached and overlap == serial bit for bit; the
  gradients of a sparse problem equal the dense problem's bit for bit;
* on 4 gloo ranks (this file run as a script, one process a rank) each
  rank's blocks and log equal to the stacked run;
* on the power-law problem through make_problem at "auto"'s family and
  c: comm="auto" resolving to "sparse", strictly fewer logged words than
  dense and the same bits.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_spawn import join, save, spawn  # noqa: E402


def _chip_smoke():
    """chip_smoke.py as a module: its ``pruned_words`` is the one model of
    the pruned words (from SparseMeta alone) that both hold logs to."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()

M = N = 512
R, P, NNZ_ROW, SEED = 64, 8, 2, 0
TILE = dict(row_tile=32, nz_block=32)
#: the (family, c) grids of check_comm_sparse.py at p = 8
CASES = [("d15", 2), ("d15", 4), ("s15", 2), ("d25", 2), ("s25", 2)]
CELLS = {"d15": ("none", "reuse", "fused"), "s15": ("none", "reuse", "fused"),
         "d25": ("none", "reuse", "fused"), "s25": ("none", "reuse")}
#: the 4-rank worlds: (family, c) each, one cell under comm="sparse" and
#: one under compress="bf16"
WORLD = 4
DIST_CASES = [("d15", 2), ("s15", 2), ("d25", 1), ("s25", 1)]
PL_SCALE, PL_EDGES, PL_SEED = 9, 8, 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its ops are small, and beside
    the other test workers' default thread pools (one per core each)
    they crawl."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(family):
    return ["sddmm", "spmm", "spmm_t"] + [f"fusedmm/{el}"
                                          for el in CELLS[family]]


OP_CASES = [(f, c, op) for f, c in CASES for op in _ops(f)]


def _plans(prob):
    """(name, plan) of every plan the api's calls use: S's own packs and
    the transposed problem's pack of spmm_t."""
    if prob.alg.name in ("d15", "d25"):
        return [("normal", prob.plan("normal")),
                ("transpose", prob.plan("transpose")),
                ("spmm_t", prob.transposed().plan("transpose"))]
    return [("normal", prob.plan("normal")),
            ("spmm_t", prob.transposed().plan("normal"))]


def _run_op(prob, op, X, Y):
    """The op's results as numpy arrays: sampled values in host COO
    order, dense outputs as (m, r) / (n, r)."""
    if op == "sddmm":
        return [prob.sddmm(X, Y).values()]
    if op == "spmm":
        return [np.asarray(prob.spmm(Y))]
    if op == "spmm_t":
        return [np.asarray(prob.spmm_t(X))]
    out, Rr = prob.fusedmm(X, Y, elision=op.split("/")[1])
    return [np.asarray(out), Rr.values()]


META_FIELDS = ("gather", "gather_b", "shift", "shift_b", "wg", "wg_b", "ws",
               "ws_b", "compress")


def _meta(sm):
    return [list(v) if isinstance(v, tuple) else v
            for v in (getattr(sm, f) for f in META_FIELDS)]


def _sup_arrays(sup):
    """{index path: array} of a plan's nested support tuple."""
    out = {}
    for i, chan in enumerate(sup):
        for j, a in enumerate(chan):
            out[f"{i}/{j}"] = np.asarray(a)
    return out


# ---------------------------------------------------------------------------
# the reference, in a subprocess
# ---------------------------------------------------------------------------

def _reference(out_path):
    """Subprocess body: the reference's api on 8 forced host devices with
    its plain kernels (tests/test_kernels.py holds them to Pallas)."""
    import json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.core import api, costmodel, sparse
    from repro.kernels import ops

    assert len(jax.devices()) == 8
    ops.set_default_backend("ref")
    rows, cols, vals, X, Y = sparse.random_problem(M, N, R, NNZ_ROW,
                                                   seed=SEED)
    res, metas = {}, {}
    for fam, c in CASES:
        for compress in (None, "bf16"):
            prob = api.make_problem(rows, cols, vals, (M, N), R,
                                    algorithm=fam, c=c, comm="sparse",
                                    compress=compress,
                                    devices=jax.devices()[:P], **TILE)
            tag = f"{fam}_{c}" + ("/bf16" if compress else "")
            if compress is None:
                for name, pl in _plans(prob):
                    metas[f"{tag}/{name}"] = _meta(pl.smeta)
                    for k, a in _sup_arrays(pl.sup).items():
                        res[f"{tag}/{name}/sup/{k}"] = a
            ops_ = _ops(fam) if compress is None else \
                [op for op in _ops(fam) if op.startswith("fusedmm")]
            for op in ops_:
                for i, a in enumerate(_run_op(prob, op, X, Y)):
                    res[f"{tag}/{op}/{i}"] = a
    prows, pcols, pvals, PX, PY = sparse.powerlaw_problem(
        PL_SCALE, R, edge_factor=PL_EDGES, seed=PL_SEED)
    pm = 1 << PL_SCALE
    choice = costmodel.choose_algorithm(m=pm, n=pm, nnz=len(pvals), r=R,
                                        p=P)
    prob = api.make_problem(prows, pcols, pvals, (pm, pm), R,
                            algorithm=choice.family, c=choice.c,
                            comm="auto", devices=jax.devices()[:P])
    el = prob.resolve_elision("auto")
    out, Rr = prob.fusedmm(PX, PY, elision=el)
    res["powerlaw/out"], res["powerlaw/R"] = np.asarray(out), Rr.values()
    metas["powerlaw"] = [prob.alg.name, prob.c, el, prob.comm]
    res["metas"] = np.array(json.dumps(metas))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json
    import subprocess
    path = str(tmp_path_factory.mktemp("comm_sparse") / "reference.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, __file__, "reference", path],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    data = np.load(path)
    out = {k: data[k] for k in data.files}
    out["metas"] = json.loads(str(out["metas"]))
    return out


# ---------------------------------------------------------------------------
# the port, stacked on the CPU
# ---------------------------------------------------------------------------

_PROBLEMS = {}


def _data():
    from repro_torch.core import sparse
    return sparse.random_problem(M, N, R, NNZ_ROW, seed=SEED)


def _problem(fam, c, comm="dense", compress=None, p=P, **kw):
    """The stacked CPU problem of a case (cached: its plans are packed
    once for the module)."""
    import torch
    from repro_torch.core import api
    key = (fam, c, comm, compress, p)
    if key not in _PROBLEMS:
        rows, cols, vals, _, _ = _data()
        _PROBLEMS[key] = api.make_problem(
            rows, cols, vals, (M, N), R, algorithm=fam, c=c, comm=comm,
            compress=compress, devices=[torch.device("cpu")] * p, **TILE)
    return _PROBLEMS[key]


def _total(prob):
    return sum(w for _, w in prob.last_collectives.words())


@pytest.mark.parametrize("fam,c", CASES)
def test_sparse_meta_and_supports_match_reference(reference, fam, c):
    """Every plan's SparseMeta (flags and widths) and support arrays
    equal the reference's, element for element."""
    prob = _problem(fam, c, "sparse")
    pruned = 0
    for name, pl in _plans(prob):
        tag = f"{fam}_{c}/{name}"
        assert _meta(pl.smeta) == reference["metas"][tag], tag
        mine = _sup_arrays(pl.sup)
        want = {k[len(tag) + 5:]: v for k, v in reference.items()
                if k.startswith(tag + "/sup/")}
        assert sorted(mine) == sorted(want), tag
        for k, a in mine.items():
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, want[k], err_msg=f"{tag} {k}")
        pruned += sum(getattr(pl.smeta, f) for f in META_FIELDS[:4])
    assert pruned, f"{fam} c={c}: no channel pruned"


@pytest.mark.parametrize("fam,c,op", OP_CASES)
def test_sparse_equals_dense_and_reference(reference, fam, c, op):
    """comm="sparse" == comm="dense" bit for bit, the reference's
    comm="sparse" within tests/test_kernels.py's tolerances, and the log
    == the dense log + the plan's delta, exactly."""
    _, _, _, X, Y = _data()
    dense, sparse_ = _problem(fam, c), _problem(fam, c, "sparse")
    want = _run_op(dense, op, X, Y)
    w_dense = _total(dense)
    got = _run_op(sparse_, op, X, Y)
    w_sparse = _total(sparse_)
    tol = 2e-3 if op.startswith("fusedmm") else 2e-4
    for i, (g, d) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, d, err_msg=f"{op} [{i}]")
        np.testing.assert_allclose(g, reference[f"{fam}_{c}/{op}/{i}"],
                                   rtol=tol, atol=tol, err_msg=op)
    pruned, dense_w = chip_smoke.pruned_words(sparse_, op)
    assert w_sparse == w_dense + pruned - dense_w, (w_sparse, w_dense,
                                                    pruned, dense_w)


@pytest.mark.parametrize("fam,c", CASES)
def test_bf16_wire_matches_reference_and_halves_pruned_words(reference,
                                                             fam, c):
    """compress="bf16": every FusedMM cell within the cross-framework
    tolerance of the reference's compress="bf16" output (both round the
    same shipped rows), near the exact result, and logging half the
    pruned words."""
    _, _, _, X, Y = _data()
    dense, bf16 = _problem(fam, c), _problem(fam, c, "sparse", "bf16")
    for el in CELLS[fam]:
        op = f"fusedmm/{el}"
        exact = _run_op(dense, op, X, Y)
        w_dense = _total(dense)
        got = _run_op(bf16, op, X, Y)
        for i, (g, e) in enumerate(zip(got, exact)):
            np.testing.assert_allclose(
                g, reference[f"{fam}_{c}/bf16/{op}/{i}"], rtol=2e-3,
                atol=2e-3, err_msg=op)
            scale = np.abs(e).max()
            assert np.abs(g - e).max() <= 2e-2 * scale, op
        pruned, dense_w = chip_smoke.pruned_words(bf16, op)
        assert _total(bf16) == w_dense + pruned / 2 - dense_w, op


def test_bf16_rounds_the_shipped_rows_only():
    """A pruned gather and a pruned permute under bf16: the receiver's
    own rows arrive unrounded, the shipped rows bf16-rounded, rows
    outside the support zero; and each permute logs half its float32
    words."""
    import torch
    from repro_torch.core import common
    from repro_torch.core.collectives import Stacked
    prob = _problem("d15", 2, "sparse", "bf16")
    plan, grid = prob.plan("normal"), prob.grid
    X = torch.from_numpy(_data()[3]) + 1.0 / 3.0     # not bf16-exact
    A = grid.stack(X)
    coll = Stacked(grid)
    send, recv = plan.sup[:2]
    T = common.pruned_gather_rows(coll, A, send, recv, compress="bf16")
    mA, r = A.shape[2], A.shape[3]
    rounded = X.to(torch.bfloat16).float()
    for u, v in grid.ranks():
        got = T[u, v]
        lo = (u * grid.c + v) * mA
        assert torch.equal(got[v * mA:(v + 1) * mA], X[lo:lo + mA])
        rows = recv[0][u, v]
        rows = rows[rows < grid.c * mA].long()
        base = u * grid.c * mA
        assert torch.equal(got[rows], rounded[base + rows])
        assert not torch.equal(got[rows], X[base + rows])
        others = torch.ones(grid.c * mA, dtype=torch.bool)
        others[v * mA:(v + 1) * mA] = False
        others[rows] = False
        assert not bool(got[others].any())
    (ev,) = coll.log
    assert ev.kind == "collective-permute"
    assert ev.words == plan.smeta.wg * r / 2
    # a pruned B chunk: every row it carries was shipped, so rounded
    _, _, ssend, srecv = plan.sup
    B = grid.stack(torch.from_numpy(_data()[4]) + 1.0 / 3.0)
    chunk = common.pruned_permute(coll, B, ssend[0], srecv[0], "layer", 1,
                                  plan.nB, compress="bf16")
    want = common.pruned_permute(Stacked(grid), B.to(torch.bfloat16).float(),
                                 ssend[0], srecv[0], "layer", 1, plan.nB)
    assert torch.equal(chunk, want)
    assert coll.log[-1].words == plan.smeta.ws[0] * r / 2


@pytest.mark.parametrize("fam,c", CASES)
def test_session_and_overlap_bitwise_under_sparse(fam, c):
    """A Session-cached call equals the uncached one, and the d15/d25
    executors' overlapped schedules equal their serial ones (outputs and
    logs), bit for bit, on comm="sparse" plans."""
    import torch
    from repro_torch.core import api, d15, d25
    from repro_torch.core.collectives import Stacked
    _, _, _, X, Y = _data()
    prob = _problem(fam, c, "sparse")
    sess = api.Session()
    for el in CELLS[fam]:
        base, Rb = prob.fusedmm(X, Y, elision=el)
        for _ in range(2):
            got, Rg = prob.fusedmm(X, Y, elision=el, session=sess)
            assert torch.equal(base, got), el
            np.testing.assert_array_equal(Rb.values(), Rg.values())
    assert (sess.stats()["hits"] > 0) == (fam != "s25")
    if fam not in ("d15", "d25"):
        return
    g = prob.grid
    Xd, Yd = torch.from_numpy(X), torch.from_numpy(Y)
    plan, plant = prob.plan("normal"), prob.plan("transpose")
    planb = prob.transposed().plan("transpose")
    if fam == "d15":
        mod, A, B = d15, g.stack(Xd), g.stack(Yd)
        Ay, Bx = B, A
    else:
        mod = d25
        A, B = prob.alg.shard_x(prob, Xd), d25.skew_b(g, Yd)
        Ay, Bx = prob.alg.shard_x(prob, Yd), d25.skew_b(g, Xd)
    runs = [("sddmm", lambda **k: getattr(mod, f"sddmm_{fam}")(
                g, plan, A, B, **k)),
            ("spmma", lambda **k: getattr(mod, f"spmma_{fam}")(
                g, plan, B, **k)),
            ("spmmb", lambda **k: getattr(mod, f"spmmb_{fam}")(
                g, planb, A, **k))]
    for el, pl, a, b in (("none", plan, A, B), ("reuse", plant, Ay, Bx),
                         ("fused", plan, A, B)):
        runs.append((el, lambda el=el, pl=pl, a=a, b=b, **k: getattr(
            mod, f"fusedmm_{fam}")(g, pl, a, b, elision=el, **k)))
    for what, run in runs:
        outs, logs = [], []
        for ov in (True, False):
            coll = Stacked(g)
            res = run(overlap=ov, coll=coll)
            outs.append(_leaves(res))
            logs.append(coll.words())
        for x, y in zip(*outs):
            assert torch.equal(x, y), what
        assert logs[0] == logs[1], what


def _leaves(res):
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _leaves(r)]
    return [res]


@pytest.mark.parametrize("fam,c", [("d15", 2), ("s15", 2), ("d25", 2),
                                   ("s25", 2)])
def test_grads_sparse_equal_dense_bitwise(fam, c):
    """grads.fusedmm (every cell) and grads.spmm on a comm="sparse"
    problem give the dense problem's gradients bit for bit."""
    import torch
    from repro_torch.core import grads
    rows, cols, vals, X, Y = _data()
    dense, sparse_ = _problem(fam, c), _problem(fam, c, "sparse")

    def fused(prob, el):
        Xl = torch.from_numpy(X).requires_grad_()
        Yl = torch.from_numpy(Y).requires_grad_()
        out = grads.fusedmm(prob, Xl, Yl, elision=el)
        return torch.autograd.grad((out * out).sum(), (Xl, Yl))

    def spmm(prob):
        v = torch.from_numpy(vals).requires_grad_()
        Yl = torch.from_numpy(Y).requires_grad_()
        out = grads.spmm(prob, v, Yl)
        return torch.autograd.grad((out * out).sum(), (v, Yl))

    for el in CELLS[fam]:
        for a, b in zip(fused(dense, el), fused(sparse_, el)):
            assert torch.equal(a, b), el
    for a, b in zip(spmm(dense), spmm(sparse_)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fam,c", CASES)
def test_converted_reference_plan_keeps_supports(reference, fam, c):
    """convert.plan_*_from_numpy carries a reference plan's support sets
    and SparseMeta across: the port's own plan's, array for array, and
    the same bits from the executor (the "none" cell, both rounds)."""
    import dataclasses
    import types
    import torch
    from repro_torch import convert
    prob = _problem(fam, c, "sparse")
    own = prob.plan("normal")
    tag = f"{fam}_{c}/normal"
    sup = tuple(tuple(reference[f"{tag}/sup/{i}/{j}"]
                      for j in range(len(own.sup[i])))
                for i in range(len(own.sup)))
    ref_plan = types.SimpleNamespace(
        **{f.name: getattr(own, f.name) for f in dataclasses.fields(own)})
    ref_plan.sup = sup
    ref_plan.smeta = types.SimpleNamespace(
        **dict(zip(META_FIELDS, reference["metas"][tag])))
    conv = getattr(convert, f"plan_{fam}_from_numpy")(ref_plan, prob.grid)
    assert conv.smeta == own.smeta
    mine, want = _sup_arrays(conv.sup), _sup_arrays(own.sup)
    assert sorted(mine) == sorted(want)
    for k in mine:
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
    _, _, _, X, Y = _data()
    fn, args, kwargs, _ = prob.alg._fusedmm_call(prob, X, Y, "none", None)
    assert args[1] is own
    got = _leaves(fn(args[0], conv, *args[2:], **kwargs))
    for a, b in zip(got, _leaves(fn(*args, **kwargs))):
        assert torch.equal(a, b)


def test_powerlaw_auto_ships_fewer_words(reference):
    """check_comm_sparse.py's power-law section: at "auto"'s family and
    c, comm="auto" resolves to "sparse", ships strictly fewer logged
    words than comm="dense", with the same bits, and the reference's
    output within tolerance."""
    import torch
    from repro_torch.core import api, costmodel, sparse
    prows, pcols, pvals, PX, PY = sparse.powerlaw_problem(
        PL_SCALE, R, edge_factor=PL_EDGES, seed=PL_SEED)
    pm = 1 << PL_SCALE
    assert costmodel.choose_comm(prows, pcols, pm, pm) == "sparse"
    choice = costmodel.choose_algorithm(m=pm, n=pm, nnz=len(pvals), r=R,
                                        p=P)
    kw = dict(algorithm=choice.family, c=choice.c,
              devices=[torch.device("cpu")] * P)
    prob_d = api.make_problem(prows, pcols, pvals, (pm, pm), R, **kw)
    prob_s = api.make_problem(prows, pcols, pvals, (pm, pm), R,
                              comm="auto", **kw)
    assert prob_s.comm == "sparse"
    el = prob_d.resolve_elision("auto")
    assert [prob_s.alg.name, prob_s.c, el, prob_s.comm] == \
        reference["metas"]["powerlaw"]
    out_d, R_d = prob_d.fusedmm(PX, PY, elision=el)
    w_dense = _total(prob_d)
    out_s, R_s = prob_s.fusedmm(PX, PY, elision=el)
    w_sparse = _total(prob_s)
    assert torch.equal(out_d, out_s)
    np.testing.assert_array_equal(R_d.values(), R_s.values())
    assert w_sparse < w_dense, (w_sparse, w_dense)
    assert prob_s.schedule_words("fusedmm", el) is None
    np.testing.assert_allclose(out_s.numpy(), reference["powerlaw/out"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(R_s.values(), reference["powerlaw/R"],
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------

def _dist_ops(fam):
    el = "reuse" if fam == "s25" else "fused"
    return [("sparse", None, "sddmm"), ("sparse", None, f"fusedmm/{el}"),
            ("bf16", "bf16", f"fusedmm/{el}")]


def _call(prob, op, X, Y):
    alg = prob.alg
    if op == "sddmm":
        return alg._sddmm_call(prob, X, Y, None)
    return alg._fusedmm_call(prob, X, Y, op.split("/")[1], None)


def _worker(rank, world, init, out_dir):
    import torch
    dist = join(rank, world, init)
    from repro_torch.core import api
    from repro_torch.core.collectives import Dist
    rows, cols, vals, X, Y = _data()
    arrays, logs = {}, {}
    try:
        for fam, c in DIST_CASES:
            for comm, compress, op in _dist_ops(fam):
                prob = api.make_problem(
                    rows, cols, vals, (M, N), R, algorithm=fam, c=c,
                    comm="sparse", compress=compress,
                    devices=[torch.device("cpu")] * world,
                    group=dist.group.WORLD, **TILE)
                fn, args, kwargs, _ = _call(prob, op, X, Y)
                coll = Dist(prob.grid)
                tag = f"{fam}/{comm}/{op}"
                for i, t in enumerate(_leaves(fn(*args, **kwargs,
                                                 coll=coll))):
                    arrays[f"{tag}/{i}"] = t.numpy()
                logs[tag] = coll.words()
    finally:
        dist.destroy_process_group()
    save(out_dir, rank, arrays, logs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(__file__, WORLD, str(tmp_path_factory.mktemp("dist")))


@pytest.mark.parametrize("fam,c", DIST_CASES)
def test_gloo_ranks_equal_stacked_bitwise(ranks, fam, c):
    """Each rank's blocks and log == the stacked run's, bit for bit, for
    one cell per family under comm="sparse" and one under bf16."""
    from repro_torch.core.collectives import Stacked
    _, _, _, X, Y = _data()
    for comm, compress, op in _dist_ops(fam):
        prob = _problem(fam, c, "sparse", compress, p=WORLD)
        sm = chip_smoke.plan_of(prob, op).smeta
        assert any(getattr(sm, f) for f in META_FIELDS[:4]), (fam, op)
        fn, args, kwargs, _ = _call(prob, op, X, Y)
        coll = Stacked(prob.grid)
        want = [t.contiguous().numpy()
                for t in _leaves(fn(*args, **kwargs, coll=coll))]
        tag = f"{fam}/{comm}/{op}"
        nd = prob.grid.ndim
        for rank, (got, logs) in enumerate(ranks):
            at = tuple(int(i) for i in np.unravel_index(rank,
                                                        prob.grid.shape))
            for i, w in enumerate(want):
                g = got[f"{tag}/{i}"]
                assert g.shape == (1,) * nd + w.shape[nd:]
                np.testing.assert_array_equal(g[(0,) * nd], w[at],
                                              err_msg=f"{tag} rank {rank}")
            assert [tuple(e) for e in logs[tag]] == coll.words(), tag


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5])
    elif sys.argv[1] == "reference":
        _reference(sys.argv[2])
