"""The port's d15 family on the stacked CPU mesh vs the reference's d15.

The reference runs in a subprocess that forces 8 host devices before
importing jax (this file run as a script, as tests/test_distributed.py
runs its dist_scripts); it packs and runs every op and elision cell at
p in {1, 2, 4, 8} and every valid c with its plain kernels
(``set_default_backend("ref")``: tests/test_torch_kernels.py holds the
kernels to Pallas) and saves packs, results and modeled words.  Here the
port packs and runs the same problem on ``[cpu] * p`` stacked ranks:
packs element-equal, results within the reference's tolerances,
``schedule_words`` equal, and within the port the bitwise identities
(overlap == serial, "none" == the sddmm-then-spmm sequence) and the
collective log == ``schedule_words``.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

M, N, R, NNZ_ROW, SEED = 256, 320, 64, 5, 0
TILE = dict(row_tile=32, nz_block=32)
GRIDS = [(p, c) for p in (1, 2, 4, 8) for c in (1, 2, 4, 8) if p % c == 0]
CELLS = ("none", "reuse", "fused")
OPS = ("sddmm", "spmm", "spmm_t")
FIELDS = ("rows_local", "cols", "vals", "tile_base")


def _reference(out_path):
    """Subprocess body: the reference's d15 on 8 forced host devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.core import d15, sparse
    from repro.core.grid import make_grid15
    from repro.kernels import ops

    assert len(jax.devices()) == 8
    ops.set_default_backend("ref")
    rows, cols, vals, X, Y = sparse.random_problem(M, N, R, NNZ_ROW,
                                                   seed=SEED)
    res, words = {}, {}
    for p, c in GRIDS:
        grid = make_grid15(c, devices=jax.devices()[:p])
        sh = grid.sharding(("layer", "fiber"))
        A, B = jax.device_put(X, sh), jax.device_put(Y, sh)
        plan = d15.plan_d15(grid, rows, cols, vals, M, N, R, **TILE)
        plant = d15.plan_d15(grid, rows, cols, vals, M, N, R,
                             transpose=True, **TILE)
        # the api's "reuse" pack: S^T's transpose orientation
        planr = d15.plan_d15(grid, cols, rows, vals, N, M, R,
                             transpose=True, **TILE)
        tag = f"{p}_{c}"
        for name, pl in (("plan", plan), ("plant", plant),
                         ("planr", planr)):
            for f in FIELDS:
                for t, a in enumerate(getattr(pl, f)):
                    res[f"{tag}/{name}/{f}/{t}"] = np.asarray(a)
            res[f"{tag}/{name}/tiling"] = np.array(
                [pl.tiling.r_tile, pl.tiling.blocks_per_step])

        def dense_R(pl, rv):
            return pl.meta.block_meta.to_dense(pl.rows_local, pl.cols, rv,
                                               pl.tile_base)

        res[f"{tag}/sddmm"] = dense_R(plan, d15.sddmm_d15(grid, plan, A, B))
        res[f"{tag}/spmm"] = np.asarray(d15.spmma_d15(grid, plan, B))
        res[f"{tag}/spmm_t"] = np.asarray(d15.spmmb_d15(grid, plant, A))
        for el in CELLS:
            # FusedMMA(S, X, Y) = FusedMMB(S^T, Y, X) in the reuse cell
            pl, a, b = (planr, B, A) if el == "reuse" else (plan, A, B)
            out, rv = d15.fusedmm_d15(grid, pl, a, b, elision=el)
            res[f"{tag}/fusedmm/{el}"] = np.asarray(out)
            res[f"{tag}/fusedmm/{el}/R"] = dense_R(pl, rv)
            words[f"{tag}/fusedmm/{el}"] = d15.schedule_words(
                grid, pl, "fusedmm", el)
        for op, pl in (("sddmm", plan), ("spmm", plan), ("spmm_t", plant)):
            words[f"{tag}/{op}"] = d15.schedule_words(grid, pl, op)
    res["words"] = np.array(json.dumps(words))
    np.savez(out_path, **res)


def run_reference(path):
    """This file run as a script: the reference's npz at ``path``."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, __file__, path],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def shared_reference(tmp_path_factory):
    """The reference's arrays, its subprocess run once a test session
    (tests/test_torch_dist.py reads the same file)."""
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_spawn
    path = _torch_spawn.session_file(tmp_path_factory, "d15_reference.npz",
                                     run_reference)
    data = np.load(path)
    return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return shared_reference(tmp_path_factory)


def _port(p, c):
    import torch
    from repro_torch.core import api
    from repro_torch.core import sparse
    rows, cols, vals, X, Y = sparse.random_problem(M, N, R, NNZ_ROW,
                                                   seed=SEED)
    prob = api.make_problem(rows, cols, vals, (M, N), R, algorithm="d15",
                            c=c, devices=[torch.device("cpu")] * p, **TILE)
    return prob, X, Y


def _model(words_list):
    return [(k, float(w)) for (_, _, k, w) in words_list if k and w]


@pytest.mark.parametrize("p,c", GRIDS)
def test_d15_matches_reference(reference, p, c):
    from repro_torch.core import d15
    prob, X, Y = _port(p, c)
    tag = f"{p}_{c}"
    words = json.loads(str(reference["words"]))
    assert (prob.p, prob.c, prob.grid.L) == (p, c, p // c)
    # packs element-equal, tilings equal
    for name, pl in (("plan", prob.plan("normal")),
                     ("plant", prob.transposed().plan("transpose")),
                     ("planr", prob.plan("transpose"))):
        for f in FIELDS:
            for t, a in enumerate(getattr(pl, f)):
                np.testing.assert_array_equal(
                    a.numpy(), reference[f"{tag}/{name}/{f}/{t}"],
                    err_msg=f"{tag} {name} {f} phase {t}")
        assert [pl.tiling.r_tile, pl.tiling.blocks_per_step] == \
            list(reference[f"{tag}/{name}/tiling"])
    # results within the reference's tolerances
    np.testing.assert_allclose(prob.sddmm(X, Y).to_dense(),
                               reference[f"{tag}/sddmm"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(prob.spmm(Y).numpy(),
                               reference[f"{tag}/spmm"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(prob.spmm_t(X).numpy(),
                               reference[f"{tag}/spmm_t"], rtol=2e-4,
                               atol=2e-4)
    for el in CELLS:
        out, Rr = prob.fusedmm(X, Y, elision=el)
        np.testing.assert_allclose(out.numpy(),
                                   reference[f"{tag}/fusedmm/{el}"],
                                   rtol=2e-3, atol=2e-3, err_msg=el)
        np.testing.assert_allclose(Rr.to_dense(),
                                   reference[f"{tag}/fusedmm/{el}/R"],
                                   rtol=2e-3, atol=2e-3, err_msg=el)
        # the port's model equals the reference's, and its log the model
        model = prob.schedule_words("fusedmm", el)
        assert [list(e) for e in model] == words[f"{tag}/fusedmm/{el}"]
        assert _model(model) == [
            (k, w) for k, w in prob.last_collectives.words() if w], el
        assert [e[:2] for e in model] == d15.schedule_events(
            prob.grid, "fusedmm", el)
    for op in OPS:
        getattr(prob, op)(*((X, Y) if op == "sddmm" else
                            (Y,) if op == "spmm" else (X,)))
        model = prob.schedule_words(op)
        assert [list(e) for e in model] == words[f"{tag}/{op}"], op
        assert _model(model) == [
            (k, w) for k, w in prob.last_collectives.words() if w], op


@pytest.mark.parametrize("p,c", [(1, 1), (4, 2), (8, 2), (8, 8)])
def test_overlap_equals_serial_bitwise(p, c):
    import torch
    from repro_torch.core import d15
    prob, X, Y = _port(p, c)
    g = prob.grid
    A, B = g.stack(torch.from_numpy(X)), g.stack(torch.from_numpy(Y))
    plan, plant = prob.plan("normal"), prob.plan("transpose")
    planb = prob.transposed().plan("transpose")
    runs = {
        "sddmm": lambda ov: d15.sddmm_d15(g, plan, A, B, overlap=ov),
        "spmma": lambda ov: (d15.spmma_d15(g, plan, B, overlap=ov),),
        "spmmb": lambda ov: (d15.spmmb_d15(g, planb, A, overlap=ov),),
    }
    for el, pl, a, b in (("none", plan, A, B), ("reuse", plant, B, A),
                         ("fused", plan, A, B)):
        runs[el] = (lambda ov, el=el, pl=pl, a=a, b=b:
                    (lambda o: (o[0],) + o[1])(d15.fusedmm_d15(
                        g, pl, a, b, elision=el, overlap=ov)))
    for what, run in runs.items():
        for a, b in zip(run(True), run(False)):
            assert torch.equal(a, b), what


@pytest.mark.parametrize("p,c", [(2, 2), (8, 2)])
def test_none_equals_sddmm_then_spmm_bitwise(p, c):
    prob, X, Y = _port(p, c)
    R_seq = prob.sddmm(X, Y)
    out_seq = prob.with_values(R_seq.values()).spmm(Y)
    out, Rr = prob.fusedmm(X, Y, elision="none")
    np.testing.assert_array_equal(out.numpy(), out_seq.numpy())
    np.testing.assert_array_equal(Rr.values(), R_seq.values())
    # the reassociating cells stay close
    for el in ("reuse", "fused"):
        o, Rc = prob.fusedmm(X, Y, elision=el)
        np.testing.assert_allclose(o.numpy(), out_seq.numpy(), rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(Rc.values(), R_seq.values(), rtol=2e-3,
                                   atol=2e-3)


def test_converted_reference_plan_runs_bitwise(reference):
    """A reference pack carried across with convert.plan_d15_from_numpy
    gives the port's own plan's results bit for bit."""
    import torch
    from repro_torch import convert
    from repro_torch.core import d15
    p, c = 8, 2
    prob, X, Y = _port(p, c)
    own = prob.plan("normal")
    bm = own.meta.block_meta
    ref_plan = types.SimpleNamespace(
        **{f: tuple(reference[f"{p}_{c}/plan/{f}/{t}"]
                    for t in range(prob.grid.L)) for f in FIELDS},
        m=M, n=N, r=R, row_tile=own.row_tile, transpose=False,
        tiling=types.SimpleNamespace(
            r_tile=int(reference[f"{p}_{c}/plan/tiling"][0]),
            blocks_per_step=int(reference[f"{p}_{c}/plan/tiling"][1])),
        meta=types.SimpleNamespace(cmA=own.cmA, nB=own.nB, block_meta=bm))
    conv = convert.plan_d15_from_numpy(ref_plan, prob.grid)
    g = prob.grid
    A, B = g.stack(torch.from_numpy(X)), g.stack(torch.from_numpy(Y))
    for el in ("none", "fused"):
        o1, r1 = d15.fusedmm_d15(g, own, A, B, elision=el)
        o2, r2 = d15.fusedmm_d15(g, conv, A, B, elision=el)
        assert torch.equal(o1, o2)
        assert all(torch.equal(a, b) for a, b in zip(r1, r2))


if __name__ == "__main__":
    _reference(sys.argv[1])
