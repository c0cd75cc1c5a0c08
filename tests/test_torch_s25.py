"""The port's s25 family on the stacked CPU mesh vs the reference's s25.

The reference runs in a subprocess that forces 8 host devices before
importing jax (this file run as a script); through its api it packs and
runs every op and elision cell on the grids of
tests/dist_scripts/check_s25.py (G x G x c = 2x2x2, 2x2x1, 1x1x2,
1x1x4), with its plain kernels (``set_default_backend("ref")``:
tests/test_torch_kernels.py holds the kernels to Pallas), and saves
packs, results and modeled words.  Here the port does the same on
``[cpu] * p`` stacked ranks: packs element-equal, results within the
reference's tolerances (tests/dist_scripts/check_s25.py), the
``schedule_words`` equal, the collective log equal to them, both cells
bitwise equal to the sddmm-then-spmm sequence, "fused" refused, and a
converted reference plan bitwise equal to the port's own.  The ``cuda``-marked
test runs the stacked p = 8 schedule on the card.
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
GRIDS = [(8, 2), (4, 1), (2, 2), (4, 4)]     # (p, c)
CELLS = ("none", "reuse")
OPS = ("sddmm", "spmm", "spmm_t")
FIELDS = ("rows_local", "cols", "vals", "tile_base")
FAMILY = "s25"
# (name, orientation, on the transposed problem) of the packs compared
PACKS = (("plan", "normal", False), ("plant", "normal", True))


def _reference(out_path):
    """Subprocess body: the reference's api on 8 forced host devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.core import api, sparse
    from repro.kernels import ops

    assert len(jax.devices()) == 8
    ops.set_default_backend("ref")
    rows, cols, vals, X, Y = sparse.random_problem(M, N, R, NNZ_ROW,
                                                   seed=SEED)
    res, words = {}, {}
    for p, c in GRIDS:
        prob = api.make_problem(rows, cols, vals, (M, N), R,
                                algorithm=FAMILY, c=c,
                                devices=jax.devices()[:p], **TILE)
        tag = f"{p}_{c}"
        for name, orient, tp in PACKS:
            pl = (prob.transposed() if tp else prob).plan(orient)
            for f in FIELDS:
                res[f"{tag}/{name}/{f}"] = np.asarray(getattr(pl, f))
            res[f"{tag}/{name}/tiling"] = np.array(
                [pl.tiling.r_tile, pl.tiling.blocks_per_step])
        res[f"{tag}/sddmm"] = prob.sddmm(X, Y).to_dense()
        res[f"{tag}/spmm"] = prob.spmm(Y)
        res[f"{tag}/spmm_t"] = prob.spmm_t(X)
        for el in prob.alg.elisions:
            out, Rr = prob.fusedmm(X, Y, elision=el)
            res[f"{tag}/fusedmm/{el}"] = out
            res[f"{tag}/fusedmm/{el}/R"] = Rr.to_dense()
            words[f"{tag}/fusedmm/{el}"] = prob.schedule_words("fusedmm", el)
        for op in OPS:
            words[f"{tag}/{op}"] = prob.schedule_words(op)
    res["words"] = np.array(json.dumps(words))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp(FAMILY) / "reference.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, __file__, path],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    data = np.load(path)
    return {k: data[k] for k in data.files}


def _port(p, c, device="cpu"):
    import torch
    from repro_torch.core import api, sparse
    rows, cols, vals, X, Y = sparse.random_problem(M, N, R, NNZ_ROW,
                                                   seed=SEED)
    prob = api.make_problem(rows, cols, vals, (M, N), R, algorithm=FAMILY,
                            c=c, devices=[torch.device(device)] * p, **TILE)
    return prob, X, Y


def _logged(prob):
    return [(k, w) for k, w in prob.last_collectives.words() if w]


def _model(words_list):
    return [(k, float(w)) for (_, _, k, w) in words_list if k and w]


@pytest.mark.parametrize("p,c", GRIDS)
def test_s25_matches_reference(reference, p, c):
    from repro_torch.core import s25
    prob, X, Y = _port(p, c)
    tag = f"{p}_{c}"
    words = json.loads(str(reference["words"]))
    assert (prob.p, prob.c, prob.grid.G ** 2 * c) == (p, c, p)
    for name, orient, tp in PACKS:
        pl = (prob.transposed() if tp else prob).plan(orient)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(pl, f).numpy(), reference[f"{tag}/{name}/{f}"],
                err_msg=f"{tag} {name} {f}")
        assert [pl.tiling.r_tile, pl.tiling.blocks_per_step] == \
            list(reference[f"{tag}/{name}/tiling"])
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
        model = prob.schedule_words("fusedmm", el)
        assert [list(e) for e in model] == words[f"{tag}/fusedmm/{el}"]
        assert _model(model) == _logged(prob), el
        assert [e[:2] for e in model] == s25.schedule_events(
            prob.grid, "fusedmm", el)
    for op in OPS:
        getattr(prob, op)(*((X, Y) if op == "sddmm" else
                            (Y,) if op == "spmm" else (X,)))
        model = prob.schedule_words(op)
        assert [list(e) for e in model] == words[f"{tag}/{op}"], op
        assert _model(model) == _logged(prob), op


@pytest.mark.parametrize("p,c", [(8, 2), (4, 1), (4, 4)])
def test_cells_equal_sddmm_then_spmm_bitwise(p, c):
    """Both s25 cells run the unfused kernel sequence ("reuse" replays
    the B chunks instead of shifting them again), so out and R equal the
    sddmm-then-spmm sequence bit for bit
    (tests/dist_scripts/check_elision_parity.py); "fused" is refused."""
    import torch
    prob, X, Y = _port(p, c)
    R_seq = prob.sddmm(X, Y)
    out_seq = prob.with_values(R_seq.values()).spmm(Y)
    for el in CELLS:
        out, Rr = prob.fusedmm(X, Y, elision=el)
        assert torch.equal(out, out_seq), el
        np.testing.assert_array_equal(Rr.values(), R_seq.values())
    with pytest.raises(ValueError, match="supports"):
        prob.fusedmm(X, Y, elision="fused")


def test_converted_reference_plan_runs_bitwise(reference):
    """A reference pack carried across with convert.plan_s25_from_numpy
    gives the port's own plan's results bit for bit."""
    import torch
    from repro_torch import convert
    from repro_torch.core import s25
    p, c = 8, 2
    prob, X, Y = _port(p, c)
    own = prob.plan("normal")
    ref_plan = types.SimpleNamespace(
        **{f: reference[f"{p}_{c}/plan/{f}"] for f in FIELDS},
        m=M, n=N, r=R, row_tile=own.row_tile,
        tiling=types.SimpleNamespace(
            r_tile=int(reference[f"{p}_{c}/plan/tiling"][0]),
            blocks_per_step=int(reference[f"{p}_{c}/plan/tiling"][1])),
        meta=types.SimpleNamespace(mS=own.mS, nS=own.nS, rc=own.rc,
                                   block_meta=own.meta.block_meta))
    conv = convert.plan_s25_from_numpy(ref_plan, prob.grid)
    alg = prob.alg
    A, B = alg.shard_x(prob, X), alg.shard_y(prob, Y)
    for el in CELLS:
        o1, r1 = s25.fusedmm_s25(prob.grid, own, A, B, elision=el)
        o2, r2 = s25.fusedmm_s25(prob.grid, conv, A, B, elision=el)
        assert torch.equal(o1, o2) and torch.equal(r1, r2), el
    with pytest.raises(ValueError, match="ranks"):
        convert.plan_s25_from_numpy(ref_plan, _port(4, 1)[0].grid)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(the kernels build with nvcc at first use)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_stacked_p8_vs_ref(cuda, record_property):
    """p = 8 ranks, c = 2, stacked on the card: every cell against the
    same call on the plain kernels, the kernels' forms recorded."""
    import torch
    from repro_torch.kernels.sddmm import sddmm_cuda
    from repro_torch.kernels.spmm import spmm_cuda
    prob, X, Y = _port(8, 2, device=cuda)
    forms = {}
    for el in CELLS:
        out, Rr = prob.fusedmm(X, Y, elision=el)
        forms[el] = (sddmm_cuda.last_form, spmm_cuda.last_form)
        assert set(forms[el]) <= {"bulk", "load"}, forms
        want, wR = prob.fusedmm(X, Y, elision=el, backend="ref")
        torch.testing.assert_close(out, want, rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(Rr.raw, wR.raw, rtol=2e-3, atol=2e-3)
    record_property("forms", json.dumps(forms))


if __name__ == "__main__":
    _reference(sys.argv[1])
