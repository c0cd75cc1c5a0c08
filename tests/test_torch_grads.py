"""The port's differentiable primitives (core/grads.py) against the
reference's (after tests/test_grads.py, tests/dist_scripts/check_grads.py
and check_grad_costs.py).

The same numpy-seeded inputs go through ``jax.grad`` of the reference's
``repro.core.grads`` on one host device (its kernels in interpret mode)
and through ``torch.autograd`` of the port on stacked CPU ranks.  At
p = 8 stacked the port is held to dense torch autograd, and each
backward's collective log to the schedule of its three dual calls and to
``costmodel.words_fusedmm_bwd`` (check_grad_costs.py's band).  On 4 gloo
ranks (this file run as a script, one process a rank) every rank's
gradients must equal the stacked run's bit for bit.  The device values
path (``SparseResult.values_tensor``) and the device value injection
(``DistProblem.injected_plan``) are held to the host paths bit for bit.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import api as japi
from repro.core import grads as jgrads
from repro_torch.core import api, costmodel, grads, sparse

sys.path.insert(0, os.path.dirname(__file__))
from _torch_spawn import spawn  # noqa: E402
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

CPU = torch.device("cpu")
ELISION_CELLS = sorted((name, el) for name in costmodel.FAMILIES
                       for el in api.ALGORITHMS[name].elisions)
FAMILIES = sorted(costmodel.FAMILIES)


def _data(m=64, n=64, r=8, k=4, seed=0):
    rows, cols, vals, X, Y = sparse.random_problem(m, n, r, k, seed=seed)
    Sd = np.zeros((m, n), np.float32)
    Sd[rows, cols] = vals
    return rows, cols, vals, X, Y, Sd


def _pair(rows, cols, vals, shape, r, name):
    """The port's problem and the reference's, each on one device."""
    prob = api.make_problem(rows, cols, vals, shape, r, algorithm=name,
                            devices=[CPU])
    jprob = japi.make_problem(rows, cols, vals, shape, r, algorithm=name,
                              devices=jax.devices()[:1])
    return prob, jprob


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _fused_grads(prob, X, Y, W, el, session=None):
    Xt, Yt = _leaf(X), _leaf(Y)
    out = grads.fusedmm(prob, Xt, Yt, elision=el, session=session)
    (out * torch.from_numpy(W)).sum().backward()
    return out, Xt.grad, Yt.grad


@pytest.mark.parametrize("name,el", ELISION_CELLS)
def test_fusedmm_grad_matches_reference(name, el):
    rows, cols, vals, X, Y, Sd = _data()
    prob, jprob = _pair(rows, cols, vals, Sd.shape, 8, name)
    W = np.random.default_rng(9).standard_normal((64, 8)).astype(
        np.float32)

    def jloss(X, Y):
        return jnp.sum(jgrads.fusedmm(jprob, X, Y, elision=el) * W)

    jv, (jx, jy) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(X), jnp.asarray(Y))
    out, gx, gy = _fused_grads(prob, X, Y, W, el)
    np.testing.assert_allclose(float((out * torch.from_numpy(W)).sum()),
                               float(jv), rtol=2e-3, atol=2e-3)
    _close(gx, jx)
    _close(gy, jy)


@pytest.mark.parametrize("name", FAMILIES)
def test_sddmm_grad_matches_reference(name):
    rows, cols, vals, X, Y, Sd = _data(seed=1)
    prob, jprob = _pair(rows, cols, vals, Sd.shape, 8, name)
    w = np.random.default_rng(3).standard_normal(len(vals)).astype(
        np.float32)
    jx, jy = jax.grad(lambda X, Y: jnp.sum(jgrads.sddmm(jprob, X, Y) * w),
                      argnums=(0, 1))(jnp.asarray(X), jnp.asarray(Y))
    Xt, Yt = _leaf(X), _leaf(Y)
    (grads.sddmm(prob, Xt, Yt) * torch.from_numpy(w)).sum().backward()
    _close(Xt.grad, jx)
    _close(Yt.grad, jy)


@pytest.mark.parametrize("name", FAMILIES)
def test_spmm_vals_grad_matches_reference(name):
    """The sample values are a differentiable input: their gradient is
    the dual SDDMM on S's pattern."""
    rows, cols, vals, X, Y, Sd = _data(seed=2)
    prob, jprob = _pair(rows, cols, vals, Sd.shape, 8, name)
    W = np.random.default_rng(4).standard_normal((64, 8)).astype(
        np.float32)
    jv, jy = jax.grad(lambda v, Y: jnp.sum(jgrads.spmm(jprob, v, Y) * W),
                      argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(Y))
    vt, Yt = _leaf(vals), _leaf(Y)
    (grads.spmm(prob, vt, Yt) * torch.from_numpy(W)).sum().backward()
    _close(vt.grad, jv)
    _close(Yt.grad, jy)


def test_session_replay_bitwise_and_hits():
    """A Session threaded through both passes changes no bit, and hits
    and misses fall on the same calls as the reference's Session."""
    rows, cols, vals, X, Y, Sd = _data(seed=4)
    prob, jprob = _pair(rows, cols, vals, Sd.shape, 8, "d15")
    W = np.ones((64, 8), np.float32)
    _, px, py = _fused_grads(prob, X, Y, W, "reuse")
    sess, jsess = api.Session(), japi.Session()

    def jgrad(X):
        return jax.grad(lambda X, Y: jnp.sum(jgrads.fusedmm(
            jprob, X, Y, elision="reuse", session=jsess)),
            argnums=(0, 1))(jnp.asarray(X), jnp.asarray(Y))

    _, cx, cy = _fused_grads(prob, X, Y, W, "reuse", session=sess)
    jgrad(X)
    assert torch.equal(px, cx) and torch.equal(py, cy)
    assert (sess.hits, sess.misses) == (jsess.hits, jsess.misses)
    assert sess.hits >= 1
    # step 2: the same stationary Y, a fresh X: Y replays in both passes
    h1 = sess.hits
    _fused_grads(prob, X * 0.5, Y, W, "reuse", session=sess)
    jgrad(X * 0.5)
    assert (sess.hits, sess.misses) == (jsess.hits, jsess.misses)
    assert sess.hits >= h1 + 2


@pytest.mark.parametrize("name", FAMILIES)
def test_two_backwards_give_equal_bits(name):
    rows, cols, vals, X, Y, Sd = _data(seed=3)
    prob = api.make_problem(rows, cols, vals, Sd.shape, 8, algorithm=name,
                            devices=[CPU] * 4)
    W = np.random.default_rng(5).standard_normal((64, 8)).astype(
        np.float32)
    one = _fused_grads(prob, X, Y, W, "auto")
    two = _fused_grads(prob, X, Y, W, "auto")
    for a, b in zip(one, two):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# p = 8 stacked: gradients, Session replay and the backward's wire words
# ---------------------------------------------------------------------------

M8, R8 = 256, 32
P8_CASES = [("d15", 2), ("d15", 4), ("s15", 2), ("d25", 2), ("s25", 2)]


@pytest.fixture(scope="module")
def p8_data():
    rows, cols, vals, X, Y = sparse.random_problem(M8, M8, R8, 5, seed=0)
    Sd = np.zeros((M8, M8), np.float32)
    Sd[rows, cols] = vals
    W = np.random.default_rng(2).standard_normal((M8, R8)).astype(
        np.float32)
    S = torch.from_numpy(Sd)
    Xt, Yt = _leaf(X), _leaf(Y)
    ((S * (Xt @ Yt.T)) @ Yt * torch.from_numpy(W)).sum().backward()
    return rows, cols, vals, X, Y, W, Xt.grad, Yt.grad


def _logged_backward(monkeypatch, prob, X, Y, W, el, session):
    """Gradients of one fusedmm step, and the (executor, words) of each
    executor call its backward made."""
    calls = []
    run = api.Algorithm._run

    def logged(self, p, call, backend):
        out = run(self, p, call, backend)
        calls.append((call[0].__name__, p.last_collectives.words()))
        return out

    Xt, Yt = _leaf(X), _leaf(Y)
    out = grads.fusedmm(prob, Xt, Yt, elision=el, session=session)
    monkeypatch.setattr(api.Algorithm, "_run", logged)
    (out * torch.from_numpy(W)).sum().backward()
    monkeypatch.setattr(api.Algorithm, "_run", run)
    return Xt.grad, Yt.grad, calls


def _nonzero(words):
    return [(k, float(w)) for k, w in words if w]


@pytest.mark.parametrize("name,c", P8_CASES)
def test_p8_grads_and_backward_words(monkeypatch, p8_data, name, c):
    rows, cols, vals, X, Y, W, want_x, want_y = p8_data
    prob = api.make_problem(rows, cols, vals, (M8, M8), R8, algorithm=name,
                            c=c, devices=[CPU] * 8, row_tile=32,
                            nz_block=32)
    assert (prob.p, prob.c) == (8, c)
    for el in prob.alg.elisions:
        totals = {}
        for use in (False, True):
            sess = api.Session() if use else None
            gx, gy, calls = _logged_backward(monkeypatch, prob, X, Y, W, el,
                                             sess)
            np.testing.assert_allclose(gx.numpy(), want_x.numpy(),
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(gy.numpy(), want_y.numpy(),
                                       rtol=2e-3, atol=2e-3)
            if use:
                assert torch.equal(gx, plain[0]) and torch.equal(gy, plain[1])
                if name != "s25":
                    assert sess.hits >= 1, (name, el, sess.stats())
            plain = (gx, gy)
            # the backward: the same cell with g in X's slot, R^T g
            # without the session, Ghat^T X with it
            assert len(calls) == 3, calls
            models = [prob.schedule_words("fusedmm", el, session=sess),
                      prob.schedule_words("spmm_t"),
                      prob.schedule_words("spmm_t", session=sess)]
            for (fn, logged), model in zip(calls, models):
                assert _nonzero(logged) == [
                    (k, float(w)) for (_, _, k, w) in model if k and w], fn
            totals[use] = sum(w for _, logged in calls for _, w in logged)
            cm = costmodel.ELISION_COST_NAME[(name, el)]
            paper = costmodel.words_fusedmm_bwd(
                cm, p=8, c=c, n=M8, r=R8, nnz=len(vals), session=use).words
            assert 0.2 <= totals[use] / paper <= 5.0, (name, el, use)
        if name == "s25":
            assert totals[True] == totals[False]
        else:
            assert totals[True] < totals[False], (name, el, totals)


# ---------------------------------------------------------------------------
# the device values path and the device value injection
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name,el", ELISION_CELLS)
@pytest.mark.parametrize("p", [1, 8])
def test_values_tensor_equals_values_bitwise(name, el, p):
    rows, cols, vals, X, Y, Sd = _data(seed=6)
    prob = api.make_problem(rows, cols, vals, Sd.shape, 8, algorithm=name,
                            c=2 if p == 8 else None, devices=[CPU] * p)
    # a sample of exactly zero and one of -0.0: padding to the host path
    X[3] = 0.0
    X[5] = -0.0
    Y[7] = -Y[7] * 0.0
    _, R = prob.fusedmm(X, Y, elision=el)
    for res in (R, prob.sddmm(X, Y), prob.ones().sddmm(X, Y)):
        got = res.values_tensor()
        want = torch.from_numpy(res.values())
        assert got.dtype == torch.float32 and got.device == CPU
        assert torch.equal(_bits(got), _bits(want)), (name, el, p)


@pytest.mark.parametrize("name", FAMILIES)
def test_each_position_has_one_slot(name):
    """No family repeats a host-COO position in its packs, in either
    orientation it plans, so a gather equals the host path's sums."""
    rows, cols, vals, X, Y, Sd = _data(seed=6)
    prob = api.make_problem(rows, cols, vals, Sd.shape, 8, algorithm=name,
                            c=2, devices=[CPU] * 8)
    orients = ("normal", "transpose") if name in ("d15", "d25") \
        else ("normal",)
    for orient in orients:
        pos = api._flat(prob._posplan(orient).vals).long()
        counts = torch.bincount(pos[pos > 0], minlength=len(vals) + 1)
        assert bool((counts[1:] == 1).all()), (name, orient)


def test_repeated_coordinates_take_the_host_sum():
    rows, cols, vals, X, Y, Sd = _data(seed=8)
    rows = np.concatenate([rows, rows[:5]])
    cols = np.concatenate([cols, cols[:5]])
    vals = np.concatenate([vals, vals[:5] * 2.0]).astype(np.float32)
    prob = api.make_problem(rows, cols, vals, Sd.shape, 8, algorithm="d15",
                            devices=[CPU] * 2)
    res = prob.sddmm(X, Y)
    got, want = res.values_tensor(), res.values()
    assert torch.equal(_bits(got), _bits(torch.from_numpy(want)))
    assert np.all(want[-5:] == 0.0) and np.any(want[:5] != 0.0)


def _repacked(prob, orient, vals):
    """The plan packed straight from float values (no position codes)."""
    return prob.alg.make_plan(prob._derive(vals=vals), orient)


def _plans_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(x, tuple) and x \
                and isinstance(x[0], torch.Tensor):
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            assert all(u.dtype == v.dtype and torch.equal(u, v)
                       for u, v in zip(xs, ys)), f.name
        elif f.name != "meta":
            assert x == y, f.name


@pytest.mark.parametrize("name", FAMILIES)
def test_injected_plan_from_a_tensor_equals_repacked(name):
    rows, cols, vals, X, Y, Sd = _data(seed=9)
    prob = api.make_problem(rows, cols, vals, Sd.shape, 8, algorithm=name,
                            c=2, devices=[CPU] * 8)
    v2 = np.random.default_rng(13).standard_normal(len(vals)).astype(
        np.float32)
    orients = ("normal", "transpose") if name in ("d15", "d25") \
        else ("normal",)
    for orient in orients:
        want = _repacked(prob, orient, v2)
        _plans_equal(prob.injected_plan(orient, torch.from_numpy(v2)), want)
        _plans_equal(prob.injected_plan(orient, v2), want)
        _plans_equal(prob.plan(orient), _repacked(prob, orient, vals))
        # a problem with other values packs nothing
        assert prob.with_values(v2)._posplan(orient) is \
            prob._posplan(orient)


def test_position_codes_stay_exact_above_2_24():
    """The position codes pass through the packer as integers: codes
    above 2^24, where float32 would round odd numbers away, come out
    exact."""
    rows, cols, _ = sparse.erdos_renyi(256, 256, 12, seed=1)
    codes = np.arange(len(rows), dtype=np.int64) + (1 << 24) + 1
    rl, cl, vl, tb, rt = sparse.pack_row_tiled_arrays(
        rows, cols, codes, (256, 256), row_tile=8, nz_block=8)
    assert vl.dtype == np.int64
    live = vl[vl > 0]
    assert sorted(live.tolist()) == codes.tolist()
    # and each code sits at its own entry's coordinates
    r = (rl + tb[:, None])[vl > 0]
    c = cl[vl > 0]
    i = live - (1 << 24) - 1
    assert np.array_equal(rows[i], r) and np.array_equal(cols[i], c)


def test_injected_plan_above_2_24_nonzeros():
    """Above 2^24 nonzeros (the size the old host re-pack began at) the
    device injection still equals the re-packed plan element for
    element: one rank, a short wide matrix, few rows a window."""
    m, n, k = 1 << 10, 1 << 16, (1 << 14) + 8
    rows = np.repeat(np.arange(m, dtype=np.int32), k)
    cols = ((np.arange(m * k, dtype=np.int64) % k) * 2
            + np.repeat(np.arange(m) % 2, k)).astype(np.int32)
    vals = np.random.default_rng(0).standard_normal(m * k).astype(np.float32)
    assert len(vals) > (1 << 24)
    prob = api.make_problem(rows, cols, vals, (m, n), 4, algorithm="d15",
                            devices=[CPU], row_tile=8, nz_block=1024)
    v2 = np.arange(len(vals), dtype=np.float32)
    got = prob.injected_plan("normal", torch.from_numpy(v2))
    want = _repacked(prob, "normal", v2)
    _plans_equal(got, want)
    # every value landed exactly, the odd ones above 2^24 included
    live = got.vals[0][got.vals[0] != 0].double()
    assert int(live.numel()) == len(vals) - 1
    assert float(live.sum()) == float(v2.astype(np.float64).sum())


# ---------------------------------------------------------------------------
# four gloo ranks: each rank's gradients equal the stacked run's
# ---------------------------------------------------------------------------

DIST_CASES = [("d15", 2), ("s15", 1), ("d25", 1), ("s25", 1)]


def _dist_problem(name, c, devices, group=None):
    rows, cols, vals, X, Y = sparse.random_problem(128, 128, 16, 5, seed=0)
    prob = api.make_problem(rows, cols, vals, (128, 128), 16,
                            algorithm=name, c=c, devices=devices,
                            group=group, row_tile=32, nz_block=32)
    W = np.random.default_rng(1).standard_normal((128, 16)).astype(
        np.float32)
    return prob, X, Y, W


def _dist_grads(prob, X, Y, W):
    """Every grads primitive's gradients on ``prob``, by name."""
    out = {}
    sess = api.Session()
    for el in prob.alg.elisions:
        _, gx, gy = _fused_grads(prob, X, Y, W, el, session=sess)
        out[f"fusedmm/{el}/x"], out[f"fusedmm/{el}/y"] = gx, gy
    Xt, Yt = _leaf(X), _leaf(Y)
    w = torch.linspace(-1, 1, prob.nnz)
    (grads.sddmm(prob, Xt, Yt, session=sess) * w).sum().backward()
    out["sddmm/x"], out["sddmm/y"] = Xt.grad, Yt.grad
    vt, Yt = _leaf(prob.vals), _leaf(Y)
    (grads.spmm(prob, vt, Yt, session=sess)
     * torch.from_numpy(W)).sum().backward()
    out["spmm/v"], out["spmm/y"] = vt.grad, Yt.grad
    return {k: v.numpy() for k, v in out.items()}


def _worker(rank, world, init, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    res = {}
    try:
        for name, c in DIST_CASES:
            prob, X, Y, W = _dist_problem(name, c, [CPU] * world,
                                          group=dist.group.WORLD)
            assert (prob.p, prob.c) == (world, c)
            for k, v in _dist_grads(prob, X, Y, W).items():
                res[f"{name}/{k}"] = v
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("grads_dist"))
    return [arrays for arrays, _ in spawn(__file__, 4, out_dir)]


@pytest.mark.parametrize("name,c", DIST_CASES)
def test_rank_gradients_equal_stacked_bitwise(gloo_ranks, name, c):
    prob, X, Y, W = _dist_problem(name, c, [CPU] * 4)
    want = _dist_grads(prob, X, Y, W)
    for rank, got in enumerate(gloo_ranks):
        for k, v in want.items():
            g = got[f"{name}/{k}"]
            assert g.dtype == v.dtype and np.array_equal(
                g.view(np.int32), v.view(np.int32)), (rank, name, k)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                sys.argv[5])
