"""The port's applications (apps/als.py, apps/gat.py) against the
reference's (after tests/test_apps.py and the app tests of
tests/test_grads.py).

Both packages draw the same matrices and initial factors from the same
numpy seeds, so the ALS and embedding histories compare step for step;
the reference runs on one host device (its kernels in interpret mode),
the port on stacked CPU ranks.  GAT parameters are the reference's
``init_gat_layer`` draw carried across (``convert.gat_params_from_numpy``):
a ``jax.random`` draw cannot be reproduced by a ``torch.Generator``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.apps import als as jals
from repro.apps import gat as jgat
from repro_torch import convert
from repro_torch.apps import als, gat
from repro_torch.core import api
from repro_torch.kernels import ops
from _torch_spawn import one_intra_op_thread  # noqa: E402,F401

CPU = torch.device("cpu")
J1 = jax.devices()[:1]


# ALS cases whose losses stay above the float32 rounding floor: with
# fewer factors than ratings a row, the solves cannot interpolate the
# ratings, and cg_iters >= r would iterate on residuals of rounding size
# (there the two packages' sum orders part ways, each as right as the
# other); the reference's own convergence case is test_als_loss_decreases
ALS_CASES = [(256, 12, 4, 8), (128, 8, 4, 6)]


@pytest.mark.parametrize("m,k,r,iters", ALS_CASES)
def test_run_als_history_matches_reference(m, k, r, iters):
    _, _, want = jals.run_als(m=m, n=m, nnz_per_row=k, r=r, rounds=3,
                              cg_iters=iters, verbose=False)
    _, _, got = als.run_als(m=m, n=m, nnz_per_row=k, r=r, rounds=3,
                            cg_iters=iters, verbose=False, device=CPU)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_als_loss_decreases():
    _, _, hist = als.run_als(m=256, n=256, nnz_per_row=6, r=16, rounds=3,
                             cg_iters=8, verbose=False, device=CPU)
    assert hist[-1] < 0.2 * hist[0], hist


@pytest.mark.parametrize("m,k,r,iters", ALS_CASES)
@pytest.mark.parametrize("p", [1, 4])
def test_run_als_distributed_history_matches_reference(m, k, r, iters, p):
    _, _, want = jals.run_als_distributed(
        m=m, n=m, nnz_per_row=k, r=r, rounds=3, cg_iters=iters,
        devices=J1, verbose=False)
    _, _, got = als.run_als_distributed(
        m=m, n=m, nnz_per_row=k, r=r, rounds=3, cg_iters=iters,
        devices=[CPU] * p, verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_als_cg_solves_normal_equations():
    """CG's result satisfies the per-row normal equations."""
    prob = als.make_problem(128, 128, 5, 8, seed=1, device=CPU)
    rng = np.random.default_rng(0)
    B = torch.from_numpy(rng.standard_normal((128, 8)).astype(np.float32))
    rhs = ops.spmm(prob.S, B, m=128)
    X = als.cg_solve(prob.mask, B, rhs, prob.reg, 128, iters=40)
    resid = rhs - als.fusedmm_matvec(prob.mask, X, B, prob.reg, 128)
    assert float(torch.linalg.norm(resid)) < 1e-2 * max(
        float(torch.linalg.norm(rhs)), 1.0)


def test_dist_cg_matches_single_device_cg():
    dp = als.make_dist_problem(128, 128, 5, 8, seed=1, devices=[CPU] * 4)
    prob = als.make_problem(128, 128, 5, 8, seed=1, device=CPU)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 8)).astype(np.float32))
    rhs = ops.spmm(prob.S, B, m=128)
    want = als.cg_solve(prob.mask, B, rhs, prob.reg, 128, iters=20)
    got = als.dist_cg_solve(dp.mask, B, rhs, dp.reg, 20, api.Session())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("p", [1, 4])
def test_embedding_history_matches_reference(p):
    kw = dict(m=96, n=96, nnz_per_row=5, r=8, steps=12, lr=0.08,
              verbose=False)
    _, _, want = jals.train_embedding_distributed(devices=J1, **kw)
    X, Y, got = als.train_embedding_distributed(devices=[CPU] * p, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < 0.5 * got[0], got
    assert not X.requires_grad and X.shape == (96, 8)


def test_embedding_on_a_given_matrix():
    from repro_torch.core import sparse
    rows, cols, vals = sparse.erdos_renyi(64, 48, 4, seed=3)
    with pytest.raises(ValueError, match="together"):
        als.train_embedding_distributed(m=64, n=48, rows=rows,
                                        devices=[CPU])
    with pytest.raises(ValueError, match="exceed"):
        als.train_embedding_distributed(m=32, n=48, rows=rows, cols=cols,
                                        vals=vals, devices=[CPU])
    _, _, hist = als.train_embedding_distributed(
        m=64, n=48, r=8, steps=8, lr=0.08, rows=rows, cols=cols,
        vals=np.abs(vals) + 0.5, devices=[CPU], verbose=False)
    assert hist[-1] < hist[0]


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------

def _params(key, d_in, d_out):
    p = jgat.init_gat_layer(jax.random.PRNGKey(key), d_in, d_out)
    return p, convert.gat_params_from_numpy(
        np.asarray(p.W), np.asarray(p.a1), np.asarray(p.a2), device=CPU)


def test_gat_row_softmax_matches_reference():
    S = jgat.make_graph(64, 4, seed=2)
    St = gat.make_graph(64, 4, seed=2, device=CPU)
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(S.vals.shape).astype(np.float32)
    vals = np.where(np.asarray(S.vals) != 0, vals, 0.0).astype(np.float32)
    want = np.asarray(jgat.row_softmax(S.with_vals(jnp.asarray(vals))).vals)
    got = gat.row_softmax(St.with_vals(torch.from_numpy(vals)))
    np.testing.assert_allclose(got.vals.numpy(), want, rtol=5e-4, atol=5e-4)
    dense = got.to_dense().numpy()
    live = St.to_dense().numpy().sum(1) > 0
    np.testing.assert_allclose(dense.sum(1)[live], 1.0, rtol=1e-5)
    assert (dense >= 0).all()


@pytest.mark.parametrize("n_heads", [1, 2])
def test_gat_layer_matches_reference(n_heads):
    n, d = 96, 16
    S = jgat.make_graph(n, 4, seed=3, row_tile=32, nz_block=32)
    St = gat.make_graph(n, 4, seed=3, row_tile=32, nz_block=32, device=CPU)
    H = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    jp, p = _params(0, d, d)
    want = np.asarray(jgat.gat_layer(S, jnp.asarray(H), jp,
                                     n_heads=n_heads))
    got = gat.gat_layer(St, torch.from_numpy(H), p, n_heads=n_heads)
    assert got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("family", ["d15", "s15", "d25", "s25"])
def test_gat_layer_distributed_matches_reference(family):
    n, d = 64, 8
    jgp = jgat.make_dist_graph(n, 4, d, algorithm=family, seed=3,
                               devices=J1)
    H = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    jp, p = _params(0, d, d)
    want = np.asarray(jgat.gat_layer_distributed(jgp, H, jp))
    for devs in ([CPU], [CPU] * 4):
        gp = gat.make_dist_graph(n, 4, d, algorithm=family, seed=3,
                                 devices=devs)
        got = gat.gat_layer_distributed(gp, H, p)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_gat_layer_trainable_matches_reference():
    """The trainable layer is the distributed layer, differentiably: its
    value and its gradients in W, a1 and a2 match the reference's."""
    n, d = 64, 8
    jgp = jgat.make_dist_graph(n, 4, d, seed=3, devices=J1)
    gp = gat.make_dist_graph(n, 4, d, seed=3, devices=[CPU] * 4)
    rng = np.random.default_rng(3)
    H = rng.standard_normal((n, d)).astype(np.float32)
    T = rng.standard_normal((n, d)).astype(np.float32)
    jp, p = _params(0, d, d)

    def jloss(W, a1, a2):
        out = jgat.gat_layer_trainable(jgp, jnp.asarray(H), W, a1, a2)
        return jnp.sum(out * T)

    args = (jnp.asarray(jp.W), jnp.asarray(jp.a1), jnp.asarray(jp.a2))
    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*args)
    leaves = [t.clone().requires_grad_() for t in (p.W, p.a1, p.a2)]
    out = gat.gat_layer_trainable(gp, H, *leaves)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(gat.gat_layer_distributed(gp, H, p)),
        rtol=5e-4, atol=5e-4)
    loss = (out * torch.from_numpy(T)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jv), rtol=5e-4, atol=5e-4)
    for leaf, want in zip(leaves, jg):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4)


def test_gat_gradients_repeat_bitwise():
    n, d = 64, 8
    gp = gat.make_dist_graph(n, 4, d, seed=3, devices=[CPU] * 4)
    H = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    _, p = _params(0, d, d)

    def grads_once():
        leaves = [t.clone().requires_grad_() for t in (p.W, p.a1, p.a2)]
        gat.gat_layer_trainable(gp, H, *leaves).sum().backward()
        return [t.grad for t in leaves]

    for a, b in zip(grads_once(), grads_once()):
        assert torch.equal(a, b)


def test_train_gat_distributed_loss_falls():
    n, d = 64, 8
    gp = gat.make_dist_graph(n, 4, d, seed=3, devices=[CPU] * 4)
    rng = np.random.default_rng(3)
    H = rng.standard_normal((n, d)).astype(np.float32)
    target = rng.standard_normal((n, d)).astype(np.float32) * 0.1
    (W, a1, a2), hist = gat.train_gat_distributed(gp, H, target, steps=6,
                                                  lr=0.05, verbose=False)
    assert hist[-1] < hist[0], hist
    assert W.shape == (d, d) and a1.shape == a2.shape == (d,)


def test_segment_softmax_refuses_unsorted_rows():
    with pytest.raises(ValueError, match="sorted"):
        gat.segment_softmax(np.array([1, 0]), torch.zeros(2), 2)


def test_init_gat_layer_scales_and_seed():
    g = torch.Generator().manual_seed(0)
    p = gat.init_gat_layer(g, 64, 32, device=CPU)
    q = gat.init_gat_layer(torch.Generator().manual_seed(0), 64, 32,
                           device=CPU)
    assert torch.equal(p.W, q.W) and torch.equal(p.a2, q.a2)
    assert p.W.shape == (64, 32) and p.a1.shape == (32,)
    assert abs(float(p.W.std()) - 64 ** -0.5) < 0.02


def test_entry_points_default_to_the_card():
    """Without a device the new entry points run on the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.core import sparse_attention
    calls = [
        lambda: als.run_als(m=64, n=64, nnz_per_row=2, r=4, rounds=1,
                            verbose=False),
        lambda: als.make_problem(64, 64, 2, 4),
        lambda: als.train_embedding_distributed(m=64, n=64, r=4, steps=1,
                                                verbose=False),
        lambda: gat.make_graph(64, 2),
        lambda: gat.make_dist_graph(64, 2, 8),
        lambda: gat.init_gat_layer(torch.Generator(), 8, 8),
        lambda: sparse_attention.build_causal_block_mask(64, 16, 2),
        lambda: convert.gat_params_from_numpy(np.ones((2, 2)), np.ones(2),
                                              np.ones(2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
