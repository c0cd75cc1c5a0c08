"""Collaborative filtering via Alternating Least Squares (paper §VI-E).

Port of ``repro.apps.als``.  Batched CG (Zhao & Canny) solves the
per-row normal equations (B_Omega_i^T B_Omega_i + lambda I) a_i =
B_Omega_i^T c_i for all rows at once.  The batched matvec

    y_i = sum_{j in Omega_i} <x_i, b_j> b_j + lambda x_i

is FusedMMA(mask, X, B) + lambda X, so every CG iteration is one FusedMM.

* the single-device path (``run_als``) calls the local kernels
  (``kernels/ops.py``);
* the distributed path (``run_als_distributed``) runs every kernel
  through ``core/api`` on any family, with a ``Session`` threaded
  through the CG loop so the stationary factor is replicated once per
  solve.  Its dense glue is torch on the grid's device (the reference's
  is numpy on the host).

``train_embedding_distributed`` is the gradient-based sibling: SGD on
the sampled loss through ``core/grads``, each step's backward the dual
SpMM/SpMM^T pair on the same grid, with the Session replaying the
forward's replication.  The same numpy seeds draw the same initial
factors as the reference, so histories compare step for step.  Its
steps are resilient as the reference's: retried after a transient fault,
re-planned onto a degraded grid after a lost rank, timed by a step
monitor, checkpointed and resumed.

The served paths (``deploy_factors``, ``predict_scores``,
``lookup_embeddings``) answer CF prediction and lookup traffic through
``repro_torch.serving`` against deployed factors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import api, grads, sparse
from repro_torch.core import device as _device
from repro_torch.core.sparse import RowTiledCOO
from repro_torch.distributed import elastic, faults
from repro_torch.kernels import ops
from repro_torch.training import checkpoint

__all__ = [
    "ALSProblem", "DistALSProblem", "als_round", "cg_solve",
    "deploy_factors", "dist_als_round", "dist_cg_solve",
    "dist_fusedmm_matvec", "dist_loss", "fusedmm_matvec", "loss",
    "lookup_embeddings", "make_dist_problem", "make_problem",
    "predict_scores", "run_als", "run_als_distributed", "sampled_loss",
    "train_embedding_distributed",
]


@dataclasses.dataclass
class ALSProblem:
    S: RowTiledCOO        # mask/ratings (m x n), vals = ratings
    St: RowTiledCOO       # transpose pack (n x m)
    mask: RowTiledCOO     # S with vals=1 at nonzeros
    maskt: RowTiledCOO
    m: int
    n: int
    r: int
    reg: float = 0.1


def _ratings(m, n, nnz_per_row, seed):
    rows, cols, vals = sparse.erdos_renyi(m, n, nnz_per_row, seed=seed)
    return rows, cols, np.abs(vals) + 0.5          # positive "ratings"


def _factors(m, n, r, seed, dev):
    """The reference's initial factors: default_rng(seed), 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, r)) * 0.1).astype(np.float32)
    B = (rng.standard_normal((n, r)) * 0.1).astype(np.float32)
    return torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev)


def make_problem(m, n, nnz_per_row, r, seed=0, reg=0.1, row_tile=128,
                 nz_block=128, device=None) -> ALSProblem:
    rows, cols, vals = _ratings(m, n, nnz_per_row, seed)
    S = sparse.pack_row_tiled(rows, cols, vals, (m, n), row_tile=row_tile,
                              nz_block=nz_block, device=device)
    St = sparse.pack_row_tiled(cols, rows, vals, (n, m), row_tile=row_tile,
                               nz_block=nz_block, device=device)

    def unit(P):
        return P.with_vals((P.vals != 0).to(P.vals.dtype))
    return ALSProblem(S, St, unit(S), unit(St), m, n, r, reg)


def fusedmm_matvec(mask, X, B, reg, m):
    """y = FusedMM(mask, X, B) + reg*X -- one CG matvec for all rows."""
    out, _ = ops.fusedmm(X, B, mask, m=m)
    return out + reg * X


def _cg(matvec, rhs, iters):
    """Batched CG on the ALS normal equations (all rows at once)."""
    X = torch.zeros_like(rhs)
    R = rhs - matvec(X)
    P = R
    rs = torch.sum(R * R, dim=1, keepdim=True)
    for _ in range(iters):
        AP = matvec(P)
        alpha = rs / torch.clamp(torch.sum(P * AP, dim=1, keepdim=True),
                                 min=1e-12)
        X = X + alpha * P
        R = R - alpha * AP
        rs_new = torch.sum(R * R, dim=1, keepdim=True)
        P = R + (rs_new / torch.clamp(rs, min=1e-12)) * P
        rs = rs_new
    return X


def cg_solve(mask, B, rhs, reg, m, iters=10):
    """Batched CG with every matvec one local FusedMM."""
    return _cg(lambda X: fusedmm_matvec(mask, X, B, reg, m), rhs, iters)


def als_round(prob: ALSProblem, A, B, cg_iters=10):
    """One ALS round: optimize A given B, then B given A."""
    rhs_a = ops.spmm(prob.S, B, m=prob.m)                  # SpMMA(C, B)
    A = cg_solve(prob.mask, B, rhs_a, prob.reg, prob.m, cg_iters)
    rhs_b = ops.spmm(prob.St, A, m=prob.n)                 # SpMMB(C, A)
    B = cg_solve(prob.maskt, A, rhs_b, prob.reg, prob.n, cg_iters)
    return A, B


def loss(prob: ALSProblem, A, B):
    """|| C - SDDMM(A, B, mask) ||_F^2 on observed entries."""
    pred = ops.sddmm(A, B, prob.mask)
    return float(torch.sum((prob.S.vals - pred.vals) ** 2))


def run_als(m=1024, n=1024, nnz_per_row=8, r=32, rounds=3, cg_iters=10,
            seed=0, verbose=True, device=None):
    dev = _device.resolve(device)
    prob = make_problem(m, n, nnz_per_row, r, seed=seed, device=dev)
    A, B = _factors(m, n, r, seed, dev)
    hist = [loss(prob, A, B)]
    for it in range(rounds):
        A, B = als_round(prob, A, B, cg_iters)
        hist.append(loss(prob, A, B))
        if verbose:
            print(f"ALS round {it}: loss {hist[-2]:.1f} -> {hist[-1]:.1f}")
    return A, B, hist


# ---------------------------------------------------------------------------
# Distributed path: every kernel call through core/api
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistALSProblem:
    """Ratings and mask problems in both orientations, one grid.

    A-solve matvecs run FusedMM on ``mask``, B-solve matvecs on
    ``mask_t``; ``ratings`` / ``ratings_t`` give the right-hand sides by
    SpMM.  Each mask shares its ratings problem's packs (a problem with
    other values packs nothing).
    """
    ratings: api.DistProblem
    ratings_t: api.DistProblem
    mask: api.DistProblem
    mask_t: api.DistProblem
    m: int
    n: int
    r: int
    reg: float = 0.1


def make_dist_problem(m, n, nnz_per_row, r, *, algorithm="auto", c=None,
                      devices=None, seed=0, reg=0.1, row_tile=32,
                      nz_block=32) -> DistALSProblem:
    """Distributed analogue of make_problem: one grid, two packed
    orientations."""
    rows, cols, vals = _ratings(m, n, nnz_per_row, seed)
    ratings = api.make_problem(rows, cols, vals, (m, n), r,
                               algorithm=algorithm, c=c, devices=devices,
                               row_tile=row_tile, nz_block=nz_block)
    ratings_t = ratings.transposed()
    return DistALSProblem(ratings, ratings_t, ratings.ones(),
                          ratings_t.ones(), m, n, r, reg)


def dist_fusedmm_matvec(maskP: api.DistProblem, X, B, reg,
                        session: api.Session | None = None,
                        elision: str = "auto"):
    """y = FusedMM(mask, X, B) + reg*X through the distributed api."""
    out, _ = maskP.fusedmm(X, B, elision=elision, session=session)
    return api.gathered(out) + reg * X


def dist_cg_solve(maskP: api.DistProblem, B, rhs, reg, iters=10,
                  session: api.Session | None = None,
                  elision: str = "auto"):
    """Batched CG with every matvec one distributed FusedMM call.

    B is stationary across the whole solve, so with a Session its fiber
    replication happens once (first matvec); the iterate changes every
    iteration and is replicated fresh."""
    rhs = torch.as_tensor(rhs, dtype=torch.float32,
                          device=maskP.grid.device)
    return _cg(lambda X: dist_fusedmm_matvec(maskP, X, B, reg, session,
                                             elision), rhs, iters)


def dist_als_round(dp: DistALSProblem, A, B, cg_iters=10,
                   session: api.Session | None = None,
                   elision: str = "auto"):
    """One distributed ALS round: optimize A given B, then B given A;
    ``elision`` pins the FusedMM cell of every CG matvec ("auto": the
    cost model's Session-aware pick)."""
    rhs_a = api.gathered(dp.ratings.spmm(B))
    A = dist_cg_solve(dp.mask, B, rhs_a, dp.reg, cg_iters, session,
                      elision)
    rhs_b = api.gathered(dp.ratings_t.spmm(A))
    B = dist_cg_solve(dp.mask_t, A, rhs_b, dp.reg, cg_iters, session,
                      elision)
    return A, B


def dist_loss(dp: DistALSProblem, A, B):
    """|| C - SDDMM(A, B, mask) ||_F^2 on observed entries."""
    pred = dp.mask.sddmm(A, B).values_tensor()
    return float(torch.sum((dp.ratings.device_vals() - pred) ** 2))


def run_als_distributed(m=1024, n=1024, nnz_per_row=8, r=32, rounds=3,
                        cg_iters=10, seed=0, algorithm="auto", c=None,
                        devices=None, elision="auto", verbose=True):
    """End-to-end distributed ALS on any family, with Session-cached
    replication in the CG loop; ``elision`` selects the FusedMM cell of
    the matvecs ("auto" = the cost model's Session-aware pick)."""
    dp = make_dist_problem(m, n, nnz_per_row, r, seed=seed,
                           algorithm=algorithm, c=c, devices=devices)
    A, B = _factors(m, n, r, seed, dp.ratings.grid.device)
    session = api.Session()
    hist = [dist_loss(dp, A, B)]
    for it in range(rounds):
        A, B = dist_als_round(dp, A, B, cg_iters, session, elision)
        hist.append(dist_loss(dp, A, B))
        if verbose:
            print(f"ALS[{dp.mask.alg.name}] round {it}: "
                  f"loss {hist[-2]:.1f} -> {hist[-1]:.1f}")
    return A, B, hist


# ---------------------------------------------------------------------------
# Query mode: trained factors served through repro_torch.serving, many
# clients' user-item score queries coalesced per tick
# ---------------------------------------------------------------------------

def deploy_factors(pool, rows, cols, vals, shape, U, V, *,
                   algorithm: str = "auto", c=None, devices=None,
                   group=None, comm: str = "dense", row_tile: int = 32,
                   nz_block: int = 32):
    """Deploy trained CF factors for serving: the ratings graph plus the
    factor matrices ``U (m, r)`` / ``V (n, r)`` (numpy or tensors) as
    stationary operands, uploaded to the grid's device once.  The pool
    key digests the factors too, so re-deploying after a training
    refresh is a miss and the identical deploy a hit.  Prediction
    traffic then moves only (user, item) coordinate lists.  Under a
    process group (``group=``) every rank makes this call with the same
    data (``pool.deploy``'s collective)."""
    if U.shape[1] != V.shape[1]:
        raise ValueError(f"factor widths differ: {tuple(U.shape)} vs "
                         f"{tuple(V.shape)}")
    return pool.deploy(rows, cols, vals, shape, int(U.shape[1]),
                       operands={"U": U, "V": V}, algorithm=algorithm,
                       c=c, devices=devices, group=group, comm=comm,
                       row_tile=row_tile, nz_block=nz_block)


def predict_scores(engine, deployment, users, items, *,
                   arrival: float = 0.0):
    """Queue a prediction query: ``score_k = <U_users[k], V_items[k]>``,
    an SDDMM sampled at the requested pairs against the deployed
    factors; a tick's worth of clients coalesces into ONE
    union-of-patterns round."""
    return engine.submit_score(deployment, users, items, "U", "V",
                               arrival=arrival)


def lookup_embeddings(engine, deployment, weights, *,
                      arrival: float = 0.0):
    """Queue an embedding aggregation ``out = ratings_graph @ weights``
    (``weights (n, w)``); all deployed-values lookups of a tick ride one
    batched-RHS SpMM round."""
    return engine.submit_aggregate(deployment, weights, arrival=arrival)


# ---------------------------------------------------------------------------
# Sampled-loss embedding training: SGD through core/grads
# ---------------------------------------------------------------------------

def sampled_loss(maskP: api.DistProblem, X, Y, targets, reg=0.0,
                 session: api.Session | None = None,
                 backend: str | None = None):
    """0.5 ||SDDMM(mask, X, Y) - targets||^2 on the observed entries
    (plus 0.5 reg (|X|^2 + |Y|^2)): only the sampled predictions enter
    the loss, so both passes communicate like one SDDMM/SpMM pair.
    ``backend`` picks the local kernels of both passes."""
    pred = grads.sddmm(maskP, X, Y, session=session, backend=backend)
    out = 0.5 * torch.sum((pred - targets) ** 2)
    if reg:
        out = out + 0.5 * reg * (torch.sum(X * X) + torch.sum(Y * Y))
    return out


def train_embedding_distributed(m=256, n=256, nnz_per_row=6, r=16,
                                steps=20, lr=0.05, seed=0,
                                algorithm="auto", c=None, devices=None,
                                reg=1e-4, rows=None, cols=None, vals=None,
                                monitor=None, ckpt_dir=None, ckpt_every=5,
                                max_retries=2, verbose=True):
    """Distributed embedding training by SGD on the sampled loss: every
    step one distributed SDDMM forward plus its dual SpMM/SpMM^T
    backward on the same grid, with a Session replaying the forward's
    replication.  Pass ``rows``, ``cols`` and ``vals`` together (with
    the matrix's ``m``/``n``) to train on a given matrix (e.g. from
    :func:`repro_torch.core.mtx.load_mtx`); by default a seeded ER
    ratings matrix is drawn.  Returns ``(X, Y, hist)``.

    Every step runs under ``elastic.run_step_resilient``: a
    ``TransientFault`` invalidates the Session's replication for this
    grid and retries; a ``DeviceLost`` re-plans onto a degraded grid via
    :func:`api.degrade` and binds the step's autograd Functions to the
    new problem before retrying.  ``monitor`` (an
    :class:`elastic.StepMonitor`) times each step.  With ``ckpt_dir``
    the factors are checkpointed every ``ckpt_every`` steps with the
    problem's :meth:`api.DistProblem.meta_dict`, and training resumes
    from the latest committed step, rebuilding the packs via
    :func:`api.problem_from_meta` (the same rank count -> the pinned
    family and c; another -> cost-model re-dispatch)."""
    if rows is None:
        if cols is not None or vals is not None:
            raise ValueError("pass rows, cols and vals together")
        rows, cols, vals = _ratings(m, n, nnz_per_row, seed)
    else:
        if cols is None or vals is None:
            raise ValueError("pass rows, cols and vals together")
        if int(np.max(rows, initial=0)) >= m \
                or int(np.max(cols, initial=0)) >= n:
            raise ValueError(
                f"coordinates exceed shape ({m}, {n}) -- pass the "
                "matrix's m/n alongside rows/cols/vals")
    maskP = api.make_problem(rows, cols, np.ones(len(vals), np.float32),
                             (m, n), r, algorithm=algorithm, c=c,
                             devices=devices)
    dev = maskP.grid.device
    rng = np.random.default_rng(seed + 1)
    X = torch.from_numpy((rng.standard_normal((m, r)) * 0.1)
                         .astype(np.float32)).to(dev).requires_grad_()
    Y = torch.from_numpy((rng.standard_normal((n, r)) * 0.1)
                         .astype(np.float32)).to(dev).requires_grad_()
    targets = torch.as_tensor(np.asarray(vals, np.float32), device=dev)
    session = api.Session()

    def make_grad(prob):
        def grad_fn(X, Y):
            X, Y = X.detach().requires_grad_(), Y.detach().requires_grad_()
            val = sampled_loss(prob, X, Y, targets, reg, session)
            return val.detach(), torch.autograd.grad(val, (X, Y))
        return grad_fn

    grad_fn = make_grad(maskP)
    X, Y = X.detach(), Y.detach()
    start = 0
    if ckpt_dir is not None:
        last = checkpoint.latest_step(ckpt_dir)
        if last is not None:
            meta = checkpoint.load_manifest(ckpt_dir, last).get("meta")
            if meta is not None:
                maskP = api.problem_from_meta(
                    meta, rows, cols, np.ones(len(vals), np.float32),
                    devices=devices)
                grad_fn = make_grad(maskP)
            tree = checkpoint.restore(ckpt_dir, last, {"X": X, "Y": Y})
            X, Y = tree["X"], tree["Y"]
            start = last
            if verbose:
                print(f"embed: resumed step {last} on "
                      f"{maskP.alg.name} p={maskP.p}")

    def on_failure(attempt, e):
        nonlocal maskP, grad_fn
        e = faults.unwrap(e)
        session.invalidate(maskP)
        if isinstance(e, faults.DeviceLost):
            maskP = api.degrade(maskP, e.rank)
            grad_fn = make_grad(maskP)
            if verbose:
                print(f"embed: lost rank {e.rank} -> re-planned onto "
                      f"{maskP.alg.name} p={maskP.p}")

    hist = []
    for it in range(start, steps):
        def step(X, Y):
            if monitor is not None:
                return monitor.timed(it, grad_fn, X, Y)
            return grad_fn(X, Y)

        val, (gx, gy) = elastic.run_step_resilient(
            step, None, None, X, Y, max_retries=max_retries,
            on_failure=on_failure)
        X, Y = X - lr * gx, Y - lr * gy
        hist.append(float(val))
        if verbose:
            print(f"embed[{maskP.alg.name}] step {it}: loss {hist[-1]:.3f}")
        if ckpt_dir is not None and (it + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, it + 1, {"X": X, "Y": Y},
                            meta=maskP.meta_dict())
    return X, Y, hist
