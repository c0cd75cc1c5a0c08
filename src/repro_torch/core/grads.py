"""Distributed autodiff: the api's sddmm / spmm / fusedmm as
``torch.autograd.Function``s whose backward is the dual primitive.

Port of ``repro.core.grads``.  Every 1.5D/2.5D SpMM algorithm converts
to an SDDMM algorithm with the same communication and the same layouts
(the paper's Table III), so the backward of each distributed primitive
is the other primitive on the same ``DistProblem`` pack.  For
``R = S * (X Y^T)`` and ``out = R Y`` (FusedMMA):

====================  =====================================================
primal                backward (cotangent g on the output)
====================  =====================================================
``sddmm(X, Y)``       ``Xbar = SpMM(S(g*s), Y)``, ``Ybar = SpMM^T(S(g*s), X)``
``spmm(v, Y)``        ``vbar = SDDMM_ones(g, Y)``, ``Ybar = SpMM^T(S(v), g)``
``fusedmm(X, Y)``     ``Xbar, Ghat = FusedMM(S, g, Y)`` -- the SAME cell --
                      ``Ybar = SpMM^T(S(r), g) + SpMM^T(S(ghat), X)``
====================  =====================================================

where ``s`` are S's sample values, ``r`` the forward's sampled
intermediate and ``Ghat = S * (g Y^T)``.  Each backward runs on the
grid, family and elision cell of its forward, so both passes ship the
words of ``costmodel.words_fusedmm_bwd``'s primitives.  Gradients exist
for the dense operands and for ``spmm``'s sample values, never for the
sparsity structure.

**Session replay.**  A ``Session`` threaded through a Function is used
by both passes, on the same calls as the reference's: the backward's
dual primitives find the forward's fiber gathers of the stationary
operands in it (content-keyed, so a saved tensor that comes back as
another object still hits).

**On the device.**  The reference runs its executors through
``jax.pure_callback`` and assembles sampled values on the host.  Here
every operand stays on the grid's device: sampled values pass between
the passes as tensors in host-COO order
(:meth:`api.SparseResult.values_tensor`) and enter the cached packs
by a device gather (:meth:`api.DistProblem.injected_plan`), so a
training step packs nothing and copies nothing to the host.

**Process groups.**  Under ``make_problem(..., group=)`` the api takes
global operands on every rank and returns this rank's ``RankBlock``.  A
Function must return a tensor, and autograd hands its backward a
cotangent shaped like that tensor, so each Function returns the global
result (``RankBlock.gather``, an all-gather outside the schedule) on
every rank: the loss, the cotangents and the gradients are then global
and the same on every rank, each backward primitive takes them as the
api takes any global operand, and each rank's gradients equal the
stacked run's bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import api

__all__ = ["sddmm", "spmm", "fusedmm"]


def _tensor(problem: api.DistProblem, x):
    """Tensors pass as they are (their autograd graph with them); numpy
    becomes a float32 tensor on the grid's device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, np.float32)).to(problem.grid.device)


class _SDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob, session, backend, X, Y):
        ctx.prob, ctx.session, ctx.backend = prob, session, backend
        ctx.save_for_backward(X, Y)
        return prob.sddmm(X, Y, session=session,
                          backend=backend).values_tensor()

    @staticmethod
    def backward(ctx, g):
        X, Y = ctx.saved_tensors
        prob, sess, be = ctx.prob, ctx.session, ctx.backend
        # the cotangent through the sampling, on S's pattern; both duals
        # inject it into the cached structure packs
        gs = g * prob.device_vals()
        xbar = ybar = None
        if ctx.needs_input_grad[3]:
            xbar = api.gathered(prob.spmm(Y, vals=gs, session=sess,
                                          backend=be))
        if ctx.needs_input_grad[4]:
            ybar = api.gathered(prob.spmm_t(X, vals=gs, session=sess,
                                            backend=be))
        return None, None, None, xbar, ybar


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob, session, backend, vals, Y):
        ctx.prob, ctx.session, ctx.backend = prob, session, backend
        ctx.save_for_backward(vals, Y)
        return api.gathered(prob.spmm(Y, vals=vals, session=session,
                                      backend=backend))

    @staticmethod
    def backward(ctx, g):
        vals, Y = ctx.saved_tensors
        prob, sess, be = ctx.prob, ctx.session, ctx.backend
        vbar = ybar = None
        if ctx.needs_input_grad[3]:
            # the dual SDDMM on the unit-valued pattern: the raw dots
            vbar = prob.ones().sddmm(g, Y, session=sess,
                                     backend=be).values_tensor()
        if ctx.needs_input_grad[4]:
            ybar = api.gathered(prob.spmm_t(g, vals=vals, backend=be))
        return None, None, None, vbar, ybar


class _FusedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob, elision, session, backend, X, Y):
        ctx.prob, ctx.elision = prob, elision
        ctx.session, ctx.backend = session, backend
        out, R = prob.fusedmm(X, Y, elision=elision, session=session,
                              backend=backend)
        ctx.save_for_backward(X, Y, R.values_tensor())
        return api.gathered(out)

    @staticmethod
    def backward(ctx, g):
        X, Y, r_vals = ctx.saved_tensors
        prob, sess, be = ctx.prob, ctx.session, ctx.backend
        # grad-wrt-X IS this FusedMM cell with g in X's slot:
        # Ghat = S * (g Y^T), Xbar = Ghat @ Y; Y's gather replays
        xbar, Ghat = prob.fusedmm(g, Y, elision=ctx.elision, session=sess,
                                  backend=be)
        ybar = None
        if ctx.needs_input_grad[5]:
            # R^T g (through the SpMM half) + Ghat^T X (through the SDDMM
            # half, replaying the forward's gather of X)
            ghat = Ghat.values_tensor()
            ybar = (api.gathered(prob.spmm_t(g, vals=r_vals, backend=be))
                    + api.gathered(prob.spmm_t(X, vals=ghat, session=sess,
                                               backend=be)))
        return None, None, None, None, api.gathered(xbar), ybar


def sddmm(problem: api.DistProblem, X, Y, *,
          session: Optional[api.Session] = None,
          backend: str | None = None) -> torch.Tensor:
    """Differentiable distributed SDDMM: the values of ``S * (X @ Y.T)``
    at nnz(S), in the problem's host COO order, ``(nnz,)`` on the grid's
    device.  Differentiable in ``X (m, r)`` and ``Y (n, r)``; the
    backward is SpMM and SpMM^T with the cotangent-valued S.
    ``backend`` ("cuda" or "ref") picks the local kernels of both
    passes."""
    return _SDDMM.apply(problem, session, backend, _tensor(problem, X),
                        _tensor(problem, Y))


def spmm(problem: api.DistProblem, vals, Y, *,
         session: Optional[api.Session] = None,
         backend: str | None = None) -> torch.Tensor:
    """Differentiable distributed SpMM: ``out = S(vals) @ Y``, ``(m, r)``,
    differentiable in the sample values ``vals (nnz,)`` (host COO order;
    pass ``problem.vals`` for S's own) and in ``Y (n, r)``.  The
    values' gradient is the dual SDDMM on S's pattern (what trains a GAT
    layer's attention), Y's the dual SpMM^T."""
    return _SpMM.apply(problem, session, backend, _tensor(problem, vals),
                       _tensor(problem, Y))


def fusedmm(problem: api.DistProblem, X, Y, *, elision: str = "auto",
            session: Optional[api.Session] = None,
            backend: str | None = None) -> torch.Tensor:
    """Differentiable distributed FusedMM, ``out = (S * (X @ Y.T)) @ Y``,
    ``(m, r)``; the sampled intermediate is kept for the backward.
    ``elision`` is resolved once here and pinned for both passes: X's
    gradient is this very cell with the cotangent in X's slot, Y's two
    SpMM^T calls."""
    el = problem.resolve_elision(elision, session)
    return _FusedMM.apply(problem, el, session, backend,
                          _tensor(problem, X), _tensor(problem, Y))
