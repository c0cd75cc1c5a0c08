"""Graph Attention Network layer (paper §VI-E).

Port of ``repro.apps.gat``.  A single-head GAT layer over adjacency S:

    e_ij  = LeakyReLU( <a1, W h_i> + <a2, W h_j> )   at nnz(S)
    Shat  = row_softmax(e)
    h'_i  = sigma( sum_j Shat_ij (W h)_j )

With augmented embeddings A* = [u, 1] and B* = [1, v] the dot
<A*_i, B*_j> = u_i + v_j, so the score computation is an r = 2 SDDMM
and the aggregation an SpMM; the softmax needs completed rows, so the
two kernels cannot fuse (the paper's Fig. 9), in any elision cell.

* the single-device path (``gat_layer``) calls the local kernels
  (``kernels/ops.py``);
* the distributed path (``gat_layer_distributed``) runs the score SDDMM
  and the aggregation SpMM through ``core/api`` on any family, with the
  row softmax between them on the completed rows in host-COO order,
  all on the grid's device;
* the trainable path (``gat_layer_trainable`` /
  ``train_gat_distributed``) is the same pipeline through
  ``core/grads``: the aggregation SpMM takes the attention as
  differentiable values, so the gradient reaches W, a1 and a2.

The row softmax runs per row in entry order
(``sparse_attention.softmax_sorted_rows``), so the layer and its
gradients repeat bit for bit on the card.  Training steps are
resilient as the reference's (retries, re-planning after a lost rank,
step monitor, checkpoints).  The served paths (``gat_deploy_layer`` ...
``gat_layer_served``) come with the serving slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import api, grads, sparse
from repro_torch.core import device as _device
from repro_torch.distributed import elastic, faults
from repro_torch.training import checkpoint
from repro_torch.core.sparse import RowTiledCOO
from repro_torch.core.sparse_attention import (row_softmax,
                                               softmax_sorted_rows)
from repro_torch.kernels import ops

__all__ = [
    "GATParams", "attention_scores", "gat_forward",
    "gat_forward_distributed", "gat_layer", "gat_layer_distributed",
    "gat_layer_trainable", "graph_coo", "init_gat_layer", "leaky_relu",
    "make_dist_graph", "make_graph", "row_softmax", "row_softmax_coo",
    "segment_softmax", "train_gat_distributed",
]


def leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def attention_scores(S_ones: RowTiledCOO, u, v):
    """e_ij = u_i + v_j at nonzeros, via the r = 2 SDDMM trick."""
    A_star = torch.stack([u, torch.ones_like(u)], dim=1)     # (m, 2)
    B_star = torch.stack([torch.ones_like(v), v], dim=1)     # (n, 2)
    return ops.sddmm(A_star, B_star, S_ones)


@dataclasses.dataclass
class GATParams:
    W: torch.Tensor       # (d_in, d_out)
    a1: torch.Tensor      # (d_out,)
    a2: torch.Tensor      # (d_out,)


def init_gat_layer(generator: torch.Generator, d_in: int, d_out: int,
                   device=None) -> GATParams:
    """Random layer parameters drawn from ``generator`` (the reference's
    scales: W ~ N(0, 1/d_in), a ~ N(0, 0.01)), placed on ``device``
    (default: the card)."""
    dev = _device.resolve(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    return GATParams(W=normal(d_in, d_out) * (1.0 / np.sqrt(d_in)),
                     a1=normal(d_out) * 0.1, a2=normal(d_out) * 0.1)


def gat_layer(S_ones: RowTiledCOO, H, p: GATParams, n_heads: int = 1,
              activation=F.elu):
    """Multi-head = independent heads on column slices of W, concatenated."""
    d_out = p.W.shape[1] // n_heads
    outs = []
    for h in range(n_heads):
        cols = slice(h * d_out, (h + 1) * d_out)
        Wh = H @ p.W[:, cols]
        e = attention_scores(S_ones, Wh @ p.a1[cols], Wh @ p.a2[cols])
        e = e.with_vals(torch.where(e.vals != 0, leaky_relu(e.vals),
                                    torch.zeros_like(e.vals)))
        Shat = row_softmax(e)
        outs.append(ops.spmm(Shat, Wh, m=S_ones.shape[0]))
    return activation(torch.cat(outs, dim=1))


def gat_forward(S_ones, H0, layers, n_heads=1):
    H = H0
    for p in layers:
        H = gat_layer(S_ones, H, p, n_heads=n_heads)
    return H


def graph_coo(n_nodes, nnz_per_row, seed=0):
    """ER adjacency + self loops (standard GAT practice), unit values,
    sorted by row."""
    rows, cols, _ = sparse.erdos_renyi(n_nodes, n_nodes, nnz_per_row,
                                       seed=seed)
    rows = np.concatenate([rows, np.arange(n_nodes, dtype=np.int32)])
    cols = np.concatenate([cols, np.arange(n_nodes, dtype=np.int32)])
    key = np.unique(rows.astype(np.int64) * n_nodes + cols)
    rows = (key // n_nodes).astype(np.int32)
    cols = (key % n_nodes).astype(np.int32)
    return rows, cols, np.ones(len(rows), np.float32)


def make_graph(n_nodes, nnz_per_row, seed=0, row_tile=128, nz_block=128,
               device=None) -> RowTiledCOO:
    rows, cols, vals = graph_coo(n_nodes, nnz_per_row, seed=seed)
    return sparse.pack_row_tiled(rows, cols, vals, (n_nodes, n_nodes),
                                 row_tile=row_tile, nz_block=nz_block,
                                 device=device)


# ---------------------------------------------------------------------------
# Distributed path: score SDDMM + aggregation SpMM through core/api, row
# softmax on completed rows in between (paper Fig. 9)
# ---------------------------------------------------------------------------

def make_dist_graph(n_nodes, nnz_per_row, r, *, algorithm="auto", c=None,
                    devices=None, seed=0, row_tile=32,
                    nz_block=32) -> api.DistProblem:
    """Adjacency as a DistProblem; ``r`` is the per-head output width the
    aggregation SpMM runs at (it must obey the family's r-divisibility)."""
    rows, cols, vals = graph_coo(n_nodes, nnz_per_row, seed=seed)
    return api.make_problem(rows, cols, vals, (n_nodes, n_nodes), r,
                            algorithm=algorithm, c=c, devices=devices,
                            row_tile=row_tile, nz_block=nz_block)


def row_softmax_coo(rows, vals, n_rows):
    """Numerically safe softmax over each row's nonzeros, COO layout, in
    float64 as the reference's host version, returned as float32 on
    ``vals``' device.  ``rows`` must be sorted and every row complete
    (the api's host-COO order of graph_coo's pattern is both)."""
    vals = torch.as_tensor(vals).double()
    rows = torch.as_tensor(rows, device=vals.device)
    return softmax_sorted_rows(rows, vals, n_rows).float()


def _score_widths(graphP: api.DistProblem, d_out: int):
    """The problems of one layer: the score SDDMM at r = 2 zero-padded to
    the family's smallest width, the aggregation at the head width."""
    mult = graphP.alg.min_r_multiple(graphP.grid)
    r_score = max(2, ((2 + mult - 1) // mult) * mult)
    return r_score, graphP.with_r(r_score), graphP.with_r(d_out)


def _augmented(u, v, r_score):
    """A* = [u, 1, 0...], B* = [1, v, 0...]: <A*_i, B*_j> = u_i + v_j."""
    one = torch.ones_like(u)[:, None]
    pad = torch.zeros((u.shape[0], r_score - 2), dtype=u.dtype,
                      device=u.device)
    return (torch.cat([u[:, None], one, pad], dim=1),
            torch.cat([one, v[:, None], pad], dim=1))


def gat_layer_distributed(graphP: api.DistProblem, H, p: GATParams,
                          n_heads: int = 1, activation=F.elu):
    """Distributed single layer, mirroring gat_layer head for head: the
    score SDDMM, LeakyReLU and the row softmax on the completed rows, the
    aggregation SpMM with the attention injected as its values."""
    dev = graphP.grid.device
    H = torch.as_tensor(H, dtype=torch.float32, device=dev)
    n = graphP.m
    d_out = p.W.shape[1] // n_heads
    r_score, scoreP, aggP = _score_widths(graphP, d_out)
    outs = []
    for h in range(n_heads):
        cols = slice(h * d_out, (h + 1) * d_out)
        Wh = H @ p.W[:, cols].to(dev)
        A_star, B_star = _augmented(Wh @ p.a1[cols].to(dev),
                                    Wh @ p.a2[cols].to(dev), r_score)
        e = leaky_relu(scoreP.sddmm(A_star, B_star).values_tensor())
        attn = row_softmax_coo(graphP.rows, e, n)
        outs.append(api.gathered(aggP.spmm(Wh, vals=attn)))
    return activation(torch.cat(outs, dim=1))


def gat_forward_distributed(graphP: api.DistProblem, H0, layers,
                            n_heads: int = 1):
    H = H0
    for p in layers:
        H = gat_layer_distributed(graphP, H, p, n_heads=n_heads)
    return H


# ---------------------------------------------------------------------------
# Trainable path: the same pipeline through core/grads
# ---------------------------------------------------------------------------

def segment_softmax(rows, vals, n_rows):
    """Differentiable row softmax over COO values (sorted, completed
    rows), float32."""
    rows = torch.as_tensor(rows, device=vals.device)
    return softmax_sorted_rows(rows, vals, n_rows)


def gat_layer_trainable(graphP: api.DistProblem, H, W, a1, a2,
                        n_heads: int = 1, activation=F.elu,
                        session: api.Session | None = None):
    """Differentiable distributed GAT layer (autograd reaches W, a1, a2
    and H).  Mirrors :func:`gat_layer_distributed` kernel for kernel, but
    every distributed call goes through :mod:`repro_torch.core.grads`:
    the score SDDMM's backward is the dual SpMM pair, and the aggregation
    SpMM takes the softmaxed attention as differentiable values, whose
    backward is the dual SDDMM on the adjacency pattern."""
    H = torch.as_tensor(H, dtype=torch.float32, device=graphP.grid.device)
    n = graphP.m
    d_out = W.shape[1] // n_heads
    r_score, scoreP, aggP = _score_widths(graphP, d_out)
    outs = []
    for h in range(n_heads):
        cols = slice(h * d_out, (h + 1) * d_out)
        Wh = H @ W[:, cols]
        A_star, B_star = _augmented(Wh @ a1[cols], Wh @ a2[cols], r_score)
        e = leaky_relu(grads.sddmm(scoreP, A_star, B_star, session=session))
        attn = segment_softmax(graphP.rows, e, n)
        outs.append(grads.spmm(aggP, attn, Wh, session=session))
    return activation(torch.cat(outs, dim=1))


def train_gat_distributed(graphP: api.DistProblem, H, target, *,
                          d_out: int | None = None, steps: int = 20,
                          lr: float = 0.05, n_heads: int = 1, seed: int = 0,
                          session: api.Session | None = None,
                          monitor=None, ckpt_dir: str | None = None,
                          ckpt_every: int = 5, max_retries: int = 2,
                          verbose: bool = True):
    """Gradient-based training of one distributed GAT layer: SGD on
    (W, a1, a2) for the MSE between the layer output and ``target``,
    every kernel of every step a distributed primitive on ``graphP``'s
    grid.  The initial parameters are :func:`init_gat_layer` of a
    generator seeded with ``seed`` on the grid's device.  Returns
    ((W, a1, a2), loss history).

    Robustness as ``als.train_embedding_distributed``'s: steps run under
    ``elastic.run_step_resilient`` -- a ``TransientFault`` invalidates
    the Session's replication for this grid and retries, a
    ``DeviceLost`` re-plans ``graphP`` onto a degraded grid and binds
    the step to it; ``monitor`` times steps; ``ckpt_dir`` checkpoints
    (W, a1, a2) with the problem's :meth:`api.DistProblem.meta_dict`
    every ``ckpt_every`` steps and resumes from the latest committed
    step, rebuilding the packs via :func:`api.problem_from_meta` on
    ``graphP``'s own devices."""
    dev = graphP.grid.device
    H = torch.as_tensor(H, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    session = session if session is not None else api.Session()
    d_out = d_out if d_out is not None else target.shape[1]
    p0 = init_gat_layer(torch.Generator(device=dev).manual_seed(seed),
                        H.shape[1], d_out, device=dev)
    params = (p0.W, p0.a1, p0.a2)

    def make_grad(prob):
        def grad_fn(params):
            params = [p.detach().requires_grad_() for p in params]
            out = gat_layer_trainable(prob, H, *params, n_heads=n_heads,
                                      session=session)
            loss = torch.mean((out - target) ** 2)
            return loss.detach(), torch.autograd.grad(loss, params)
        return grad_fn

    grad_fn = make_grad(graphP)
    start = 0
    if ckpt_dir is not None:
        last = checkpoint.latest_step(ckpt_dir)
        if last is not None:
            meta = checkpoint.load_manifest(ckpt_dir, last).get("meta")
            if meta is not None:
                # resume onto the ranks of the problem the caller handed
                # us, not onto a default device set
                graphP = api.problem_from_meta(
                    meta, graphP.rows, graphP.cols, graphP.vals,
                    devices=list(graphP.grid.devices))
                grad_fn = make_grad(graphP)
            tree = checkpoint.restore(
                ckpt_dir, last, {"W": params[0], "a1": params[1],
                                 "a2": params[2]})
            params = tuple(tree[k] for k in ("W", "a1", "a2"))
            start = last
            if verbose:
                print(f"gat: resumed step {last} on "
                      f"{graphP.alg.name} p={graphP.p}")

    def on_failure(attempt, e):
        nonlocal graphP, grad_fn
        e = faults.unwrap(e)
        session.invalidate(graphP)
        if isinstance(e, faults.DeviceLost):
            graphP = api.degrade(graphP, e.rank)
            grad_fn = make_grad(graphP)
            if verbose:
                print(f"gat: lost rank {e.rank} -> re-planned onto "
                      f"{graphP.alg.name} p={graphP.p}")

    hist = []
    for it in range(start, steps):
        def step(params):
            if monitor is not None:
                return monitor.timed(it, grad_fn, params)
            return grad_fn(params)

        loss, gparams = elastic.run_step_resilient(
            step, None, None, params, max_retries=max_retries,
            on_failure=on_failure)
        params = tuple(p - lr * g for p, g in zip(params, gparams))
        hist.append(float(loss))
        if verbose:
            print(f"gat[{graphP.alg.name}] step {it}: loss {hist[-1]:.5f}")
        if ckpt_dir is not None and (it + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, it + 1,
                            {"W": params[0], "a1": params[1],
                             "a2": params[2]}, meta=graphP.meta_dict())
    return params, hist
