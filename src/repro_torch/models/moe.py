"""Mixture-of-Experts with top-k routing, static capacity, shared experts.

Port of ``repro.models.moe``.  Dispatch is sort-free and static-shape:
(token, k)-assignments are ranked per expert with a cumulative-sum
position (drop on overflow -- standard capacity-factor semantics),
scattered to (E, C, d) expert buffers, run as one grouped matmul per
weight, and combined with the gate weights.  (The reference's
expert-parallel ``constrain`` on the buffers places nothing on one card
and is dropped.)

``dispatch="spmm"`` is the paper's integration point: the dispatch and
combine are sparse matrices, run through ``ops.spmm`` -- the Hopper SpMM
(``kernels/csrc/spmm.cu``) for tensors on the card, its plain version on
the CPU.  The reference packs each as one window of ``E*C`` (resp.
``T``) rows holding one block of all ``T*k`` entries, rows unsorted; the
kernels refuse that pack (a window's float32 accumulator must fit in
shared memory, and its blocks must be sorted by window).  The port packs
them as the kernels take them, on the card and with nothing read back
to the host, in windows of ``MOE_ROW_TILE`` rows:

* dispatch ``D`` (E*C, T), ``D[slot, t] = 1``: the kept slots are
  distinct, so sorting the assignments by slot is a scatter to position
  ``slot``; every row of ``E*C`` (padded up to a multiple of the row
  tile) gets one entry, of value 0 where no assignment landed, and each
  window is one block of ``MOE_ROW_TILE`` entries;
* combine ``G`` (T, E*C), ``G[t, slot] = gate``: the assignments in
  (token, k) order are already sorted by row, ``k`` entries a row
  (dropped ones of value 0); ``T`` is padded up to a multiple of the row
  tile and each window is one block of ``MOE_ROW_TILE * k`` entries.

The padded rows are sliced off the products.

Under autograd the two products are :class:`_DispatchSpMM` and
:class:`_CombineSpMM`, whose backward passes run on the same kernels
(the wrappers launch through ``ctypes`` into fresh tensors, which carry
no graph): dx = D^T dbuf is an SpMM on ``combine_pack``'s layout with
``keep`` as values; dy = G^T dout one on ``dispatch_pack``'s layout with
the gates as values; and d(gate)[t, j] = keep * <dout[t], y[slot]> one
SDDMM on the combine pattern with ``keep`` as values.  A forward and
backward launch 4 SpMM and 1 SDDMM, with a fixed sum order.

**Data parallelism** (``group=``, a ``torch.distributed`` group whose
ranks hold consecutive rows of one global batch, in rank order): the
routing is the global batch's.  The capacity is C = capacity_factor *
T_global * k / E, a token's place in its expert's queue counts the
tokens of the lower ranks (their per-expert counts are all-gathered
before routing), and the load-balancing loss each rank returns is its
share of the global one (its probability sums over T_global against the
global counts), so the ranks' shares sum to it.  Each rank's expert
buffers hold all E * C slots, its own filled.

**Expert parallelism** over the mesh's ``model`` axis (:func:`moe_tp`):
the expert weights are split on E, and rank r of m runs
:func:`moe_share`, its E/m experts on slots ``[r E/m C, (r+1) E/m C)``
(those rows of D, those columns of G, the same windows of MOE_ROW_TILE
rows); the shares are summed over the model group.  The whole layer is
the share of rank 0 of 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sparse import RowTiledCOO
from repro_torch.kernels import ops
from repro_torch.models.layers import Init, init_mlp, swiglu

#: rows of one output window of the MoE dispatch/combine packs (the bulk
#: SpMM keeps a window's float32 accumulator of 128 columns in 64 KiB)
MOE_ROW_TILE = 128


class MoE(nn.Module):
    """Router (d, E), expert weights w1, w3 (E, d, ff), w2 (E, ff, d),
    and the shared experts' MLP."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
        self.router = init.normal((d, E), 0.02)
        self.w1 = init.normal((E, d, ff), 0.02)
        self.w3 = init.normal((E, d, ff), 0.02)
        self.w2 = init.normal((E, ff, d), 0.02)
        if cfg.moe_shared:
            self.shared = init_mlp(init, d, cfg.moe_shared * ff)


def init_moe(init: Init, cfg) -> MoE:
    return MoE(init, cfg)


def _experts(p, buf):
    """The grouped SwiGLU over expert buffers (E, C, d)."""
    h = torch.bmm(buf, p.w1.to(buf.dtype))
    g = torch.bmm(buf, p.w3.to(buf.dtype))
    h = h * F.silu(g.float()).to(buf.dtype)
    return torch.bmm(h, p.w2.to(buf.dtype))


def _shared(p, xf, tp):
    """The shared experts on tokens ``xf`` (T, d), computed the same on
    every rank of ``tp`` (their leaves gathered whole where split)."""
    s = p.shared
    return swiglu(xf[None], tp.weight(s.w1), tp.weight(s.w3),
                  tp.weight(s.w2))[0]


def _world(group) -> int:
    """Ranks of the data-parallel ``group`` (None: this process alone)."""
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def _global_counts(counts, group):
    """(assignments of the lower ranks per expert, of all ranks) from
    each rank's per-expert ``counts`` (E,), all-gathered over
    ``group``."""
    if group is None:
        return torch.zeros_like(counts), counts
    import torch.distributed as dist
    world = dist.get_world_size(group)
    parts = [torch.empty_like(counts) for _ in range(world)]
    dist.all_gather(parts, counts, group=group)
    rank = dist.get_rank(group)
    lower = torch.zeros_like(counts)
    for part in parts[:rank]:
        lower = lower + part
    total = torch.zeros_like(counts)
    for part in parts:
        total = total + part
    return lower, total


def route(cfg, p, xf, group=None):
    """Top-k routing of tokens ``xf`` (T, d) with static capacity.

    The router runs in float32; the gates are renormalised over the top
    k.  Returns ``(probs, gate_i, gate_v, slot, keep, C, counts)``: each
    (token, k)-assignment's expert, gate and slot ``expert * C + rank``
    (the rank in its expert's queue by an exclusive cumulative sum,
    clipped to C-1), whether it is kept (rank < C), and the global
    batch's assignments per expert.  Under ``group`` the tokens are this
    rank's share of the global batch (see the module docstring).
    """
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = xf.shape[0]
    logits = xf.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = torch.topk(probs, k, dim=-1)       # (T, k)
    gate_v = gate_v / torch.clamp_min(gate_v.sum(-1, keepdim=True), 1e-9)
    flat = F.one_hot(gate_i, E).reshape(T * k, E)
    lower, counts = _global_counts(flat.sum(0), group)
    C = int(cfg.capacity_factor * T * _world(group) * k / E) or 1
    ranks = torch.cumsum(flat, dim=0) - flat                  # exclusive
    rank = (ranks * flat).sum(-1).reshape(T, k) + lower[gate_i]
    keep = rank < C
    slot = gate_i * C + torch.clamp_max(rank, C - 1)          # (T, k)
    return probs, gate_i, gate_v, slot, keep, C, counts


def moe(cfg, pcfg, p, x, dispatch: str = "einsum", group=None):
    """x (B, S, d) -> (B, S, d).  Also returns aux losses dict.  Under
    ``group`` x is this rank's rows of the global batch and ``lb_loss``
    its share of the global loss (module docstring).  The whole layer:
    :func:`moe_tp` on a group of one."""
    from repro_torch.distributed import tensor_parallel as tpm
    (_, out), aux = moe_tp(cfg, pcfg, p, tpm.ONE.enter(x), tpm.ONE,
                           dispatch, group)
    return out, aux


def _aux(cfg, probs, counts, group):
    """The load-balancing auxiliary loss (Switch-style)."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    T_all = probs.shape[0] * _world(group)
    me = probs.sum(0) / T_all
    ce = counts.float() / (T_all * k)
    return {"lb_loss": E * torch.sum(me * ce)}


def moe_share(cfg, p, xf, gate_v, slot, keep, C, rank: int, m: int,
              dispatch: str = "einsum"):
    """Expert parallelism's share of rank ``rank`` of ``m``: the routed
    output (T, d) of its ``E / m`` experts, whose weights ``p.w1``,
    ``p.w3``, ``p.w2`` are (rows ``[rank E/m, (rank+1) E/m)`` of the
    whole).  The rank keeps only its experts' slots ``[lo, lo + E/m *
    C)``: those rows of the dispatch matrix D and those columns of the
    combine matrix G (an assignment elsewhere is dropped here, its gate
    0).  The ``m`` shares sum to the whole layer's routed output; ``m =
    1`` is the whole layer."""
    T, d = xf.shape
    k = slot.shape[1]
    Em = cfg.moe_experts // m
    rows = Em * C
    lo = rank * rows
    mine = keep & (slot >= lo) & (slot < lo + rows)
    local = torch.where(mine, slot - lo, 0)
    gates = (gate_v * mine).to(xf.dtype)
    if dispatch == "spmm":
        buf = _DispatchSpMM.apply(xf, local, mine, rows)
        y = _experts(p, buf.reshape(Em, C, d)).reshape(rows, d)
        return _CombineSpMM.apply(y, gates, local, mine)
    if dispatch != "einsum":
        raise ValueError(f"dispatch must be 'einsum' or 'spmm', got "
                         f"{dispatch!r}")
    # scatter tokens into expert buffers (rows, d); a dropped assignment
    # adds zeros at the last row
    tok_idx = torch.arange(T, device=xf.device)[:, None].expand(T, k)
    src = torch.where(mine.reshape(-1, 1), xf[tok_idx.reshape(-1)], 0.0)
    buf = torch.zeros((rows, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_add_(0, torch.where(mine, local, rows - 1).reshape(-1),
                         src)
    y = _experts(p, buf.reshape(Em, C, d)).reshape(rows, d)
    # combine in compute dtype
    return (y[local.reshape(-1)].reshape(T, k, d) * gates[..., None]).sum(1)


def moe_tp(cfg, pcfg, p, h, tp, dispatch: str = "einsum", group=None):
    """The MoE layer on the leaves' shards under ``tp`` (``h`` an
    ``Entry``): every model rank routes the same tokens with the
    replicated router (``group``: the data group, as in :func:`moe`),
    runs its own experts' share (:func:`moe_share`; its tokens and
    gates enter by *f*) and leaves it to the caller's *g*; the shared
    experts and ``lb_loss`` are computed the same on every rank (they
    count once).  Returns ``((partial, replicated), aux)``."""
    from repro_torch.distributed.tensor_parallel import shard_dim
    del pcfg
    B, S, d = h.rep.shape
    xr = h.rep.reshape(B * S, d)
    probs, gate_i, gate_v, slot, keep, C, counts = route(cfg, p, xr, group)
    aux = _aux(cfg, probs, counts, group)
    shared = None
    if cfg.moe_shared:
        shared = _shared(p, xr, tp).reshape(B, S, d)
    if shard_dim(p.w1) == 0:
        part = moe_share(cfg, p, h.par.reshape(B * S, d), tp.copy(gate_v),
                         slot, keep, C, tp.rank, tp.size, dispatch)
        return (part.reshape(B, S, d), shared), aux
    out = moe_share(cfg, p, xr, gate_v, slot, keep, C, 0, 1, dispatch)
    out = out.reshape(B, S, d)
    return (None, out if shared is None else out + shared), aux


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def dispatch_pack(slot, keep, T: int, m: int, dtype, gates=None):
    """The dispatch matrix D (m = E*C, T), ``D[slot, t] = 1`` for each
    kept assignment (``gates``, shaped as ``slot``: those values in place
    of ones -- G^T), as a RowTiledCOO of ``m`` rounded up to a multiple
    of MOE_ROW_TILE rows: window w is one block of MOE_ROW_TILE entries,
    entry i at row i (its token, or token 0 with value 0 where no
    assignment landed)."""
    row_tile = MOE_ROW_TILE
    dev = slot.device
    k = slot.shape[1]
    mp = _round_up(m, row_tile)
    nw = mp // row_tile
    pos = torch.where(keep, slot, mp).reshape(-1)   # dropped -> spare slot
    tok = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)
    cols = torch.zeros((mp + 1,), dtype=torch.int32, device=dev)
    cols.index_put_((pos,), tok)
    vals = torch.zeros((mp + 1,), dtype=dtype, device=dev)
    vals.index_put_((pos,), torch.ones((), dtype=dtype, device=dev)
                    if gates is None else gates.reshape(-1).to(dtype))
    rows_local = torch.arange(row_tile, dtype=torch.int32,
                              device=dev).repeat(nw).reshape(nw, row_tile)
    tile_base = torch.arange(0, mp, row_tile, dtype=torch.int32, device=dev)
    return RowTiledCOO(rows_local, cols[:mp].reshape(nw, row_tile),
                       vals[:mp].reshape(nw, row_tile), tile_base,
                       (mp, T), row_tile)


def combine_pack(slot, gates, m: int):
    """The combine matrix G (T, m = E*C), ``G[t, slot] = gate``, as a
    RowTiledCOO of ``T`` rounded up to a multiple of MOE_ROW_TILE rows:
    window w is one block of ``MOE_ROW_TILE * k`` entries in (token, k)
    order (the padded tokens' entries are slot 0 with value 0).  With
    ``keep`` as the gates it is D^T."""
    row_tile = MOE_ROW_TILE
    dev = slot.device
    T, k = slot.shape
    Tp = _round_up(T, row_tile)
    nw = Tp // row_tile
    cols = torch.zeros((Tp * k,), dtype=torch.int32, device=dev)
    cols[:T * k] = slot.reshape(-1)
    vals = torch.zeros((Tp * k,), dtype=gates.dtype, device=dev)
    vals[:T * k] = gates.reshape(-1)
    rows_local = torch.arange(row_tile, dtype=torch.int32,
                              device=dev).repeat_interleave(k).repeat(nw)
    tile_base = torch.arange(0, Tp, row_tile, dtype=torch.int32, device=dev)
    bk = row_tile * k
    return RowTiledCOO(rows_local.reshape(nw, bk), cols.reshape(nw, bk),
                       vals.reshape(nw, bk), tile_base, (Tp, m), row_tile)


def _spmm(S: RowTiledCOO, B, rows: int):
    """The first ``rows`` rows of S @ B on the port's SpMM (``r_tile``
    and ``blocks_per_step`` given, so ``ops`` reads nothing back)."""
    B = B.contiguous()
    return ops.spmm(S, B, m=S.shape[0], r_tile=B.shape[-1],
                    blocks_per_step=1)[:rows]


class _DispatchSpMM(torch.autograd.Function):
    """buf = D @ xf (E*C rows); dxf = D^T @ dbuf."""

    @staticmethod
    def forward(ctx, xf, slot, keep, m):
        T = xf.shape[0]
        ctx.save_for_backward(slot, keep)
        ctx.m = m
        return _spmm(dispatch_pack(slot, keep, T, m, xf.dtype), xf, m)

    @staticmethod
    def backward(ctx, dbuf):
        slot, keep = ctx.saved_tensors
        DT = combine_pack(slot, keep.to(dbuf.dtype), ctx.m)
        return _spmm(DT, dbuf, slot.shape[0]), None, None, None


class _CombineSpMM(torch.autograd.Function):
    """out = G @ y (T rows), G[t, slot] = gates; dy = G^T @ dout and
    dgates[t, j] = keep * <dout[t], y[slot]> (an SDDMM on G's pattern;
    a dropped assignment's gate is 0 and gets no gradient)."""

    @staticmethod
    def forward(ctx, y, gates, slot, keep):
        T, m = slot.shape[0], y.shape[0]
        ctx.save_for_backward(y, gates, slot, keep)
        return _spmm(combine_pack(slot, gates, m), y, T)

    @staticmethod
    def backward(ctx, dout):
        y, gates, slot, keep = ctx.saved_tensors
        T, k = slot.shape
        m = y.shape[0]
        dout = dout.contiguous()
        dy = dgates = None
        if ctx.needs_input_grad[0]:
            GT = dispatch_pack(slot, keep, T, m, dout.dtype, gates=gates)
            dy = _spmm(GT, dout, m)
        if ctx.needs_input_grad[1]:
            pattern = combine_pack(slot, keep.to(dout.dtype), m)
            A = dout.new_zeros((pattern.shape[0], dout.shape[1]))
            A[:T] = dout
            dots = ops.sddmm(A, y.contiguous(), pattern, r_tile=y.shape[1],
                             blocks_per_step=1)
            dgates = dots.vals.reshape(-1)[:T * k].reshape(T, k).to(
                gates.dtype)
        return dy, dgates, None, None
