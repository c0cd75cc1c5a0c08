"""Tensor parallelism over a mesh's ``model`` axis (Megatron-style).

The port's execution of ``models.model.param_specs`` under a mesh with
``model > 1`` (``launch/mesh.py``; ``ParallelConfig.dp_over_model``
makes that axis data parallelism instead, and then nothing here runs).
:func:`shard_model` keeps this rank's shard of every leaf the sanitized
specs split (``sharding.sanitize_tree``), along its one split dimension
(``Parameter.tp_dim``), and under FSDP its data-axis shard of that
(``distributed/fsdp.py``); :func:`full_tree` gathers the full leaves
back onto the host over both axes, one at a time, and
:func:`local_leaf` slices a full leaf to a rank's shard.

The layers run their products on shards between two conjugate
operators on the model group (:class:`TP`):

* *f* (:meth:`TP.copy`): identity forward, sum backward -- where a
  replicated tensor enters a computation that differs by rank;
* *g* (:meth:`TP.reduce`): sum forward, identity backward -- where the
  ranks' partial products become one replicated tensor.

Every sum over the group all-gathers the ranks' parts and adds them in
rank order (as ``training.train_step.ordered_sum`` does over the data
group), so every rank holds the same bits and two runs are equal.  On a
group of one (:data:`ONE`) the operators are identities: the training
forward of one process's whole leaves is the same code
(``models.model._forward_tp``).

A layer's input is an :class:`Entry` (:meth:`TP.enter`): ``rep`` feeds
the consumers that compute the same thing on every rank (a router, a
replicated projection), ``par`` those that differ by rank (a
column-parallel product); the backward adds the second's summed
gradient to the first's.  A layer's output is a partial sum (``g``
applies) and/or a replicated tensor, which :meth:`TP.exit` adds.

A serving forward's cache leaves split over the group carry their
dimension as a shard does (:func:`placed`; :func:`full_cache` gathers
them), and a decode step over blocks of cached positions adds the ranks'
softmax shares in rank order (:meth:`TP.softmax_combine`).

Under ``seq_parallel`` (Megatron-SP) the residual stream between two
layers holds this rank's ``S / m`` positions: :meth:`TP.enter` all-gathers
the sequence (its backward reduce-scatters), :meth:`TP.exit`
reduce-scatters the partial sum (its backward all-gathers).  Both keep
the rank order, and a norm's scale gradient is summed over the ``m``
sequence chunks in rank order with or without SP (:func:`rms_norm`), so
SP is bit for bit equal to TP without it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class TP:
    """The model group of one forward: ``size`` ranks, this one
    ``rank``, sequence parallel or not."""
    group: Any
    rank: int
    size: int
    seq: bool = False

    # -- collectives, every sum in rank order --------------------------
    def _parts(self, x):
        import torch.distributed as dist
        x = x.contiguous()
        if self.size == 1:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return parts

    def sum(self, x):
        """The group's sum of ``x``, added in rank order."""
        parts = self._parts(x)
        total = parts[0].clone()
        for q in parts[1:]:
            total += q
        return total

    def max(self, x):
        """The group's elementwise max of ``x`` (exact in any order)."""
        return torch.stack(self._parts(x)).amax(0)

    def cat(self, x, dim):
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        return torch.cat(self._parts(x), dim=dim)

    def sum_chunk(self, x, dim):
        """This rank's chunk (of ``size``) along ``dim`` of the group's
        sum of ``x``: the chunks exchanged all to all, added in rank
        order (the same bits as ``self.sum(x)``'s chunk)."""
        import torch.distributed as dist
        chunks = torch.stack([c.contiguous() for c in
                              x.chunk(self.size, dim=dim)])
        got = torch.empty_like(chunks)
        dist.all_to_all_single(got, chunks, group=self.group)
        total = got[0].clone()
        for q in got[1:]:
            total += q
        return total

    def chunk(self, x, dim):
        return x.chunk(self.size, dim=dim)[self.rank]

    def all_to_all(self, x, split_dim, cat_dim):
        """Chunk ``j`` of ``x`` along ``split_dim`` to rank ``j``; the
        chunks this rank receives, concatenated along ``cat_dim`` in rank
        order."""
        if self.size == 1:
            return x
        import torch.distributed as dist
        chunks = torch.stack([c.contiguous() for c in
                              x.chunk(self.size, dim=split_dim)])
        got = torch.empty_like(chunks)
        dist.all_to_all_single(got, chunks, group=self.group)
        return torch.cat(list(got), dim=cat_dim)

    def softmax_combine(self, m, l, acc):
        """Attention over the group's blocks of keys from each rank's
        share: its row max ``m``, sum of exponentials ``l`` (..., H) and
        exponential-weighted values ``acc`` (..., H, dv), all gathered and
        rescaled to the group's max, then added in rank order (the same
        bits on every rank and in every run; no atomics).  Returns the
        attention output (..., H, dv) in float32."""
        parts = self._parts(torch.cat([m[..., None], l[..., None], acc],
                                      -1).float())
        top = parts[0][..., 0]
        for q in parts[1:]:
            top = torch.maximum(top, q[..., 0])
        den = num = None
        for q in parts:
            w = torch.exp(q[..., 0] - top)
            dl, da = q[..., 1] * w, q[..., 2:] * w[..., None]
            den = dl if den is None else den + dl
            num = da if num is None else num + da
        return num / torch.clamp_min(den, 1e-30)[..., None]

    # -- the operators (identities on a group of one) ------------------
    def copy(self, x):
        """*f*: identity forward, the group's sum backward."""
        return x if self.size == 1 else _Copy.apply(x, self)

    def reduce(self, x):
        """*g*: the group's sum forward, identity backward."""
        return x if self.size == 1 else _Reduce.apply(x, self)

    def gather(self, x, dim):
        """This rank's part of a tensor split along ``dim`` -> the whole,
        replicated (its consumers compute the same on every rank, so the
        backward keeps this rank's part of the gradient)."""
        return x if self.size == 1 else _Gather.apply(x, self, dim)

    def split(self, x, dim):
        """A replicated tensor -> this rank's part along ``dim`` (the
        backward all-gathers)."""
        return x if self.size == 1 else _Split.apply(x, self, dim)

    def weight(self, w):
        """The whole of leaf ``w`` (gathered along ``w.tp_dim`` if it is
        a shard), for a product computed the same on every rank."""
        dim = shard_dim(w)
        return w if dim is None else self.gather(w, dim)

    def enter(self, x) -> "Entry":
        """A layer's input from the residual stream (its positions under
        ``seq``)."""
        if self.size == 1:
            return Entry(x, x)
        rep, par = _Enter.apply(x, self)
        return Entry(rep, par)

    def exit(self, partial=None, replicated=None):
        """A layer's output onto the residual stream: ``partial`` summed
        over the group (``g``; reduce-scattered over the sequence under
        ``seq``), plus ``replicated`` (this rank's positions under
        ``seq``)."""
        out = None
        if partial is not None:
            out = (_ReduceSeq.apply(partial, self) if self.seq
                   and self.size > 1 else self.reduce(partial))
        if replicated is not None:
            rep = self.split(replicated, 1) if self.seq else replicated
            out = rep if out is None else out + rep
        return out


#: the group of one rank: the forward of one process's whole leaves
ONE = TP(None, 0, 1)


class Entry(NamedTuple):
    """A layer's input: the same values twice, ``rep`` for consumers
    that compute the same on every rank, ``par`` (*f* applied) for those
    that differ by rank."""
    rep: torch.Tensor
    par: torch.Tensor


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.cat(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.chunk(g, ctx.dim).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.chunk(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.cat(g, ctx.dim), None, None


class _Enter(torch.autograd.Function):
    """x -> (rep, par); under ``seq`` x is this rank's positions and
    both outputs the whole sequence.  Backward: the group's sum of
    ``par``'s gradient (this rank's chunk under ``seq``) plus ``rep``'s
    (its chunk under ``seq``)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        full = tp.cat(x, 1) if tp.seq else x
        return full.view_as(full), full.view_as(full)

    @staticmethod
    def backward(ctx, g_rep, g_par):
        tp = ctx.tp
        out = None
        if g_par is not None:
            out = (tp.sum_chunk(g_par, 1) if tp.seq else tp.sum(g_par))
        if g_rep is not None:
            rep = tp.chunk(g_rep, 1) if tp.seq else g_rep
            out = rep if out is None else out + rep
        return out, None


class _ReduceSeq(torch.autograd.Function):
    """Partial sums -> this rank's chunk of positions of their sum
    (reduce-scatter in rank order); backward all-gathers."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.sum_chunk(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.cat(g, 1), None


class _ScaleRows(torch.autograd.Function):
    """``n * scale`` over rows (..., S, d) whose scale gradient is summed
    over the group's ``size`` chunks of positions in rank order: locally
    (the whole sequence) or over the group (its chunk under ``seq``)."""

    @staticmethod
    def forward(ctx, n, scale, tp):
        ctx.tp = tp
        ctx.save_for_backward(n, scale)
        return n * scale

    @staticmethod
    def backward(ctx, g):
        n, scale = ctx.saved_tensors
        tp = ctx.tp
        prod = g * n
        lead = tuple(range(prod.dim() - 1))
        if tp.seq:
            dscale = tp.sum(prod.sum(dim=lead))
        else:
            parts = [c.contiguous().sum(dim=lead)
                     for c in prod.chunk(tp.size, dim=1)]
            dscale = parts[0]
            for q in parts[1:]:
                dscale = dscale + q
        return g * scale, dscale, None


def rms_norm(x, scale, eps, tp: TP):
    """``layers.rms_norm`` on the residual stream under ``tp``: the same
    forward, the scale's gradient summed over the sequence chunks in
    rank order (module docstring)."""
    from repro_torch.models import layers
    if tp.size == 1 or (not tp.seq and x.shape[1] % tp.size):
        return layers.rms_norm(x, scale, eps)
    return _ScaleRows.apply(layers.rms_normalize(x, eps), scale.float(),
                            tp).to(x.dtype)


# ---------------------------------------------------------------------------
# which forward runs tensor parallel
# ---------------------------------------------------------------------------

def of_mesh(mesh, pcfg) -> Optional[TP]:
    """The model group of ``mesh``, or None where the forward runs on one
    rank's whole leaves: no mesh, a model axis of one, or
    ``dp_over_model``."""
    if mesh is None or pcfg.dp_over_model:
        return None
    m = mesh.axis_sizes.get(pcfg.model_axis, 1)
    if m == 1:
        return None
    rank = mesh.coords[list(mesh.axis_names).index(pcfg.model_axis)]
    return TP(mesh.model_group, int(rank), int(m), bool(pcfg.seq_parallel))


def active(pcfg) -> Optional[TP]:
    """:func:`of_mesh` of the installed mesh (``sharding.set_mesh``)."""
    return of_mesh(sharding.current_mesh(), pcfg)


def shard_dim(w) -> Optional[int]:
    """The dimension leaf ``w`` is split along over the model group
    (None: whole)."""
    return getattr(w, "tp_dim", None)


def split_dims(cfg, pcfg, model, mesh) -> dict:
    """``{name: the dimension split over the model axis, or None}`` from
    the sanitized ``param_specs`` on the model's whole leaves (the rules
    split one dimension at most)."""
    from repro_torch.models import model as M
    named = dict(model.named_parameters())
    specs = sharding.sanitize_tree(M.param_specs(cfg, pcfg, model), named,
                                   mesh.axis_sizes)
    return {n: next((i for i, e in enumerate(spec) if e == pcfg.model_axis),
                    None) for n, spec in specs.items()}


def local_part(full, dim: Optional[int], rank: int, size: int):
    """Rank ``rank``'s shard (of ``size``) of ``full`` along ``dim``."""
    if dim is None:
        return full
    n = full.shape[dim] // size
    return full.narrow(dim, rank * n, n)


def placement(cfg, pcfg, model, mesh, fsdp: bool = False) -> dict:
    """``{name: (dimension split over the model axis, over the data
    axis)}``, each None where that axis does not split the leaf: the
    model axis where it runs tensor parallel (:func:`split_dims`), the
    data axis under ``fsdp`` (``sharding.fsdp_dims``; never the same
    dimension).  ``model`` holds whole leaves (the meta device will
    do)."""
    from repro_torch.distributed import fsdp as fsdp_mod
    tp = of_mesh(mesh, pcfg)
    fs = fsdp_mod.of_mesh(mesh, pcfg) if fsdp else None
    tdims = split_dims(cfg, pcfg, model, mesh) if tp is not None else {}
    fdims = (sharding.fsdp_dims(cfg, pcfg, model, mesh) if fs is not None
             else {})
    return {n: (tdims.get(n), fdims.get(n))
            for n, _ in model.named_parameters()}


def local_leaf(full, dims, tp: Optional[TP], fs: Optional[TP]):
    """This rank's shard of ``full`` over both axes (``dims`` as
    :func:`placement` gives them; ``tp``/``fs`` the model and data
    groups): a copy, or ``full`` itself where nothing splits it."""
    td, fd = dims
    x = full
    if td is not None:
        x = local_part(x, td, tp.rank, tp.size)
    if fd is not None:
        x = local_part(x, fd, fs.rank, fs.size)
    return full if x is full else x.clone()


def mark(model, dims, tp: Optional[TP], fs: Optional[TP]):
    """Record the placement on ``model`` whose leaves hold their shards:
    ``tp_dim``/``fsdp_dim`` on each split leaf, ``tp_shards`` and
    ``fsdp_shards`` ((ranks, this rank) or None) on the model."""
    for name, p in model.named_parameters():
        td, fd = dims[name]
        if td is not None:
            p.tp_dim = td
        if fd is not None:
            p.fsdp_dim = fd
    model.tp_shards = None if tp is None else (tp.size, tp.rank)
    model.fsdp_shards = None if fs is None else (fs.size, fs.rank)
    return model


@torch.no_grad()
def shard_model(cfg, pcfg, model, mesh, fsdp: bool = False):
    """Keep this rank's shard of every leaf the sanitized specs split
    over the model axis, and under ``fsdp`` over the data axis too
    (``distributed/fsdp.py``), in place (each a new ``Parameter``; the
    whole leaf is freed).  The model's weights are the one-rank model's,
    so an init from the seed then this slicing equals the one-card model
    bit for bit.  Returns the model."""
    from repro_torch.distributed import fsdp as fsdp_mod
    tp = of_mesh(mesh, pcfg)
    fs = fsdp_mod.of_mesh(mesh, pcfg) if fsdp else None
    if tp is None and fs is None:
        return model
    if getattr(model, "tp_shards", None) is not None or getattr(
            model, "fsdp_shards", None) is not None:
        raise ValueError("the model is sharded already")
    dims = placement(cfg, pcfg, model, mesh, fsdp)
    for name, d in dims.items():
        if d == (None, None):
            continue
        owner, leaf = _owner(model, name)
        full = getattr(owner, leaf)
        owner._parameters[leaf] = torch.nn.Parameter(
            local_leaf(full.data, d, tp, fs),
            requires_grad=full.requires_grad)
        del full
    return mark(model, dims, tp, fs)


def _owner(model, name):
    *path, leaf = name.split(".")
    owner = model
    for p in path:
        owner = getattr(owner, p)
    return owner, leaf


def check_sharded(model, tp: Optional[TP]) -> None:
    """Refuse a forward whose model's leaves do not match the group: a
    whole model under a model axis would run replicated in silence."""
    have = getattr(model, "tp_shards", None)
    want = None if tp is None else (tp.size, tp.rank)
    if have != want:
        raise ValueError(f"the model's leaves are sharded for {have} "
                         f"(model ranks, rank), the mesh runs {want}: "
                         f"use tensor_parallel.shard_model")


@torch.no_grad()
def full_leaf(x, dim: Optional[int], tp: Optional[TP]):
    """The whole leaf of ``x``, this rank's shard along ``dim`` (gathered
    over ``tp``'s group; ``x`` itself where it is whole)."""
    return x if dim is None or tp is None else tp.cat(x, dim)


def placed(x, dim: Optional[int]):
    """``x`` marked as this rank's part of a cache leaf split along
    ``dim`` over the model group (``shard_dim`` reads it); ``x`` itself
    where ``dim`` is None."""
    if dim is not None:
        x.tp_dim = dim
    return x


@torch.no_grad()
def full_cache(cache, tp: Optional[TP]):
    """``cache`` with every leaf that the model group splits
    (``placed``) gathered whole along its dimension, in rank order: this
    data rank's rows of the whole cache (every rank of ``tp`` takes
    part)."""
    if isinstance(cache, dict):
        return {k: full_cache(v, tp) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(full_cache(v, tp) for v in cache)
    return full_leaf(cache, shard_dim(cache), tp)


def fsdp_dim(w) -> Optional[int]:
    """The dimension leaf ``w`` is split along over the data group (None:
    whole over it)."""
    return getattr(w, "fsdp_dim", None)


def _to_host(group, x, dim, keep):
    """The group's parts of ``x`` concatenated along ``dim`` on the host
    (None where not ``keep``); the card holds the parts until they are
    copied."""
    parts = group._parts(x)
    host = [q.cpu() for q in parts] if keep else None
    del parts
    return torch.cat(host, dim) if keep else None


@torch.no_grad()
def full_tree(model, opt_state, mesh, keep: bool = True):
    """The checkpointed tree (``launch.train.train_tree``'s layout) with
    every leaf whole, on the host (None where not ``keep``).  Every rank
    of ``mesh`` takes part (the gathers are collectives: over the data
    group first where FSDP splits a leaf, then over the model group),
    one leaf at a time: a card holds one whole leaf at most beside its
    shards, and frees it before the next."""
    tps = getattr(model, "tp_shards", None)
    fss = getattr(model, "fsdp_shards", None)
    tp = None if tps is None else TP(mesh.model_group, tps[1], tps[0])
    fs = None if fss is None else TP(mesh.data_group, fss[1], fss[0])
    params = dict(model.named_parameters())
    dims = {n: (shard_dim(p), fsdp_dim(p)) for n, p in params.items()}

    def whole(name, x):
        td, fd = dims[name]
        if fd is not None and td is None:
            return _to_host(fs, x, fd, keep)
        if fd is not None:
            x = fs.cat(x, fd)
        if td is None:
            return x.detach().cpu() if keep else None
        return _to_host(tp, x, td, keep)
    out = {"params": {n: whole(n, p) for n, p in params.items()},
           "opt": {k: {n: whole(n, v) for n, v in opt_state[k].items()}
                   for k in ("mu", "nu")}}
    out["opt"]["step"] = opt_state["step"].cpu()
    return out if keep else None


def full_shapes(model, opt_state):
    """:func:`full_tree`'s structure with zero-stride numpy leaves of the
    whole shapes: a restore target that holds no memory."""
    import numpy as np
    tsize = (getattr(model, "tp_shards", None) or (1, 0))[0]
    fsize = (getattr(model, "fsdp_shards", None) or (1, 0))[0]

    def like(x, dims):
        shape = list(x.shape)
        for dim, size in zip(dims, (tsize, fsize)):
            if dim is not None:
                shape[dim] *= size
        dt = np.dtype(str(x.dtype).replace("torch.", ""))
        return np.broadcast_to(np.zeros((), dt), shape)
    params = dict(model.named_parameters())
    dims = {n: (shard_dim(p), fsdp_dim(p)) for n, p in params.items()}
    out = {"params": {n: like(p, dims[n]) for n, p in params.items()},
           "opt": {k: {n: like(v, dims[n])
                       for n, v in opt_state[k].items()}
                   for k in ("mu", "nu")}}
    out["opt"]["step"] = like(opt_state["step"], (None, None))
    return out
