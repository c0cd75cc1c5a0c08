"""FSDP (ZeRO-3) over the mesh's ``data`` axis.

The port's execution of the reference's training placement
(``sharding.fsdp_specs``: ``fsdp_extend_tree`` over the data axis, as
``launch/dryrun.py`` places parameters and moments).  A leaf that the
placement splits holds this data rank's shard along ``fsdp_dim``
(``tensor_parallel.shard_model(..., fsdp=True)`` or the sharded init,
``models.model.init_sharded``); the model records ``fsdp_shards =
(data ranks, this rank)``.  Its AdamW moments are shards like it.

A forward reads a split leaf through :func:`gather`: the data group's
shards all-gathered and concatenated in rank order.  Its backward is the
ordered reduce-scatter: the gradient's chunks exchanged all to all and
the parts added in rank order (``TP.sum_chunk``), so a rank's gradient
shard equals, bit for bit, that rank's slice of what
``train_step.ordered_sum`` gives the whole leaf.  There are no float
atomics and no backend reduction order.  On a data group of one, or
for a leaf that is not split, every operator is the identity.

Each block gathers its leaves at its start (:func:`gathered`).  The
leaves outside the blocks (``embed``, ``head``, ``final_norm``) are
gathered where a forward first reads them, once a forward (:class:`Top`):
a tied embedding is gathered once and its gradient reduce-scattered
once.  A leaf split over both axes is gathered over the data group
first, which gives this rank's model-axis shard, and the
tensor-parallel code takes it from there (``tp_dim`` is kept).
"""
from __future__ import annotations

import types
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.tensor_parallel import TP


def of_mesh(mesh, pcfg) -> Optional[TP]:
    """The data group that FSDP splits leaves over (``TP``'s collectives
    on ``mesh.data_group``), or None where the data axis has one rank.
    Raises where the batch's ranks are not the data axis (a pod axis,
    ``dp_over_model`` on a model axis) and where a card's group is not
    NCCL's."""
    if mesh is None:
        return None
    n = mesh.axis_sizes.get(pcfg.data_axis, 1)
    if n == 1:
        return None
    if pcfg.pod_axis or (pcfg.dp_over_model
                         and mesh.axis_sizes.get(pcfg.model_axis, 1) > 1):
        raise NotImplementedError(
            "FSDP splits leaves over the data axis alone; a batch split "
            "over a pod or the model axis too is not executed")
    dev = getattr(mesh, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch.distributed as dist
        backend = dist.get_backend(mesh.data_group)
        if backend != "nccl":
            raise ValueError(f"FSDP on the card needs NCCL's data group, "
                             f"got {backend!r}")
    rank = mesh.coords[list(mesh.axis_names).index(pcfg.data_axis)]
    return TP(mesh.data_group, int(rank), int(n))


def check(model, group: Optional[TP]) -> None:
    """Refuse a forward whose model's shards do not match the mesh's
    data group."""
    have = getattr(model, "fsdp_shards", None)
    want = None if group is None else (group.size, group.rank)
    if have != want:
        raise ValueError(f"the model's leaves are FSDP-split for {have} "
                         f"(data ranks, rank), the mesh runs {want}")


class _Gather(torch.autograd.Function):
    """shard -> the data group's shards in rank order along ``dim``;
    backward: this rank's chunk of the group's gradient sum, added in
    rank order."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.cat(shard, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum_chunk(g, ctx.dim), None, None


def gather(w, group: Optional[TP]):
    """Leaf ``w`` whole over the data group (this rank's model-axis shard
    where it is split over both axes); ``w`` itself where it is not
    split."""
    dim = getattr(w, "fsdp_dim", None)
    if dim is None or group is None:
        return w
    out = _Gather.apply(w, group, dim)
    tp_dim = getattr(w, "tp_dim", None)
    if tp_dim is not None:
        out.tp_dim = tp_dim
    return out


def gathered(module, group: Optional[TP]):
    """``module``'s leaves as a block's forward reads them: a namespace
    of its structure, each split leaf gathered (``module`` itself
    without a group)."""
    if group is None:
        return module
    ns = types.SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        setattr(ns, name, gather(p, group))
    for name, child in module.named_children():
        setattr(ns, name, gathered(child, group))
    return ns


class Top:
    """A model as one forward reads it: its attributes, each split leaf
    gathered where first read and the same tensor at every later read."""

    def __init__(self, model, group: TP):
        self.model, self.group, self._got = model, group, {}

    def __getattr__(self, name):
        got = self.__dict__["_got"]
        if name not in got:
            v = getattr(self.__dict__["model"], name)
            got[name] = (gather(v, self.__dict__["group"])
                         if isinstance(v, torch.nn.Parameter) else v)
        return got[name]


def view(model, pcfg):
    """``model`` for one forward: itself where no leaf is FSDP-split,
    else a :class:`Top` on the installed mesh's data group
    (``sharding.set_mesh``), which must match the model's shards."""
    if isinstance(model, Top) or getattr(model, "fsdp_shards",
                                         None) is None:
        return model
    group = of_mesh(sharding.current_mesh(), pcfg)
    check(model, group)
    return Top(model, group)


def group_of(model) -> Optional[TP]:
    """The data group a :func:`view` gathers over (None: no FSDP)."""
    return model.group if isinstance(model, Top) else None
