"""Processor grids of the 1.5D and 2.5D algorithms over torch devices.

Port of ``repro.core.grid``: the paper's ``p`` processors with
replication factor ``c`` form named rank axes.

  1.5D: ("layer", "fiber") of shape (p/c, c)
        cyclic shifts run over "layer", replication collectives over
        "fiber".
  2.5D: ("row", "col", "fiber") of shape (sqrt(p/c), sqrt(p/c), c)
        Cannon shifts over "row"/"col", replication over "fiber".

A grid takes one of two forms, and the executors run unchanged on both
(``core/collectives.py`` has a backend for each):

* **stacked** (``group=None``): all p ranks live in one process on one
  device, and every distributed tensor carries the grid's rank axes in
  front (``grid.shape``, "fiber" last).  ``devices`` names one device p
  times (``[torch.device("cuda")] * 8`` runs an 8-rank schedule on one
  card; ``[torch.device("cpu")] * 8`` on the CPU).
* **distributed** (``group=`` a ``torch.distributed`` process group of p
  processes): this process is one rank, on its own device, and holds
  only its own blocks, which keep the grid's rank dimensions, each of
  size 1 (``local_shape``).  CUDA devices need the group's backend to be
  NCCL, CPU devices gloo.  Rank ``i`` of the group is grid rank
  ``i``, in row-major order over ``shape``.

Rank arithmetic is always on global coordinates (``ranks()`` yields the
ranks this process holds); :meth:`_Grid.at` turns a global rank tuple
into the index of its block in local storage.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core import device as _device

#: the process-group backend each device type needs (no fallback)
DIST_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class _Grid:
    """What both grids share: rank axes in front, stacked or one rank
    per process."""

    devices: Tuple[torch.device, ...]
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    group: Any
    rank: int
    global_ranks: Tuple[int, ...]
    fiber_group: Any

    @property
    def p(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device (the one device of a stacked grid)."""
        return self.devices[self.rank]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def coords(self) -> Tuple[int, ...]:
        """This process's rank tuple (``(0, ..)`` on a stacked grid)."""
        return tuple(int(i) for i in np.unravel_index(self.rank, self.shape))

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The rank dimensions of the blocks this process holds."""
        return self.shape if self.group is None else (1,) * self.ndim

    def dim(self, axis: str) -> int:
        """The tensor dimension of rank axis ``axis``."""
        return self.axes.index(axis)

    def all_ranks(self):
        """Every rank's index tuple of the grid, in row-major order."""
        return list(itertools.product(*(range(s) for s in self.shape)))

    def ranks(self):
        """The rank tuples this process holds: every rank of a stacked
        grid, its own one under a process group."""
        return self.all_ranks() if self.group is None else [self.coords]

    def held_coords(self, device):
        """Each rank axis's coordinate of the ranks this process holds, as
        index tensors of shape ``local_shape`` on ``device``."""
        held = torch.tensor(self.ranks(), device=device)
        return tuple(held[:, d].reshape(self.local_shape)
                     for d in range(self.ndim))

    def at(self, *rank) -> Tuple[int, ...]:
        """The local storage index of global rank ``rank``."""
        if self.group is None:
            return rank
        if rank != self.coords:
            raise ValueError(f"rank {rank} is not held here "
                             f"(this process is rank {self.coords})")
        return (0,) * self.ndim

    def local(self, x):
        """This process's share of a tensor (or numpy array) laid out
        with the grid's rank axes in front: all of it when stacked."""
        if self.group is None:
            return x
        return x[self.coords].reshape(*self.local_shape,
                                      *x.shape[self.ndim:])

    def stacked(self) -> "_Grid":
        """The stacked form of this grid on this process's device."""
        if self.group is None:
            return self
        return dataclasses.replace(self, devices=(self.device,) * self.p,
                                   group=None, rank=0, global_ranks=(),
                                   fiber_group=None)

    def global_rank(self, rank) -> int:
        """The process-group peer (global rank) of grid rank ``rank``."""
        return self.global_ranks[int(np.ravel_multi_index(rank,
                                                          self.shape))]

    def gather_stacked(self, x):
        """Every rank's block of ``x`` (a tensor in local storage, or a
        tuple of them), all-gathered into the stacked layout on every
        rank: a collective under a process group, ``x`` itself when
        stacked.  For checks and results, not for the executors."""
        if isinstance(x, (tuple, list)):
            return tuple(self.gather_stacked(a) for a in x)
        if self.group is None:
            return x
        import torch.distributed as dist
        blk = x.contiguous()
        parts = [torch.empty_like(blk) for _ in range(self.p)]
        dist.all_gather(parts, blk, group=self.group)
        return torch.cat(parts).reshape(*self.shape, *x.shape[self.ndim:])


@dataclasses.dataclass(frozen=True)
class Grid15(_Grid):
    devices: Tuple[torch.device, ...]
    c: int
    layer: str = "layer"
    fiber: str = "fiber"
    group: Any = dataclasses.field(default=None, compare=False)
    rank: int = 0
    global_ranks: Tuple[int, ...] = dataclasses.field(default=(),
                                                      compare=False)
    fiber_group: Any = dataclasses.field(default=None, compare=False)

    @property
    def L(self) -> int:
        return self.p // self.c

    @property
    def axes(self) -> Tuple[str, str]:
        return (self.layer, self.fiber)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.L, self.c)

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """(p * rows, ...) row-block sharded over (layer, fiber) ->
        (L, c, rows, ...), rank (u, v) holding row block u * c + v (this
        process's block under a process group)."""
        return self.local(x.reshape(self.L, self.c, x.shape[0] // self.p,
                                    *x.shape[1:]))

    def unstack(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`stack` on a stacked grid."""
        return x.reshape(self.p * x.shape[2], *x.shape[3:])


@dataclasses.dataclass(frozen=True)
class Grid25(_Grid):
    devices: Tuple[torch.device, ...]
    c: int
    row: str = "row"
    col: str = "col"
    fiber: str = "fiber"
    group: Any = dataclasses.field(default=None, compare=False)
    rank: int = 0
    global_ranks: Tuple[int, ...] = dataclasses.field(default=(),
                                                      compare=False)
    fiber_group: Any = dataclasses.field(default=None, compare=False)

    @property
    def G(self) -> int:
        return math.isqrt(self.p // self.c)

    @property
    def axes(self) -> Tuple[str, str, str]:
        return (self.row, self.col, self.fiber)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.G, self.G, self.c)


def _devices(c: int, devices, group):
    if group is not None:
        devices = _group_devices(devices, group)
    else:
        devices = [torch.device(d) for d in devices] \
            if devices is not None else [_device.resolve(None)]
    p = len(devices)
    if c < 1 or p % c:
        raise ValueError(f"replication factor c={c} must divide p={p}")
    if group is None and any(d != devices[0] for d in devices):
        raise NotImplementedError(
            "ranks on distinct devices run one per process over "
            "torch.distributed: pass group= (a process group of p "
            "processes) and each process's device; without a group every "
            "rank runs stacked on one device: pass one device p times")
    return tuple(devices)


def _group_devices(devices, group):
    """Each rank's device under ``group`` (default: this process's
    current card for every rank), checked against the group's backend."""
    import torch.distributed as dist
    p, rank = dist.get_world_size(group), dist.get_rank(group)
    if devices is None:
        own = _device.resolve(None)
        devices = [torch.device("cuda", torch.cuda.current_device())] * p \
            if own.type == "cuda" else [own] * p
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != p:
        raise ValueError(f"{len(devices)} devices for a process group of "
                         f"{p} ranks")
    want = DIST_BACKEND.get(devices[rank].type)
    have = dist.get_backend(group)
    if want is None or have != want:
        raise ValueError(f"rank {rank} on {devices[rank]} needs a {want} "
                         f"process group, got {have!r} (no fallback)")
    return devices


#: (process group, grid shape) -> this process's fiber subgroup, so grids
#: of one layout share their communicators instead of making new ones
_FIBER_GROUPS: dict = {}


def _fibers(shape, global_ranks):
    """(head coordinates, the fiber's global ranks) of each fiber of a
    grid of ``shape`` over ``global_ranks`` (row-major), in the order
    every process makes their subgroups."""
    ranks = np.asarray(global_ranks).reshape(shape)
    for head in itertools.product(*(range(s) for s in shape[:-1])):
        yield head, [int(g) for g in ranks[head]]


def shadow_fiber_groups(shape, global_ranks) -> None:
    """Take part, from a process outside the grid, in making the fiber
    subgroups of a grid of ``shape`` over ``global_ranks``: every process
    of the job enters ``new_group`` for each of them
    (``api.degrade`` under a process group)."""
    import torch.distributed as dist
    if shape[-1] > 1:
        for _, members in _fibers(shape, global_ranks):
            dist.new_group(members)


def _fiber_group(grid: _Grid):
    """This process's fiber subgroup of ``grid``: made once per (group,
    shape), every process building every fiber's in one order."""
    import torch.distributed as dist
    key = (grid.group, grid.shape)
    if key not in _FIBER_GROUPS:
        for head, members in _fibers(grid.shape, grid.global_ranks):
            sub = dist.new_group(members)
            if head == grid.coords[:-1]:
                if tuple(dist.get_process_group_ranks(sub)) != \
                        tuple(members):
                    raise ValueError("the fiber subgroup's rank order is "
                                     "not the fiber's")
                _FIBER_GROUPS[key] = sub
    return _FIBER_GROUPS[key]


def _join(grid: _Grid, group) -> _Grid:
    """``grid`` as this process's rank of ``group``: its fiber subgroup,
    and one all-reduce on each group so a backend that cannot start fails
    here."""
    import torch.distributed as dist
    glob = tuple(dist.get_process_group_ranks(group))
    grid = dataclasses.replace(grid, group=group,
                               rank=dist.get_rank(group), global_ranks=glob)
    fiber = _fiber_group(grid) if grid.c > 1 else None
    grid = dataclasses.replace(grid, fiber_group=fiber)
    for g in (group, fiber):
        if g is not None:
            dist.all_reduce(torch.zeros(1, device=grid.device), group=g)
    return grid


def make_grid15(c: int, devices=None, group=None) -> Grid15:
    """A (p/c, c) grid over ``devices`` (default: one CUDA device), or
    with ``group`` this process's rank of it (p = the group's size)."""
    grid = Grid15(_devices(c, devices, group), c)
    return grid if group is None else _join(grid, group)


def make_grid25(c: int, devices=None, group=None) -> Grid25:
    """A (G, G, c) grid over ``devices``, p = G^2 c (default: one CUDA
    device), or with ``group`` this process's rank of it."""
    devices = _devices(c, devices, group)
    p = len(devices)
    g = math.isqrt(p // c)
    if g * g * c != p:
        raise ValueError(f"p/c={p // c} must be a perfect square")
    grid = Grid25(devices, c)
    return grid if group is None else _join(grid, group)
