"""Processor grids of the 1.5D and 2.5D algorithms over torch devices.

Port of ``repro.core.grid``: the paper's ``p`` processors with
replication factor ``c`` form named rank axes.

  1.5D: ("layer", "fiber") of shape (p/c, c)
        cyclic shifts run over "layer", replication collectives over
        "fiber".
  2.5D: ("row", "col", "fiber") of shape (sqrt(p/c), sqrt(p/c), c)
        Cannon shifts over "row"/"col", replication over "fiber".

The port's collective layer is *stacked* (``core/collectives.py``): all
p ranks live in one process on one device, and every distributed tensor
carries the grid's rank axes in front (``grid.shape``, "fiber" last).
So ``devices`` must name one device p times (``[torch.device("cuda")] *
8`` runs an 8-rank schedule on one card; ``[torch.device("cpu")] * 8``
on the CPU).  Ranks on distinct devices need a ``torch.distributed``
backend, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Tuple

import torch

from repro_torch.core import device as _device


class _Stacked:
    """What both grids share: one device, rank axes in front."""

    devices: Tuple[torch.device, ...]
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def p(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every rank of the stacked grid lives on."""
        return self.devices[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self, axis: str) -> int:
        """The tensor dimension of rank axis ``axis``."""
        return self.axes.index(axis)

    def ranks(self):
        """Every rank's index tuple, in stacked (row-major) order."""
        return list(itertools.product(*(range(s) for s in self.shape)))


@dataclasses.dataclass(frozen=True)
class Grid15(_Stacked):
    devices: Tuple[torch.device, ...]
    c: int
    layer: str = "layer"
    fiber: str = "fiber"

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
        (L, c, rows, ...); rank (u, v) holds row block u * c + v."""
        return x.reshape(self.L, self.c, x.shape[0] // self.p,
                         *x.shape[1:])

    def unstack(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`stack`."""
        return x.reshape(self.p * x.shape[2], *x.shape[3:])


@dataclasses.dataclass(frozen=True)
class Grid25(_Stacked):
    devices: Tuple[torch.device, ...]
    c: int
    row: str = "row"
    col: str = "col"
    fiber: str = "fiber"

    @property
    def G(self) -> int:
        return math.isqrt(self.p // self.c)

    @property
    def axes(self) -> Tuple[str, str, str]:
        return (self.row, self.col, self.fiber)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.G, self.G, self.c)


def _devices(c: int, devices):
    devices = [torch.device(d) for d in devices] if devices is not None \
        else [_device.resolve(None)]
    p = len(devices)
    if c < 1 or p % c:
        raise ValueError(f"replication factor c={c} must divide p={p}")
    if any(d != devices[0] for d in devices):
        raise NotImplementedError(
            "ranks on distinct devices need the torch.distributed "
            "collective backend (not ported yet); the stacked backend runs "
            "every rank on one device: pass one device p times")
    return tuple(devices)


def make_grid15(c: int, devices=None) -> Grid15:
    """A (p/c, c) grid over ``devices`` (default: one CUDA device)."""
    return Grid15(_devices(c, devices), c)


def make_grid25(c: int, devices=None) -> Grid25:
    """A (G, G, c) grid over ``devices``, p = G^2 c (default: one CUDA
    device)."""
    devices = _devices(c, devices)
    g = math.isqrt(len(devices) // c)
    if g * g * c != len(devices):
        raise ValueError(f"p/c={len(devices) // c} must be a perfect "
                         f"square")
    return Grid25(devices, c)
