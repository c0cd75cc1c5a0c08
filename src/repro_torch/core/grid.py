"""Processor grid of the 1.5D algorithms over a list of torch devices.

Port of ``repro.core.grid``: the paper's ``p`` processors with
replication factor ``c`` form a ``("layer", "fiber")`` grid of shape
``(p/c, c)``.  Cyclic shifts run over "layer", replication collectives
over "fiber".

The port's collective layer is *stacked* (``core/collectives.py``): all
p ranks live in one process on one device, and every distributed tensor
carries leading ``(L, c)`` rank axes.  So ``devices`` must name one
device p times (``[torch.device("cuda")] * 8`` runs an 8-rank schedule
on one card; ``[torch.device("cpu")] * 8`` on the CPU).  Ranks on
distinct devices need the ``torch.distributed`` backend of a later
slice.  ``Grid25`` comes with the 2.5D families.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class Grid15:
    devices: Tuple[torch.device, ...]
    c: int
    layer: str = "layer"
    fiber: str = "fiber"

    @property
    def p(self) -> int:
        return len(self.devices)

    @property
    def L(self) -> int:
        return self.p // self.c

    @property
    def device(self) -> torch.device:
        """The one device every rank of the stacked grid lives on."""
        return self.devices[0]

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """(p * rows, ...) row-block sharded over (layer, fiber) ->
        (L, c, rows, ...); rank (u, v) holds row block u * c + v."""
        return x.reshape(self.L, self.c, x.shape[0] // self.p,
                         *x.shape[1:])

    def unstack(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`stack`."""
        return x.reshape(self.p * x.shape[2], *x.shape[3:])


def make_grid15(c: int, devices=None) -> Grid15:
    """A (p/c, c) grid over ``devices`` (default: one CUDA device)."""
    devices = [torch.device(d) for d in devices] if devices is not None \
        else [_device.resolve(None)]
    p = len(devices)
    if c < 1 or p % c:
        raise ValueError(f"replication factor c={c} must divide p={p}")
    if any(d != devices[0] for d in devices):
        raise NotImplementedError(
            "ranks on distinct devices need the torch.distributed "
            "collective backend (a later slice); the stacked backend runs "
            "every rank on one device: pass one device p times")
    return Grid15(tuple(devices), c)
