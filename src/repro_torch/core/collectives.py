"""Stacked collectives: the p ranks of a grid in one process.

Stands in for the ``jax.lax`` collectives of the reference's
``shard_map`` bodies.  Every distributed tensor carries leading
``(L, c)`` rank axes (``Grid15.stack``), and each collective is a fixed
tensor operation on them:

  shift        ``ppermute`` i -> i+1 over "layer": a roll of axis 0
  all_gather   tiled over "fiber": (L, c, rows, r) -> every rank holds
               its layer's (c * rows, r) block (a broadcast view)
  psum_scatter tiled over "fiber": the c partials of each layer summed
               in fiber order 0..c-1, then split back into c row blocks

Every call appends one :class:`Event` to ``log`` with the words one
device receives (all_gather, shift) or sends (psum_scatter) -- the
quantities ``d15.schedule_words`` models per event.  Results do not
depend on the issue order, so an overlapped schedule equals its serial
form bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str      # "collective-permute" | "all-gather" | "reduce-scatter"
    axis: str      # "layer" | "fiber"
    words: float   # per-device words on the wire


class Stacked:
    """The stacked collective backend of one grid, with its event log."""

    def __init__(self, grid):
        self.grid = grid
        self.log: List[Event] = []

    def _note(self, kind: str, axis: str, words: int) -> None:
        self.log.append(Event(kind, axis, float(words)))

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Cyclic shift over "layer": rank (u, v) receives (u-1, v)'s."""
        self._note("collective-permute", self.grid.layer,
                   x[0, 0].numel())
        if self.grid.L == 1:
            return x
        return torch.roll(x, shifts=1, dims=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all-gather over "fiber": (L, c, rows, r) -> (L, c, c*rows,
        r), every fiber rank of a layer holding the same block."""
        L, c = self.grid.L, self.grid.c
        self._note("all-gather", self.grid.fiber,
                   (c - 1) * x[0, 0].numel())
        full = x.reshape(L, 1, c * x.shape[2], *x.shape[3:])
        return full.expand(L, c, *full.shape[2:])

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled reduce-scatter over "fiber": (L, c, c*rows, r) partials ->
        (L, c, rows, r), summed in fiber order."""
        L, c = self.grid.L, self.grid.c
        rows = x.shape[2] // c
        self._note("reduce-scatter", self.grid.fiber,
                   (c - 1) * rows * x[0, 0].shape[1:].numel())
        if c == 1:
            return x
        acc = x[:, 0]
        for v in range(1, c):
            acc = acc + x[:, v]
        return acc.reshape(L, c, rows, *x.shape[3:])

    def words(self):
        """Per-event (kind, words) in issue order."""
        return [(e.kind, e.words) for e in self.log]
