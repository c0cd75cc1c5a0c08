"""Stacked collectives: the p ranks of a grid in one process.

Stands in for the ``jax.lax`` collectives of the reference's
``shard_map`` bodies.  Every distributed tensor carries the grid's rank
axes in front (``grid.shape``: ``(L, c)`` for ``Grid15``, ``(G, G, c)``
for ``Grid25``, "fiber" always last), and each collective is a fixed
tensor operation on them:

  shift        ``ppermute`` over one rank axis: a roll of its dimension,
               i -> i+1, or i -> i-1 with ``back=True`` (Cannon)
  all_gather   tiled over "fiber": every fiber rank receives the c
               blocks of its fiber, stacked by rows (rank (.., z) holds
               rows z*rows..) or, with ``cols=True``, side by side by
               columns (a broadcast view over the fiber either way)
  psum_scatter tiled over "fiber": the c partials of each fiber summed
               in fiber order 0..c-1, then split back into c row blocks

Every call appends one :class:`Event` to ``log`` with the words one
device receives (all_gather, shift) or sends (psum_scatter) -- the
quantities the families' ``schedule_words`` model per event.  A schedule
event may move several tensors (a traveling pack and its partial dots,
a Cannon carry of structure and B chunk): the executors tag each move
with its schedule ``point``, and :meth:`Stacked.words` counts the moves
of one point as one event.  Results do not depend on the issue order,
so an overlapped schedule equals its serial form bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str      # "collective-permute" | "all-gather" | "reduce-scatter"
    axis: str      # the rank axis
    words: float   # per-device words on the wire
    point: Optional[Tuple[str, int]] = None   # schedule event it belongs to


class Stacked:
    """The stacked collective backend of one grid, with its event log."""

    def __init__(self, grid):
        self.grid = grid
        self.log: List[Event] = []

    def _note(self, kind: str, axis: str, words: int, point) -> None:
        self.log.append(Event(kind, axis, float(words), point))

    def _rank(self, x: torch.Tensor) -> torch.Tensor:
        """One rank's block of a stacked tensor."""
        return x[(0,) * self.grid.ndim]

    def shift(self, x: torch.Tensor, axis: str | None = None, *,
              back: bool = False, point=None) -> torch.Tensor:
        """Cyclic shift over ``axis`` (default: the grid's first): rank
        i receives rank i-1's block, or rank i+1's with ``back=True``."""
        axis = axis or self.grid.axes[0]
        d = self.grid.dim(axis)
        self._note("collective-permute", axis, self._rank(x).numel(), point)
        if x.shape[d] == 1:
            return x
        return torch.roll(x, shifts=-1 if back else 1, dims=d)

    def all_gather(self, x: torch.Tensor, *, cols: bool = False,
                   point=None) -> torch.Tensor:
        """Tiled all-gather over "fiber".  (..., c, rows, r) ->
        (..., c, c*rows, r), or with ``cols`` (..., c, rows, c*r): every
        fiber rank holding the same block."""
        nd, c = self.grid.ndim, self.grid.c
        self._note("all-gather", self.grid.fiber,
                   (c - 1) * self._rank(x).numel(), point)
        front = x.shape[:nd - 1]
        if cols:
            full = x.movedim(nd - 1, nd).reshape(
                *front, 1, x.shape[nd], c * x.shape[nd + 1])
        else:
            full = x.reshape(*front, 1, c * x.shape[nd], *x.shape[nd + 1:])
        return full.expand(*front, c, *full.shape[nd:])

    def psum_scatter(self, x: torch.Tensor, *, point=None) -> torch.Tensor:
        """Tiled reduce-scatter over "fiber": (..., c, c*rows, r) partials
        -> (..., c, rows, r), summed in fiber order."""
        nd, c = self.grid.ndim, self.grid.c
        rows = x.shape[nd] // c
        self._note("reduce-scatter", self.grid.fiber,
                   (c - 1) * rows * self._rank(x).shape[1:].numel(), point)
        if c == 1:
            return x
        acc = x.select(nd - 1, 0)
        for v in range(1, c):
            acc = acc + x.select(nd - 1, v)
        return acc.reshape(*x.shape[:nd], rows, *x.shape[nd + 1:])

    def words(self):
        """Per-event (kind, words) in issue order; the moves tagged with
        one schedule point count as one event, where the first was."""
        out, at = [], {}
        for e in self.log:
            if e.point is not None and e.point in at:
                kind, w = out[at[e.point]]
                out[at[e.point]] = (kind, w + e.words)
                continue
            if e.point is not None:
                at[e.point] = len(out)
            out.append((e.kind, e.words))
        return out


def stacked(grid, coll: Stacked | None = None) -> Stacked:
    """The caller's collective backend, else a fresh one for ``grid``."""
    return coll if coll is not None else Stacked(grid)


class Ring:
    """The traveling operand of one round of phases.

    ``cur`` is the operand of the current phase; :meth:`advance` moves to
    the next with ``move(x, k)``, the round's k-th shift.  At most
    ``n_shifts`` shifts are issued: one fewer than the phases when the
    round's final position is dead, as many when the operand must come
    home.  ``overlap`` issues each shift one phase ahead (before the
    kernel that reads the current operand), as the reference's double
    buffer does; on one stream that changes the order, not the result.
    """

    def __init__(self, move: Callable, x, n_shifts: int, overlap: bool):
        self.move, self.n, self.overlap = move, n_shifts, overlap
        self.issued = 0
        self.cur = x
        self.nxt = self._shift(x) if overlap else None

    def _shift(self, x):
        if x is None or self.issued >= self.n:
            return None
        self.issued += 1
        return self.move(x, self.issued - 1)

    def advance(self):
        if self.overlap:
            self.cur = self.nxt
            self.nxt = self._shift(self.nxt)
        else:
            self.cur = self._shift(self.cur)


def cannon_ring(coll: Stacked, x, axis: str, n_shifts: int, *,
                overlap: bool = False, start: int = 0) -> Ring:
    """A tensor traveling back (i -> i-1) along ``axis``, as the 2.5D
    Cannon rounds move them; its k-th shift is the schedule's shift
    event ``start + k``."""
    return Ring(lambda y, k: coll.shift(y, axis, back=True,
                                        point=("shift", start + k)),
                x, n_shifts, overlap)


def on_ranks(grid, fn):
    """Stacked result(s) of ``fn(*rank)`` over every rank of ``grid``:
    the local kernels of one phase, one call per rank."""
    outs = [fn(*rank) for rank in grid.ranks()]
    if isinstance(outs[0], tuple):
        return tuple(_stack(grid, [o[i] for o in outs])
                     for i in range(len(outs[0])))
    return _stack(grid, outs)


def _stack(grid, outs):
    if len(outs) == 1:
        return outs[0].reshape(*grid.shape, *outs[0].shape)
    return torch.stack(outs).reshape(*grid.shape, *outs[0].shape)


def acc(total, contrib):
    """Running sum of per-phase contributions (the first starts it)."""
    return contrib if total is None else total + contrib
