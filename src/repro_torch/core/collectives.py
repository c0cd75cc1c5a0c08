"""The collective layer of the executors: two backends, one interface.

Stands in for the ``jax.lax`` collectives of the reference's
``shard_map`` bodies.  Every distributed tensor carries the grid's rank
axes in front (``grid.shape``: ``(L, c)`` for ``Grid15``, ``(G, G, c)``
for ``Grid25``, "fiber" always last), with the blocks this process holds
(``grid.local_shape``).

:class:`Stacked` runs the p ranks of a grid in one process, and each
collective is a fixed tensor operation on the rank axes:

  permute      ``ppermute`` over one rank axis: rank i sends to rank
               i + offset (cyclic), a roll of the axis's dimension
  shift        the permute by +1, or by -1 with ``back=True`` (Cannon)
  all_gather   tiled over "fiber": every fiber rank receives the c
               blocks of its fiber, stacked by rows (rank (.., z) holds
               rows z*rows..) or, with ``cols=True``, side by side by
               columns (a broadcast view over the fiber either way)
  psum_scatter tiled over "fiber": the c partials of each fiber summed
               in fiber order 0..c-1, then split back into c row blocks

:class:`Dist` runs one rank per process over ``torch.distributed``
(NCCL across cards, gloo on the CPU) and gives each rank the same bits:
a permute is a point-to-point exchange with the partners at -offset and
+offset on the axis,
the all-gather ``all_gather_into_tensor`` on the fiber subgroup, and the
reduce-scatter an ``all_to_all_single`` followed by a local sum in fiber
order 0..c-1 (a reduce-scatter of the backend would not fix the order).

Every call appends one :class:`Event` to ``log`` with the words one
device receives (all_gather, permute) or sends (psum_scatter), in 4-byte
words of the payload's bytes (a bfloat16 payload counts half) -- the
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
    offset: Optional[int] = None   # a permute's: rank i sends to i + offset


class Backend:
    """The event log both backends keep, and the issue/wait pair of an
    overlapped move."""

    def __init__(self, grid):
        self.grid = grid
        self.log: List[Event] = []

    def _note(self, kind: str, axis: str, words: int, point,
              offset=None) -> None:
        self.log.append(Event(kind, axis, float(words), point, offset))

    def _rank(self, x: torch.Tensor) -> torch.Tensor:
        """One rank's block of a tensor in local storage."""
        return x[(0,) * self.grid.ndim]

    def issue(self, fn: Callable):
        """``(fn(), works)``: the moves ``fn`` makes, still in flight in
        ``works`` (none on the stacked backend); :meth:`wait` them before
        their results are read."""
        return fn(), ()

    def wait(self, works) -> None:
        del works

    def permute(self, x: torch.Tensor, axis: str, offset: int, *,
                point=None, then: Callable | None = None) -> torch.Tensor:
        """Rank i sends its block of ``x`` to rank i + offset on ``axis``
        (cyclic); returns what this rank receives.  ``then(arrived)``
        runs once the arrivals are in: at once, or, for a permute issued
        inside :meth:`issue`, when its works are waited (a receive
        buffer is not read before)."""
        raise NotImplementedError

    def shift(self, x: torch.Tensor, axis: str | None = None, *,
              back: bool = False, point=None) -> torch.Tensor:
        """Cyclic shift over ``axis`` (default: the grid's first): rank
        i receives rank i-1's block, or rank i+1's with ``back=True``."""
        return self.permute(x, axis or self.grid.axes[0], -1 if back else 1,
                            point=point)

    def _note_permute(self, x: torch.Tensor, axis: str, offset: int,
                      point) -> None:
        blk = self._rank(x)
        self._note("collective-permute", axis,
                   blk.numel() * blk.element_size() / 4, point, offset)

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


class Stacked(Backend):
    """The stacked collective backend of one grid, with its event log."""

    def permute(self, x: torch.Tensor, axis: str, offset: int, *,
                point=None, then: Callable | None = None) -> torch.Tensor:
        """A roll of the axis's dimension (see :meth:`Backend.permute`)."""
        d = self.grid.dim(axis)
        self._note_permute(x, axis, offset, point)
        if x.shape[d] > 1 and offset % x.shape[d]:
            x = torch.roll(x, shifts=offset, dims=d)
        if then is not None:
            then(x)
        return x

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
            # contiguous: at one column a slab the reshape would be a
            # strided view, and the kernels take contiguous operands
            full = x.movedim(nd - 1, nd).reshape(
                *front, 1, x.shape[nd], c * x.shape[nd + 1]).contiguous()
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


class Dist(Backend):
    """The ``torch.distributed`` backend: this process's rank of a grid
    made with a process group, one rank per process, with the event log
    of :class:`Stacked` and the same bits on every rank.

    Each permute is one ``batch_isend_irecv`` on global ranks.  Inside
    :meth:`issue` its works are handed back unfinished, so an overlapped
    ring runs it beside the kernel in flight; elsewhere each collective
    is waited on before it returns.  On NCCL a wait orders the current
    stream after the collective and does not block the host."""

    def __init__(self, grid):
        if grid.group is None:
            raise ValueError("the torch.distributed backend needs a grid "
                             "made with a process group")
        super().__init__(grid)
        self._inflight = None     # the works of an issue() in progress
        self._tag = 0             # one tag per permute, the same on all
                                  # ranks

    def issue(self, fn: Callable):
        self._inflight = []
        try:
            return fn(), self._inflight
        finally:
            self._inflight = None

    def wait(self, works) -> None:
        for w in works:
            w.wait()

    def _done(self, works) -> None:
        if self._inflight is not None:
            self._inflight.extend(works)
        else:
            self.wait(works)

    def permute(self, x: torch.Tensor, axis: str, offset: int, *,
                point=None, then: Callable | None = None) -> torch.Tensor:
        """This rank sends its block to rank i + offset on ``axis`` and
        receives rank i - offset's (cyclic), one send/receive pair (see
        :meth:`Backend.permute`).

        A bfloat16 payload (the ``compress="bf16"`` wire) ships as
        bfloat16, half the bytes of float32, over NCCL and over gloo,
        whose point-to-point pairs carry it as it is.  The reference's
        host count cannot show this halving: XLA legalizes bf16
        collectives to float32 on the CPU (``repro.core.common._unwire``).
        """
        import torch.distributed as dist
        g = self.grid
        d = g.dim(axis)
        self._note_permute(x, axis, offset, point)
        size = g.shape[d]
        if offset % size == 0:
            if then is not None:
                then(x)
            return x
        me = g.coords
        to = me[:d] + ((me[d] + offset) % size,) + me[d + 1:]
        frm = me[:d] + ((me[d] - offset) % size,) + me[d + 1:]
        x = x.contiguous()
        out = torch.empty_like(x)
        self._tag += 1
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, g.global_rank(to), g.group, self._tag),
            dist.P2POp(dist.irecv, out, g.global_rank(frm), g.group,
                       self._tag)])
        if then is not None:
            works = [_Then(works, lambda: then(out))]
        self._done(works)
        return out

    def all_gather(self, x: torch.Tensor, *, cols: bool = False,
                   point=None) -> torch.Tensor:
        """Tiled all-gather over "fiber": this rank's (rows, r) block ->
        (c*rows, r), or with ``cols`` (rows, c*r), in local storage."""
        import torch.distributed as dist
        g, c = self.grid, self.grid.c
        blk = self._rank(x)
        self._note("all-gather", g.fiber, (c - 1) * blk.numel(), point)
        if c == 1:
            return x
        blk = blk.contiguous()
        out = blk.new_empty((c * blk.shape[0], *blk.shape[1:]))
        self.wait([dist.all_gather_into_tensor(out, blk, group=g.fiber_group,
                                               async_op=True)])
        if cols:     # contiguous at one column a block too (Stacked's)
            out = out.reshape(c, *blk.shape).movedim(0, 1).reshape(
                blk.shape[0], c * blk.shape[1]).contiguous()
        return out.reshape(*g.local_shape, *out.shape)

    def psum_scatter(self, x: torch.Tensor, *, point=None) -> torch.Tensor:
        """Tiled reduce-scatter over "fiber": this rank's (c*rows, r)
        partial -> its (rows, r) block of the sum, summed in fiber order."""
        import torch.distributed as dist
        g, c = self.grid, self.grid.c
        blk = self._rank(x)
        rows = blk.shape[0] // c
        self._note("reduce-scatter", g.fiber,
                   (c - 1) * rows * blk.shape[1:].numel(), point)
        if c == 1:
            return x
        blk = blk.contiguous()
        parts = torch.empty_like(blk)
        self.wait([dist.all_to_all_single(parts, blk, group=g.fiber_group,
                                          async_op=True)])
        parts = parts.reshape(c, rows, *blk.shape[1:])
        acc = parts[0]
        for v in range(1, c):
            acc = acc + parts[v]
        return acc.reshape(*g.local_shape, *acc.shape)


class _Then:
    """Works in flight and what runs on their results once they are
    waited."""

    def __init__(self, works, fn: Callable):
        self.works, self.fn = works, fn

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        self.fn()


def coll_for(grid, coll: Backend | None = None) -> Backend:
    """The caller's collective backend, else a fresh one for ``grid``:
    :class:`Dist` for a grid made with a process group, else
    :class:`Stacked`."""
    if coll is not None:
        return coll
    return Stacked(grid) if grid.group is None else Dist(grid)


class Ring:
    """The traveling operand of one round of phases.

    ``cur`` is the operand of the current phase; :meth:`advance` moves to
    the next with ``move(x, k)``, the round's k-th shift.  At most
    ``n_shifts`` shifts are issued: one fewer than the phases when the
    round's final position is dead, as many when the operand must come
    home.  ``overlap`` issues each shift one phase ahead (before the
    kernel that reads the current operand), as the reference's double
    buffer does: on the stacked backend that changes the order, not the
    result; under :class:`Dist` the shift is in flight while the kernel
    runs, and :meth:`advance` waits on it before its operand is read.
    """

    def __init__(self, coll: Backend, move: Callable, x, n_shifts: int,
                 overlap: bool):
        self.coll, self.move, self.n = coll, move, n_shifts
        self.overlap = overlap
        self.issued = 0
        self.cur = x
        self.nxt, self.works = coll.issue(lambda: self._shift(x)) \
            if overlap else (None, ())

    def _shift(self, x):
        if x is None or self.issued >= self.n:
            return None
        self.issued += 1
        return self.move(x, self.issued - 1)

    def advance(self):
        if self.overlap:
            self.coll.wait(self.works)
            self.cur = self.nxt
            self.nxt, self.works = self.coll.issue(
                lambda: self._shift(self.cur))
        else:
            self.cur = self._shift(self.cur)


def cannon_ring(coll: Backend, x, axis: str, n_shifts: int, *,
                overlap: bool = False, start: int = 0) -> Ring:
    """A tensor traveling back (i -> i-1) along ``axis``, as the 2.5D
    Cannon rounds move them; its k-th shift is the schedule's shift
    event ``start + k``."""
    return Ring(coll, lambda y, k: coll.shift(y, axis, back=True,
                                              point=("shift", start + k)),
                x, n_shifts, overlap)


def on_ranks(grid, fn):
    """Result(s) of ``fn(*rank)`` over the ranks this process holds, in
    local storage: the local kernels of one phase, one call per rank
    (one call per process under a process group)."""
    outs = [fn(*rank) for rank in grid.ranks()]
    if isinstance(outs[0], tuple):
        return tuple(_stack(grid, [o[i] for o in outs])
                     for i in range(len(outs[0])))
    return _stack(grid, outs)


def _stack(grid, outs):
    if len(outs) == 1:
        return outs[0].reshape(*grid.local_shape, *outs[0].shape)
    return torch.stack(outs).reshape(*grid.local_shape, *outs[0].shape)


def acc(total, contrib):
    """Running sum of per-phase contributions (the first starts it)."""
    return contrib if total is None else total + contrib
