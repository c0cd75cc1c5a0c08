"""Device time of each collective move, from CUDA events around it.

:func:`timed_backend` gives a grid's collective backend (``Stacked`` or
``Dist``, as ``core.collectives.coll_for`` would) that records one
:class:`MoveSpan` per move: a CUDA event on the current stream before
the move and one after it.  The tracer (``obs.tracer``) runs its rounds
on one on the card, and ``chip_smoke.py`` times the serial pass of its
four-card cells with one, so the port has one copy of the timer.

What a span holds:

* a move waited before it returns (every move of the stacked backend,
  and every ``Dist`` move outside ``issue``): its own work, from the
  stream's point of issue to the end of its wait, NCCL's stream
  included (a wait orders the current stream after the collective), and
  any time spent waiting for a peer that has not reached the move yet;
* a move issued inside ``issue`` (an overlapped ring's shift): the end
  event is recorded when its works are waited, so the span runs from
  the issue to the wait and also holds the kernel that the move
  overlaps, on the compute stream.  It bounds the transfer from above.

``barrier=True`` lines the ranks up before each move (the card idle,
then, under a process group, an all-reduce of one word), so a span of a
serial pass holds the transfer and not a wait for a peer's kernel.  It
serializes the schedule and is for measurements only.

Reading a span's time synchronizes with the card; recording costs two
event records a move and no synchronization.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.core.collectives import Dist, Event, Stacked, _Then

__all__ = ["MoveSpan", "timed_backend"]


@dataclasses.dataclass
class MoveSpan:
    """One move of the collective log and the CUDA events around it."""
    event: Event
    crossed: bool                 # its rank axis has more than one rank
    start: torch.cuda.Event
    end: torch.cuda.Event

    @property
    def ms(self) -> float:
        """Device milliseconds (the end event must have completed)."""
        return self.start.elapsed_time(self.end)


class _Timed:
    """A collective backend that records a :class:`MoveSpan` per move."""

    def __init__(self, grid, barrier: bool = False):
        super().__init__(grid)
        self.spans: List[MoveSpan] = []
        self.barrier = barrier

    def _line_up(self) -> None:
        torch.cuda.synchronize(self.grid.device)
        if self.grid.group is not None:
            import torch.distributed as dist
            dist.all_reduce(torch.zeros(1, device=self.grid.device),
                            group=self.grid.group)
            torch.cuda.synchronize(self.grid.device)

    def _span(self, move, *args, **kwargs):
        if self.barrier:
            self._line_up()
        stream = torch.cuda.current_stream(self.grid.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        inflight = getattr(self, "_inflight", None)
        held = len(inflight) if inflight is not None else 0
        start.record(stream)
        out = move(*args, **kwargs)
        if inflight is not None and len(inflight) > held:
            # in flight inside issue(): the end is recorded at the wait
            works = inflight[held:]
            del inflight[held:]
            inflight.append(_Then(works, lambda: end.record(stream)))
        else:
            end.record(stream)
        ev = self.log[-1]
        crossed = self.grid.shape[self.grid.dim(ev.axis)] > 1
        self.spans.append(MoveSpan(ev, crossed, start, end))
        return out

    def permute(self, *args, **kwargs):
        return self._span(super().permute, *args, **kwargs)

    def all_gather(self, *args, **kwargs):
        return self._span(super().all_gather, *args, **kwargs)

    def psum_scatter(self, *args, **kwargs):
        return self._span(super().psum_scatter, *args, **kwargs)

    def by_kind(self) -> Dict[str, dict]:
        """{kind: ms, bytes, moves, GB/s} over the moves that crossed a
        rank (4-byte words; a bfloat16 payload counts half).
        Synchronizes once."""
        torch.cuda.synchronize(self.grid.device)
        out: Dict[str, dict] = {}
        for s in self.spans:
            if not s.crossed:
                continue
            k = out.setdefault(s.event.kind, {"ms": 0.0, "bytes": 0.0,
                                              "moves": 0})
            k["ms"] += s.ms
            k["bytes"] += 4 * s.event.words
            k["moves"] += 1
        for k in out.values():
            k["gb_per_s"] = k["bytes"] / k["ms"] / 1e6 if k["ms"] else None
        return out


class TimedStacked(_Timed, Stacked):
    pass


class TimedDist(_Timed, Dist):
    pass


def timed_backend(grid, *, barrier: bool = False):
    """The collective backend of ``grid`` (``Dist`` for a grid made with
    a process group, else ``Stacked``) with each move's CUDA events; the
    grid must be on a card."""
    if grid.device.type != "cuda":
        raise ValueError(f"moves are timed with CUDA events; the grid is "
                         f"on {grid.device}")
    cls = TimedStacked if grid.group is None else TimedDist
    return cls(grid, barrier=barrier)

