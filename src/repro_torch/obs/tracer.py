"""Per-round communication spans with live cost-model drift.

Port of ``repro.obs.tracer``.  A :class:`Tracer` hooks the executor
rounds that the fault harness guards (``repro_torch.distributed.
faults``): one **round span** per ``DistProblem.sddmm/spmm/spmm_t/
fusedmm`` call, subdivided into one **event span** per entry of the
family's ``schedule_events``.  Each event span carries the collective
kind and the *modeled* wire words (``schedule_words``); the round span
carries the *measured* per-device words and their ratio, **cost-model
drift** (1.0 when the model matches the wire).  Support-pruned
(``comm="sparse"``) rounds trace without modeled words and drift.

Measured words come from the round's collective log (the backend the
round ran on, ``DistProblem.last_collectives`` after it), which stands
in for the reference's parse of the compiled HLO: reading it costs
nothing, so ``measure_wire=False`` only means "modeled words only".  A
round that dies is recorded with its ``error`` and no measured words.

Timing.  On the CPU, or with an injected ``clock``, a round's ``t0`` and
``dur`` come from the clock, as in the reference.  On a card the port's
calls return before the device finishes, so a round is timed with CUDA
events on the current stream of the grid's device, and each move of the
round with the events of ``obs.moves``: ``dur`` and ``device_ms`` are
the device's, ``t0`` is on the device's timeline (the first round's
host time plus device time since that round began).  The events are
read when the trace is read (:attr:`Tracer.rounds`), with one
synchronize per read and none per round, so tracing does not serialize
an overlapped schedule.

Event spans tile the round: its time is split by modeled words (equally
where there is no model), a *modeled attribution* aligned 1:1 with
``schedule_events``.  On a card each event span also carries
``device_ms``, the summed device time of the moves tagged with its
schedule point (``obs.moves`` says what a span of an overlapped move
holds), and ``moves``, their count.

Zero cost when disabled, like ``faults.guard``: no tracer is installed by
default and the api layer pays one module attribute read per call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.core.collectives import coll_for
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import moves as _moves

__all__ = ["EventSpan", "RoundSpan", "Tracer", "active", "trace",
           "measured_words"]


@dataclasses.dataclass
class EventSpan:
    """One schedule event inside a round: a fault-harness coordinate."""
    point: str                    # gather | phase | shift | reduce
    phase: int
    kind: Optional[str]           # collective, None for compute
    words: Optional[float]        # modeled wire words (None: no model)
    t0: float = 0.0               # seconds since trace epoch
    dur: float = 0.0
    moves: int = 0                # moves of the log tagged with this event
    device_ms: Optional[float] = None   # their device time (on a card)


@dataclasses.dataclass
class RoundSpan:
    """One guarded executor call, subdivided into its schedule events."""
    op: str
    family: str
    elision: str
    comm: str
    p: int
    c: int
    round: int                    # per-op call counter since tracing began
    session: bool
    t0: float
    dur: float
    events: List[EventSpan]
    modeled_words: Optional[float]      # sum of event models (dense only)
    measured_words: Optional[dict]      # measured_words() of the log
    drift: Optional[float]              # measured total / modeled total
    error: Optional[str] = None         # exception type, if the round died
    device_ms: Optional[float] = None   # the round on the card


def measured_words(log) -> dict:
    """Per-device wire words of a collective log, in the reference's
    ``wire_words`` layout: ``{"total", "count", "<kind>",
    "<kind>_count"}`` over the moves that put words on the wire."""
    out = {"total": 0.0, "count": 0.0}
    for e in log:
        if e.words <= 0:
            continue
        out["total"] += e.words
        out["count"] += 1
        out[e.kind] = out.get(e.kind, 0.0) + e.words
        out[f"{e.kind}_count"] = out.get(f"{e.kind}_count", 0.0) + 1
    return out


@dataclasses.dataclass
class _Pending:
    """A round on the card whose CUDA events are not read yet."""
    span: RoundSpan
    shares: List[float]
    device: torch.device
    start: torch.cuda.Event
    end: torch.cuda.Event
    moves: List[List[_moves.MoveSpan]]   # per event span
    registry: Optional[_metrics.MetricsRegistry]


class Tracer:
    """Collects :class:`RoundSpan`\\ s; arm with :func:`trace`.

    ``measure_wire=False`` keeps modeled words only.  ``registry``
    (default: the armed ``obs.metrics`` registry, if any) receives round
    latency histograms (``executor.round_seconds``), round counts
    (``executor.rounds``) and live drift gauges (``costmodel.drift``).
    ``clock`` replaces the device timing with a host clock."""

    def __init__(self, *, measure_wire: bool = True,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 clock=None):
        self._rounds: List[RoundSpan] = []
        self.measure_wire = measure_wire
        self._registry = registry
        self._device_clock = clock is None
        self._clock = clock or time.perf_counter
        self.epoch = self._clock()
        self._counts: dict = {}
        self._pending: List[_Pending] = []
        self._anchors: dict = {}     # device -> (host t0, first event)

    # -- the round hook ------------------------------------------------------
    @contextlib.contextmanager
    def round(self, problem, op: str, elision: str = "none",
              session=None):
        """Span one executor round (called by the api layer).  Yields
        the collective backend the round runs on."""
        rnd = self._counts.get(op, 0)
        self._counts[op] = rnd + 1
        t0 = self._clock() - self.epoch
        on_card = self._device_clock and problem.grid.device.type == "cuda"
        if on_card:
            coll = _moves.timed_backend(problem.grid)
            stream = torch.cuda.current_stream(problem.grid.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        else:
            coll = coll_for(problem.grid)
            start = None
        err = None
        try:
            yield coll
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            dur = self._clock() - self.epoch - t0
            end = None
            if on_card:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
            self._finish(problem, op, elision, session, rnd, t0, dur, err,
                         coll, start, end)

    def _finish(self, problem, op, elision, session, rnd, t0, dur, err,
                coll=None, start=None, end=None):
        events = problem.alg.schedule_events(problem, op, elision)
        words = problem.alg.schedule_words(problem, op, elision,
                                           session=session)
        total = None if words is None else sum(w for *_, w in words)
        measured = drift = None
        if err is None and self.measure_wire and coll is not None:
            measured = measured_words(coll.log)
            if total:
                drift = measured["total"] / total
        # modeled attribution: the round's time split across events by
        # modeled words (equally when there is no model)
        if words is None:
            shares = [1.0] * len(events)
        else:
            shares = [max(w, 0.0) for *_, w in words]
        if sum(shares) == 0.0:
            shares = [1.0] * len(events)
        tagged = {}
        for e in (coll.log if coll is not None else ()):
            if e.point is not None:
                tagged[tuple(e.point)] = tagged.get(tuple(e.point), 0) + 1
        spans = [EventSpan(
            point=point, phase=phase,
            kind=None if words is None else words[i][2],
            words=None if words is None else words[i][3],
            moves=tagged.get((point, phase), 0))
            for i, (point, phase) in enumerate(events)]
        span = RoundSpan(
            op=op, family=problem.alg.name, elision=elision,
            comm=problem.comm, p=problem.p, c=problem.c, round=rnd,
            session=session is not None, t0=t0, dur=dur, events=spans,
            modeled_words=total, measured_words=measured, drift=drift,
            error=err)
        self._rounds.append(span)
        reg = self._registry or _metrics.active()
        lab = dict(op=op, family=problem.alg.name)
        if reg is not None:
            reg.inc("executor.rounds", 1, **lab)
            if drift is not None:
                reg.gauge("costmodel.drift", drift, **lab)
        if start is None:
            self._tile(span, shares)
            if reg is not None:
                reg.observe("executor.round_seconds", dur, **lab)
            return
        per_event = [[s for s in coll.spans if s.event.point is not None
                      and tuple(s.event.point) == (e.point, e.phase)]
                     for e in spans]
        dev = problem.grid.device
        if dev not in self._anchors:
            self._anchors[dev] = (t0, start)
        self._pending.append(_Pending(span, shares, dev, start, end,
                                      per_event, reg))

    @staticmethod
    def _tile(span: RoundSpan, shares: List[float]) -> None:
        denom = sum(shares)
        t = span.t0
        for e, share in zip(span.events, shares):
            e.t0 = t
            e.dur = span.dur * share / denom
            t += e.dur

    def _resolve(self) -> None:
        """Read the pending rounds' CUDA events: one synchronize."""
        if not self._pending:
            return
        torch.cuda.synchronize()
        for pend in self._pending:
            span = pend.span
            host0, first = self._anchors[pend.device]
            span.device_ms = pend.start.elapsed_time(pend.end)
            span.t0 = host0 + first.elapsed_time(pend.start) / 1e3
            span.dur = span.device_ms / 1e3
            self._tile(span, pend.shares)
            for e, moves in zip(span.events, pend.moves):
                if moves:
                    e.device_ms = sum(m.ms for m in moves)
            if pend.registry is not None:
                pend.registry.observe("executor.round_seconds", span.dur,
                                      op=span.op, family=span.family)
        self._pending = []

    # -- reading -------------------------------------------------------------
    @property
    def rounds(self) -> List[RoundSpan]:
        """The traced rounds, in order (reads the card's events)."""
        self._resolve()
        return self._rounds

    def drifts(self) -> List[float]:
        """All defined per-round drift ratios, trace order."""
        return [r.drift for r in self.rounds if r.drift is not None]


_ACTIVE: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    """The armed tracer, or None (the zero-cost disabled state)."""
    return _ACTIVE


@contextlib.contextmanager
def trace(tracer: Optional[Tracer] = None, **kw):
    """Arm a tracer for the dynamic extent of the context.

    Yields the :class:`Tracer`; nesting restores the previous one on
    exit -- the same discipline as ``faults.inject``."""
    global _ACTIVE
    tr = Tracer(**kw) if tracer is None else tracer
    prev = _ACTIVE
    _ACTIVE = tr
    try:
        yield tr
    finally:
        _ACTIVE = prev
