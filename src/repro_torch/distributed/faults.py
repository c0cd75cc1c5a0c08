"""Deterministic fault-injection harness for the distributed executors.

Port of ``repro.distributed.faults``: the same plans, coordinates,
controller records and summaries, so one scripted plan over one call
sequence fires at the same coordinates in both packages.

Every executor round (one ``DistProblem.sddmm/spmm/spmm_t/fusedmm``
call) follows a statically known communication schedule: an optional
fiber **gather**, a sequence of **phase** computations interleaved with
cyclic **shift**s, and possibly a terminal **reduce**/scatter.  Each
family module exports its schedule (``d15.schedule_events`` etc.) as an
ordered list of ``(point, phase)`` events; a fault is addressed by the
coordinate

    (op, point, rank, phase, round)

-- the ``round``-th guarded call of ``op`` since injection was armed, at
schedule event ``(point, phase)``, originating from rank ``rank``.  A
collective failure kills the whole round, so the guard raises on the
host at the round boundary, before the executor launches any kernel or
collective.  Under a process group every process holds the same plan
and guards the same calls, so every rank raises the same typed fault at
the same coordinate and no rank is left waiting in a collective.

Faults are **typed**: :class:`TransientFault` models a recoverable hiccup
(link timeout, preemption -- retry on the same grid succeeds);
:class:`DeviceLost` additionally names the failed rank and requires the
caller to re-plan onto a degraded grid (``repro_torch.core.api.
ElasticProblem`` does both).  A scripted spec fires exactly once; the
retry that follows runs fault-free unless another spec matches.

:meth:`FaultPlan.random` derives every coordinate from a seeded
``numpy`` PRNG, so a failing injection run is replayable from its seed
alone; :meth:`FaultController.summary` returns a JSON-ready record of
every guarded round and every fired fault.

Nothing here imports torch: the harness is host-side bookkeeping and
costs one attribute read when no plan is armed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TransientFault", "DeviceLost", "FaultSpec", "FaultPlan", "unwrap",
    "FaultController", "inject", "active", "guard", "OPS", "POINTS",
]

OPS = ("sddmm", "spmm", "spmm_t", "fusedmm")
POINTS = ("gather", "phase", "shift", "reduce")


class TransientFault(RuntimeError):
    """A retryable executor failure (simulated timeout / preemption).

    ``coord`` carries the (op, point, rank, phase, round) the fault was
    injected at, so recovery logs and test assertions can name it."""

    def __init__(self, msg: str, coord: Optional[dict] = None):
        super().__init__(msg)
        self.coord = coord or {}


class DeviceLost(TransientFault):
    """A device dropped out of the mesh: retrying on the same grid can
    never succeed — the caller must re-plan onto a degraded mesh
    (``repro_torch.core.api.degrade``).  ``rank`` is the flat
    device index (schedule order) of the lost device."""

    def __init__(self, msg: str, rank: int, coord: Optional[dict] = None):
        super().__init__(msg, coord)
        self.rank = int(rank)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault at a (op, point, rank, phase, round) coordinate.

    ``-1`` / ``"*"`` wildcards match the first candidate in schedule
    order; ``round`` counts guarded calls of ``op`` since the plan was
    armed (0-based).  ``kind`` is ``"transient"`` or ``"device_lost"``.
    """
    op: str = "*"
    point: str = "*"
    rank: int = -1
    phase: int = -1
    round: int = 0
    kind: str = "transient"

    def __post_init__(self):
        if self.kind not in ("transient", "device_lost"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.op != "*" and self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; known: {OPS}")
        if self.point != "*" and self.point not in POINTS:
            raise ValueError(f"unknown point {self.point!r}; "
                             f"known: {POINTS}")


class FaultPlan:
    """An ordered script of :class:`FaultSpec`s; each fires at most once."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs: List[FaultSpec] = list(specs)

    @classmethod
    def scripted(cls, *specs: FaultSpec) -> "FaultPlan":
        return cls(specs)

    @classmethod
    def random(cls, seed: int, n_faults: int = 1, *, p: int = 8,
               ops: Sequence[str] = OPS,
               points: Sequence[str] = POINTS,
               max_phase: int = 2, max_round: int = 2,
               kinds: Sequence[str] = ("transient",)) -> "FaultPlan":
        """Seeded, replayable plan: identical seeds script identical
        coordinates (the harness's replay guarantee)."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            specs.append(FaultSpec(
                op=str(rng.choice(list(ops))),
                point=str(rng.choice(list(points))),
                rank=int(rng.integers(p)),
                phase=int(rng.integers(max_phase)),
                round=int(rng.integers(max_round)),
                kind=str(rng.choice(list(kinds)))))
        return cls(specs)

    def __len__(self):
        return len(self.specs)


class FaultController:
    """Walks each guarded round's schedule against the armed plan.

    ``rounds`` counts guarded calls per op; ``log`` records every round
    (fired or not) and ``fired`` every injected fault — together the
    fault-injection summary."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.pending: List[FaultSpec] = list(plan.specs)
        self.rounds: dict = {}
        self.log: List[dict] = []
        self.fired: List[dict] = []
        #: the typed fault most recently raised and not yet reclaimed by
        #: :func:`unwrap`
        self.last_raised: Optional[TransientFault] = None

    def guard(self, op: str, family: str, p: int,
              events: Sequence[Tuple[str, int]]):
        """Check one executor round against the plan; raises on a match.

        ``events`` is the family's ordered (point, phase) schedule for
        this op.  The first pending spec whose coordinate occurs in the
        schedule fires (and is consumed); specs naming coordinates the
        schedule never reaches stay pending — a no-op, not an error.
        """
        rnd = self.rounds.get(op, 0)
        self.rounds[op] = rnd + 1
        rec = dict(op=op, family=family, round=rnd, p=p,
                   events=len(events), fired=False)
        self.log.append(rec)
        for i, spec in enumerate(self.pending):
            if spec.op not in ("*", op) or spec.round not in (-1, rnd):
                continue
            for point, phase in events:
                if spec.point not in ("*", point):
                    continue
                if spec.phase not in (-1, phase):
                    continue
                rank = spec.rank if spec.rank >= 0 else 0
                if rank >= p:
                    continue        # names a rank this mesh doesn't have
                del self.pending[i]
                coord = dict(op=op, family=family, point=point,
                             rank=rank, phase=phase, round=rnd)
                rec["fired"] = True
                rec["coord"] = coord
                self.fired.append(coord)
                msg = (f"injected {spec.kind} fault at {point} "
                       f"(rank {rank}, phase {phase}) in {family}.{op} "
                       f"round {rnd}")
                if spec.kind == "device_lost":
                    err = DeviceLost(msg, rank, coord)
                else:
                    err = TransientFault(msg, coord)
                self.last_raised = err
                try:
                    raise err
                finally:
                    # a frame holding its own exception is a reference
                    # cycle: the failed call's frames, and the device
                    # state they hold, would wait for the cyclic collector
                    del err

    def summary(self) -> dict:
        """JSON-ready injection record."""
        return dict(rounds=dict(self.rounds), guarded=len(self.log),
                    fired=self.fired,
                    pending=[dataclasses.asdict(s) for s in self.pending],
                    log=self.log)


_ACTIVE: Optional[FaultController] = None


def active() -> Optional[FaultController]:
    return _ACTIVE


@contextlib.contextmanager
def inject(plan):
    """Arm a fault plan for the dynamic extent of the context.

    Yields the :class:`FaultController` so callers can read the
    injection log/summary afterwards.  Nesting restores the previous
    controller on exit."""
    global _ACTIVE
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan(plan)
    ctl = FaultController(plan)
    prev = _ACTIVE
    _ACTIVE = ctl
    try:
        yield ctl
    finally:
        _ACTIVE = prev


def unwrap(e: BaseException) -> BaseException:
    """Recover the typed fault behind a wrapped exception.

    A guard that fires where a framework re-raises the error under
    another type loses ``DeviceLost.rank`` on the way out; the
    controller keeps the typed original in ``last_raised``, and this
    reclaims it (once) so recovery code can still dispatch on
    transient-vs-device-lost.  A guard in an autograd backward
    (``core/grads.py``) reaches the caller typed; typed exceptions and
    exceptions raised with no armed controller pass through unchanged.
    Reclaiming a typed fault also drops the controller's reference to it:
    its traceback holds the frames of the failed call, and with them the
    device state the recovery is about to release.
    """
    if isinstance(e, TransientFault):
        if _ACTIVE is not None and _ACTIVE.last_raised is e:
            _ACTIVE.last_raised = None
        return e
    if _ACTIVE is not None and _ACTIVE.last_raised is not None:
        typed, _ACTIVE.last_raised = _ACTIVE.last_raised, None
        return typed
    return e


def guard(op: str, problem, elision: str = "none") -> None:
    """Fault boundary of one executor round — called by the api layer.

    No-op (one attribute read) when no plan is armed.  ``problem`` is a
    ``repro_torch.core.api.DistProblem``; its algorithm supplies the family's
    (point, phase) schedule for ``op`` (FusedMM schedules depend on the
    resolved ``elision``), so the scripted coordinates line up with what
    the executor actually does on the wire.
    """
    if _ACTIVE is None:
        return
    events = problem.alg.schedule_events(problem, op, elision)
    _ACTIVE.guard(op, problem.alg.name, problem.p, events)
