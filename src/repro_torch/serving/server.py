"""The serving loop: admission queue -> per-tick coalesced rounds.

Port of ``repro.serving.server``.  :class:`ServingEngine` ties the
layers together: requests enter through the bounded
:class:`~repro_torch.serving.requests.RequestQueue`; each ``tick``
drains up to ``max_batch`` tickets, pins their deployments against pool
eviction, plans the tick's merge units (:mod:`repro_torch.serving.
batcher`) and runs them, union-of-patterns SDDMM rounds for scores and
batched-RHS SpMM rounds for aggregates, all through each deployment's
``ElasticProblem``, so a ``DeviceLost`` mid-tick re-plans and retries
without the caller noticing.  A tick ends when its device work has
finished (the tick's wall time is the service time).
``batching=False`` makes the same engine the per-request baseline (one
round per ticket, no caches).  ``use_session`` chooses whether score
rounds and solo rounds use the deployment's Session; a batched
aggregation round runs on the elastic facade, which holds it.

:func:`replay_trace` is the latency method: an open-loop arrival trace
in *simulated* seconds is replayed deterministically -- every request
whose arrival precedes the current simulated time is admitted, one tick
runs, its WALL duration is measured, and each served ticket completes at
tick start + wall.  Arrivals are fixed by the trace and service times
measured, so p50/p99 include queueing delay under bursts.

**Under a process group** (``group=``, one rank per card) the engine is
one controller made of several processes.  The group's first rank is
the *front end*: it alone takes submissions, admits or sheds them,
drains the queue and keeps the clock.  Each ``tick`` broadcasts the
drained requests as one *tick record* (:class:`~repro_torch.serving.
requests.WireRequest` s by deployment key, with the front end's grouping
keys, and each distinct operand tensor that is not a deployment's, sent
once), and then every rank runs the tick's rounds together: the same
units, in the same order, on deployments that every rank deployed with
the same ``pool.deploy(..., group=)`` call.  The other ranks call
:meth:`ServingEngine.follow`, which runs the records as they come and
returns at the front end's :meth:`ServingEngine.stop`.  Every choice
that selects a collective (the tick's tickets, their units, the union
pattern, the padded width, a Session hit, an eviction, a retry) comes
from the record or from state that evolved the same way on every rank.
Only the front end's tickets are its callers'; a rank that leaves a
deployment's degraded grid (``api.RankRetired``) runs none of that
deployment's rounds again and goes on following the records.  The
front end's own loss is not handled: there is one front end.
"""
from __future__ import annotations

import pickle
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import batcher
from repro_torch.serving.pool import SessionPool
from repro_torch.serving.requests import (AdmissionError, AggregateRequest,
                                          RequestQueue, ScoreRequest, Ticket,
                                          from_wire, to_wire)

__all__ = ["ServingEngine", "replay_trace"]


def _finish(deployments) -> None:
    """Wait for the device work of the tick's deployments."""
    for dev in {d.problem.grid.device for d in deployments}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _round(tickets: List[Ticket], run: Callable[[], int]) -> int:
    """One round of ``tickets`` (one deployment's), unless this process
    has left the deployment's degraded grid.  A round that takes this
    process out of it (``api.RankRetired``, under a process group: the
    survivors retry it without this process) fails the tickets here
    and marks the deployment, and the rest of the tick runs on.  Counts
    the round either way: the tick's rounds are its plan's."""
    dep = tickets[0].request.deployment
    if dep.retired is None:
        try:
            return run()
        except api.RankRetired as e:
            dep.retired = e
    for t in tickets:
        if not t.done:
            t.fail(dep.retired)
    return 1


class ServingEngine:
    """Continuous-batching server over a deployment pool; under a process
    group, one front end and its followers (see the module doc)."""

    @staticmethod
    def clock() -> float:
        """The clock of a tick's wall time (:func:`replay_trace`'s
        service time); an engine's own may replace it."""
        return time.perf_counter()

    def __init__(self, pool: SessionPool, *, max_batch: int = 64,
                 max_pending: int = 256, batching: bool = True,
                 use_session: bool = True, group=None):
        self.pool = pool
        self.queue = RequestQueue(max_pending)
        self.max_batch = max_batch
        self.batching = batching
        self.use_session = use_session
        self.group = group
        self.rounds = 0
        self.served = 0
        self.failed = 0
        if group is not None:
            import torch.distributed as dist
            self._rank = dist.get_rank(group)
            self._src = dist.get_global_rank(group, 0)
            self._backend = dist.get_backend(group)

    @property
    def _wire_device(self) -> torch.device:
        """Where tick records travel: the CPU under gloo; under NCCL this
        rank's card, the one its deployments live on (the current card
        while the pool is empty)."""
        if self._backend != "nccl":
            return torch.device("cpu")
        for key in self.pool.keys:
            return self.pool.resident(key).problem.grid.device
        return torch.device("cuda", torch.cuda.current_device())

    @property
    def front_end(self) -> bool:
        """Whether this process takes submissions and ticks: always
        without a group, the group's first rank under one."""
        return self.group is None or self._rank == 0

    def _front(self, what: str) -> None:
        if not self.front_end:
            raise RuntimeError(
                f"{what} on rank {self._rank}: under a process group only "
                "the front end (the group's first rank) takes requests "
                "and ticks; the other ranks call follow()")

    # -- submission ----------------------------------------------------------
    def submit_score(self, deployment, rows, cols, X, Y=None, *,
                     x_key: Optional[str] = None,
                     y_key: Optional[str] = None,
                     arrival: float = 0.0) -> Ticket:
        """Queue an SDDMM score query.  ``X`` / ``Y`` are arrays or NAMES
        of deployment operands (the common case: factors deployed with
        the graph, already on its device); a name is its own key, so
        the Session's identity memo serves it across ticks."""
        self._front("submit_score")
        if isinstance(X, str):
            name = X
            X = deployment.operand(name)
            x_key = x_key or f"operand:{name}"
        if isinstance(Y, str) or Y is None:
            name = Y or "Y"
            Y = deployment.operand(name)
            y_key = y_key or f"operand:{name}"
        req = ScoreRequest.make(deployment, rows, cols, X, Y,
                                x_key=x_key, y_key=y_key)
        return self.queue.submit(req, arrival=arrival)

    def submit_aggregate(self, deployment, Y, vals=None, *,
                         arrival: float = 0.0) -> Ticket:
        """Queue an SpMM aggregation/lookup: ``deployment_graph @ Y``."""
        self._front("submit_aggregate")
        req = AggregateRequest.make(deployment, Y, vals=vals)
        return self.queue.submit(req, arrival=arrival)

    # -- the tick ------------------------------------------------------------
    def tick(self) -> dict:
        """Drain one batch, run its coalesced rounds, fulfill tickets.
        Returns the tick report (counts + wall seconds; under a group
        also the record's bytes and its broadcast's ms, inside the
        wall).  Under a group this broadcasts the tick record first, so
        it runs on the front end while the other ranks follow."""
        self._front("tick")
        tickets = self.queue.drain(self.max_batch)
        report = dict(requests=len(tickets), rounds=0, wall=0.0,
                      tickets=tickets)
        if not tickets:
            return report
        t0 = self.clock()
        run = tickets if self.group is None else self._send(tickets, report)
        self._run(run, report)
        report["wall"] = self.clock() - t0
        self._observe(report)
        return report

    def _run(self, tickets: List[Ticket], report: dict) -> None:
        """Run ``tickets``' rounds (the deployments pinned) and count
        them; a round that exhausts its retry budget fails the tickets
        still pending, never the whole server.  Under a process group
        that is the one failure caught: every rank exhausts the same
        budget at the same round, while any other error may be this
        rank's alone (out of memory, a failed kernel), and carrying on
        would leave its peers waiting in the round's collectives."""
        if not tickets:
            return
        deployments = {id(t.request.deployment): t.request.deployment
                       for t in tickets}
        caught = Exception if self.group is None \
            else api.FaultRecoveryError
        with self.pool.pin(*deployments.values()):
            try:
                if self.batching:
                    report["rounds"] = self._run_batched(tickets)
                else:
                    report["rounds"] = self._run_solo(tickets)
                _finish(deployments.values())
            except caught as e:
                for t in tickets:
                    if not t.done:
                        t.fail(e)
                        self.failed += 1
        self.rounds += report["rounds"]
        self.served += sum(1 for t in tickets
                           if t.done and t._error is None)

    def _observe(self, report: dict) -> None:
        reg = obs_metrics.active()
        if reg is None:
            return
        reg.observe("serving.tick_seconds", report["wall"])
        reg.observe("serving.batch_occupancy",
                    report["requests"] / max(self.max_batch, 1))
        reg.inc("serving.ticks")
        reg.inc("serving.requests", report["requests"])
        reg.gather("serving", dict(rounds=self.rounds, served=self.served,
                                   failed=self.failed))
        reg.gather("serving.queue", self.queue.stats())
        pstats = self.pool.stats()
        reg.gather("serving.pool", pstats)
        reg.gather("serving.pool.session", pstats["session"])

    # -- the tick record (under a process group) -----------------------------
    def _send(self, tickets: List[Ticket], report: dict) -> List[Ticket]:
        """Broadcast the tick record of the drained ``tickets``; returns
        the ones every rank will run.  A ticket whose deployment is not
        this pool's resident one, or whose grid the front end has left,
        fails here and stays out of the record (no follower could run
        it); the record is sent whatever fails, so no follower waits for
        a record that never comes."""
        sent, wire, run = [], [], []
        for t in tickets:
            dep = t.request.deployment
            if self.pool.resident(dep.key) is not dep:
                t.fail(RuntimeError(
                    f"ticket {t.seq}: its deployment is not resident in "
                    "the engine's pool; under a process group a tick "
                    "serves only the pool's resident deployments"))
            elif dep.retired is not None:
                t.fail(dep.retired)
            else:
                wire.append((t.seq, to_wire(t.request, sent)))
                run.append(t)
                continue
            self.failed += 1
        dev = self._wire_device
        payload = [a.detach().to(device=dev, dtype=torch.float32)
                   .contiguous() if isinstance(a, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(
                       a, np.float32)).to(dev) for a in sent]
        header = dict(op="tick", requests=len(tickets), wire=wire,
                      shapes=[tuple(x.shape) for x in payload])
        report["record_bytes"] = len(pickle.dumps(header)) + sum(
            x.numel() * x.element_size() for x in payload)
        t0 = time.perf_counter()
        self._broadcast(header, payload)
        report["broadcast_ms"] = (time.perf_counter() - t0) * 1e3
        return run

    def _broadcast(self, header: dict, payload=()) -> None:
        import torch.distributed as dist
        dev = self._wire_device
        dist.broadcast_object_list([header], src=self._src,
                                   group=self.group, device=dev)
        for x in payload:
            dist.broadcast(x, src=self._src, group=self.group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _receive(self):
        """The next record: (header, tensors, its bytes and the ms its
        tensors took to arrive)."""
        import torch.distributed as dist
        dev = self._wire_device
        box = [None]
        dist.broadcast_object_list(box, src=self._src, group=self.group,
                                   device=dev)
        header = box[0]
        t0 = time.perf_counter()
        tensors = []
        for shape in header["shapes"]:
            x = torch.empty(shape, dtype=torch.float32, device=dev)
            dist.broadcast(x, src=self._src, group=self.group)
            tensors.append(x)
        if tensors and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wire = dict(record_bytes=len(pickle.dumps(header)) + sum(
            x.numel() * x.element_size() for x in tensors),
            broadcast_ms=(time.perf_counter() - t0) * 1e3)
        return header, tensors, wire

    def follow(self,
               on_tick: Optional[Callable[[dict], None]] = None) -> int:
        """On a rank other than the front end: receive tick records and
        run each tick's rounds, until the front end's :meth:`stop`.
        ``on_tick`` gets each tick's report (its tickets are this rank's
        copies, which nobody else sees).  Returns the ticks run.  A
        follower's wall time runs from the record's arrival and decides
        nothing."""
        if self.group is None or self.front_end:
            raise RuntimeError("follow() runs on the ranks of a process "
                               "group other than the front end")
        n = 0
        while True:
            header, tensors, wire = self._receive()
            if header["op"] == "stop":
                return n
            t0 = self.clock()
            tickets = []
            for seq, w in header["wire"]:
                dep = self.pool.resident(w.deployment)
                if dep is None:
                    raise RuntimeError(
                        f"rank {self._rank}: no resident deployment "
                        f"{w.deployment}; every rank must make the same "
                        "pool.deploy(..., group=) calls")
                tickets.append(Ticket(from_wire(w, dep, tensors), seq))
            report = dict(requests=header["requests"], rounds=0, wall=0.0,
                          tickets=tickets, **wire)
            del tensors
            self._run(tickets, report)
            report["wall"] = self.clock() - t0
            self._observe(report)
            if on_tick is not None:
                on_tick(report)
            n += 1

    def stop(self) -> None:
        """On the front end: end every follower's :meth:`follow` (each
        returns; the engine may serve again after the ranks' next
        collective calls, e.g. another deploy).  A no-op without a
        group."""
        if self.group is None:
            return
        self._front("stop")
        self._broadcast(dict(op="stop", shapes=[]))

    def _run_batched(self, tickets: List[Ticket]) -> int:
        scores = [t for t in tickets if t.request.kind == "score"]
        aggs = [t for t in tickets if t.request.kind == "aggregate"]
        rounds = 0
        for unit in batcher.plan_score_units(scores):
            rounds += _round(unit.tickets,
                             lambda: batcher.execute_score_unit(
                                 unit, use_session=self.use_session))
        for group in batcher.plan_aggregate_groups(aggs):
            rounds += _round(group,
                             lambda: batcher.execute_aggregate_group(group))
        return rounds

    def _run_solo(self, tickets: List[Ticket]) -> int:
        rounds = 0
        for t in tickets:
            rounds += _round([t], lambda: batcher.execute_solo(
                t, use_session=self.use_session))
        return rounds

    def run_until_drained(self, max_ticks: int = 1000) -> int:
        """Tick until the queue is empty; returns ticks executed."""
        ticks = 0
        while len(self.queue) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks

    def stats(self) -> dict:
        return dict(rounds=self.rounds, served=self.served,
                    failed=self.failed, queue=self.queue.stats(),
                    pool=self.pool.stats())


def replay_trace(engine: ServingEngine,
                 trace: List[Tuple[float, Callable]]) -> dict:
    """Deterministically replay an open-loop arrival trace.

    ``trace`` is a list of ``(arrival_sim_seconds, submit_fn)``, where
    ``submit_fn(engine, arrival)`` submits one request and returns its
    :class:`Ticket` (an :class:`AdmissionError` is counted as shed
    load).  Simulated time advances by each tick's measured wall time;
    a ticket completes at tick start + wall, so ``latency = queueing
    delay + service time`` as an open-loop client sees it.  Returns the
    latency summary (p50/p99/mean/max seconds, requests per simulated
    second, shed count) and the tickets.
    """
    trace = sorted(trace, key=lambda item: item[0])
    sim = trace[0][0] if trace else 0.0
    i = 0
    tickets: List[Ticket] = []
    shed = 0
    while i < len(trace) or len(engine.queue):
        if not len(engine.queue) and i < len(trace) and trace[i][0] > sim:
            sim = trace[i][0]          # idle server: jump to next arrival
        while i < len(trace) and trace[i][0] <= sim:
            arrival, submit_fn = trace[i]
            try:
                tickets.append(submit_fn(engine, arrival))
            except AdmissionError:
                shed += 1
            i += 1
        report = engine.tick()
        for t in report["tickets"]:
            t.completion = sim + report["wall"]
        sim += report["wall"]
    lats = sorted(t.latency for t in tickets
                  if t.done and t._error is None)
    summary = dict(served=len(lats), shed=shed,
                   sim_seconds=sim - (trace[0][0] if trace else 0.0),
                   tickets=tickets)
    if lats:
        summary.update(
            p50=float(np.percentile(lats, 50)),
            p99=float(np.percentile(lats, 99)),
            mean=float(np.mean(lats)),
            max=float(lats[-1]),
            throughput=len(lats) / max(summary["sim_seconds"], 1e-12))
    return summary
