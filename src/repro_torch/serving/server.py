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
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import batcher
from repro_torch.serving.pool import SessionPool
from repro_torch.serving.requests import (AdmissionError, AggregateRequest,
                                          RequestQueue, ScoreRequest, Ticket)

__all__ = ["ServingEngine", "replay_trace"]


def _finish(deployments) -> None:
    """Wait for the device work of the tick's deployments."""
    for dev in {d.problem.grid.device for d in deployments}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class ServingEngine:
    """Continuous-batching server over a deployment pool."""

    def __init__(self, pool: SessionPool, *, max_batch: int = 64,
                 max_pending: int = 256, batching: bool = True,
                 use_session: bool = True):
        self.pool = pool
        self.queue = RequestQueue(max_pending)
        self.max_batch = max_batch
        self.batching = batching
        self.use_session = use_session
        self.rounds = 0
        self.served = 0
        self.failed = 0

    # -- submission ----------------------------------------------------------
    def submit_score(self, deployment, rows, cols, X, Y=None, *,
                     x_key: Optional[str] = None,
                     y_key: Optional[str] = None,
                     arrival: float = 0.0) -> Ticket:
        """Queue an SDDMM score query.  ``X`` / ``Y`` are arrays or NAMES
        of deployment operands (the common case: factors deployed with
        the graph, already on its device); a name is its own key, so
        the Session's identity memo serves it across ticks."""
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
        req = AggregateRequest.make(deployment, Y, vals=vals)
        return self.queue.submit(req, arrival=arrival)

    # -- the tick ------------------------------------------------------------
    def tick(self) -> dict:
        """Drain one batch, run its coalesced rounds, fulfill tickets.
        Returns the tick report (counts + wall seconds)."""
        tickets = self.queue.drain(self.max_batch)
        report = dict(requests=len(tickets), rounds=0, wall=0.0,
                      tickets=tickets)
        if not tickets:
            return report
        deployments = {id(t.request.deployment): t.request.deployment
                       for t in tickets}
        t0 = time.perf_counter()
        with self.pool.pin(*deployments.values()):
            try:
                if self.batching:
                    report["rounds"] = self._run_batched(tickets)
                else:
                    report["rounds"] = self._run_solo(tickets)
                _finish(deployments.values())
            except Exception as e:
                # a round that exhausts its retry budget fails the
                # tickets still pending, never the whole server
                for t in tickets:
                    if not t.done:
                        t.fail(e)
                        self.failed += 1
        self.rounds += report["rounds"]
        self.served += sum(1 for t in tickets
                           if t.done and t._error is None)
        report["wall"] = time.perf_counter() - t0
        reg = obs_metrics.active()
        if reg is not None:
            reg.observe("serving.tick_seconds", report["wall"])
            reg.observe("serving.batch_occupancy",
                        len(tickets) / max(self.max_batch, 1))
            reg.inc("serving.ticks")
            reg.inc("serving.requests", len(tickets))
            reg.gather("serving", dict(rounds=self.rounds,
                                       served=self.served,
                                       failed=self.failed))
            reg.gather("serving.queue", self.queue.stats())
            pstats = self.pool.stats()
            reg.gather("serving.pool", pstats)
            reg.gather("serving.pool.session", pstats["session"])
        return report

    def _run_batched(self, tickets: List[Ticket]) -> int:
        scores = [t for t in tickets if t.request.kind == "score"]
        aggs = [t for t in tickets if t.request.kind == "aggregate"]
        rounds = 0
        for unit in batcher.plan_score_units(scores):
            rounds += batcher.execute_score_unit(
                unit, use_session=self.use_session)
        for group in batcher.plan_aggregate_groups(aggs):
            rounds += batcher.execute_aggregate_group(group)
        return rounds

    def _run_solo(self, tickets: List[Ticket]) -> int:
        rounds = 0
        for t in tickets:
            rounds += batcher.execute_solo(t, use_session=self.use_session)
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
