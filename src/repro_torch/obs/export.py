"""Exporters: Chrome-trace/Perfetto JSON, text summaries, artifacts.

Port of ``repro.obs.export``.  ``chrome_trace`` renders a
:class:`repro_torch.obs.tracer.Tracer` in the Chrome trace-event format
(load at ``ui.perfetto.dev`` or ``chrome://tracing``): one track (tid)
per rank -- the executors are SPMD, every rank runs the same schedule,
so the round's spans are duplicated onto each rank's track with
per-device word counts -- with event spans nested inside round spans by
time containment.  On a card the spans carry the device milliseconds
(``device_ms``) of the round and of each event's moves.

``write_artifacts`` writes ``TRACE_<tag>.json`` (Perfetto-loadable) and
``METRICS_<tag>.json`` (``MetricsRegistry.snapshot()``) into the
directory its caller names, and nowhere else.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer

__all__ = ["chrome_trace", "round_summary", "write_artifacts"]


def _name(r) -> str:
    return f"{r.family}.{r.op}" + (f"[{r.elision}]"
                                   if r.op == "fusedmm" else "")


def chrome_trace(tracer: Tracer) -> dict:
    """Chrome trace-event JSON for a finished trace (one track per rank)."""
    rounds = tracer.rounds
    ranks = max([r.p for r in rounds], default=1)
    ev = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
           "args": {"name": "repro_torch executors (SPMD; per-device "
                            "words)"}}]
    for tid in range(ranks):
        ev.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                   "args": {"name": f"rank {tid}"}})
    for r in rounds:
        args = {"family": r.family, "op": r.op, "elision": r.elision,
                "comm": r.comm, "round": r.round, "p": r.p, "c": r.c,
                "session": r.session}
        if r.modeled_words is not None:
            args["modeled_words"] = r.modeled_words
        if r.measured_words is not None:
            args["measured_words"] = r.measured_words["total"]
        if r.drift is not None:
            args["drift"] = r.drift
        if r.device_ms is not None:
            args["device_ms"] = r.device_ms
        if r.error is not None:
            args["error"] = r.error
        for tid in range(r.p):
            ev.append({"name": _name(r), "cat": "round", "ph": "X",
                       "pid": 0, "tid": tid, "ts": r.t0 * 1e6,
                       "dur": r.dur * 1e6, "args": args})
            for s in r.events:
                a = {"point": s.point, "phase": s.phase}
                if s.kind is not None:
                    a["collective"] = s.kind
                if s.words is not None:
                    a["modeled_words"] = s.words
                if s.moves:
                    a["moves"] = s.moves
                if s.device_ms is not None:
                    a["device_ms"] = s.device_ms
                ev.append({"name": f"{s.point}[{s.phase}]",
                           "cat": "event", "ph": "X", "pid": 0,
                           "tid": tid, "ts": s.t0 * 1e6,
                           "dur": s.dur * 1e6, "args": a})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def round_summary(tracer: Tracer) -> str:
    """One line per traced round: words modeled vs measured, drift, time."""
    lines = [f"{'round':28s} {'comm':6s} {'modeled':>10s} {'measured':>10s} "
             f"{'drift':>8s} {'ms':>9s}"]
    for r in tracer.rounds:
        name = (_name(r) + ("+sess" if r.session else "") + f"#{r.round}")
        mod = "-" if r.modeled_words is None else f"{r.modeled_words:.0f}"
        mea = "-" if r.measured_words is None \
            else f"{r.measured_words['total']:.0f}"
        dr = "-" if r.drift is None else f"{r.drift:.4f}"
        err = f"  ERROR={r.error}" if r.error else ""
        lines.append(f"{name:28s} {r.comm:6s} {mod:>10s} {mea:>10s} "
                     f"{dr:>8s} {r.dur * 1e3:9.3f}{err}")
    return "\n".join(lines)


def write_artifacts(out_dir: str, tag: str, *,
                    tracer: Optional[Tracer] = None,
                    registry: Optional[MetricsRegistry] = None) -> dict:
    """Write ``TRACE_<tag>.json`` / ``METRICS_<tag>.json`` into
    ``out_dir``; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    if tracer is not None:
        p = os.path.join(out_dir, f"TRACE_{tag}.json")
        with open(p, "w") as fh:
            json.dump(chrome_trace(tracer), fh)
        paths["trace"] = p
    if registry is not None:
        p = os.path.join(out_dir, f"METRICS_{tag}.json")
        with open(p, "w") as fh:
            fh.write(registry.to_json())
        paths["metrics"] = p
    return paths
