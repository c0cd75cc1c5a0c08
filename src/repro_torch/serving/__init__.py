"""Serving layer: continuous batching over the distributed api.

Port of ``repro.serving``.  Two sub-stacks share this package:

* the distributed serving engine (requests/pool/batcher/server):
  coalesced SDDMM/SpMM rounds over pooled graph deployments, each round
  on the port's hand-written kernels.  :class:`ServingEngine` is the
  engine; :func:`replay_trace` replays an open-loop arrival trace
  through it.  Across cards the engine runs over a process group: a
  front end (rank 0) broadcasts each tick's requests and every rank runs
  the tick's rounds (:meth:`ServingEngine.follow` on the others, ended
  by :meth:`ServingEngine.stop`);
* the local LM decode path (:mod:`repro_torch.serving.decode`): prefill
  + greedy decode on the one-card model, imported explicitly so this
  package does not pull the model stack in for graph serving
  (``repro_torch.serving.engine`` is a deprecated alias that warns on
  import).
"""
from repro_torch.serving.pool import Deployment, SessionPool, content_key
from repro_torch.serving.requests import (AdmissionError, AggregateRequest,
                                          RequestQueue, ScoreRequest, Ticket)
from repro_torch.serving.server import ServingEngine, replay_trace

__all__ = [
    "AdmissionError", "AggregateRequest", "Deployment", "RequestQueue",
    "ScoreRequest", "ServingEngine", "SessionPool", "Ticket",
    "content_key", "replay_trace",
]
