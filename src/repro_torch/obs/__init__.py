"""Observability: per-round comm spans, live cost-model drift, metrics.

Port of ``repro.obs``, with the same names.  Two surfaces, each armed on
its own and zero-cost when disabled (one module attribute read on the
executor hot path):

* :mod:`repro_torch.obs.tracer` -- ``with obs.trace() as tr:`` spans
  every executor round at the gather/phase/shift/reduce coordinates the
  fault harness guards, with modeled (``schedule_words``) against
  measured (the collective log's) wire words and their ratio, the
  **cost-model drift**, and on the card the device time of each round
  and of each event's moves (:mod:`repro_torch.obs.moves`);
* :mod:`repro_torch.obs.metrics` -- ``with obs.collect() as reg:`` one
  labeled counter/gauge/histogram registry with a JSON-exact snapshot.

:mod:`repro_torch.obs.export` renders traces as Perfetto-loadable Chrome
trace JSON and writes ``TRACE_<tag>.json`` / ``METRICS_<tag>.json`` into
a directory its caller names.
"""
from repro_torch.obs import metrics
from repro_torch.obs.export import chrome_trace, round_summary, write_artifacts
from repro_torch.obs.metrics import MetricsRegistry, collect
from repro_torch.obs.tracer import EventSpan, RoundSpan, Tracer, active, trace

__all__ = [
    "EventSpan", "MetricsRegistry", "RoundSpan", "Tracer", "active",
    "chrome_trace", "collect", "metrics", "round_summary", "trace",
    "write_artifacts",
]
