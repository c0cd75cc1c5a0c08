"""Labeled counters / gauges / histograms with a JSON-exact snapshot.

One process-wide metric surface for everything the repo used to count
ad-hoc: ``Session.stats()``, ``SessionPool`` hit/eviction/pin counts,
``ElasticProblem`` retry/degrade/fault tallies, serving tick latency and
batch occupancy, ``StepMonitor`` straggler flags.  The push API
(:meth:`MetricsRegistry.inc` / :meth:`gauge` / :meth:`observe`) covers
event-shaped sources; :meth:`gather` absorbs an existing ``stats()``-style
dict as gauges so the owning classes keep their cheap local counters and
the registry pulls them at snapshot points.

Port of ``repro.obs.metrics``, the same code: framework-free, so the two
packages' snapshots compare key for key.

Zero-cost when disabled, mirroring ``repro_torch.distributed.faults``:
nothing here imports torch, no registry is installed by default, and an
instrumentation site pays exactly one module attribute read
(:func:`active` returning None) when no collection context is armed.

Snapshots round-trip: ``MetricsRegistry.from_snapshot(r.snapshot())``
reproduces ``r.snapshot()`` bit-for-bit — the ``METRICS_<tag>.json``
artifact contract (docs/observability.md).
"""
from __future__ import annotations

import contextlib
import json
import math
from typing import Dict, Optional, Tuple

__all__ = [
    "MetricsRegistry", "active", "collect", "HIST_BOUNDS",
]

#: Shared histogram bucket upper bounds: log-spaced, 4 per decade, from
#: 1 microsecond-scale to 1e6 — wide enough for latencies in seconds AND
#: batch occupancies in slots without per-metric configuration.
HIST_BOUNDS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 4.0), 10) for e in range(-24, 25))


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Counters, gauges and histograms keyed by (name, labels).

    A *series* is one (name, label-set) pair with a fixed type; mixing
    types on one series raises (the usual metrics-client contract).
    Histograms record count/sum/min/max plus :data:`HIST_BOUNDS` bucket
    counts — enough for rate, mean and coarse quantiles without storing
    samples.
    """

    def __init__(self):
        # (name, ((k, v), ...)) -> series dict
        self._series: Dict[tuple, dict] = {}

    # -- write paths ---------------------------------------------------------
    def _get(self, name: str, mtype: str, labels: Dict[str, object]) -> dict:
        key = (name, _label_key(labels))
        s = self._series.get(key)
        if s is None:
            s = dict(name=name, type=mtype,
                     labels={k: v for k, v in key[1]})
            if mtype == "histogram":
                s.update(count=0, sum=0.0, min=math.inf, max=-math.inf,
                         buckets=[0] * (len(HIST_BOUNDS) + 1))
            else:
                s["value"] = 0.0
            self._series[key] = s
        elif s["type"] != mtype:
            raise TypeError(f"series {name!r}{dict(key[1])} is "
                            f"{s['type']}, not {mtype}")
        return s

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add to a monotone counter series."""
        self._get(name, "counter", labels)["value"] += float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a point-in-time gauge series."""
        self._get(name, "gauge", labels)["value"] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one sample into a histogram series."""
        s = self._get(name, "histogram", labels)
        v = float(value)
        s["count"] += 1
        s["sum"] += v
        s["min"] = min(s["min"], v)
        s["max"] = max(s["max"], v)
        lo, hi = 0, len(HIST_BOUNDS)        # first bound >= v, else overflow
        while lo < hi:
            mid = (lo + hi) // 2
            if HIST_BOUNDS[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        s["buckets"][lo] += 1

    def gather(self, prefix: str, stats: Dict[str, object], **labels) -> None:
        """Absorb a ``stats()``-style dict of numbers as gauges.

        Non-numeric values are skipped — the owning class's identity
        fields (names, digests) stay out of the metric surface."""
        for k, v in stats.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.gauge(f"{prefix}.{k}", float(v), **labels)

    # -- read paths ----------------------------------------------------------
    def value(self, name: str, **labels) -> Optional[float]:
        """Current value of a counter/gauge series (None if absent)."""
        s = self._series.get((name, _label_key(labels)))
        return None if s is None or s["type"] == "histogram" \
            else s["value"]

    def histogram(self, name: str, **labels) -> Optional[dict]:
        """count/sum/min/max/mean of a histogram series (None if absent)."""
        s = self._series.get((name, _label_key(labels)))
        if s is None or s["type"] != "histogram":
            return None
        return dict(count=s["count"], sum=s["sum"], min=s["min"],
                    max=s["max"],
                    mean=(s["sum"] / s["count"]) if s["count"] else 0.0)

    def series(self):
        """All series dicts, deterministically ordered."""
        return [self._series[k] for k in sorted(self._series)]

    def merge(self, other: "MetricsRegistry", **labels) -> None:
        """Fold another registry's series into this one, adding
        ``labels`` to every merged series — how a sweep accumulates its
        per-run registries into one artifact.  Counters and histogram
        cells add; gauges take the merged value."""
        for s in other.series():
            lab = dict(s["labels"], **{k: str(v) for k, v in
                                       labels.items()})
            mine = self._get(s["name"], s["type"], lab)
            if s["type"] == "histogram":
                mine["count"] += s["count"]
                mine["sum"] += s["sum"]
                mine["min"] = min(mine["min"], s["min"])
                mine["max"] = max(mine["max"], s["max"])
                mine["buckets"] = [a + b for a, b in
                                   zip(mine["buckets"], s["buckets"])]
            elif s["type"] == "counter":
                mine["value"] += s["value"]
            else:
                mine["value"] = s["value"]

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able full state: ``{"series": [...]}``, sorted.

        Histogram ``min``/``max`` of an empty series serialize as None
        (JSON has no inf); :meth:`from_snapshot` restores them."""
        out = []
        for s in self.series():
            d = dict(s)
            if d["type"] == "histogram":
                d["buckets"] = list(d["buckets"])
                d["min"] = None if d["count"] == 0 else d["min"]
                d["max"] = None if d["count"] == 0 else d["max"]
            out.append(d)
        return {"series": out}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "MetricsRegistry":
        reg = cls()
        for d in snap.get("series", ()):
            s = reg._get(d["name"], d["type"], d.get("labels", {}))
            if d["type"] == "histogram":
                s["count"] = int(d["count"])
                s["sum"] = float(d["sum"])
                s["min"] = math.inf if d["min"] is None else float(d["min"])
                s["max"] = -math.inf if d["max"] is None else float(d["max"])
                s["buckets"] = [int(b) for b in d["buckets"]]
            else:
                s["value"] = float(d["value"])
        return reg

    def to_json(self, **dump_kw) -> str:
        dump_kw.setdefault("indent", 1)
        dump_kw.setdefault("sort_keys", True)
        return json.dumps(self.snapshot(), **dump_kw)

    def summary(self) -> str:
        """Human-readable one-line-per-series table."""
        lines = []
        for s in self.series():
            lab = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
            head = f"{s['name']}{{{lab}}}" if lab else s["name"]
            if s["type"] == "histogram":
                n = s["count"]
                mean = (s["sum"] / n) if n else 0.0
                lines.append(f"{head:52s} histogram n={n} mean={mean:.6g} "
                             f"min={s['min'] if n else '-'} "
                             f"max={s['max'] if n else '-'}")
            else:
                lines.append(f"{head:52s} {s['type']} "
                             f"value={s['value']:.6g}")
        return "\n".join(lines)


_ACTIVE: Optional[MetricsRegistry] = None


def active() -> Optional[MetricsRegistry]:
    """The armed registry, or None (the zero-cost disabled state)."""
    return _ACTIVE


@contextlib.contextmanager
def collect(registry: Optional[MetricsRegistry] = None):
    """Arm a registry for the dynamic extent of the context.

    Yields the registry; nesting restores the previous one on exit —
    same discipline as ``faults.inject``."""
    global _ACTIVE
    reg = MetricsRegistry() if registry is None else registry
    prev = _ACTIVE
    _ACTIVE = reg
    try:
        yield reg
    finally:
        _ACTIVE = prev
