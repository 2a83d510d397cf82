"""In-process metrics registry: counters, gauges, histograms with
labels, plus a bounded ring of structured events.

Dependency-free (stdlib only) and thread-safe: one leaf lock guards
every table, taken last in any runtime lock order (emission sites call
in while holding backend/autoscaler locks; the registry never calls
out), so it can be written from worker threads, the manager's pump
loop, and the autoscaler's control thread at once. ``snapshot()``
returns a deep copy taken under the same lock — exporters and the
cost-signal autoscaler read a consistent cut, never live tables.

Series identity is ``(metric name, sorted label items)``. Total series
are capped (``max_series``): past the cap new series are dropped and
counted in ``dropped_series`` instead of growing without bound — a
mis-labelled emission (e.g. a task id used as a label) degrades to a
counter, not an OOM.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# Prometheus-style default buckets, in seconds: spans a worker poll
# (~1 ms) through a straggling chunk (~minutes)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"))

LabelKey = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelKey]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0


class MetricsRegistry:
    """The live metrics bus. Write interface (``inc`` / ``set_gauge`` /
    ``observe`` / ``event``) matches
    ``repro_torch.runtime.metrics.NullMetrics`` so the runtime seam can
    swap between them; the read interface
    (``snapshot`` / ``counter_total`` / ``gauge_value`` / ``agg_gauge``)
    serves the exporters and the cost-signal autoscaler."""

    enabled = True

    def __init__(self, *, max_series: int = 1024, events=None,
                 event_ring: int = 512):
        self.max_series = int(max_series)
        self.dropped_series = 0
        #: optional EventLog (or any object with ``emit(record)``) that
        #: durable-sinks every event alongside the in-memory ring
        self.events = events
        self._lock = threading.Lock()
        self._counters: Dict[SeriesKey, float] = {}
        self._gauges: Dict[SeriesKey, float] = {}
        self._hists: Dict[SeriesKey, _Hist] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._ring: deque = deque(maxlen=int(event_ring))

    # -- write side -----------------------------------------------------
    def declare_histogram(self, name: str, buckets) -> None:
        """Set custom bucket bounds for ``name`` (before first observe).
        Bounds are upper edges; +inf is appended if missing."""
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        with self._lock:
            self._buckets[name] = bs

    def _admit(self, table: dict, key: SeriesKey) -> bool:
        # caller holds self._lock
        if key in table:
            return True
        total = (len(self._counters) + len(self._gauges)
                 + len(self._hists))
        if total >= self.max_series:
            self.dropped_series += 1
            return False
        return True

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            if self._admit(self._counters, key):
                self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            if self._admit(self._gauges, key):
                self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                if not self._admit(self._hists, key):
                    return
                h = self._hists[key] = _Hist(
                    self._buckets.get(name, DEFAULT_BUCKETS))
            v = float(value)
            for i, upper in enumerate(h.buckets):
                if v <= upper:
                    h.counts[i] += 1
                    break
            h.sum += v
            h.count += 1

    def event(self, kind: str, **fields) -> None:
        rec = {"t": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._ring.append(rec)
        sink = self.events
        if sink is not None:
            sink.emit(rec)

    # -- read side ------------------------------------------------------
    def snapshot(self) -> dict:
        """Deep, consistent copy of every table: ``{"counters": {...},
        "gauges": {...}, "histograms": {key: {"buckets": [...],
        "counts": [...], "sum": s, "count": n}}, "dropped_series": d}``
        keyed by ``(name, ((label, value), ...))``."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    key: {"buckets": list(h.buckets),
                          "counts": list(h.counts),
                          "sum": h.sum, "count": h.count}
                    for key, h in self._hists.items()},
                "dropped_series": self.dropped_series,
            }

    def recent_events(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            evts = list(self._ring)
        return evts if n is None else evts[-n:]

    def counter_total(self, name: str, default: float = 0.0) -> float:
        """Sum of ``name`` across all label sets (0.0 if absent)."""
        with self._lock:
            vals = [v for (n, _), v in self._counters.items() if n == name]
        return sum(vals) if vals else default

    def gauge_value(self, name: str, default: Optional[float] = None,
                    **labels) -> Optional[float]:
        """One labelled gauge series, or ``default`` when absent."""
        key = (name, _label_key(labels))
        with self._lock:
            return self._gauges.get(key, default)

    def agg_gauge(self, name: str, agg: str = "sum",
                  default: Optional[float] = None) -> Optional[float]:
        """Aggregate of ``name`` across all label sets: ``sum`` / ``mean``
        / ``max``. ``default`` when no series exists — callers (the
        cost-signal autoscaler) fall back to their own estimates."""
        with self._lock:
            vals = [v for (n, _), v in self._gauges.items() if n == name]
        if not vals:
            return default
        if agg == "mean":
            return sum(vals) / len(vals)
        if agg == "max":
            return max(vals)
        return sum(vals)

    def has_series(self, name: str) -> bool:
        with self._lock:
            return any(n == name for n, _ in list(self._counters)
                       + list(self._gauges) + list(self._hists))
