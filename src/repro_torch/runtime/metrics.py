"""Metrics seam for the dispatch runtime — the zero-cost half of the
observability plane.

The runtime (``mq.py``, ``batchq.py``, ``core/hostbridge.py``) publishes
counters, gauges, histograms and structured events through the module
global installed here. By default that global is :data:`NULL`, a no-op
sink whose ``enabled`` flag is ``False`` — instrumentation sites guard
with ``if m.enabled:`` so even the *argument expressions* of an emission
cost nothing when observability is off. ``repro_torch.obs.MetricsRegistry``
duck-types the same write interface and is installed with
:func:`set_registry` by whoever owns the run (ga_run, tests, benchmarks).

Like the thread sanitizer, the plane must be zero-cost when disabled:
this module is stdlib-only, lives inside ``runtime/`` so the
worker-purity closure stays green, and ``runtime/`` never imports
``repro_torch.obs`` (the import-graph test pins it) — the dependency points
the other way.
"""
from __future__ import annotations


class NullMetrics:
    """Do-nothing metrics sink; the default registry.

    Mirrors the write interface of ``repro_torch.obs.MetricsRegistry``:
    ``inc`` / ``set_gauge`` / ``observe`` / ``event``. ``enabled`` is
    ``False`` so emission sites can skip building label dicts and
    computing values entirely.
    """

    enabled = False

    def inc(self, name, value=1.0, **labels):
        pass

    def set_gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def event(self, kind, **fields):
        pass


NULL = NullMetrics()

_registry = NULL


def set_registry(registry) -> None:
    """Install the process-wide metrics sink (``None`` restores the
    no-op default). The reference swap is atomic under the GIL; emission
    sites re-read it per call, so installation mid-run takes effect on
    the next emission."""
    global _registry
    _registry = NULL if registry is None else registry


def get_registry():
    """The current process-wide metrics sink (never ``None``)."""
    return _registry
