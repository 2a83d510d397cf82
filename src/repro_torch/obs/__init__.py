"""Observability plane for the dispatch runtime: metrics bus,
structured events, Prometheus export, terminal dashboard.

The plane is strictly one-directional: ``repro_torch.obs`` imports from the
runtime, NEVER the reverse — ``runtime/`` publishes through the no-op
seam in :mod:`repro_torch.runtime.metrics` and stays importable (and
worker-purity clean) without this package. Install the live bus with::

    from repro_torch.obs import MetricsRegistry, EventLog
    from repro_torch.runtime import metrics as runtime_metrics

    reg = MetricsRegistry(events=EventLog("events.jsonl"))
    runtime_metrics.set_registry(reg)

Exporters (:class:`TextfileExporter`, :class:`MetricsHTTPServer`) and
the cost-signal ``FleetAutoscaler`` both read the SAME registry, so a
test can drive autoscaling decisions purely through planted metrics.
``python -m repro_torch.obs --dashboard`` renders the exported artifacts in
a terminal; ``--grafana-out`` emits importable dashboard JSON.
"""
from repro_torch.obs.dashboard import (grafana_dashboard, load_metrics_dir,
                                       render_dashboard,
                                       write_grafana_dashboard)
from repro_torch.obs.events import (EventLog, iter_events,
                                    queue_depth_timeline, replay_events)
from repro_torch.obs.export import (PROM_FILENAME, MetricsHTTPServer,
                                    TextfileExporter, parse_prometheus_text,
                                    render_prometheus)
from repro_torch.obs.registry import DEFAULT_BUCKETS, MetricsRegistry

__all__ = [
    "DEFAULT_BUCKETS", "EventLog", "MetricsHTTPServer",
    "MetricsRegistry", "PROM_FILENAME", "TextfileExporter",
    "grafana_dashboard", "iter_events", "load_metrics_dir",
    "parse_prometheus_text", "queue_depth_timeline", "render_dashboard",
    "render_prometheus", "replay_events", "write_grafana_dashboard",
]
