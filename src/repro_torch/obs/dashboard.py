"""Terminal dashboard over the exported textfiles + event log, and a
Grafana-dashboard-JSON generator for runs scraped into a real Prometheus.

The terminal renderer is deliberately dumb: it reads the SAME artifacts
an external scraper would (``*.prom`` textfiles, the JSONL event log)
rather than reaching into a live registry — if the dashboard can see
it, so can node-exporter. Directory listings are suffix-filtered so an
in-flight atomic write's ``*.tmp`` sibling is invisible, same contract
as every other polled broker path.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.events import iter_events, queue_depth_timeline
from repro_torch.obs.export import LabelKey, parse_prometheus_text

# metric families the canned Grafana dashboard graphs; panels are one
# per entry: (metric or PromQL expr, panel title)
GRAFANA_PANELS = (
    ("mq_ready_total", "Ready tasks (queue depth)"),
    ("mq_leased_total", "Leased tasks (in evaluation)"),
    ("autoscaler_size", "Fleet size vs desired"),
    ("mq_worker_utilization", "Worker utilization"),
    ("mq_cost_per_task_seconds", "Cost per task (EMA)"),
    ("mq_outstanding_cost_seconds", "Predicted outstanding cost"),
    ("rate(mq_claims_total[1m])", "Claim rate"),
    ("rate(mq_results_streamed_total[1m])", "Result stream rate"),
    ("rate(mq_lease_requeues_total[1m])", "Lease re-queue rate"),
    ("histogram_quantile(0.9, "
     "rate(mq_chunk_duration_seconds_bucket[5m]))",
     "Chunk duration p90"),
    ("histogram_quantile(0.9, "
     "rate(mq_claim_latency_seconds_bucket[5m]))",
     "Claim latency p90"),
)


def load_metrics_dir(metrics_dir: str) -> Dict[Tuple[str, LabelKey], float]:
    """Parse every published ``*.prom`` textfile in ``metrics_dir``.
    Suffix-filtered: an atomic write's ``.tmp`` sibling (or any other
    broker file) is never read."""
    merged: Dict[Tuple[str, LabelKey], float] = {}
    try:
        names = sorted(os.listdir(metrics_dir))
    except OSError:
        return merged
    for name in names:
        if not name.endswith(".prom"):
            continue
        try:
            with open(os.path.join(metrics_dir, name)) as f:
                merged.update(parse_prometheus_text(f.read()))
        except (OSError, ValueError):
            continue                             # racing replace: next poll
    return merged


def _sparkline(series: List[float], width: int = 32) -> str:
    if not series:
        return ""
    blocks = " ▁▂▃▄▅▆▇█"
    tail = series[-width:]
    hi = max(tail) or 1.0
    return "".join(blocks[min(8, int(8 * v / hi))] for v in tail)


def _fmt_key(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def render_dashboard(metrics_dir: Optional[str] = None,
                     events_log: Optional[str] = None,
                     max_events: int = 12) -> str:
    """One frame of the terminal dashboard: current metric values from
    the textfiles, a queue-depth sparkline replayed from the event log,
    and the most recent events."""
    lines = ["== CHAMB-GA dispatch observability =="]
    metrics = load_metrics_dir(metrics_dir) if metrics_dir else {}
    if metrics:
        lines.append(f"-- metrics ({metrics_dir}) --")
        plain = {k: v for k, v in sorted(metrics.items())
                 if not k[0].endswith(("_bucket", "_sum", "_count"))}
        for (name, labels), v in plain.items():
            lines.append(f"  {_fmt_key(name, labels):<52} {v:g}")
        counts = {k: v for k, v in sorted(metrics.items())
                  if k[0].endswith("_count")}
        for (name, labels), n in counts.items():
            total = metrics.get((name[:-len("_count")] + "_sum", labels))
            if total is not None and n:
                lines.append(
                    f"  {_fmt_key(name[:-len('_count')], labels):<52} "
                    f"n={n:g} mean={total / n:.4g}s")
    elif metrics_dir:
        lines.append(f"-- metrics ({metrics_dir}) -- (no *.prom yet)")
    if events_log and os.path.exists(events_log):
        evts = list(iter_events(events_log))
        depth = queue_depth_timeline(evts)
        lines.append(f"-- events ({events_log}: {len(evts)} records) --")
        if depth:
            series = [float(d) for _, d in depth]
            lines.append(f"  queue depth  peak={int(max(series))} "
                         f"now={int(series[-1])}  {_sparkline(series)}")
        for e in evts[-max_events:]:
            fields = " ".join(f"{k}={v}" for k, v in e.items()
                              if k not in ("t", "kind"))
            lines.append(f"  {e.get('t', 0.0):.3f} {e.get('kind'):<14} "
                         f"{fields}")
    return "\n".join(lines) + "\n"


def grafana_dashboard(title: str = "CHAMB-GA dispatch",
                      datasource: str = "Prometheus") -> dict:
    """Grafana dashboard JSON (schema v36-ish, import-ready) graphing
    the exported metric families — one timeseries panel per entry of
    :data:`GRAFANA_PANELS`."""
    panels = []
    for i, (expr, panel_title) in enumerate(GRAFANA_PANELS):
        panels.append({
            "id": i + 1,
            "title": panel_title,
            "type": "timeseries",
            "datasource": {"type": "prometheus", "uid": datasource},
            "gridPos": {"h": 8, "w": 8,
                        "x": 8 * (i % 3), "y": 8 * (i // 3)},
            "targets": [{"expr": expr, "refId": "A",
                         "legendFormat": "{{run}}"}],
            "fieldConfig": {"defaults": {"custom": {
                "drawStyle": "line", "fillOpacity": 10}}, "overrides": []},
        })
    return {
        "title": title,
        "schemaVersion": 36,
        "tags": ["chamb-ga", "dispatch"],
        "timezone": "browser",
        "refresh": "5s",
        "time": {"from": "now-15m", "to": "now"},
        "panels": panels,
        "templating": {"list": []},
        "annotations": {"list": []},
    }


def write_grafana_dashboard(path: str, **kwargs) -> None:
    from repro_torch.runtime.fsatomic import atomic_write_text
    atomic_write_text(path, json.dumps(grafana_dashboard(**kwargs),
                                       indent=2, sort_keys=True) + "\n")
