"""CLI for the observability plane.

* ``python -m repro_torch.obs --dashboard --metrics-dir DIR [--events-log F]
  [--watch S]`` — render the exported textfiles + event log in the
  terminal (one frame, or refreshed every ``--watch`` seconds).
* ``python -m repro_torch.obs --grafana-out FILE`` — write import-ready
  Grafana dashboard JSON for the exported metric families.
* ``python -m repro_torch.obs --smoke`` — CI smoke: run a real thread-mode
  mq dispatch with the metrics bus installed, publish the textfile,
  and assert it parses and the event log is well-formed JSONL.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time


def _smoke(keep_dir=None) -> int:
    import numpy as np

    from repro_torch.obs import (EventLog, MetricsRegistry, TextfileExporter,
                                 iter_events, parse_prometheus_text,
                                 queue_depth_timeline)
    from repro_torch.runtime import metrics as runtime_metrics

    root = keep_dir or tempfile.mkdtemp(prefix="chambga-obs-smoke-")
    os.makedirs(root, exist_ok=True)
    mq_dir = os.path.join(root, "mq")
    events_path = os.path.join(root, "events.jsonl")
    log = EventLog(events_path)
    reg = MetricsRegistry(events=log)
    runtime_metrics.set_registry(reg)
    try:
        from repro_torch.runtime.mq import LocalWorkerPool, QueueBackend
        backend = QueueBackend(
            fn_spec="repro_torch.fitness.hostsim:sphere", num_workers=4,
            mq_dir=mq_dir, run_id="obssmoke", lease_s=10.0,
            poll_interval_s=0.002,
            worker_pool=LocalWorkerPool(num_workers=2, mode="thread",
                                        poll_s=0.002))
        g = np.random.default_rng(0).uniform(
            -1.0, 1.0, (16, 4)).astype(np.float32)
        for _ in range(2):
            out = backend._host_eval(g)
            assert out.shape == (16, 1), out.shape
        backend.close()
        prom_path = os.path.join(mq_dir, "chambga.prom")
        TextfileExporter(reg, prom_path).write_once()
        with open(prom_path) as f:
            parsed = parse_prometheus_text(f.read())
        jobs = sum(v for (n, _), v in parsed.items()
                   if n == "mq_jobs_total")
        claims = sum(v for (n, _), v in parsed.items()
                     if n == "mq_claims_total")
        assert jobs == 2, f"expected 2 jobs in textfile, got {jobs}"
        assert claims >= 8, f"expected >=8 claims, got {claims}"
        events = list(iter_events(events_path))   # raises if malformed
        kinds = {e["kind"] for e in events}
        assert {"enqueue", "claim", "result"} <= kinds, kinds
        depth = queue_depth_timeline(events)
        assert depth and depth[-1][1] == 0, depth[-3:]
        print(f"obs smoke ok: {len(parsed)} series, "
              f"{len(events)} events, peak depth "
              f"{max(d for _, d in depth)}")
        return 0
    finally:
        runtime_metrics.set_registry(None)
        log.close()
        if keep_dir is None:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__)
    p.add_argument("--dashboard", action="store_true",
                   help="render metrics-dir/events-log in the terminal")
    p.add_argument("--metrics-dir", default=None,
                   help="directory holding exported *.prom textfiles "
                        "(typically the broker dir)")
    p.add_argument("--events-log", default=None,
                   help="JSONL event log to replay/tail")
    p.add_argument("--watch", type=float, default=None, metavar="S",
                   help="refresh the dashboard every S seconds")
    p.add_argument("--grafana-out", default=None, metavar="FILE",
                   help="write Grafana dashboard JSON and exit")
    p.add_argument("--smoke", action="store_true",
                   help="CI smoke: instrumented mq dispatch, assert "
                        "textfile parses + event log is valid JSONL")
    p.add_argument("--keep", default=None, metavar="DIR",
                   help="(smoke) keep artifacts under DIR")
    args = p.parse_args(argv)
    if args.smoke:
        return _smoke(args.keep)
    if args.grafana_out:
        from repro_torch.obs import write_grafana_dashboard
        write_grafana_dashboard(args.grafana_out)
        print(f"wrote {args.grafana_out}")
        return 0
    if args.dashboard:
        from repro_torch.obs import render_dashboard
        if not args.metrics_dir and not args.events_log:
            p.error("--dashboard needs --metrics-dir and/or --events-log")
        while True:
            frame = render_dashboard(args.metrics_dir, args.events_log)
            if args.watch is None:
                sys.stdout.write(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame)
            sys.stdout.flush()
            try:
                time.sleep(args.watch)
            except KeyboardInterrupt:
                return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
