"""Append-only structured event log (JSONL) + replay helpers.

One JSON object per line: ``{"t": epoch_s, "kind": ..., **fields}``.
Appends are line-buffered single ``write()`` calls under a lock, so
concurrent emitters (worker threads, the pump loop, the autoscaler)
never interleave bytes within a line; a reader tailing the file sees
whole records or nothing. The log is append-only BY DESIGN — unlike
the polled metric textfiles it is never replaced in place, so the
atomic-write protocol does not apply; a crash can at worst truncate
the final line, which :func:`iter_events` tolerates.

:func:`queue_depth_timeline` replays queue events back into a depth
series, reconstructing what the broker directory looked like over time
from the log alone — the test suite uses it to cross-check the live
gauges against the event stream.
"""
from __future__ import annotations

import json
import threading
from typing import Iterable, Iterator, List, Tuple


class EventLog:
    """Durable event sink: hand one to ``MetricsRegistry(events=...)``
    and every ``event()`` lands here as one JSONL line."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        # append-only journal, deliberately NOT an atomic replace:
        # lines are only ever added, never rewritten (the atomic-write
        # rule scopes to the queue protocol modules; tmp-invisible
        # covers this package's listings instead)
        self._f = open(path, "a", buffering=1)

    def emit(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True,
                          separators=(",", ":"), default=str)
        with self._lock:
            self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False


def iter_events(path: str) -> Iterator[dict]:
    """Yield event records from a JSONL log. A torn final line (writer
    crashed mid-append) is skipped, not fatal."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue                         # torn tail write


def replay_events(path: str, kinds: Iterable[str] = ()) -> List[dict]:
    """Load the log (optionally filtered to ``kinds``), time-ordered."""
    want = set(kinds)
    evts = [e for e in iter_events(path)
            if not want or e.get("kind") in want]
    evts.sort(key=lambda e: e.get("t", 0.0))
    return evts


def queue_depth_timeline(events: Iterable[dict]) -> List[Tuple[float, int]]:
    """Reconstruct ready-queue depth over time from queue events.

    ``enqueue`` raises depth by its ``chunks`` count (one task file per
    chunk), ``claim`` lowers it by one (task renamed into ``claimed/``),
    ``lease_requeue`` raises it back by one (stale lease renamed back
    into ``tasks/``). Returns ``[(t, depth), ...]`` after each event.
    """
    depth = 0
    out: List[Tuple[float, int]] = []
    for e in sorted(events, key=lambda e: e.get("t", 0.0)):
        kind = e.get("kind")
        if kind == "enqueue":
            depth += int(e.get("chunks", 1))
        elif kind == "claim":
            depth -= 1
        elif kind == "lease_requeue":
            depth += 1
        else:
            continue
        out.append((e.get("t", 0.0), depth))
    return out
