"""Exporters: Prometheus text exposition over a snapshot, the atomic
textfile writer, and the optional stdlib HTTP ``/metrics`` endpoint.

The textfile path is the HPC-native one: the ``.prom`` file is
published ATOMICALLY (tmp sibling + fsync + rename, via
``runtime/fsatomic``) into the broker directory, where a node-exporter
textfile collector — or this package's ``--dashboard`` — polls it with
zero extra daemons; a scraper never sees a torn write, only the
previous whole file or the next. The HTTP endpoint is the cloud-native
one: ``http.server`` only, no dependencies, for runs where a Prometheus
can reach the manager over the network.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from repro_torch.runtime.fsatomic import atomic_write_text

PROM_FILENAME = "chambga.prom"

LabelKey = Tuple[Tuple[str, str], ...]


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _unescape(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt_labels(labels: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Render a ``MetricsRegistry.snapshot()`` in Prometheus text
    exposition format (``# TYPE`` lines, cumulative histogram buckets
    with ``le`` labels, ``_sum``/``_count`` series)."""
    lines = []
    by_name: Dict[str, list] = {}
    for (name, labels), v in sorted(snapshot.get("counters", {}).items()):
        by_name.setdefault(name, []).append((labels, v))
    for name, series in by_name.items():
        lines.append(f"# TYPE {name} counter")
        for labels, v in series:
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
    by_name = {}
    for (name, labels), v in sorted(snapshot.get("gauges", {}).items()):
        by_name.setdefault(name, []).append((labels, v))
    for name, series in by_name.items():
        lines.append(f"# TYPE {name} gauge")
        for labels, v in series:
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
    by_name = {}
    for (name, labels), h in sorted(snapshot.get("histograms", {}).items()):
        by_name.setdefault(name, []).append((labels, h))
    for name, series in by_name.items():
        lines.append(f"# TYPE {name} histogram")
        for labels, h in series:
            cum = 0
            for upper, n in zip(h["buckets"], h["counts"]):
                cum += n
                le = (("le", _fmt_value(upper)),)
                lines.append(f"{name}_bucket{_fmt_labels(labels, le)} "
                             f"{cum}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} "
                         f"{_fmt_value(h['sum'])}")
            lines.append(f"{name}_count{_fmt_labels(labels)} "
                         f"{h['count']}")
    lines.append("# TYPE obs_dropped_series_total counter")
    lines.append("obs_dropped_series_total "
                 f"{int(snapshot.get('dropped_series', 0))}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[Tuple[str, LabelKey], float]:
    """Parse exposition text back into ``{(name, labels): value}`` —
    the test-side inverse of :func:`render_prometheus` (comments are
    skipped; histogram ``_bucket``/``_sum``/``_count`` series appear
    under their suffixed names)."""
    out: Dict[Tuple[str, LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        labels: tuple = ()
        if "{" in line:
            name, rest = line.split("{", 1)
            body, tail = rest.rsplit("}", 1)
            pairs = []
            for part in _split_labels(body):
                k, v = part.split("=", 1)
                pairs.append((k.strip(), _unescape(v.strip().strip('"'))))
            labels = tuple(pairs)
            value = tail.strip()
        else:
            name, value = line.rsplit(None, 1)
        v = float("inf") if value == "+Inf" else float(value)
        out[(name.strip(), labels)] = v
    return out


def _split_labels(body: str) -> list:
    parts, cur, in_str, esc = [], [], False, False
    for c in body:
        if esc:
            cur.append(c)
            esc = False
        elif c == "\\":
            cur.append(c)
            esc = True
        elif c == '"':
            cur.append(c)
            in_str = not in_str
        elif c == "," and not in_str:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p.strip()]


class TextfileExporter:
    """Periodically publish the registry as a ``.prom`` textfile.

    Every write goes through ``atomic_write_text`` — the file lives in
    a POLLED directory (the broker dir, typically), so the torn-write
    rules of the queue protocol apply to it too (the ``tmp-invisible``
    lint covers this module). ``write_once()`` is also the synchronous
    entry for end-of-run flushes."""

    def __init__(self, registry, path: str, interval_s: float = 2.0):
        self.registry = registry
        self.path = path
        self.interval_s = float(interval_s)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write_once(self) -> str:
        text = render_prometheus(self.registry.snapshot())
        atomic_write_text(self.path, text)
        return text

    def _run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.write_once()
            except OSError:
                pass                             # shared-FS hiccup: retry

    def start(self):
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def stop(self, *, final_write: bool = True):
        if self._thread is not None:
            self._stop_evt.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_write:
            try:
                self.write_once()
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False


class MetricsHTTPServer:
    """Optional ``/metrics`` endpoint on stdlib ``http.server`` for
    cloud runs (no textfile collector on the node). ``port=0`` binds an
    ephemeral port, read back from :attr:`port` after :meth:`start`."""

    def __init__(self, registry, port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry
        self.host = host
        self.port = int(port)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = render_prometheus(registry.snapshot()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass                             # no stderr chatter

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False
