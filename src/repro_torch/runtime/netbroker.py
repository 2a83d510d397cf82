"""Socket broker transport: the mq queue contract over TCP frames.

The port of the reference's ``runtime/netbroker.py``, byte for byte on the
wire (the same frames), so a port client can talk to a reference server
and the reverse. Workers are spawned as
``python -m repro_torch.runtime.netbroker --worker``.

CHAMB-GA's "central message broker" is a standalone microservice that
manager and workers talk to over the network — not a shared volume. The
file broker (:mod:`repro_torch.runtime.mq`) realizes the queue contract as a
shared broker directory, which is the zero-dependency fallback and the
conformance oracle, but every claim/heartbeat/result there is a
shared-FS metadata op: the bottleneck at fleet scale and a hard blocker
for cloud deployments without a shared volume. This module is the
network transport for the SAME contract:

* :class:`BrokerServer` — a single-process asyncio TCP service
  (``python -m repro_torch.runtime.netbroker --serve``). It owns a private,
  server-LOCAL broker directory and executes :mod:`repro_torch.runtime.mq`'s
  own protocol functions (:func:`~repro_torch.runtime.mq.claim_next`,
  :func:`~repro_torch.runtime.mq.write_lease`,
  :func:`~repro_torch.runtime.mq.publish_result`, ...) as RPC handlers inside
  one event loop — the queue contract (cross-run priority claims,
  mtime-heartbeat leases with delivery-bump re-queue, at-least-once
  delivery, first-result-wins, run-scoped namespaces, run-aware GC,
  poison-free fleet STOP) is therefore bit-identical to the file broker
  BY CONSTRUCTION, not by reimplementation. Only the server touches the
  directory; clients never need a shared filesystem.
* :class:`BrokerClient` — a blocking stdlib-socket client holding ONE
  persistent connection (workers keep theirs for their whole lifetime;
  heartbeat frames interleave with result frames on the same socket
  under a lock).
* :class:`SocketQueueBackend` — the manager: a
  :class:`~repro_torch.runtime.mq.QueueBackend` subclass that overrides
  exactly the ``_t_*`` transport seam with RPCs, inheriting the
  chunking / streaming pump / retry / GC logic verbatim.
* :func:`net_worker_loop` / :class:`NetWorkerPool` — the worker side
  (``python -m repro_torch.runtime.netbroker --worker --broker-addr H:P``):
  the same multi-tenant claim -> evaluate -> report loop as
  :func:`~repro_torch.runtime.mq.worker_loop`, but task payloads arrive in
  the CLAIM reply and results STREAM back inline as frames — one
  round-trip per report, no result file batching on the worker side.

Network transport
-----------------
Frame protocol (both directions)::

    !II big-endian prefix | JSON header (utf-8) | raw binary blob
     header_len blob_len

Every request header carries ``op``; every reply carries ``ok`` (plus
``error`` with the server traceback on False). Genome and fitness
arrays ride the blob: npz bytes for task payloads, raw float32 + a
``shape`` header field for fitness, so the hot result path never pays
a container format. Ops: CLAIM, LEASE, HEARTBEAT, RESULT, FAIL,
RELEASE, ENQUEUE, REGISTER_RUN, DEREGISTER_RUN (the run-scoped
CLOSE_RUN signal), RUN_INFO, RESOLVE_FAIL_SET/GET, TOMBSTONE, JANITOR,
GC_SWEEP, RESULT_FETCH / FAIL_FETCH / LEASE_STATE / REQUEUE (manager
pump), STOP_SET/CLEAR/GET (fleet-wide STOP), PING, and debug/test ops
(LIST, BACKDATE_LEASE, TORN_RESULT) that let the conformance suite and
the proto replay harness drive the exact adversarial schedules of the
file broker.

Failure semantics:

* A torn or partial frame (connection dropped mid-frame, short read)
  NEVER corrupts queue state: the server dispatches only complete
  frames and discards the connection on a short read, so a half-sent
  RESULT simply never happened — the worker's claim is later released
  or its lease expires and the manager re-queues the chunk under a
  bumped delivery (at-least-once, exactly the file broker's crash
  story).
* A worker that reconnects resumes claiming with no duplicate winner:
  first-result-wins is enforced server-side by the same
  first-existing-result acceptance as the file broker.
* Lease age is computed ON THE SERVER's clock (``LEASE_STATE`` returns
  the age, not a timestamp), so manager/worker clock skew can never
  fake a stale lease.
* Crash of the SERVER loses queued state (the server-local directory
  is private); managers see connection errors and fail their chunks
  through the normal retry budget. Run the file broker on a shared
  volume when you need broker-crash durability; run the socket broker
  when you need fleet scale or have no shared volume.

When to prefer which transport: the file broker (``mq``) needs no
server process and survives manager crashes on a durable shared volume
— the right default on one box and on SLURM/K8s clusters with a shared
FS. The socket broker (``mq-net``) needs no shared volume at all and
turns the per-poll shared-FS metadata storm into one TCP round-trip —
the right choice for cloud fleets and high worker counts. Where the
crossover lies for the port has not been measured;
``chip_smoke.py::transport_latency`` times one task's round trip over
each.

The server emits the same ``mq_*`` metrics as the file broker through
the :mod:`repro_torch.runtime.metrics` seam — claim counters/latency come
from :func:`~repro_torch.runtime.mq.claim_next` itself; the publish-side
counters (``mq_tasks_completed_total``, ``mq_task_failures_total``,
``mq_worker_busy_seconds_total``, ``mq_worker_idle_seconds_total``)
are emitted by the RESULT/FAIL/CLAIM handlers, since over this
transport the server is the one place that observes the whole fleet's
timeline.

Worker purity: this module is a worker entrypoint
(``python -m repro_torch.runtime.netbroker --worker``) and its module-scope
import closure is stdlib + numpy + the mq/fsatomic/metrics runtime
modules — the ``repro.analysis`` worker-purity checker enforces it, so
persistent socket workers keep the ~0.8 s numpy-only startup.

Model/conformance coverage: the proto spec's ``rpc_broker`` variant
maps the RPC steps onto the same actor machines (crash-mid-RESULT
drops the frame — nothing torn lands, unlike the file transport's
``*.tmp`` dropping) and must sweep clean;
``tests/backend_conformance.py`` and the replay corpus
(``tests/test_proto_replay.py``) run against BOTH transports.
"""
from __future__ import annotations

import asyncio
import io
import json
import os
import pickle
import socket
import struct
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime import metrics as _metrics
from repro_torch.runtime import mq
from repro_torch.runtime.fsatomic import atomic_write_bytes, atomic_write_text
from repro_torch.runtime.mq import (LEASE_SUFFIX, POISON_SUFFIX, STOP_NAME,
                                    QueueBackend, parse_task_name)

#: repo src/ root, for subprocess-mode worker PYTHONPATH
_SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# ---------------------------------------------------------------------------
# Frame codec
# ---------------------------------------------------------------------------

#: length prefix: header bytes, blob bytes (big-endian uint32 each)
_HDR = struct.Struct("!II")
#: sanity bounds — a corrupt prefix must not allocate gigabytes
MAX_HEADER = 1 << 20
MAX_BLOB = 1 << 31


class BrokerError(RuntimeError):
    """An RPC the server rejected (its traceback is the message)."""


def encode_frame(header: dict, blob: bytes = b"") -> bytes:
    """One wire frame: length prefix + JSON header + raw blob."""
    hd = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if len(hd) > MAX_HEADER or len(blob) > MAX_BLOB:
        raise ValueError("frame exceeds protocol bounds")
    return _HDR.pack(len(hd), len(blob)) + hd + blob


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` — a short
    read is a dropped/torn frame, never silently truncated data."""
    parts = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def recv_frame(sock: socket.socket) -> Tuple[dict, bytes]:
    """Blocking read of one whole frame from a stdlib socket."""
    hlen, blen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if hlen > MAX_HEADER or blen > MAX_BLOB:
        raise ConnectionError("corrupt frame prefix")
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    blob = _recv_exact(sock, blen) if blen else b""
    return header, blob


def _parse_addr(addr) -> Tuple[str, int]:
    """Normalize ``"host:port"`` / ``(host, port)`` to a tuple."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        if not host:
            raise ValueError(f"broker address must be HOST:PORT: {addr!r}")
        return host, int(port)
    host, port = addr
    return str(host), int(port)


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    # exception[atomic-write], as the reference allows: serializes genomes into
    # an in-memory wire frame — no polled path is ever written on the client
    # side
    np.savez(buf, **arrays)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

def _wire_stamp(state_dir: str, run: str) -> Optional[list]:
    """Registry stamp in its JSON wire form (list, not tuple), so
    client-side cache keys compare equal to what the server sends."""
    stamp = mq.registry_stamp(state_dir, run)
    return list(stamp) if stamp is not None else None


class BrokerServer:
    """Single-process asyncio TCP broker speaking the frame protocol.

    Owns a private server-local broker directory and executes
    :mod:`repro_torch.runtime.mq`'s protocol functions as op handlers; the
    event loop serializes every state transition, so the contract's
    atomicity (one claim winner, whole-or-nothing publishes) holds with
    no extra locking. ``start()`` runs the loop on a daemon thread and
    returns once the port is bound (``addr`` holds the bound
    ``(host, port)``); ``stop()`` shuts the loop down and removes the
    state directory when the server created it."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 state_dir: Optional[str] = None):
        self._host = host
        self._port = port
        self._owns_state = state_dir is None
        self.state_dir = state_dir or tempfile.mkdtemp(
            prefix="chambga-netbroker-")
        mq.make_broker_dirs(self.state_dir)
        self.addr: Optional[Tuple[str, int]] = None
        self._ready = threading.Event()
        self._boot_error: Optional[str] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopping: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "BrokerServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        if not self._ready.wait(30.0) or self._boot_error:
            raise RuntimeError(
                f"BrokerServer failed to bind {self._host}:{self._port}"
                + (f"\n{self._boot_error}" if self._boot_error else ""))
        return self

    def _serve(self) -> None:
        try:
            asyncio.run(self._amain())
        except Exception:
            self._boot_error = traceback.format_exc()
            self._ready.set()

    async def _amain(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stopping = asyncio.Event()
        server = await asyncio.start_server(
            self._handle, self._host, self._port)
        self.addr = server.sockets[0].getsockname()[:2]
        self._ready.set()
        async with server:
            await self._stopping.wait()

    def stop(self) -> None:
        thread = self._thread
        if thread is not None and thread.is_alive() \
                and self._loop is not None:
            self._loop.call_soon_threadsafe(self._stopping.set)
            thread.join(timeout=10.0)
        if self._owns_state:
            import shutil
            shutil.rmtree(self.state_dir, ignore_errors=True)

    def __enter__(self) -> "BrokerServer":
        return self.start()

    def __exit__(self, *exc_info) -> bool:
        self.stop()
        return False

    # -- connection handler --------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """One persistent client connection: dispatch complete frames
        until EOF. A short read (connection dropped mid-frame) discards
        the partial frame WITHOUT touching queue state — the torn-frame
        half of the at-least-once story."""
        try:
            while True:
                try:
                    prefix = await reader.readexactly(_HDR.size)
                except asyncio.IncompleteReadError:
                    return                       # clean close / torn frame
                hlen, blen = _HDR.unpack(prefix)
                if hlen > MAX_HEADER or blen > MAX_BLOB:
                    return                       # corrupt prefix: drop conn
                try:
                    raw = await reader.readexactly(hlen + blen)
                except asyncio.IncompleteReadError:
                    return                       # torn frame: no state op
                try:
                    header = json.loads(raw[:hlen].decode("utf-8"))
                    reply, rblob = self._dispatch(header, raw[hlen:])
                except Exception:
                    reply, rblob = {"ok": False,
                                    "error": traceback.format_exc()}, b""
                writer.write(encode_frame(reply, rblob))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            return                               # client vanished mid-reply
        finally:
            writer.close()

    def _dispatch(self, header: dict, blob: bytes) -> Tuple[dict, bytes]:
        op = header.get("op")
        handler = self._OPS.get(op)
        if handler is None:
            raise BrokerError(f"unknown op: {op!r}")
        reply, rblob = handler(self, header, blob)
        out = {"ok": True}
        out.update(reply)
        return out, rblob

    # -- run registry ops ----------------------------------------------
    def _op_ping(self, h: dict, blob: bytes):
        return {}, b""

    def _op_register_run(self, h: dict, blob: bytes):
        run = mq.sanitize_run_id(h["run"])
        if h.get("clear_resolve_fail"):
            try:
                os.remove(mq.resolve_fail_path(self.state_dir, run))
            except OSError:
                pass
        # the client pickled its fitness (register_run would, but the
        # callable lives in the manager's process); pickle first,
        # registry last — same publication order as register_run
        if blob:
            atomic_write_bytes(mq.run_pickle_path(self.state_dir, run),
                               blob)
        mq.register_run(self.state_dir, run,
                        priority=int(h.get("priority", 0)),
                        num_objectives=int(h.get("num_objectives", 1)),
                        fn_spec=h.get("fn_spec"))
        return {}, b""

    def _op_deregister_run(self, h: dict, blob: bytes):
        mq.deregister_run(self.state_dir, mq.sanitize_run_id(h["run"]))
        return {}, b""

    def _op_run_info(self, h: dict, blob: bytes):
        run = mq.sanitize_run_id(h["run"])
        spec = None
        reg = mq.run_registry_path(self.state_dir, run)
        try:
            with open(reg) as f:
                spec = json.load(f).get("fn_spec")
        except (OSError, ValueError):
            pass
        pkl = b""
        if h.get("want_pickle"):
            try:
                with open(mq.run_pickle_path(self.state_dir, run),
                          "rb") as f:
                    pkl = f.read()
            except OSError:
                pass
        legacy = os.path.exists(os.path.join(self.state_dir, mq._PAYLOAD))
        return {"stamp": _wire_stamp(self.state_dir, run),
                "fn_spec": spec, "legacy": legacy}, pkl

    def _op_resolve_fail_set(self, h: dict, blob: bytes):
        run = mq.sanitize_run_id(h["run"])
        try:
            atomic_write_text(mq.resolve_fail_path(self.state_dir, run),
                              blob.decode("utf-8"))
        except OSError:
            pass
        return {}, b""

    def _op_resolve_fail_get(self, h: dict, blob: bytes):
        path = mq.resolve_fail_path(self.state_dir,
                                    mq.sanitize_run_id(h["run"]))
        try:
            with open(path) as f:
                return {"msg": f.read()}, b""
        except OSError:
            return {"msg": None}, b""

    # -- worker protocol ops -------------------------------------------
    def _op_claim(self, h: dict, blob: bytes):
        if os.path.exists(os.path.join(self.state_dir, STOP_NAME)):
            return {"name": None, "stop": True, "stale_bad": []}, b""
        bad = h.get("bad_runs") or {}
        # a re-registered run id (stamp changed) gets a fresh chance —
        # the worker drops it from its local bad-run skip on reply
        stale = [r for r, s in bad.items()
                 if _wire_stamp(self.state_dir, r) != s]
        skip = tuple(r for r in bad if r not in stale)
        name = mq.claim_next(self.state_dir, skip_runs=skip)
        if name is None:
            m = _metrics.get_registry()
            if m.enabled and h.get("poll_s"):
                # over this transport the server owns the fleet timeline
                m.inc("mq_worker_idle_seconds_total", float(h["poll_s"]))
            return {"name": None, "stop": False, "stale_bad": stale}, b""
        if name.endswith(POISON_SUFFIX):
            try:
                os.remove(os.path.join(self.state_dir, mq.CLAIMED_DIR,
                                       name))
            except OSError:
                pass
            return {"name": name, "poison": True, "stop": False,
                    "stale_bad": stale}, b""
        parsed = parse_task_name(name)
        run = parsed[0] if parsed else ""
        with open(os.path.join(self.state_dir, mq.CLAIMED_DIR, name),
                  "rb") as f:
            payload = f.read()
        return {"name": name, "run": run, "poison": False, "stop": False,
                "stamp": _wire_stamp(self.state_dir, run),
                "stale_bad": stale}, payload

    def _op_lease(self, h: dict, blob: bytes):
        mq.write_lease(self.state_dir, h["name"])
        return {}, b""

    def _op_heartbeat(self, h: dict, blob: bytes):
        lease = os.path.join(self.state_dir, mq.CLAIMED_DIR,
                             h["name"]) + LEASE_SUFFIX
        try:
            os.utime(lease, None)
            return {"renewed": True}, b""
        except OSError:
            # the manager gave up on this worker and re-queued: the
            # client heartbeat thread stops, mirroring mq._Heartbeat
            return {"renewed": False}, b""

    def _op_result(self, h: dict, blob: bytes):
        name = h["name"]
        fit = np.frombuffer(blob, np.float32).reshape(
            [int(s) for s in h["shape"]])
        mq.publish_result(self.state_dir, name, fit,
                          float(h["duration"]))
        m = _metrics.get_registry()
        if m.enabled:
            parsed = parse_task_name(name)
            run = parsed[0] if parsed else ""
            busy = float(h.get("busy", h["duration"]))
            m.inc("mq_worker_busy_seconds_total", busy)
            m.inc("mq_tasks_completed_total", run=run)
            m.event("publish", task=name, run=run,
                    duration=round(busy, 6))
        return {}, b""

    def _op_fail(self, h: dict, blob: bytes):
        name = h["name"]
        mq.publish_fail(self.state_dir, name, blob.decode("utf-8"))
        m = _metrics.get_registry()
        if m.enabled:
            parsed = parse_task_name(name)
            run = parsed[0] if parsed else ""
            m.inc("mq_worker_busy_seconds_total",
                  float(h.get("busy", 0.0)))
            m.inc("mq_task_failures_total", run=run)
            m.event("fail", task=name, run=run)
        return {}, b""

    def _op_release(self, h: dict, blob: bytes):
        mq.release_claim(self.state_dir, h["name"])
        return {}, b""

    def _op_tombstone(self, h: dict, blob: bytes):
        return {"cleaned": mq.clean_if_run_closed(self.state_dir,
                                                  h["name"])}, b""

    def _op_janitor(self, h: dict, blob: bytes):
        removed = mq.janitor_sweep(self.state_dir,
                                   max_age_s=float(h["max_age_s"]))
        return {"removed": removed}, b""

    # -- manager pump ops ----------------------------------------------
    def _op_enqueue(self, h: dict, blob: bytes):
        atomic_write_bytes(os.path.join(self.state_dir, mq.TASKS_DIR,
                                        h["name"]), blob)
        return {}, b""

    def _op_result_fetch(self, h: dict, blob: bytes):
        path = mq.mq_result_path(self.state_dir, h["name"])
        if not os.path.exists(path):
            return {"found": False}, b""
        with np.load(path) as d:
            fit = np.asarray(d["fitness"], np.float32)
            dur = float(d["duration"])
        return {"found": True, "duration": dur,
                "shape": list(fit.shape)}, fit.tobytes()

    def _op_fail_fetch(self, h: dict, blob: bytes):
        path = mq.mq_fail_path(self.state_dir, h["name"])
        try:
            with open(path) as f:
                return {"msg": f.read()}, b""
        except OSError:
            return {"msg": None}, b""

    def _op_lease_state(self, h: dict, blob: bytes):
        claimed = os.path.join(self.state_dir, mq.CLAIMED_DIR, h["name"])
        if not os.path.exists(claimed):
            return {"claimed": False, "age_s": None}, b""
        try:
            # the lease AUTHORITY's clock: both the heartbeat utime and
            # this age computation happen on the server, so client clock
            # skew can never fake (or hide) a stale lease
            age = time.time() - os.path.getmtime(claimed + LEASE_SUFFIX)
            return {"claimed": True, "age_s": age}, b""
        except OSError:
            return {"claimed": True, "age_s": None}, b""

    def _op_requeue(self, h: dict, blob: bytes):
        claimed = os.path.join(self.state_dir, mq.CLAIMED_DIR, h["old"])
        try:
            os.rename(claimed, os.path.join(self.state_dir, mq.TASKS_DIR,
                                            h["new"]))
        except OSError:
            return {"requeued": False}, b""
        try:
            os.remove(claimed + LEASE_SUFFIX)
        except OSError:
            pass
        return {"requeued": True}, b""

    def _op_gc_sweep(self, h: dict, blob: bytes):
        keep = {int(j): set(names) for j, names in h["keep"].items()}
        mq.gc_sweep(self.state_dir, mq.sanitize_run_id(h["run"]),
                    set(h["active"]), keep)
        return {}, b""

    # -- fleet STOP ----------------------------------------------------
    def _op_stop_set(self, h: dict, blob: bytes):
        atomic_write_text(os.path.join(self.state_dir, STOP_NAME),
                          "stop\n")
        return {}, b""

    def _op_stop_clear(self, h: dict, blob: bytes):
        try:
            os.remove(os.path.join(self.state_dir, STOP_NAME))
        except OSError:
            pass
        return {}, b""

    def _op_stop_get(self, h: dict, blob: bytes):
        return {"stop": os.path.exists(
            os.path.join(self.state_dir, STOP_NAME))}, b""

    # -- debug/test ops ------------------------------------------------
    def _op_list(self, h: dict, blob: bytes):
        """RAW directory listings for test assertions (leftover checks,
        replay parity) — entries are returned verbatim, tmp/lease
        siblings included, and never acted on here."""
        out = {}
        for key, d in (("tasks", mq.TASKS_DIR), ("claimed", mq.CLAIMED_DIR),
                       ("results", mq.RESULTS_DIR), ("runs", mq.RUNS_DIR)):
            try:
                # exception[tmp-invisible], as the reference allows: debug op:
                # returns the RAW listing (tmp/lease included) for test
                # assertions; the server never acts on these names
                out[key] = sorted(os.listdir(
                    os.path.join(self.state_dir, d)))
            except OSError:
                out[key] = []
        return out, b""

    def _op_backdate_lease(self, h: dict, blob: bytes):
        lease = os.path.join(self.state_dir, mq.CLAIMED_DIR,
                             h["name"]) + LEASE_SUFFIX
        past = time.time() - float(h["age_s"])
        os.utime(lease, (past, past))
        return {}, b""

    def _op_torn_result(self, h: dict, blob: bytes):
        """Crash-mid-publish injection: drop a raw ``*.tmp`` sibling of
        a result, exactly what a killed atomic writer leaves behind."""
        from repro_torch.runtime.fsatomic import TMP_SUFFIX
        path = mq.mq_result_path(self.state_dir, h["name"]) + TMP_SUFFIX
        # exception[atomic-write], as the reference allows: deliberately TORN
        # test injection — this op exists to simulate a writer killed mid-
        # atomic-write
        with open(path, "wb") as f:
            f.write(b"torn")
        return {}, b""

    _OPS: Dict[str, Callable] = {
        "PING": _op_ping,
        "REGISTER_RUN": _op_register_run,
        "DEREGISTER_RUN": _op_deregister_run,
        "RUN_INFO": _op_run_info,
        "RESOLVE_FAIL_SET": _op_resolve_fail_set,
        "RESOLVE_FAIL_GET": _op_resolve_fail_get,
        "CLAIM": _op_claim,
        "LEASE": _op_lease,
        "HEARTBEAT": _op_heartbeat,
        "RESULT": _op_result,
        "FAIL": _op_fail,
        "RELEASE": _op_release,
        "TOMBSTONE": _op_tombstone,
        "JANITOR": _op_janitor,
        "ENQUEUE": _op_enqueue,
        "RESULT_FETCH": _op_result_fetch,
        "FAIL_FETCH": _op_fail_fetch,
        "LEASE_STATE": _op_lease_state,
        "REQUEUE": _op_requeue,
        "GC_SWEEP": _op_gc_sweep,
        "STOP_SET": _op_stop_set,
        "STOP_CLEAR": _op_stop_clear,
        "STOP_GET": _op_stop_get,
        "LIST": _op_list,
        "BACKDATE_LEASE": _op_backdate_lease,
        "TORN_RESULT": _op_torn_result,
    }


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class BrokerClient:
    """Blocking frame-protocol client over ONE persistent connection.

    ``call`` is serialized under a lock so a worker's heartbeat thread
    can interleave frames with its evaluation thread on the same
    socket. Connection errors surface as ``ConnectionError``/``OSError``
    — callers decide whether to :meth:`connect` again (workers do;
    their claim is recovered via lease expiry, at-least-once)."""

    def __init__(self, addr, *, timeout_s: float = 60.0):
        self.addr = _parse_addr(addr)
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.connect()

    def connect(self) -> "BrokerClient":
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            sock = socket.create_connection(self.addr,
                                            timeout=self.timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
        return self

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def call(self, op: str, header: Optional[dict] = None,
             blob: bytes = b"") -> Tuple[dict, bytes]:
        hd = dict(header or {})
        hd["op"] = op
        frame = encode_frame(hd, blob)
        with self._lock:
            if self._sock is None:
                raise ConnectionError("BrokerClient is closed")
            self._sock.sendall(frame)
            reply, rblob = recv_frame(self._sock)
        if not reply.get("ok"):
            raise BrokerError(reply.get("error", "broker error"))
        return reply, rblob

    # -- convenience wrappers (thin; the op table is the protocol) -----
    def ping(self) -> None:
        self.call("PING")

    def register_run(self, run: str, *, priority: int = 0,
                     num_objectives: int = 1,
                     fn_spec: Optional[str] = None,
                     fn_pickle: bytes = b"",
                     clear_resolve_fail: bool = True) -> None:
        self.call("REGISTER_RUN",
                  {"run": run, "priority": priority,
                   "num_objectives": num_objectives, "fn_spec": fn_spec,
                   "clear_resolve_fail": clear_resolve_fail}, fn_pickle)

    def deregister_run(self, run: str) -> None:
        self.call("DEREGISTER_RUN", {"run": run})

    def run_info(self, run: str, *, want_pickle: bool = False):
        return self.call("RUN_INFO",
                         {"run": run, "want_pickle": want_pickle})

    def resolve_fail_set(self, run: str, tb: str) -> None:
        self.call("RESOLVE_FAIL_SET", {"run": run}, tb.encode("utf-8"))

    def resolve_fail_get(self, run: str) -> Optional[str]:
        reply, _ = self.call("RESOLVE_FAIL_GET", {"run": run})
        return reply["msg"]

    def claim(self, bad_runs: Optional[dict] = None,
              poll_s: Optional[float] = None) -> Tuple[dict, bytes]:
        return self.call("CLAIM", {"bad_runs": bad_runs or {},
                                   "poll_s": poll_s})

    def lease(self, name: str) -> None:
        self.call("LEASE", {"name": name})

    def heartbeat(self, name: str) -> bool:
        reply, _ = self.call("HEARTBEAT", {"name": name})
        return bool(reply["renewed"])

    def result(self, name: str, fit: np.ndarray, duration: float, *,
               busy: Optional[float] = None) -> None:
        fit = np.asarray(fit, np.float32)
        self.call("RESULT", {"name": name, "duration": duration,
                             "busy": busy, "shape": list(fit.shape)},
                  fit.tobytes())

    def fail(self, name: str, tb: str, *,
             busy: Optional[float] = None) -> None:
        self.call("FAIL", {"name": name, "busy": busy},
                  tb.encode("utf-8"))

    def release(self, name: str) -> None:
        self.call("RELEASE", {"name": name})

    def tombstone(self, name: str) -> bool:
        reply, _ = self.call("TOMBSTONE", {"name": name})
        return bool(reply["cleaned"])

    def janitor(self, max_age_s: float) -> int:
        reply, _ = self.call("JANITOR", {"max_age_s": max_age_s})
        return int(reply["removed"])

    def enqueue(self, name: str, genomes: np.ndarray) -> None:
        self.call("ENQUEUE", {"name": name},
                  _npz_bytes(genomes=np.asarray(genomes, np.float32)))

    def result_fetch(self, name: str):
        reply, blob = self.call("RESULT_FETCH", {"name": name})
        if not reply["found"]:
            return None
        fit = np.frombuffer(blob, np.float32).reshape(
            [int(s) for s in reply["shape"]])
        return fit, float(reply["duration"])

    def fail_fetch(self, name: str) -> Optional[str]:
        reply, _ = self.call("FAIL_FETCH", {"name": name})
        return reply["msg"]

    def lease_state(self, name: str):
        reply, _ = self.call("LEASE_STATE", {"name": name})
        return bool(reply["claimed"]), reply["age_s"]

    def requeue(self, old: str, new: str) -> bool:
        reply, _ = self.call("REQUEUE", {"old": old, "new": new})
        return bool(reply["requeued"])

    def gc_sweep(self, run: str, active, keep_by_job: Dict) -> None:
        self.call("GC_SWEEP",
                  {"run": run, "active": sorted(active),
                   "keep": {str(j): sorted(names)
                            for j, names in keep_by_job.items()}})

    def stop_set(self) -> None:
        self.call("STOP_SET")

    def stop_clear(self) -> None:
        self.call("STOP_CLEAR")

    def stop_get(self) -> bool:
        reply, _ = self.call("STOP_GET")
        return bool(reply["stop"])

    def listdir(self) -> Dict[str, List[str]]:
        reply, _ = self.call("LIST")
        return {k: reply[k] for k in ("tasks", "claimed", "results",
                                      "runs")}

    def backdate_lease(self, name: str, age_s: float) -> None:
        self.call("BACKDATE_LEASE", {"name": name, "age_s": age_s})

    def torn_result(self, name: str) -> None:
        self.call("TORN_RESULT", {"name": name})

    def __enter__(self) -> "BrokerClient":
        return self

    def __exit__(self, *exc_info) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# Worker side (numpy-only; the socket twin of mq.worker_loop)
# ---------------------------------------------------------------------------

class _NetHeartbeat:
    """Background thread renewing a claimed task's lease over the
    worker's OWN connection (frames interleave under the client lock).
    Stops silently when the server reports the lease gone (the manager
    re-queued — our eventual result is still accepted, at-least-once)
    or the connection drops."""

    def __init__(self, client: BrokerClient, name: str, interval_s: float):
        self._client = client
        self._name = name
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                if not self._client.heartbeat(self._name):
                    return
            except (BrokerError, ConnectionError, OSError):
                return

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()


def _fn_from_info(info: dict, pkl: bytes) -> Callable:
    """Fitness callable from a RUN_INFO reply — import spec first,
    pickle fallback; mirrors :func:`repro_torch.runtime.mq.resolve_run_fn`."""
    spec = info.get("fn_spec")
    if spec:
        import importlib
        mod, _, attr = spec.partition(":")
        return getattr(importlib.import_module(mod), attr)
    if pkl:
        return pickle.loads(pkl)
    raise FileNotFoundError("run is not registered with the broker "
                            "(no fn_spec, no pickle)")


def _process_remote(client: BrokerClient, name: str, blob: bytes,
                    fn: Callable, heartbeat_s: float) -> bool:
    """Evaluate one claimed task whose payload arrived in the CLAIM
    reply: lease -> heartbeat -> eval -> stream RESULT/FAIL inline ->
    release. Eval errors publish a FAIL marker; connection errors
    propagate to the caller's reconnect handling."""
    client.lease(name)
    hb = _NetHeartbeat(client, name, heartbeat_s)
    hb.start()
    ok = False
    t_claim = time.perf_counter()
    try:
        try:
            genomes = np.load(io.BytesIO(blob))["genomes"]
            t0 = time.perf_counter()
            fit = np.asarray(fn(genomes),
                             np.float32).reshape(len(genomes), -1)
            duration = time.perf_counter() - t0
        except Exception:
            tb = traceback.format_exc()
            sys.stderr.write(tb)
            client.fail(name, tb, busy=time.perf_counter() - t_claim)
            return False
        client.result(name, fit, duration,
                      busy=time.perf_counter() - t_claim)
        ok = True
    finally:
        hb.stop()
        client.release(name)
    return ok


def net_worker_loop(addr, *, fn: Optional[Callable] = None,
                    lease_s: float = 15.0, poll_s: float = 0.05,
                    max_tasks: Optional[int] = None,
                    idle_exit_s: Optional[float] = None,
                    hang_substrings: tuple = ()) -> int:
    """Persistent socket worker: one connection, claim -> evaluate ->
    stream result until the broker reports the fleet-wide STOP (or
    ``max_tasks`` / ``idle_exit_s`` triggers). Multi-tenant exactly like
    :func:`repro_torch.runtime.mq.worker_loop`: per-run fitness resolved once
    via RUN_INFO and cached keyed on the registry stamp, RESOLVE_FAIL
    markers for unservable runs, idle-worker janitor sweeps, poison
    STOP tickets honored at chunk boundaries, ``hang_substrings`` fault
    injection (lease written once, worker dies unreported). A dropped
    connection is retried with a fresh connect — any claim lost
    mid-flight is recovered by lease expiry (at-least-once); a VANISHED
    broker ends the worker. Returns the number of tasks completed."""
    heartbeat_s = max(0.05, lease_s / 4.0)
    done = 0
    fns: Dict[str, tuple] = {}       # run -> (wire stamp, fitness)
    bad_runs: Dict[str, object] = {}  # run -> wire stamp when it failed
    try:
        client = BrokerClient(addr)
    except OSError:
        return 0
    idle_t0 = time.monotonic()
    janitor_t = time.monotonic()
    try:
        while True:
            try:
                reply, blob = client.claim(bad_runs, poll_s)
            except (BrokerError, ConnectionError, OSError):
                time.sleep(poll_s)
                try:
                    client.connect()
                except OSError:
                    return done                  # broker gone for good
                continue
            if reply.get("stop"):
                return done
            for run in reply.get("stale_bad", ()):
                # re-registered run id: fresh chance, same as worker_loop
                bad_runs.pop(run, None)
            name = reply.get("name")
            if name is None:
                if (idle_exit_s is not None
                        and time.monotonic() - idle_t0 > idle_exit_s):
                    return done
                # idle workers double as the fleet's janitor, throttled
                # to one sweep per lease window (server-side age guard
                # keeps anything live untouched)
                if time.monotonic() - janitor_t > lease_s:
                    janitor_t = time.monotonic()
                    try:
                        client.janitor(2.0 * lease_s)
                    except (BrokerError, ConnectionError, OSError):
                        pass
                time.sleep(poll_s)
                continue
            if reply.get("poison"):
                return done                      # scale-down: one worker out
            idle_t0 = time.monotonic()
            run = reply.get("run", "")
            stamp = reply.get("stamp")
            task_fn = fn
            if task_fn is None:
                hit = fns.get(run)
                if hit is not None and hit[0] == stamp:
                    task_fn = hit[1]
            try:
                if task_fn is None:
                    info, pkl = client.run_info(run, want_pickle=True)
                    stamp = info.get("stamp")
                    try:
                        task_fn = _fn_from_info(info, pkl)
                        fns[run] = (stamp, task_fn)
                    except Exception:
                        if stamp is None and not info.get("legacy"):
                            # the run deregistered between claim and
                            # resolve (close() raced us): stray task,
                            # not a bad spec — drop the claim quietly
                            bad_runs[run] = stamp
                            client.release(name)
                            continue
                        tb = traceback.format_exc()
                        sys.stderr.write(tb)
                        client.resolve_fail_set(run, tb)
                        bad_runs[run] = stamp
                        client.release(name)
                        continue
                if any(s in name for s in hang_substrings):
                    client.lease(name)
                    return done                  # the simulated kill -9
                _process_remote(client, name, blob, task_fn, heartbeat_s)
                if fn is None:
                    # late-report tombstone (registry-resolved runs only)
                    client.tombstone(name)
            except (ConnectionError, OSError):
                # dropped mid-task: the half-done claim is recovered by
                # lease expiry; reconnect and resume claiming
                time.sleep(poll_s)
                try:
                    client.connect()
                except OSError:
                    return done
                continue
            done += 1
            if max_tasks is not None and done >= max_tasks:
                return done
    finally:
        client.close()


class NetWorkerPool:
    """Socket-transport twin of
    :class:`repro_torch.runtime.mq.LocalWorkerPool`: a fleet of
    :func:`net_worker_loop` members on threads (fast,
    in-process) or subprocesses (real numpy-only interpreters, each
    holding its own persistent connection). ``addr`` may be bound later
    (``SocketQueueBackend(worker_pool=...)`` binds its broker address
    before starting the pool). ``stop()`` raises the fleet-wide STOP on
    the server — never use a shared pool's ``stop`` from a tenant that
    doesn't own the fleet."""

    def __init__(self, num_workers: int = 4, mode: str = "thread", *,
                 addr=None, fn: Optional[Callable] = None,
                 lease_s: float = 15.0, poll_s: float = 0.01,
                 hang_substrings: tuple = (),
                 python: Optional[str] = None):
        if mode not in ("thread", "subprocess"):
            raise ValueError(f"mode must be thread|subprocess: {mode}")
        self.num_workers = max(1, num_workers)
        self.mode = mode
        self.addr = _parse_addr(addr) if addr is not None else None
        self.fn = fn
        self.lease_s = lease_s
        self.poll_s = poll_s
        self.hang_substrings = tuple(hang_substrings)
        self.python = python or sys.executable
        self._members: list = []
        self._started = False
        # guards _members/num_workers/_started, same discipline as
        # LocalWorkerPool: grow() may run on another thread
        self._lock = threading.Lock()

    def _spawn_member(self):
        # caller holds self._lock
        if self.mode == "thread":
            t = threading.Thread(
                target=net_worker_loop, args=(self.addr,),
                kwargs=dict(fn=self.fn, lease_s=self.lease_s,
                            poll_s=self.poll_s,
                            hang_substrings=self.hang_substrings),
                daemon=True)
            t.start()
            self._members.append(t)
        else:
            import subprocess
            env = dict(os.environ)
            env["PYTHONPATH"] = _SRC_ROOT + (
                os.pathsep + env["PYTHONPATH"]
                if env.get("PYTHONPATH") else "")
            cmd = [self.python, "-m", "repro_torch.runtime.netbroker",
                   "--worker",
                   "--broker-addr", f"{self.addr[0]}:{self.addr[1]}",
                   "--lease-s", str(self.lease_s),
                   "--poll-s", str(self.poll_s)]
            if self.hang_substrings:
                cmd += ["--hang-substrings",
                        ",".join(self.hang_substrings)]
            self._members.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL))

    def start(self) -> "NetWorkerPool":
        with self._lock:
            if self._started:
                return self
            if self.addr is None:
                raise ValueError("NetWorkerPool.start: addr not bound")
            for _ in range(self.num_workers):
                self._spawn_member()
            self._started = True
        return self

    def grow(self, n: int) -> "NetWorkerPool":
        n = max(0, int(n))
        with self._lock:
            self.num_workers += n
            if self._started:
                for _ in range(n):
                    self._spawn_member()
        return self

    def alive_workers(self) -> int:
        with self._lock:
            members = list(self._members)
        alive = 0
        for m in members:
            if isinstance(m, threading.Thread):
                alive += m.is_alive()
            else:
                alive += m.poll() is None
        return alive

    def stop(self, timeout_s: float = 10.0):
        """Raise the fleet-wide STOP on the server and collect the
        members (threads are daemons; subprocesses are killed past the
        deadline)."""
        with self._lock:
            if not self._started:
                return
            # swap out under the lock; join/wait OUTSIDE it so a slow
            # drain never blocks a concurrent grow()/alive_workers()
            members, self._members = self._members, []
            self._started = False
        try:
            stopper = BrokerClient(self.addr, timeout_s=5.0)
            try:
                stopper.stop_set()
            finally:
                stopper.close()
        except (BrokerError, ConnectionError, OSError):
            pass                                 # server already gone
        deadline = time.monotonic() + timeout_s
        for m in members:
            left = max(0.0, deadline - time.monotonic())
            if isinstance(m, threading.Thread):
                m.join(timeout=left)
            else:
                import subprocess
                try:
                    m.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    m.kill()

    def __enter__(self) -> "NetWorkerPool":
        return self.start()

    def __exit__(self, *exc_info) -> bool:
        self.stop()
        return False


# ---------------------------------------------------------------------------
# Manager side
# ---------------------------------------------------------------------------

class SocketQueueBackend(QueueBackend):
    """``DispatchBackend`` over the socket broker — the network twin of
    :class:`repro_torch.runtime.mq.QueueBackend`, selectable via
    ``ga_run --dispatch-backend mq-net --broker-addr HOST:PORT``.

    Inherits the chunking, streaming pump, retry/timeout, lease
    re-queue, and GC logic verbatim and overrides ONLY the ``_t_*``
    transport seam with RPCs to a :class:`BrokerServer` — one contract,
    two transports. Three attachment modes:

    * ``broker_addr=...`` — attach to an external server (the cloud /
      multi-tenant deployment: several managers, one broker, workers
      launched separately with ``--worker --broker-addr``);
    * ``server=...`` — attach to a :class:`BrokerServer` object the
      caller owns (tests, benchmarks);
    * neither — self-contained: starts an in-process server (stopped on
      ``close()``). Pass a ``worker_pool`` (:class:`NetWorkerPool`) to
      own workers too.

    Fleet semantics mirror the file transport: the fleet-wide STOP is
    raised on close only when this backend owns the workers (its
    ``worker_pool``) or the whole server; a tenant closing against a
    shared server leaves the fleet and the other tenants alive. The
    autoscaler's poison-ticket protocol is not wired for this transport
    (``ga_run`` rejects ``--mq-autoscale`` with ``mq-net``)."""

    name = "mq-net"

    def __init__(self, fitness_fn: Optional[Callable] = None, *,
                 fn_spec: Optional[str] = None,
                 num_objectives: int = 1, num_workers: int = 4,
                 broker_addr=None,
                 server: Optional[BrokerServer] = None,
                 run_id: Optional[str] = None,
                 priority: int = 0,
                 lease_s: float = 15.0,
                 chunk_timeout_s: Optional[float] = 300.0,
                 max_retries: int = 2,
                 poll_interval_s: float = 0.02,
                 cost_ema=None,
                 chunk_sizing: str = "cost",
                 min_chunk_cost_s: float = 0.0,
                 keep_jobs: Optional[int] = 4,
                 worker_pool: Optional[NetWorkerPool] = None,
                 step_hook: Optional[Callable] = None):
        self._init_manager(
            fitness_fn, fn_spec=fn_spec, num_objectives=num_objectives,
            num_workers=num_workers, run_id=run_id, priority=priority,
            lease_s=lease_s, chunk_timeout_s=chunk_timeout_s,
            max_retries=max_retries, poll_interval_s=poll_interval_s,
            cost_ema=cost_ema, chunk_sizing=chunk_sizing,
            min_chunk_cost_s=min_chunk_cost_s, keep_jobs=keep_jobs,
            step_hook=step_hook)
        self._owns_server = server is None and broker_addr is None
        self.server = server
        if self._owns_server:
            self.server = BrokerServer().start()
        if self.server is not None:
            broker_addr = self.server.addr
        self.broker_addr = _parse_addr(broker_addr)
        # no broker filesystem on the manager side — that is the point
        self.mq_dir = None
        self._owns_dir = False
        self.autoscaler = None
        self.client = BrokerClient(self.broker_addr)
        # fleet STOP hygiene mirrors the file transport: only an
        # invocation that owns workers (its pool, or the whole server)
        # may clear a stale sentinel
        if self._owns_server or worker_pool is not None:
            self.client.stop_clear()
        fn_pickle = b""
        if not fn_spec and fitness_fn is not None:
            try:
                fn_pickle = pickle.dumps(fitness_fn)
            except Exception:
                # unpicklable callables still work with thread pools
                # carrying an fn override; registry-resolving workers
                # surface a per-run RESOLVE_FAIL instead of hanging
                fn_pickle = b""
        self.client.register_run(
            self.run_id, priority=self.priority,
            num_objectives=num_objectives, fn_spec=fn_spec,
            fn_pickle=fn_pickle, clear_resolve_fail=True)
        self.worker_pool = worker_pool
        if worker_pool is not None:
            if getattr(worker_pool, "addr", None) is None:
                worker_pool.addr = self.broker_addr
            worker_pool.start()

    # -- transport seam: RPCs instead of broker file ops ---------------
    def _t_enqueue(self, name: str, chunk: np.ndarray) -> None:
        self.client.enqueue(name, chunk)

    def _t_result_fetch(self, name: str):
        return self.client.result_fetch(name)

    def _t_fail_fetch(self, name: str) -> Optional[str]:
        return self.client.fail_fetch(name)

    def _t_lease_state(self, name: str):
        return self.client.lease_state(name)

    def _t_requeue(self, old: str, new: str) -> bool:
        return self.client.requeue(old, new)

    def _t_resolve_fail_fetch(self) -> Optional[str]:
        return self.client.resolve_fail_get(self.run_id)

    def _t_deregister_run(self) -> None:
        self.client.deregister_run(self.run_id)

    def _gc_sweep(self, active: set, keep_by_job: Dict[int, set]) -> None:
        self.client.gc_sweep(self.run_id, active, keep_by_job)

    def _t_teardown(self, remove_dir: Optional[bool]) -> None:
        if self.worker_pool is not None:
            self.worker_pool.stop()              # raises fleet-wide STOP
        elif self._owns_server:
            try:
                self.client.stop_set()
            except (BrokerError, ConnectionError, OSError):
                pass
        self.client.close()
        if self._owns_server:
            self.server.stop()


# ---------------------------------------------------------------------------
# CLI:  --serve | --worker | --smoke
# ---------------------------------------------------------------------------

def _smoke(num_workers: int = 3, n: int = 64, genes: int = 6) -> int:
    """CI fast-lane smoke (``scripts/ci.sh netbroker-smoke``): in-process
    server, thread workers, one dispatched batch — asserts the fitness
    values, then that the run drained to done (no queue leftovers, no
    claims, fleet still stoppable). Seconds, no torch."""
    from repro_torch.fitness import hostsim
    rng = np.random.default_rng(0)
    genomes = rng.standard_normal((n, genes)).astype(np.float32)
    with BrokerServer() as server:
        pool = NetWorkerPool(num_workers, "thread", addr=server.addr,
                             poll_s=0.005)
        backend = SocketQueueBackend(
            fn_spec="repro_torch.fitness.hostsim:sphere",
            num_workers=num_workers, server=server,
            worker_pool=pool, poll_interval_s=0.005)
        with backend:
            out = backend._host_eval(genomes)
            want = np.asarray(hostsim.sphere(genomes), np.float32)
            assert out.shape == (n, 1), out.shape
            assert np.allclose(out.ravel(), want.ravel(),
                               rtol=1e-5), "fitness mismatch"
            assert backend.stats_snapshot()["jobs"] == 1
        # close() deregistered the run and GC-swept it; the server (still
        # ours, not stopped — backend attached, did not own it) must hold
        # zero queue state and the fleet must have drained on the STOP
        probe = BrokerClient(server.addr)
        listing = probe.listdir()
        probe.close()
        left = [x for k in ("tasks", "claimed", "results", "runs")
                for x in listing[k]]
        assert left == [], f"queue not drained: {left}"
        assert pool.alive_workers() == 0, "fleet did not drain on STOP"
    print(f"netbroker-smoke OK: {n} genomes x {num_workers} workers "
          f"drained to done")
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.runtime.netbroker",
        description="Socket broker for the mq queue contract: "
                    "--serve runs the TCP broker service, --worker a "
                    "persistent socket worker, --smoke the CI "
                    "drain-to-done check.")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--serve", action="store_true",
                      help="run the broker server (foreground)")
    mode.add_argument("--worker", action="store_true",
                      help="run the persistent worker loop")
    mode.add_argument("--smoke", action="store_true",
                      help="in-process server + thread workers, assert "
                           "drain-to-done (CI fast lane)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--serve: bind host (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=0,
                    help="--serve: bind port (default: ephemeral, "
                         "printed on stdout)")
    ap.add_argument("--state-dir", default=None,
                    help="--serve: server-local broker state directory "
                         "(default: private temp dir)")
    ap.add_argument("--broker-addr", default=None,
                    help="--worker: server address HOST:PORT")
    ap.add_argument("--lease-s", type=float, default=15.0,
                    help="lease duration; heartbeats renew at lease/4")
    ap.add_argument("--poll-s", type=float, default=0.05,
                    help="idle claim poll interval")
    ap.add_argument("--max-tasks", type=int, default=None,
                    help="--worker: exit after N completed tasks")
    ap.add_argument("--idle-exit-s", type=float, default=None,
                    help="--worker: exit after this long idle")
    ap.add_argument("--hang-substrings", default="",
                    help="--worker: die (stale lease) on matching tasks")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()
    if args.worker:
        if not args.broker_addr:
            ap.error("--worker requires --broker-addr HOST:PORT")
        hang = tuple(s for s in args.hang_substrings.split(",") if s)
        net_worker_loop(args.broker_addr, lease_s=args.lease_s,
                        poll_s=args.poll_s, max_tasks=args.max_tasks,
                        idle_exit_s=args.idle_exit_s,
                        hang_substrings=hang)
        return 0
    server = BrokerServer(args.host, args.port,
                          state_dir=args.state_dir).start()
    host, port = server.addr
    print(f"netbroker serving on {host}:{port}", flush=True)
    try:
        while True:
            time.sleep(3600.0)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
