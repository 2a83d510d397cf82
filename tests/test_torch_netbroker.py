"""The port's socket broker (``repro_torch.runtime.netbroker``) and
observability plane (``repro_torch.obs``): twins of the reference's frame
and chaos checks in ``tests/test_netbroker.py`` (torn request frames, a
worker dropped mid-RESULT frame, the error reply), the two CLIs' smokes
(``--smoke`` of each, the port's module names in their spawned and
resolved strings), and the Prometheus exposition against the reference's
byte for byte on the same registry contents.
"""
import io
import os
import socket
import struct
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import render_prometheus as ref_render
from repro.runtime import netbroker as ref_nb
from repro_torch.fitness import hostsim
from repro_torch.obs import (PROM_FILENAME, MetricsHTTPServer,
                             MetricsRegistry, TextfileExporter,
                             load_metrics_dir, parse_prometheus_text,
                             queue_depth_timeline, render_prometheus)
from repro_torch.runtime.mq import task_name
from repro_torch.runtime.netbroker import (BrokerClient, BrokerError,
                                           BrokerServer, encode_frame,
                                           recv_frame)

ROOT = Path(__file__).resolve().parents[1]
SPEC = "repro_torch.fitness.hostsim:sphere"


@pytest.fixture
def server():
    with BrokerServer() as s:
        yield s


@pytest.fixture
def mgr(server):
    client = BrokerClient(server.addr)
    client.register_run("a", fn_spec=SPEC)
    yield client
    client.close()


def _enqueue_one(mgr, chunk=0):
    name = task_name("a", 0, chunk, 0, 0)
    g = np.random.default_rng(chunk).uniform(-1, 1, (4, 3)).astype(
        np.float32)
    mgr.enqueue(name, g)
    return name, g


@pytest.mark.parametrize("blob_size", [0, 1, 65536])
def test_frames_decode_across_packages(blob_size):
    header = {"op": "ENQUEUE", "name": task_name("a", 0, 1, 0, 0)}
    blob = os.urandom(blob_size)
    for enc, dec in ((encode_frame, ref_nb.recv_frame),
                     (ref_nb.encode_frame, recv_frame)):
        a, b = socket.socketpair()
        try:
            a.sendall(enc(header, blob))
            assert dec(b) == (header, blob)
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("cut", ["mid_prefix", "mid_header", "mid_blob",
                                 "garbage_prefix"])
def test_torn_request_frame_never_touches_queue_state(server, mgr, cut):
    name, _ = _enqueue_one(mgr)
    raw = socket.create_connection(server.addr, timeout=10.0)
    frame = encode_frame({"op": "CLAIM", "bad_runs": {}, "poll_s": None})
    if cut == "mid_prefix":
        raw.sendall(frame[:3])
    elif cut == "mid_header":
        raw.sendall(frame[:12])
    elif cut == "mid_blob":
        blob_frame = encode_frame({"op": "ENQUEUE",
                                   "name": task_name("a", 0, 9, 0, 0)},
                                  b"x" * 1024)
        raw.sendall(blob_frame[: len(blob_frame) - 100])
    else:
        raw.sendall(struct.pack("!II", 0xFFFFFFFF, 0xFFFFFFFF))
    raw.close()
    listing = mgr.listdir()
    assert listing["tasks"] == [name]
    assert listing["claimed"] == []
    reply, _ = mgr.claim()
    assert reply["name"] == name
    mgr.release(name)


def test_connection_drop_mid_result_frame_is_not_a_lost_task(server, mgr):
    """A worker dies mid-RESULT frame: nothing lands, the claim and lease
    survive, and the stale-lease re-queue recovers the task."""
    name, g = _enqueue_one(mgr)
    w = BrokerClient(server.addr)
    reply, blob = w.claim()
    assert reply["name"] == name
    w.lease(name)
    fit = hostsim.sphere(np.load(io.BytesIO(blob))["genomes"])
    frame = encode_frame({"op": "RESULT", "name": name, "duration": 0.01,
                          "busy": 0.01, "shape": list(fit.shape)},
                         fit.tobytes())
    w._sock.sendall(frame[: len(frame) // 2])
    w._sock.close()
    assert mgr.result_fetch(name) is None
    assert mgr.fail_fetch(name) is None
    assert not [x for x in mgr.listdir()["results"] if x.startswith("ra_")]
    claimed, _ = mgr.lease_state(name)
    assert claimed
    mgr.backdate_lease(name, 9999.0)
    bumped = task_name("a", 0, 0, 0, 1)
    assert mgr.requeue(name, bumped)
    w2 = BrokerClient(server.addr)
    reply2, blob2 = w2.claim()
    assert reply2["name"] == bumped
    w2.lease(bumped)
    w2.result(bumped, hostsim.sphere(np.load(io.BytesIO(blob2))["genomes"]),
              0.01)
    w2.release(bumped)
    w2.close()
    got = mgr.result_fetch(bumped)
    assert got is not None and np.array_equal(got[0], hostsim.sphere(g))


def test_server_error_reply_carries_traceback(server):
    client = BrokerClient(server.addr)
    try:
        with pytest.raises(BrokerError, match="unknown op"):
            client.call("NO_SUCH_OP")
        client.ping()
    finally:
        client.close()


@pytest.mark.parametrize("module", ["repro_torch.runtime.netbroker",
                                    "repro_torch.obs"])
def test_cli_smoke(module, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", module, "--smoke"],
                          capture_output=True, text=True, env=env,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "ok" in proc.stdout.lower()


# ---------------------------------------------------------------------------
# Prometheus exposition against the reference
# ---------------------------------------------------------------------------

def _populate(reg):
    reg.inc("mq_claims_total", 3.0, run='we"ird\nrun')
    reg.set_gauge("mq_ready_total", 8.0)
    reg.declare_histogram("dur", [0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        reg.observe("dur", v, run="a")
    return reg


def test_exposition_matches_the_reference(tmp_path):
    port = _populate(MetricsRegistry()).snapshot()
    ref = _populate(RefRegistry()).snapshot()
    text = render_prometheus(port)
    assert text == ref_render(ref)
    parsed = parse_prometheus_text(text)
    assert parsed[("dur_count", (("run", "a"),))] == 3
    assert parsed[("mq_claims_total", (("run", 'we"ird\nrun'),))] == 3.0
    # the textfile is published atomically, a stale tmp stays invisible
    reg = _populate(MetricsRegistry())
    TextfileExporter(reg, str(tmp_path / PROM_FILENAME)).write_once()
    (tmp_path / (PROM_FILENAME + ".1.tmp")).write_text("mq_ready_total 9\n")
    assert load_metrics_dir(str(tmp_path))[("mq_ready_total", ())] == 8.0
    with MetricsHTTPServer(reg, port=0) as srv:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read()
    assert parse_prometheus_text(body.decode())[("mq_ready_total", ())] \
        == 8.0
    assert queue_depth_timeline([{"t": 1.0, "kind": "enqueue", "chunks": 2},
                                 {"t": 2.0, "kind": "claim"}]) == \
        [(1.0, 2), (2.0, 1)]
