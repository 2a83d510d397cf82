"""The port's queue runtime and the reference's speak one protocol: the same
task names, broker layout, npz payloads and TCP frames.

Both ways, on both transports: a port ``QueueBackend`` is served by the
reference's ``worker_loop`` threads and a reference ``QueueBackend`` by the
port's; a port ``SocketQueueBackend`` (and its ``BrokerClient``) against a
reference ``BrokerServer`` and the reverse. Each worker resolves the
fitness spec its manager registered. Fitness must equal ``hostsim.sphere``
bit for bit: both packages' simulators are the same numpy code on the same
rows. The pure protocol functions (task names, ``parse_task_name``,
``cost_sized_chunk_sizes``, ``encode_frame``) must agree exactly on the
same inputs.
"""
import numpy as np
import pytest

from repro.core import hostbridge as ref_hb
from repro.fitness import hostsim as ref_hostsim
from repro.runtime import mq as ref_mq
from repro.runtime import netbroker as ref_nb
from repro_torch.core import hostbridge as hb
from repro_torch.fitness import hostsim
from repro_torch.runtime import mq
from repro_torch.runtime import netbroker as nb

PORT_SPEC = "repro_torch.fitness.hostsim:sphere"
REF_SPEC = "repro.fitness.hostsim:sphere"


def _genomes(n=29, g=5, seed=0):
    return np.random.default_rng(seed).uniform(-2, 2, (n, g)).astype(
        np.float32)


def _queue_pair(side, tmp_path):
    """(manager, worker pool) with the manager from ``side`` and the
    workers from the other package, on one broker directory."""
    mq_dir = str(tmp_path / "mq")
    mgr_mod, pool_mod, spec = ((mq, ref_mq, PORT_SPEC) if side == "port"
                               else (ref_mq, mq, REF_SPEC))
    pool = pool_mod.LocalWorkerPool(3, "thread", mq_dir=mq_dir,
                                    lease_s=30.0, poll_s=0.005)
    backend = mgr_mod.QueueBackend(fn_spec=spec, num_workers=3,
                                   mq_dir=mq_dir, worker_pool=pool,
                                   chunk_timeout_s=60,
                                   poll_interval_s=0.005)
    return backend, mq_dir


@pytest.mark.parametrize("manager", ["port", "reference"])
def test_file_queue_served_by_the_other_package(manager, tmp_path):
    backend, mq_dir = _queue_pair(manager, tmp_path)
    g = _genomes()
    cost = np.linspace(3.0, 1.0, len(g)).astype(np.float32)
    with backend:
        out = backend._host_eval(g)
        # cost-sized chunks (pricier first) scatter back to batch order
        out_cost = backend._host_eval(g, np.arange(len(g)), cost)
    want = hostsim.sphere(g)
    assert np.array_equal(want, ref_hostsim.sphere(g))
    assert np.array_equal(out, want)
    assert np.array_equal(out_cost, want)
    for d in (mq.TASKS_DIR, mq.CLAIMED_DIR, mq.RUNS_DIR):
        assert list((tmp_path / "mq" / d).iterdir()) == []


@pytest.mark.parametrize("server_side", ["reference", "port"])
def test_socket_broker_across_packages(server_side):
    """The server of one package; the manager, its ``BrokerClient`` and
    the socket workers of the other."""
    srv_mod, cli_mod, spec = ((ref_nb, nb, PORT_SPEC)
                              if server_side == "reference"
                              else (nb, ref_nb, REF_SPEC))
    g = _genomes(n=23, seed=1)
    with srv_mod.BrokerServer() as server:
        pool = cli_mod.NetWorkerPool(3, "thread", addr=server.addr,
                                     lease_s=30.0, poll_s=0.005)
        backend = cli_mod.SocketQueueBackend(
            fn_spec=spec, num_workers=3, server=None,
            broker_addr="%s:%d" % server.addr, worker_pool=pool,
            chunk_timeout_s=60, poll_interval_s=0.005)
        with backend:
            out = backend._host_eval(g)
        probe = cli_mod.BrokerClient(server.addr)
        listing = probe.listdir()
        probe.close()
    assert np.array_equal(out, hostsim.sphere(g))
    assert [x for k in ("tasks", "claimed", "runs") for x in listing[k]] \
        == []


@pytest.mark.parametrize("case", [("a", 0, 0, 0, 0), ("run-7", 12, 3, 2, 5),
                                  ("x9", 999999, 9999, 1, 0)])
def test_task_names_agree(case):
    name = mq.task_name(*case)
    assert name == ref_mq.task_name(*case)
    assert mq.parse_task_name(name) == ref_mq.parse_task_name(name) == case
    assert mq.result_name(name) == ref_mq.result_name(name)
    for foreign in (name + ".tmp", "zzzstop-1-0000.stop", "junk"):
        assert mq.parse_task_name(foreign) is None
        assert ref_mq.parse_task_name(foreign) is None
    assert mq.sanitize_run_id("Run_A 7") == ref_mq.sanitize_run_id("Run_A 7")


@pytest.mark.parametrize("seed", range(4))
def test_cost_sized_chunks_agree(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    cost = rng.exponential(1.0, n) * (rng.random(n) > 0.1)
    w = int(rng.integers(1, 9))
    for floor in (0.0, 0.5):
        assert hb.cost_sized_chunk_sizes(cost, w, min_chunk_cost=floor) == \
            ref_hb.cost_sized_chunk_sizes(cost, w, min_chunk_cost=floor)


@pytest.mark.parametrize("blob_size", [0, 1, 4096])
def test_encode_frame_bytes_agree(blob_size):
    header = {"op": "RESULT", "name": mq.task_name("a", 1, 2, 0, 0),
              "duration": 0.25, "shape": [4, 1]}
    blob = bytes(range(256)) * (blob_size // 256) + b"\x07" * (blob_size
                                                                % 256)
    assert nb.encode_frame(header, blob) == ref_nb.encode_frame(header, blob)
