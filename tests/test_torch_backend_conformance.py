"""The reference's DispatchBackend contract (``tests/backend_conformance.py``'s
``TestBackendContract``) run against the port's five decoupled kinds: the
host pool, the spool behind the SLURM and Kubernetes mock schedulers, and
the persistent-worker queue over both transports (file and socket broker).

That file imports jax, so its contract is mirrored here. Eager evaluation
stands in for ``jax.jit``: a torch tensor goes through the backend and
through ``Broker.evaluate`` with its padded cost-balanced dispatch. The
fitness must equal the port's numpy ``hostsim`` simulator bit for bit (the
workers evaluate the same rows with it) and the reference's jax ``sphere``
on the same numpy inputs at the reference suite's rtol 1e-6.
"""
import functools
import threading
import time

import numpy as np
import pytest
import torch

from repro.fitness import sphere as jax_sphere
from repro_torch.core.broker import (Broker, DispatchBackend,
                                     HostPoolBackend, padded_size)
from repro_torch.fitness import hostsim
from repro_torch.runtime.batchq import (KubernetesScheduler,
                                        LocalMockScheduler, MockKubectl,
                                        SlurmArrayBackend)
from repro_torch.runtime.mq import LocalWorkerPool, QueueBackend
from repro_torch.runtime.netbroker import NetWorkerPool, SocketQueueBackend

SPEC = "repro_torch.fitness.hostsim:sphere"
BACKEND_KINDS = ("hostpool", "slurm-mock", "k8s-mock", "mq", "mq-net")


def run_conformance(backend, n=29):
    """Eager evaluation matches the fitness, and the backend composes with
    the broker's padded cost-balanced dispatch (n % 4 != 0 exercises the
    sentinel pads)."""
    g = np.random.default_rng(0).uniform(0, 1, (n, 5)).astype(np.float32)
    want = hostsim.sphere(g)
    np.testing.assert_allclose(want, np.asarray(jax_sphere(g)), rtol=1e-6)
    assert isinstance(backend, DispatchBackend)
    out = backend(torch.from_numpy(g))
    assert out.dtype == torch.float32 and out.shape == (n, 1)
    assert np.array_equal(out.numpy(), want)
    broker = Broker(cost_fn=lambda x: torch.sum(torch.abs(x), -1) + 0.1,
                    num_workers=4, backend=backend)
    fit, stats = broker.evaluate(torch.from_numpy(g))
    assert np.array_equal(fit.numpy(), want)
    assert float(stats["balanced"]) == 1.0
    assert int(stats["padded"]) == padded_size(n, 4) - n


def make_backend(kind, tmp_path, *, fitness_fn=None, fn_spec=None,
                 pool_fn=None, hang_substrings=(), chunk_timeout_s=60,
                 max_retries=2, num_workers=3):
    """One port backend per ``kind``, with the knobs of the reference's
    ``backend_conformance.make_backend``."""
    if fitness_fn is None and fn_spec is None:
        fn_spec = SPEC
    if kind == "hostpool":
        fn = fitness_fn if fitness_fn is not None else hostsim.sphere
        return HostPoolBackend(fn, num_workers=num_workers,
                               chunk_timeout_s=chunk_timeout_s,
                               max_retries=max_retries)
    if kind in ("slurm-mock", "k8s-mock"):
        scheduler = (
            LocalMockScheduler(mode="thread",
                               hang_substrings=hang_substrings)
            if kind == "slurm-mock" else
            KubernetesScheduler(runner=MockKubectl(
                mode="thread", hang_substrings=hang_substrings)))
        return SlurmArrayBackend(fitness_fn, fn_spec=fn_spec,
                                 num_workers=num_workers,
                                 scheduler=scheduler,
                                 spool_dir=str(tmp_path / "spool"),
                                 chunk_timeout_s=chunk_timeout_s,
                                 max_retries=max_retries,
                                 poll_interval_s=0.005)
    if kind == "mq":
        pool = LocalWorkerPool(num_workers=num_workers, mode="thread",
                               lease_s=30.0, poll_s=0.005, fn=pool_fn)
        return QueueBackend(fitness_fn, fn_spec=fn_spec,
                            num_workers=num_workers, worker_pool=pool,
                            mq_dir=str(tmp_path / "mq"),
                            chunk_timeout_s=chunk_timeout_s,
                            max_retries=max_retries,
                            poll_interval_s=0.005)
    if kind == "mq-net":
        pool = NetWorkerPool(num_workers=num_workers, mode="thread",
                             lease_s=30.0, poll_s=0.005, fn=pool_fn)
        return SocketQueueBackend(fitness_fn, fn_spec=fn_spec,
                                  num_workers=num_workers,
                                  worker_pool=pool,
                                  chunk_timeout_s=chunk_timeout_s,
                                  max_retries=max_retries,
                                  poll_interval_s=0.005)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", BACKEND_KINDS)
class TestBackendContract:
    def test_conformance_and_padded_broker_compose(self, kind, tmp_path):
        with make_backend(kind, tmp_path) as backend:
            run_conformance(backend)

    def test_pickled_fitness(self, kind, tmp_path):
        """No import spec: workers load the callable from the pickle
        payload (the host pool calls it directly)."""
        with make_backend(kind, tmp_path,
                          fitness_fn=hostsim.rastrigin) as backend:
            g = np.random.default_rng(1).uniform(-1, 1, (11, 4)).astype(
                np.float32)
            assert np.array_equal(backend._host_eval(g),
                                  hostsim.rastrigin(g))

    def test_drain_before_close(self, kind, tmp_path):
        """close() while an evaluation is in flight drains it, and later
        use raises."""
        slow = functools.partial(hostsim.delay_sphere, base_s=0.03)
        g = np.random.default_rng(7).uniform(-1, 1, (12, 3)).astype(
            np.float32)
        g[:, 0] = -1.0                           # no hot rows: base_s only
        with make_backend(kind, tmp_path, fitness_fn=slow,
                          pool_fn=slow) as backend:
            box = {}
            t = threading.Thread(
                target=lambda: box.update(out=backend._host_eval(g)),
                daemon=True)
            t.start()
            time.sleep(0.05)                     # eval is in flight
            backend.close()                      # must drain, not strand
            t.join(timeout=30)
            assert not t.is_alive()
            assert np.array_equal(box["out"], hostsim.sphere(g))
            with pytest.raises(RuntimeError, match="after close"):
                backend._host_eval(g)

    def test_timeout_then_retry_succeeds(self, kind, tmp_path):
        """One chunk straggles past the per-chunk timeout and the
        re-queued attempt delivers: mock schedulers lose the node or pod,
        the host pool and the queues get a stuck-but-alive worker."""
        release = threading.Event()
        state = {"hung": False}
        lock = threading.Lock()

        def hang_once(genomes):
            g = np.asarray(genomes, np.float32)
            hot = bool(np.any(g[:, 0] > 0))
            with lock:
                first = hot and not state["hung"]
                if first:
                    state["hung"] = True
            if first:
                release.wait(timeout=30)
            return hostsim.sphere(g)

        g = np.random.default_rng(4).uniform(-1, 1, (24, 3)).astype(
            np.float32)
        g[:, 0] = -1.0
        if kind in ("slurm-mock", "k8s-mock"):
            kw = dict(hang_substrings=("chunk_0001_try0",))
        else:
            g[0, 0] = 1.0                        # chunk 0 carries the hot row
            kw = dict(fitness_fn=hang_once, pool_fn=hang_once)
        with make_backend(kind, tmp_path, chunk_timeout_s=0.5,
                          **kw) as backend:
            try:
                out = backend._host_eval(g)
                assert np.array_equal(out, hostsim.sphere(g))
                # a loaded box may time out healthy chunks too: >= not ==
                assert backend.stats["retries"] >= 1
                if "timeouts" in backend.stats:
                    assert backend.stats["timeouts"] >= 1
            finally:
                release.set()
