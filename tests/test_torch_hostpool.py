"""The decoupled host-evaluation half of the broker against the reference
(``repro.core.broker``, ``repro.core.hostbridge``, ``repro.fitness.hostsim``):
the numpy simulators, the chunk planners and ``CostEMA`` bit for bit,
``HostPoolBackend`` and ``Broker.evaluate`` with a host backend against
the reference's jitted broker, the host-pool hardening cases of
``tests/test_broker.py`` and the HostPool kind of
``tests/backend_conformance.py`` (mirrored: that file imports jax), and one
GA generation through both packages' host pools.

Tolerances: both packages evaluate the host pool with the same numpy
simulators on the same rows, so fitness must be bit-equal. Broker skew
statistics sum predicted costs in another order than XLA: 1e-6. A cost
model read through torch and jax ops (a prime) is held at 1e-6 too.
"""
import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GAConfig as JaxGAConfig
from repro.core import broker as jb
from repro.core import hostbridge as jhb
from repro.core import island as jisland
from repro.core.population import init_population as jax_init_population
from repro.fitness import hostsim as jhostsim
from repro_torch.configs.base import GAConfig
from repro_torch.core import broker as tb
from repro_torch.core import hostbridge as thb
from repro_torch.core import island
from repro_torch.core.population import population_from_numpy
from repro_torch.core.uniforms import ArrayUniforms
from repro_torch.fitness import hostsim
from torch_parity import jax_generation_draws, to_np, to_torch

ROOT = Path(__file__).resolve().parents[1]
STATS_TOL = dict(rtol=1e-6, atol=1e-6)
SIMULATORS = ("sphere", "rastrigin", "rosenbrock", "ackley", "griewank")


def _genomes(n, g, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, g)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# numpy simulators and the import boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SIMULATORS)
def test_hostsim_matches_reference_bit_for_bit(name):
    g = _genomes(37, 6, 1, -5.12, 5.12)
    np.testing.assert_array_equal(getattr(hostsim, name)(g),
                                  getattr(jhostsim, name)(g))


def test_hostsim_delay_pid_and_failure():
    g = _genomes(6, 3, 2)
    g[:2, 0] = 1.0
    t0 = time.perf_counter()
    np.testing.assert_array_equal(
        hostsim.delay_sphere(g, slow_s=0.02), jhostsim.sphere(g))
    assert time.perf_counter() - t0 >= 0.04     # two slow rows
    np.testing.assert_array_equal(hostsim.worker_pid(g), jhostsim.worker_pid(g))
    with pytest.raises(RuntimeError, match="simulated simulator"):
        hostsim.always_fail(g)


def test_importing_hostsim_imports_no_torch():
    """A spawned worker unpickles a simulator from ``fitness.hostsim`` and
    ``_timed_eval`` from ``core.hostbridge``: neither may import torch."""
    code = ("import sys, json\n"
            "import repro_torch.fitness.hostsim\n"
            "import repro_torch.core.hostbridge\n"
            "from repro_torch.fitness import hostsim\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('torch', 'jax', 'repro'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ---------------------------------------------------------------------------
# chunk planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w,min_cost", [(1, 4, 0.0), (7, 3, 0.0),
                                          (29, 4, 0.0), (64, 8, 0.0),
                                          (29, 4, 2.0), (100, 16, 5.0),
                                          (12, 12, 1.5)])
@pytest.mark.parametrize("kind", ["pareto", "ties", "zero_tail"])
def test_planners_match_reference(n, w, min_cost, kind):
    rs = np.random.default_rng(n * 131 + w)
    if kind == "pareto":
        cost = rs.pareto(1.5, n).astype(np.float32)
    elif kind == "ties":
        cost = rs.integers(0, 3, n).astype(np.float32)
    else:
        cost = np.concatenate([rs.uniform(0.5, 2, n - n // 3),
                               np.zeros(n // 3)]).astype(np.float32)
    assert (thb.cost_sized_chunk_sizes(cost, w, min_chunk_cost=min_cost)
            == jhb.cost_sized_chunk_sizes(cost, w, min_chunk_cost=min_cost))
    # planner with sentinel pads marked -inf and a permutation to carry
    marked = cost.copy()
    marked[rs.random(n) < 0.2] = -np.inf
    genomes = _genomes(n, 3, n)
    perm = rs.permutation(n + 3)[:n]
    got = thb.plan_cost_chunks(genomes, perm, marked, w,
                               min_chunk_cost=min_cost)
    ref = jhb.plan_cost_chunks(genomes, perm, marked, w,
                               min_chunk_cost=min_cost)
    assert got[1] == ref[1]
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)
    out = hostsim.sphere(genomes[got[2]])
    np.testing.assert_array_equal(thb.scatter_chunk_results(out, got[2], n),
                                  jhb.scatter_chunk_results(out, ref[2], n))


def test_fold_and_collect_match_reference():
    rs = np.random.default_rng(5)
    c = rs.uniform(0, 3, 40)
    for sizes in ([10, 10, 10, 10], [1, 1, 30, 8], [40], [5] * 8):
        for floor in (0.0, 4.0, 20.0, 1e9):
            assert (thb._fold_small_chunks(list(sizes), c, floor)
                    == jhb._fold_small_chunks(list(sizes), c, floor))
    outs = [(hostsim.sphere(_genomes(k, 2, k)), 0.01 * k) for k in (3, 4, 2)]
    perm = np.array([4, 0, 8, 1, 2, 5, 3, 6, 7], np.int64)
    ema_t, ema_j = tb.CostEMA(alpha=0.5), jb.CostEMA(alpha=0.5)
    ema_t.snapshot(8)
    ema_j.snapshot(8)
    np.testing.assert_array_equal(
        thb.collect_chunk_results(outs, ema_t, perm, [3, 4, 2]),
        jhb.collect_chunk_results(outs, ema_j, perm, [3, 4, 2]))
    np.testing.assert_array_equal(ema_t.snapshot(8), ema_j.snapshot(8))


# ---------------------------------------------------------------------------
# CostEMA
# ---------------------------------------------------------------------------

def _ema_sequence(cls, prime):
    """The tables a CostEMA holds through one sequence of cold reads,
    observations (with sentinel pads), a reset, a re-prime and a resize."""
    ema = cls(alpha=0.3, init_cost=2.0)
    tables = [ema.snapshot(10)]
    rs = np.random.default_rng(0)
    for k in range(3):
        perm = rs.permutation(12)                # 10 real slots + 2 pads
        ema.observe(perm, [3, 3, 3, 3], list(rs.uniform(0.1, 2.0, 4)))
        tables.append(ema.snapshot(10))
    ema.reset()
    tables.append(ema.snapshot(10, prime))       # cold read takes the prime
    ema.observe(np.arange(10), [4, 6], [0.8, 3.0])
    tables.append(ema.snapshot(10, prime * 0))   # warm: prime ignored
    tables.append(ema.snapshot(7))               # resize re-keys
    return tables, ema.updates


def test_cost_ema_tables_match_reference_bit_for_bit():
    prime = np.random.default_rng(1).uniform(1, 5, 10).astype(np.float32)
    got, n_got = _ema_sequence(tb.CostEMA, prime)
    ref, n_ref = _ema_sequence(jb.CostEMA, prime)
    assert n_got == n_ref == 4
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_cost_ema_reads_as_tensor_and_primes_from_device_model():
    g = _genomes(12, 3, 3)
    ema = tb.CostEMA()
    out = ema(to_torch(g))
    assert out.dtype == torch.float32 and out.shape == (12,)
    np.testing.assert_array_equal(to_np(out), np.ones(12, np.float32))
    static_t = lambda x: torch.sum(torch.abs(x), -1) + 0.5      # noqa: E731
    static_j = lambda x: jnp.sum(jnp.abs(x), -1) + 0.5          # noqa: E731
    ema_t = tb.CostEMA(alpha=0.5, prime_fn=static_t)
    ema_j = jb.CostEMA(alpha=0.5, prime_fn=static_j)
    np.testing.assert_allclose(to_np(ema_t(to_torch(g))),
                               np.asarray(jax.jit(ema_j)(jnp.asarray(g))),
                               **STATS_TOL)
    with pytest.raises(ValueError, match="alpha"):
        tb.CostEMA(alpha=0.0)


# ---------------------------------------------------------------------------
# HostPoolBackend and Broker.evaluate against the reference's broker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(29, 4), (37, 6), (5, 8), (64, 8)])
def test_host_eval_matches_reference(n, w):
    g = _genomes(n, 5, n + w, -5.12, 5.12)
    perm = np.random.default_rng(w).permutation(n)
    with tb.HostPoolBackend(hostsim.rastrigin, num_workers=w) as tpool, \
            jb.HostPoolBackend(jhostsim.rastrigin, num_workers=w) as jpool:
        out = tpool._host_eval(g)
        np.testing.assert_array_equal(out, jpool._host_eval(g))
        np.testing.assert_array_equal(out, hostsim.rastrigin(g))
        assert out.dtype == np.float32 and out.shape == (n, 1)
        got = tpool.eval_with_perm(to_torch(g), to_torch(perm),
                                   to_torch(np.ones(n, np.float32)))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(to_np(got), out)


def _cost_t(x):
    return x[:, 0] + 2.0


def _cost_j(x):
    return x[:, 0] + 2.0


@pytest.mark.parametrize("n,w", [(29, 4), (37, 6), (3, 8)])
@pytest.mark.parametrize("model", ["static", "ema", "ema_primed"])
def test_broker_with_host_backend_matches_reference(n, w, model):
    """Padded cost-balanced dispatch (n % w != 0) through the host pool:
    the port's eager broker against the reference's jitted one. The
    learned table differs after the first round (wall times), so stats
    are compared on round 1 and fitness on both rounds."""
    g = _genomes(n, 4, n * w, -5.12, 5.12)
    if model == "static":
        cost_t, cost_j = _cost_t, _cost_j
    else:
        prime = model == "ema_primed"
        cost_t = tb.CostEMA(alpha=0.5, prime_fn=_cost_t if prime else None)
        cost_j = jb.CostEMA(alpha=0.5, prime_fn=_cost_j if prime else None)
    with tb.HostPoolBackend(hostsim.rastrigin, num_workers=w) as tpool, \
            jb.HostPoolBackend(jhostsim.rastrigin, num_workers=w) as jpool:
        tbroker = tb.Broker(cost_fn=cost_t, num_workers=w, backend=tpool)
        jbroker = jb.Broker(cost_fn=cost_j, num_workers=w, backend=jpool)
        jev = jax.jit(jbroker.evaluate)
        for rnd in range(2):
            fit, stats = tbroker.evaluate(to_torch(g))
            jfit, jstats = jev(jnp.asarray(g))
            np.testing.assert_array_equal(to_np(fit), np.asarray(jfit))
            np.testing.assert_array_equal(to_np(fit), hostsim.rastrigin(g))
            if rnd == 0:
                for k in ("skew", "naive_skew", "balanced"):
                    np.testing.assert_allclose(float(stats[k]),
                                               float(jstats[k]), **STATS_TOL)
                assert int(stats["padded"]) == int(jstats["padded"]) \
                    == tb.padded_size(n, w) - n
        if model != "static":
            assert tpool.cost_ema is cost_t          # auto-wired
            assert cost_t.updates == cost_j.updates == 2
        assert tbroker.backend_stats() == jbroker.backend_stats() \
            == {"retries": 0}


def test_broker_backend_stats_is_a_copy():
    with tb.HostPoolBackend(hostsim.sphere, num_workers=2) as pool:
        broker = tb.Broker(num_workers=2, backend=pool)
        stats = broker.backend_stats()
        stats["retries"] = 99
        assert broker.backend_stats() == {"retries": 0}
    assert tb.Broker(hostsim.sphere).backend_stats() == {}


def test_learns_hot_lane_and_rebalances():
    """tests/test_broker.py's case: round 1 exposes the hot lane, the EMA
    charges its slots, and the next rounds spread them."""
    n, w = 32, 4
    perm0 = to_np(tb.balanced_permutation(torch.ones(n), w))
    hot = np.zeros(n, bool)
    hot[perm0[:n // w]] = True
    g = _genomes(n, 3, 0)
    g[:, 0] = np.where(hot, 1.0, -1.0)
    ema = tb.CostEMA(alpha=0.6)
    het_fn = functools.partial(hostsim.delay_sphere, slow_s=0.01)
    with tb.HostPoolBackend(het_fn, num_workers=w) as backend:
        broker = tb.Broker(cost_fn=ema, num_workers=w, backend=backend)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fit, _ = broker.evaluate(to_torch(g))
            times.append(time.perf_counter() - t0)
    est = ema.snapshot(n)
    assert ema.updates == 3
    assert est[hot].mean() > est[~hot].mean()
    assert times[2] < times[0]
    np.testing.assert_array_equal(to_np(fit), hostsim.sphere(g))


# ---------------------------------------------------------------------------
# hardening (tests/test_broker.py's host-pool cases)
# ---------------------------------------------------------------------------

def test_straggler_chunk_retried():
    calls = {"n": 0}
    lock = threading.Lock()

    def flaky(genomes):
        with lock:
            calls["n"] += 1
            first = calls["n"] == 1
        if first:
            time.sleep(1.0)                     # unmodeled straggler
        return hostsim.sphere(genomes)

    backend = tb.HostPoolBackend(flaky, num_workers=2, chunk_timeout_s=0.2,
                                 max_retries=2)
    g = _genomes(10, 3, 3)
    np.testing.assert_array_equal(backend._host_eval(g), hostsim.sphere(g))
    assert backend.stats_snapshot()["retries"] >= 1
    backend.close()


def test_failed_chunk_exhausts_retries():
    backend = tb.HostPoolBackend(hostsim.always_fail, num_workers=2,
                                 max_retries=1)
    with pytest.raises(tb.ChunkFailure, match="simulated simulator"):
        backend._host_eval(np.ones((4, 2), np.float32))
    # chunk 0 is re-queued once, then fails the call
    assert backend.stats_snapshot() == {"retries": 1}
    backend.close()


def test_run_chunks_retry_counts_a_failed_resubmit():
    attempts = []

    def submit(i, chunk, attempt):
        attempts.append(attempt)
        if attempt == 1:
            raise OSError("transient submit failure")
        return attempt

    def wait(i, token, timeout_s):
        if token == 0:
            raise TimeoutError("straggler")
        return token

    for mod in (tb, jb):
        attempts.clear()
        assert mod.run_chunks_retry([None], submit, wait,
                                    max_retries=2) == [2]
        assert attempts == [0, 1, 2]
        with pytest.raises(mod.ChunkFailure, match="2 attempt"):
            mod.run_chunks_retry([None], submit, wait, max_retries=1)


def test_close_drains_inflight_evaluation():
    started, release = threading.Event(), threading.Event()

    def gated(genomes):
        started.set()
        release.wait(10.0)
        return hostsim.sphere(genomes)

    backend = tb.HostPoolBackend(gated, num_workers=2)
    g = _genomes(8, 3, 5)
    result = {}
    caller = threading.Thread(
        target=lambda: result.update(out=backend(to_torch(g))))
    caller.start()
    assert started.wait(10.0)                   # evaluation is in flight
    closer = threading.Thread(target=backend.close)
    closer.start()
    time.sleep(0.1)
    assert closer.is_alive()                    # draining, not dropping
    release.set()
    caller.join(10.0)
    closer.join(10.0)
    assert not closer.is_alive() and not caller.is_alive()
    np.testing.assert_array_equal(to_np(result["out"]), hostsim.sphere(g))
    with pytest.raises(RuntimeError, match="after close"):
        backend._host_eval(np.ones((2, 3), np.float32))


def test_context_manager_and_executor_check():
    with tb.HostPoolBackend(hostsim.sphere, num_workers=2) as backend:
        g = _genomes(6, 3, 6)
        np.testing.assert_array_equal(to_np(backend(to_torch(g))),
                                      hostsim.sphere(g))
    assert backend._pool is None
    backend.close()                             # idempotent
    with pytest.raises(ValueError, match="thread|process"):
        tb.HostPoolBackend(hostsim.sphere, executor="fork")


# ---------------------------------------------------------------------------
# tests/backend_conformance.py, HostPool kind (mirrored)
# ---------------------------------------------------------------------------

def _make_pool(fitness_fn=hostsim.sphere, chunk_timeout_s=60,
               executor="thread", num_workers=3):
    return tb.HostPoolBackend(fitness_fn, num_workers=num_workers,
                              chunk_timeout_s=chunk_timeout_s,
                              max_retries=2, executor=executor)


@pytest.mark.parametrize("executor", ["thread", "process"])
def test_conformance_and_padded_broker_compose(executor):
    n = 29
    g = _genomes(n, 5, 0, 0.0, 1.0)
    direct = hostsim.sphere(g)
    with _make_pool(executor=executor) as backend:
        assert isinstance(backend, tb.DispatchBackend)
        np.testing.assert_array_equal(to_np(backend(to_torch(g))), direct)
        broker = tb.Broker(
            cost_fn=lambda x: torch.sum(torch.abs(x), -1) + 0.1,
            num_workers=4, backend=backend)
        fit, stats = broker.evaluate(to_torch(g))
        np.testing.assert_array_equal(to_np(fit), direct)
        assert float(stats["balanced"]) == 1.0
        assert int(stats["padded"]) == (-(-n // 4) * 4) - n


@pytest.mark.parametrize("executor", ["thread", "process"])
def test_pickled_fitness(executor):
    """Under ``process`` the simulator travels to spawned workers by
    pickle; both executors give the reference's bits."""
    with _make_pool(hostsim.rastrigin, executor=executor) as backend:
        g = _genomes(11, 4, 1)
        np.testing.assert_array_equal(backend._host_eval(g),
                                      jhostsim.rastrigin(g))


def test_process_pool_runs_in_other_interpreters():
    with _make_pool(hostsim.worker_pid, executor="process",
                    num_workers=2) as backend:
        pids = backend._host_eval(np.zeros((8, 2), np.float32))
    assert float(pids.max()) != float(os.getpid())


def test_drain_before_close():
    slow = functools.partial(hostsim.delay_sphere, base_s=0.03)
    g = _genomes(12, 3, 7)
    g[:, 0] = -1.0                              # no hot rows: base_s only
    with _make_pool(slow) as backend:
        box = {}
        t = threading.Thread(
            target=lambda: box.update(out=backend._host_eval(g)),
            daemon=True)
        t.start()
        time.sleep(0.05)                        # eval is in flight
        backend.close()                         # must drain, not strand
        t.join(timeout=30)
        assert not t.is_alive()
        np.testing.assert_array_equal(box["out"], hostsim.sphere(g))
        with pytest.raises(RuntimeError, match="after close"):
            backend._host_eval(g)


def test_timeout_then_retry_succeeds():
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

    g = _genomes(24, 3, 4)
    g[:, 0] = -1.0
    g[0, 0] = 1.0                               # chunk 0 carries the hot row
    with _make_pool(hang_once, chunk_timeout_s=0.5) as backend:
        try:
            np.testing.assert_array_equal(backend._host_eval(g),
                                          hostsim.sphere(g))
            assert backend.stats_snapshot()["retries"] >= 1
        finally:
            release.set()


# ---------------------------------------------------------------------------
# the paper's decoupled simulation backend on the HVDC fitness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["thread", "process"])
def test_host_backend_powerflow_simulation(executor):
    """tests/test_broker.py's small-grid case: the HVDC fitness through the
    host pool (padded, N=5, W=2) against the port's inline evaluation
    (same torch code per row; 1e-5) and the reference's (its own test's
    solver tolerance, 1e-3)."""
    from repro.fitness.powerflow import HVDCDispatchFitness as JaxHVDC
    from repro.powerflow.grid import make_synthetic_grid as jax_grid
    from repro_torch.core.hostbridge import LockedHostFitness
    from repro_torch.fitness.powerflow import (HVDCDispatchFitness,
                                               SpawnedHostFitness)
    from repro_torch.powerflow.grid import make_synthetic_grid
    kw = dict(n_bus=12, n_line=20, n_gen=4, n_hvdc=2, seed=0)
    fit = HVDCDispatchFitness(make_synthetic_grid(**kw), newton_iters=12,
                              device="cpu")
    g = (0.5 * np.random.default_rng(3).uniform(-1, 1, (5, 2))).astype(
        np.float32)
    direct = to_np(fit(to_torch(g)))
    host_fn = (LockedHostFitness(fit) if executor == "thread"
               else SpawnedHostFitness(fit))
    with tb.HostPoolBackend(host_fn, num_workers=2,
                            executor=executor) as backend:
        broker = tb.Broker(cost_fn=fit.cost_model(), num_workers=2,
                           backend=backend)
        out, stats = broker.evaluate(to_torch(g))
    assert int(stats["padded"]) == 1
    np.testing.assert_allclose(to_np(out), direct, rtol=1e-5)
    ref = np.asarray(JaxHVDC(jax_grid(**kw), newton_iters=12)(
        jnp.asarray(g)))
    np.testing.assert_allclose(to_np(out), ref, rtol=1e-3)


# ---------------------------------------------------------------------------
# one GA generation through both packages' host pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("islands,pop", [(2, 16), (3, 10)])
def test_generation_through_host_pools_matches_reference(islands, pop):
    """Both packages' host-thread pools evaluate with the same numpy
    rastrigin; the port replays the reference's draws (pre-drawn uniforms).
    Genomes at the generation replay's tolerance
    (tests/test_torch_island_engine.py: SBX rounds differently in XLA),
    each side's fitness bit-equal to the simulator on its own genomes, and
    the same survivors."""
    base = dict(num_genes=6, pop_per_island=pop, num_islands=islands,
                lower=-5.12, upper=5.12, mutation_prob=0.7,
                mutation_eta=20.0, crossover_prob=0.9, crossover_eta=15.0,
                seed=4)
    jcfg, cfg = JaxGAConfig(**base), GAConfig(**base)
    with tb.HostPoolBackend(hostsim.rastrigin, num_workers=4) as tpool, \
            jb.HostPoolBackend(jhostsim.rastrigin, num_workers=4) as jpool:
        jbroker = jb.Broker(num_workers=4, backend=jpool)
        jpop = jisland.evaluate_population(
            jcfg, jbroker, jax_init_population(jcfg, jax.random.PRNGKey(2)))
        jnew, _ = jax.jit(jisland.make_generation_step(jcfg, jbroker))(
            jpop, None)
        tpop = population_from_numpy(jax.device_get(jpop._asdict()), "cpu")
        src = ArrayUniforms(jax_generation_draws(
            jpop.rng, pop, cfg.num_genes, cfg.tournament_size,
            cfg.fused_operators))
        gen = island.make_generation_step(
            cfg, tb.Broker(num_workers=4, backend=tpool), "cpu")
        tnew, _ = gen(tpop, src)
    assert src.remaining() == 0
    tg, jg = to_np(tnew.genomes), np.asarray(jnew.genomes)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    for genomes, fitness in ((tg, to_np(tnew.fitness)),
                             (jg, np.asarray(jnew.fitness))):
        np.testing.assert_array_equal(
            fitness.reshape(-1, 1),
            hostsim.rastrigin(genomes.reshape(-1, cfg.num_genes)))
    # the same individuals survive: every genome is within the tolerance
    # of the reference's genome in the same slot, and the fitness order
    # within each island agrees
    np.testing.assert_array_equal(np.argsort(to_np(tnew.fitness)[..., 0], 1,
                                             kind="stable"),
                                  np.argsort(np.asarray(jnew.fitness)[..., 0],
                                             1, kind="stable"))
