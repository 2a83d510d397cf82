"""The port's message queue (``repro_torch.runtime.mq``) and its ``ga_run``
wiring: twins of the reference's checks in ``tests/test_mq.py`` and
``tests/test_mq_multitenant.py`` (priority claims across runs, run-scoped
GC, the autoscaler's poison tickets, ``ga_run`` flag errors), the metrics
bus in the ported core against the reference's, one subprocess fleet (its
workers are ``python -m repro_torch.runtime.mq`` and import no torch), and
``ga_run`` over the queue backends: named benchmarks bit-identical to the
host-thread backend, ``--fitness hvdc`` over ``mq-mock`` on a 20-bus grid.

Fitness goes through the same numpy simulators in every backend, so it is
compared bit for bit; ``CostEMA``'s gauges are float32 means of the same
table in both packages, compared exactly.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import broker as ref_broker
from repro.core import hostbridge as ref_hb
from repro.obs import MetricsRegistry as RefRegistry
from repro.runtime import metrics as ref_metrics
from repro_torch.core import broker as tb
from repro_torch.core import hostbridge as thb
from repro_torch.fitness import hostsim
from repro_torch.launch import ga_run
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime import metrics as runtime_metrics
from repro_torch.runtime.fsatomic import atomic_savez
from repro_torch.runtime.mq import (CLAIMED_DIR, LEASE_SUFFIX, POISON_SUFFIX,
                                    RESULTS_DIR, RUNS_DIR, TASKS_DIR,
                                    LocalWorkerPool, QueueBackend,
                                    claim_next, make_broker_dirs,
                                    mq_result_path, parse_task_name,
                                    process_task, register_run, task_name,
                                    worker_loop)

ROOT = Path(__file__).resolve().parents[1]
SPEC = "repro_torch.fitness.hostsim:sphere"
FAST = dict(poll_interval_s=0.005, chunk_timeout_s=60)
GA = ["--fitness", "rastrigin", "--genes", "4", "--islands", "2",
      "--pop", "13", "--epochs", "2", "--gens-per-epoch", "2",
      "--device", "cpu"]


def _queue_empty(mq_dir):
    return all(os.listdir(os.path.join(mq_dir, d)) == []
               for d in (TASKS_DIR, CLAIMED_DIR, RUNS_DIR))


# ---------------------------------------------------------------------------
# queue contract twins
# ---------------------------------------------------------------------------

def test_cross_run_claim_prefers_priority_then_oldest(tmp_path):
    """Among runs with ready tasks the highest-priority run drains first
    (ties on run id), oldest task within each run, whatever the enqueue
    order."""
    mq = str(tmp_path)
    make_broker_dirs(mq)
    register_run(mq, "hi", priority=7, fn_spec=SPEC)
    register_run(mq, "mid", priority=3, fn_spec=SPEC)
    register_run(mq, "lo", priority=1, fn_spec=SPEC)
    for run, chunks in (("lo", 3), ("mid", 2), ("hi", 3)):
        for i in range(chunks):
            atomic_savez(os.path.join(mq, TASKS_DIR,
                                      task_name(run, 0, i, 0, 0)),
                         genomes=np.ones((1, 1), np.float32))
    order = []
    while (name := claim_next(mq)) is not None:
        order.append(parse_task_name(name))
    assert [p[0] for p in order] == ["hi"] * 3 + ["mid"] * 2 + ["lo"] * 3
    for run in ("hi", "mid", "lo"):
        chunks = [p[2] for p in order if p[0] == run]
        assert chunks == sorted(chunks)


def test_run_aware_gc_never_sweeps_other_runs_files(tmp_path):
    mq = str(tmp_path)
    victim = QueueBackend(fn_spec=SPEC, num_workers=2, run_id="victim",
                          mq_dir=mq, **FAST)
    vtask = task_name("victim", 3, 0, 0, 0)
    atomic_savez(os.path.join(mq, TASKS_DIR, vtask),
                 genomes=np.ones((2, 2), np.float32))
    vclaim = task_name("victim", 3, 1, 0, 0)
    for path in (os.path.join(mq, CLAIMED_DIR, vclaim),
                 os.path.join(mq, CLAIMED_DIR, vclaim + LEASE_SUFFIX)):
        Path(path).write_text("live")
    vres = task_name("victim", 2, 0, 0, 0)
    atomic_savez(mq_result_path(mq, vres),
                 fitness=np.zeros((2, 1), np.float32),
                 duration=np.float64(0.1))
    # run "a" churns through jobs with keep_jobs=0 (maximal GC pressure)
    a = QueueBackend(fn_spec=SPEC, num_workers=2, run_id="a",
                     keep_jobs=0, mq_dir=mq, **FAST)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            name = claim_next(mq, skip_runs=("victim",))
            if name is None:
                time.sleep(0.005)
                continue
            process_task(mq, name, hostsim.sphere)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        for _ in range(3):
            out = a._host_eval(np.ones((6, 2), np.float32))
            assert np.array_equal(out, np.full((6, 1), 2.0, np.float32))
    finally:
        stop.set()
        t.join(timeout=10)
    leftovers = []
    for d in (TASKS_DIR, CLAIMED_DIR, RESULTS_DIR):
        leftovers += os.listdir(os.path.join(mq, d))
    assert all(n.startswith("rvictim_") for n in leftovers), leftovers
    for path in (os.path.join(mq, TASKS_DIR, vtask),
                 os.path.join(mq, CLAIMED_DIR, vclaim),
                 os.path.join(mq, CLAIMED_DIR, vclaim + LEASE_SUFFIX),
                 mq_result_path(mq, vres)):
        assert os.path.exists(path), path
    a.close()
    victim.close()


def test_poison_ticket_honored_at_chunk_boundary(tmp_path):
    """A worker claims a poison STOP ticket only when no real task is
    ready, and exits removing it."""
    mq = str(tmp_path)
    make_broker_dirs(mq)
    for i in range(2):
        atomic_savez(os.path.join(mq, TASKS_DIR, task_name("a", 0, i, 0, 0)),
                     genomes=np.ones((2, 2), np.float32))
    Path(mq, TASKS_DIR, "zzzstop-0" + POISON_SUFFIX).write_text("stop")
    done = worker_loop(mq, fn=hostsim.sphere, poll_s=0.005)
    assert done == 2
    assert os.listdir(os.path.join(mq, TASKS_DIR)) == []
    assert os.listdir(os.path.join(mq, CLAIMED_DIR)) == []
    assert len(os.listdir(os.path.join(mq, RESULTS_DIR))) == 2


def test_autoscaler_scales_down_with_poison_tickets(tmp_path):
    """An idle autoscaled fleet of 3 over a floor of 1 drops two poison
    tickets, and two workers retire on them."""
    from repro_torch.runtime.mq import FleetAutoscaler
    mq = str(tmp_path)
    pool = LocalWorkerPool(3, "thread", mq_dir=mq, lease_s=5.0,
                           poll_s=0.005, fn=hostsim.sphere)
    scaler = FleetAutoscaler(pool, min_workers=1, max_workers=3,
                             interval_s=0.02, cooldown_s=0.0)
    backend = QueueBackend(fn_spec=SPEC, num_workers=3, mq_dir=mq,
                           worker_pool=pool, autoscaler=scaler, **FAST)
    try:
        g = np.random.default_rng(0).uniform(-1, 1, (9, 3)).astype(
            np.float32)
        assert np.array_equal(backend._host_eval(g), hostsim.sphere(g))
        deadline = time.monotonic() + 10
        while pool.alive_workers() > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pool.alive_workers() == 1
        stats = tb.Broker(backend=backend).backend_stats()
        assert stats["autoscaler_scale_downs"] >= 1
        assert stats["autoscaler_peak_workers"] == 3
    finally:
        backend.close()


# ---------------------------------------------------------------------------
# the metrics bus in the ported core, against the reference's
# ---------------------------------------------------------------------------

def _both_registries():
    port, ref = MetricsRegistry(), RefRegistry()
    runtime_metrics.set_registry(port)
    ref_metrics.set_registry(ref)
    return port, ref


def _reset_registries():
    runtime_metrics.set_registry(None)
    ref_metrics.set_registry(None)


def test_chunk_durations_and_cost_ema_published_like_the_reference():
    port, ref = _both_registries()
    try:
        outs = [(np.ones((3, 1), np.float32), 0.5),
                (np.zeros((2, 1), np.float32), 0.25)]
        perm = np.array([4, 0, 2, 1, 3, 5])      # 5 is a sentinel pad
        emas = []
        for mod in (tb, ref_broker):
            ema = mod.CostEMA(alpha=0.5)
            ema.snapshot(5)
            emas.append(ema)
        got = thb.collect_chunk_results(outs, emas[0], perm, [3, 3])
        want = ref_hb.collect_chunk_results(outs, emas[1], perm, [3, 3])
        assert np.array_equal(got, want)
        assert np.array_equal(emas[0].snapshot(5), emas[1].snapshot(5))
        for reg in (port, ref):
            assert reg.counter_total("cost_ema_updates_total") == 1
        for name in ("cost_ema_mean_seconds", "cost_ema_max_seconds",
                     "cost_ema_min_seconds"):
            assert port.agg_gauge(name) == ref.agg_gauge(name)
        assert port.snapshot()["histograms"] == ref.snapshot()["histograms"]
        hist = port.snapshot()["histograms"]
        (key, h), = [(k, v) for k, v in hist.items()
                     if k[0] == "dispatch_chunk_duration_seconds"]
        assert h["count"] == 2 and h["sum"] == 0.75
    finally:
        _reset_registries()


def test_metrics_off_publishes_nothing():
    assert runtime_metrics.get_registry() is runtime_metrics.NULL
    ema = tb.CostEMA()
    ema.snapshot(2)
    thb.collect_chunk_results([(np.ones((2, 1), np.float32), 0.1)], ema,
                              np.arange(2), [2])
    assert ema.updates == 1


def test_runtime_and_core_do_not_import_obs():
    code = ("import sys, repro_torch.runtime.mq, repro_torch.runtime.batchq,"
            " repro_torch.runtime.netbroker, repro_torch.core.broker, "
            "repro_torch.core.hostbridge, repro_torch.launch.ga_run; "
            "bad = [m for m in sys.modules if m.startswith('repro_torch.obs')"
            " or m.split('.')[0] in ('repro', 'jax')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


# ---------------------------------------------------------------------------
# a subprocess fleet: the port's workers, numpy only
# ---------------------------------------------------------------------------

def test_subprocess_fleet_runs_the_ports_numpy_workers(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import sys\nimport numpy as np\n"
        "def modules(genomes):\n"
        "    heavy = any(m.split('.')[0] in ('torch', 'jax', 'repro')\n"
        "                for m in sys.modules)\n"
        "    spec = getattr(sys.modules['__main__'], '__spec__', None)\n"
        "    port = getattr(spec, 'name', '') == 'repro_torch.runtime.mq'\n"
        "    return np.full((len(genomes), 1), 2 * heavy + port,\n"
        "                   np.float32)\n")
    mq = str(tmp_path / "mq")
    pool = LocalWorkerPool(2, "subprocess", lease_s=10.0, poll_s=0.01)
    env_path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = str(tmp_path) + (os.pathsep + env_path
                                                if env_path else "")
    try:
        backend = QueueBackend(fn_spec="probe:modules", num_workers=2,
                               mq_dir=mq, worker_pool=pool, **FAST)
    finally:
        os.environ["PYTHONPATH"] = env_path
    with backend:
        members = list(pool._members)
        assert len(members) == 2
        for proc in members:
            assert proc.args[1:4] == ["-m", "repro_torch.runtime.mq",
                                      "--worker"]
            # Popen returns once exec has begun; the new image's argument
            # area (what /proc shows) is set up a moment later, so read
            # until it appears
            cmdline, deadline = b"", time.monotonic() + 10.0
            while not cmdline and time.monotonic() < deadline:
                cmdline = Path(f"/proc/{proc.pid}/cmdline").read_bytes()
                time.sleep(0 if cmdline else 0.01)
            assert b"repro_torch.runtime.mq" in cmdline
        g = np.ones((8, 3), np.float32)
        # 1: the worker's main module is the port's, and no torch, jax or
        # reference module is loaded
        assert np.array_equal(backend._host_eval(g),
                              np.ones((8, 1), np.float32))
        spec_backend = QueueBackend(fn_spec=SPEC, num_workers=2, mq_dir=mq,
                                    **FAST)
        with spec_backend:
            g = np.random.default_rng(3).uniform(-1, 1, (8, 3)).astype(
                np.float32)
            assert np.array_equal(spec_backend._host_eval(g),
                                  hostsim.sphere(g))
    assert all(p.poll() is not None for p in members)
    assert _queue_empty(mq)


# ---------------------------------------------------------------------------
# ga_run: flag errors, and the queue backends end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--dispatch-backend", "mq", "--mq-fleet", "external"],
    ["--dispatch-backend", "mq", "--mq-fleet", "external", "--mq-dir", "D",
     "--mq-autoscale", "1:4"],
    ["--dispatch-backend", "mq", "--mq-fleet", "slurm"],
    ["--dispatch-backend", "mq", "--mq-fleet", "k8s"],
    ["--dispatch-backend", "mq", "--mq-autoscale", "4"],
    ["--dispatch-backend", "mq", "--mq-autoscale", "3:2"],
    ["--dispatch-backend", "mq-net", "--mq-autoscale", "1:2"],
    ["--dispatch-backend", "mq-net", "--mq-dir", "D"],
    ["--dispatch-backend", "mq-net", "--mq-fleet", "slurm"],
    ["--cost-ema"],
], ids=["external-no-dir", "external-autoscale", "slurm-fleet-no-dir",
        "k8s-fleet-no-dir", "autoscale-format", "autoscale-order",
        "net-autoscale", "net-mq-dir", "net-fleet", "cost-ema-inline"])
def test_flag_errors_match_the_reference(extra, capsys):
    from repro.launch import ga_run as ref_ga_run
    base = ["--fitness", "sphere", "--genes", "2", "--islands", "2",
            "--pop", "4", "--epochs", "1"]
    with pytest.raises(SystemExit) as ref_exc:
        ref_ga_run.main(base + extra)
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as exc:
        ga_run.main(base + ["--device", "cpu"] + extra)
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert exc.value.code == ref_exc.value.code == 2
    # the reference's message, with the port's module name in it
    assert err.split(": error: ")[1] == ref_err.split(": error: ")[1] \
        .replace("repro.runtime.netbroker", "repro_torch.runtime.netbroker")
    assert runtime_metrics.get_registry() is runtime_metrics.NULL


def _best_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("best genome")]


@pytest.mark.parametrize("backend", ["mq-mock", "mq-net", "k8s-mock"])
def test_ga_run_queue_backend_bit_identical_to_host_thread(backend,
                                                           tmp_path, capsys):
    """The queue backends evaluate with the host pool's numpy simulators,
    so the run is the host-thread run bit for bit (inline dispatch
    evaluates with torch ops, whose round-off differs)."""
    pop_host, _ = ga_run.main(GA + ["--dispatch-backend", "host-thread"])
    ref_out = capsys.readouterr().out
    extra = ["--dispatch-backend", backend, "--chunk-timeout-s", "60",
             "--keep-jobs", "2", "--lease-s", "30"]
    if backend == "mq-mock":
        extra += ["--mq-dir", str(tmp_path / "mq"), "--cost-ema",
                  "--metrics-dir", str(tmp_path / "metrics"),
                  "--events-log", str(tmp_path / "events.jsonl")]
    pop, hist = ga_run.main(GA + extra)
    out = capsys.readouterr().out
    assert torch.equal(pop.genomes, pop_host.genomes)
    assert torch.equal(pop.fitness, pop_host.fitness)
    assert _best_line(out) == _best_line(ref_out)
    assert "retries=0" in out
    # the stored fitness is the numpy simulator's, bit for bit
    g = pop.genomes.reshape(-1, 4).numpy()
    assert np.array_equal(pop.fitness.reshape(-1, 1).numpy(),
                          hostsim.rastrigin(g))
    assert runtime_metrics.get_registry() is runtime_metrics.NULL
    if backend == "mq-mock":
        assert _queue_empty(str(tmp_path / "mq"))
        from repro_torch.obs import parse_prometheus_text
        prom = parse_prometheus_text(
            (tmp_path / "metrics" / "chambga.prom").read_text())
        jobs = sum(v for (n, _), v in prom.items() if n == "mq_jobs_total")
        chunks = sum(v for (n, _), v in prom.items()
                     if n == "mq_chunks_enqueued_total")
        count = sum(v for (n, _), v in prom.items()
                    if n == "dispatch_chunk_duration_seconds_count")
        assert jobs == 1 + 2 * 2            # initial eval + generations
        assert count == chunks == jobs * 4
        assert sum(v for (n, _), v in prom.items()
                   if n == "cost_ema_updates_total") == chunks
        kinds = {json.loads(ln)["kind"] for ln in
                 (tmp_path / "events.jsonl").read_text().splitlines()}
        assert {"enqueue", "claim", "publish", "result"} <= kinds


def test_ga_run_hvdc_over_mq_mock_matches_host_thread(capsys):
    """HVDC on a 20-bus grid: the thread fleet is handed the fitness behind
    one lock through the pool's ``fn`` (nothing card-resident is
    pickled), and the run matches the host-thread backend: the same
    genomes, and objectives at ``tests/test_torch_powerflow.py``'s
    OBJ_TOL (the queue sizes its chunks by predicted cost, the host pool
    splits equally, and a batched Newton solve's round-off depends on
    its batch)."""
    args = ["--fitness", "hvdc", "--grid-size", "20", "--islands", "3",
            "--pop", "10", "--epochs", "2", "--num-workers", "4",
            "--device", "cpu", "--lease-s", "30"]
    pop_host, _ = ga_run.main(args + ["--dispatch-backend", "host-thread"])
    host_out = capsys.readouterr().out
    pop, _ = ga_run.main(args + ["--dispatch-backend", "mq-mock"])
    out = capsys.readouterr().out
    assert torch.equal(pop.genomes, pop_host.genomes)
    torch.testing.assert_close(pop.fitness, pop_host.fitness, rtol=1e-4,
                               atol=1e-4)
    assert _best_line(out) == _best_line(host_out)
    assert "retries=0" in out


def test_queue_fitness_never_pickles_a_card_fitness():
    from repro_torch.core.hostbridge import LockedHostFitness
    from repro_torch.fitness.powerflow import SpawnedHostFitness
    assert ga_run.queue_fitness("rastrigin", None) == (None, None)
    assert ga_run.fitness_spec("rastrigin") == \
        "repro_torch.fitness.hostsim:rastrigin"
    assert ga_run.fitness_spec("hvdc") is None

    class Fit:
        grid = None
        num_contingencies = newton_iters = screen_top_k = seed = 0

    queue_fn, pool_fn = ga_run.queue_fitness("hvdc", Fit())
    assert isinstance(queue_fn, SpawnedHostFitness)
    assert isinstance(pool_fn, LockedHostFitness)
