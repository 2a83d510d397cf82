"""GA optimization driver — the paper's main entrypoint (CHAMB-GA Fig. 1),
in PyTorch.

Builds the GA configuration for a benchmark fitness, prints the scaling
plan and runs the island-model engine with optional checkpointing. Runs on
the GPU unless ``--device cpu`` is given; without a GPU and without
``--device cpu`` it fails.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness rastrigin \
      --genes 128 --islands 32 --pop 1024 --epochs 3
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness rastrigin \
      --genes 8 --islands 4 --pop 48 --epochs 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness hvdc \
      --grid-size 2715 --hvdc-lines 18 --islands 2 --pop 16 --epochs 2 \
      --gens-per-epoch 2 --num-workers 4
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness lm \
      --lm-arch gemma2-2b --epochs 2
  # the paper's decoupled simulation backend: fitness on a host pool
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness rastrigin \
      --genes 128 --islands 32 --pop 1024 --epochs 3 \
      --dispatch-backend host-thread --num-workers 4 --cost-ema
  # the paper's central message broker: persistent numpy workers behind
  # a file queue (mq), a TCP broker (mq-net), or spooled array jobs
  # (slurm*, k8s*; *-mock runs the same path on local workers)
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness rastrigin \
      --genes 128 --islands 32 --pop 1024 --epochs 3 \
      --dispatch-backend mq --mq-fleet local --num-workers 4 \
      --metrics-dir /tmp/chambga-metrics

``--fitness hvdc`` is the paper's §4.2 HVDC dispatch (batched AC Newton
power flow on a synthetic grid of ``--grid-size`` buses), with its cost
model driving the broker's balanced dispatch over ``--num-workers`` lanes.
``--fitness lm`` is the LM hyperparameter search (``fitness/lm.py``): each
genome trains the reduced ``--lm-arch`` for ``--lm-steps`` steps, all of a
generation's genomes batched into one vmapped training run.

The GA runs on the genomes' device; every decoupled backend copies each
generation's offspring to the host, evaluates them there and copies the
fitness back. The flags of the ``slurm*``, ``k8s*`` and ``mq*`` backends,
their defaults and their errors are the reference's (see the epilog).
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import GAConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import GAEngine
from repro_torch.core.scaling import plan_scaling
from repro_torch.fitness import get_benchmark

BENCHMARKS = ("rastrigin", "sphere", "rosenbrock", "ackley", "griewank")
DISPATCH_BACKENDS = ("inline", "host-thread", "host-process", "slurm",
                     "slurm-mock", "k8s", "k8s-mock", "mq", "mq-mock",
                     "mq-net")


def build(fitness_name: str, args, device):
    """(GAConfig, fitness_fn, cost_fn) for a fitness on ``device``."""
    if fitness_name == "lm":
        from repro_torch.fitness.lm import NUM_LM_GENES, LMTrainFitness
        fit = LMTrainFitness(args.lm_arch, steps=args.lm_steps,
                             device=device)
        cfg = GAConfig(num_genes=NUM_LM_GENES, pop_per_island=args.pop,
                       num_islands=args.islands,
                       generations_per_epoch=args.gens_per_epoch,
                       num_epochs=args.epochs, lower=0.0, upper=1.0,
                       mutation_prob=0.5, mutation_eta=20.0,
                       crossover_prob=0.9, crossover_eta=15.0,
                       fused_operators=False, seed=args.seed)
        return cfg, fit, None
    if fitness_name == "hvdc":
        from repro_torch.fitness.powerflow import HVDCDispatchFitness
        from repro_torch.powerflow.grid import make_synthetic_grid
        n = args.grid_size
        grid = make_synthetic_grid(
            n_bus=n, n_line=int(n * 1.97), n_gen=max(4, n // 4),
            n_hvdc=args.hvdc_lines, seed=args.seed)
        fit = HVDCDispatchFitness(grid, contingencies=args.contingencies,
                                  screen_top_k=args.screen_top_k,
                                  device=device)
        cfg = GAConfig(num_genes=grid.n_hvdc, pop_per_island=args.pop,
                       num_islands=args.islands,
                       generations_per_epoch=args.gens_per_epoch,
                       num_epochs=args.epochs, lower=-1.0, upper=1.0,
                       mutation_prob=0.7, mutation_eta=34.6,   # paper Tab. 3
                       crossover_prob=1.0, crossover_eta=97.5,
                       seed=args.seed)
        return cfg, fit, fit.cost_model()
    cfg = GAConfig(num_genes=args.genes, pop_per_island=args.pop,
                   num_islands=args.islands,
                   generations_per_epoch=args.gens_per_epoch,
                   num_epochs=args.epochs, lower=-5.12, upper=5.12,
                   mutation_prob=0.7, mutation_eta=20.0,
                   crossover_prob=0.9, crossover_eta=15.0,
                   seed=args.seed)
    return cfg, get_benchmark(fitness_name), None


SCHEDULERS_HELP = """\
Schedulers (--dispatch-backend slurm|slurm-mock|k8s|k8s-mock):
  Both batch backends spool each evaluation batch to --spool-dir and
  submit the chunks through the Scheduler protocol; only the scheduler
  object differs (the paper's K8s<->SLURM portability claim).
    slurm      one `sbatch --array` job per batch; task i resolves its
               chunk from a manifest by $SLURM_ARRAY_TASK_ID.
    k8s        one indexed Job per batch (completionMode=Indexed); pod i
               resolves its chunk by $JOB_COMPLETION_INDEX.
    slurm-mock / k8s-mock
               the same spool/poll/retry path against local workers (a
               numpy subprocess per chunk / in-process threads).
  The spool must be a filesystem shared with the workers. Completed job_*
  spool dirs are pruned down to --keep-jobs; chunks are sized by
  predicted cost when a cost model is active; chunks predicted cheaper
  than --min-chunk-cost-s are folded into a neighbor.

Message queue (--dispatch-backend mq|mq-mock):
  --mq-dir holds a file-backed task and result queue, served by a fleet
  of PERSISTENT numpy workers (python -m repro_torch.runtime.mq --worker)
  that claim tasks by atomic rename and heartbeat a lease; the manager
  re-queues a task whose lease is stale for --lease-s, and keeps
  --chunk-timeout-s as the backstop for live-but-stuck workers.
    mq         --mq-fleet local (subprocesses on this host), slurm / k8s
               (ONE long-lived array job / indexed Job), or external
               (attach to a fleet another invocation owns).
    mq-mock    in-process thread workers.
  --num-mq-workers sizes the fleet (default: the dispatch lane count);
  --mq-run-id / --mq-priority namespace and rank this run on a shared
  fleet; --mq-autoscale MIN:MAX makes an owned fleet elastic, on queue
  depth or predicted cost (--mq-autoscale-signal).

Network transport (--dispatch-backend mq-net):
  The same queue contract over a TCP broker service:
    python -m repro_torch.runtime.netbroker --serve --port 7077
    python -m repro_torch.runtime.netbroker --worker --broker-addr H:7077
  Without --broker-addr the run is self-contained (an in-process server
  plus thread workers). --mq-dir, --mq-fleet and --mq-autoscale do not
  apply.

Fitness on the workers:
  Named benchmarks resolve to repro_torch.fitness.hostsim's numpy
  simulators by import spec. --fitness hvdc and lm are pickled as CPU
  rebuilds (SpawnedHostFitness, SpawnedLMFitness) for fleets of processes
  (mq local/slurm/k8s, slurm*, k8s*, external mq-net workers); in-process
  thread pools (mq-mock, self-contained mq-net) run them on their own
  device behind one lock (LockedHostFitness).

Observability (--metrics-dir / --metrics-port / --events-log):
  Off by default. Any of the three installs the metrics bus:
  --metrics-dir DIR publishes DIR/chambga.prom every ~2 s
  (python -m repro_torch.obs --dashboard --metrics-dir DIR renders it),
  --metrics-port P serves /metrics, --events-log FILE appends every
  dispatch event as one JSON line.
"""


def host_fitness(fitness_name: str, fitness_fn, executor: str):
    """What the host pool evaluates: a named benchmark's numpy simulator
    (``fitness.hostsim``, on the host's cores: the decoupled container),
    or for ``hvdc`` and ``lm`` a numpy adapter over the fitness — on its
    own device behind one lock under threads, rebuilt on the CPU of each
    spawned worker under processes."""
    if fitness_name in BENCHMARKS:
        from repro_torch.fitness import hostsim
        return getattr(hostsim, fitness_name)
    from repro_torch.core.hostbridge import LockedHostFitness
    from repro_torch.fitness.powerflow import SpawnedHostFitness
    if executor == "thread":
        return LockedHostFitness(fitness_fn)
    if fitness_name == "lm":
        from repro_torch.fitness.lm import SpawnedLMFitness
        return SpawnedLMFitness(fitness_fn)
    return SpawnedHostFitness(fitness_fn)


def fitness_spec(fitness_name: str):
    """Import spec of a named benchmark's numpy simulator, which queue
    workers resolve without torch; None for fitnesses without one."""
    from repro_torch.fitness import hostsim
    return (f"repro_torch.fitness.hostsim:{fitness_name}"
            if hasattr(hostsim, fitness_name) else None)


def queue_fitness(fitness_name: str, fitness_fn):
    """``(fitness_fn, pool_fn)`` for the queue backends. Named benchmarks
    go by import spec (``(None, None)``). HVDC is pickled as the host
    pool's CPU rebuild for fleets of processes, and in-process thread
    workers are handed the host pool's thread fitness through the pool's
    ``fn``: a card-resident fitness is never pickled."""
    if fitness_spec(fitness_name) is not None:
        return None, None
    return (host_fitness(fitness_name, fitness_fn, "process"),
            host_fitness(fitness_name, fitness_fn, "thread"))


def make_queue_backend(args, ap, fitness_fn, pool_fn, num_objectives,
                       workers, obs_registry):
    """The ``slurm*``, ``k8s*``, ``mq-net`` and ``mq*`` backends, built
    as the reference builds them (same flags, defaults and errors)."""
    fn_spec = fitness_spec(args.fitness)
    # 0 disables the timeout; the queue backends default to 300 s
    timeout = (300.0 if args.chunk_timeout_s is None
               else args.chunk_timeout_s or None)
    keep = None if args.keep_jobs < 0 else args.keep_jobs
    if args.dispatch_backend.startswith(("slurm", "k8s")):
        from repro_torch.runtime.batchq import (KubernetesScheduler,
                                                LocalMockScheduler,
                                                MockKubectl,
                                                SlurmArrayBackend,
                                                SlurmScheduler)
        if args.dispatch_backend == "slurm":
            scheduler = SlurmScheduler(partition=args.slurm_partition)
        elif args.dispatch_backend == "slurm-mock":
            scheduler = LocalMockScheduler()
        else:
            scheduler = KubernetesScheduler(
                namespace=args.k8s_namespace, image=args.k8s_image,
                runner=(MockKubectl()
                        if args.dispatch_backend == "k8s-mock" else None))
        return SlurmArrayBackend(
            fitness_fn, fn_spec=fn_spec, num_objectives=num_objectives,
            num_workers=workers, scheduler=scheduler,
            spool_dir=args.spool_dir, chunk_timeout_s=timeout,
            min_chunk_cost_s=args.min_chunk_cost_s, keep_jobs=keep)
    if args.dispatch_backend == "mq-net":
        from repro_torch.runtime.netbroker import (NetWorkerPool,
                                                   SocketQueueBackend)
        if args.mq_autoscale:
            ap.error("--mq-autoscale is not wired for mq-net (the "
                     "poison-ticket scale-down protocol is file-broker "
                     "only); size the fleet with --num-mq-workers")
        if args.mq_dir:
            ap.error("mq-net has no broker directory — the server owns "
                     "its state privately; use --broker-addr (or drop "
                     "--mq-dir for a self-contained in-process server)")
        if args.mq_fleet != "local":
            ap.error("--mq-fleet does not apply to mq-net: attach to a "
                     "shared fleet with --broker-addr, or launch workers "
                     "with `python -m repro_torch.runtime.netbroker "
                     "--worker`")
        pool = None
        if args.broker_addr is None:
            # self-contained: in-process server + thread workers
            pool = NetWorkerPool(
                num_workers=args.num_mq_workers or workers,
                mode="thread", lease_s=args.lease_s, fn=pool_fn)
        return SocketQueueBackend(
            fitness_fn, fn_spec=fn_spec, num_objectives=num_objectives,
            num_workers=workers, broker_addr=args.broker_addr,
            run_id=args.mq_run_id, priority=args.mq_priority,
            lease_s=args.lease_s, chunk_timeout_s=timeout,
            min_chunk_cost_s=args.min_chunk_cost_s, keep_jobs=keep,
            worker_pool=pool)
    from repro_torch.runtime.mq import (FleetAutoscaler, LocalWorkerPool,
                                        MQWorkerFleet, QueueBackend)
    n_mq = args.num_mq_workers or workers
    autoscale = None
    if args.mq_autoscale:
        lo, _, hi = args.mq_autoscale.partition(":")
        try:
            autoscale = (int(lo), int(hi))
        except ValueError:
            ap.error("--mq-autoscale wants MIN:MAX, e.g. 1:16")
        if autoscale[0] < 1 or autoscale[1] < autoscale[0]:
            ap.error("--mq-autoscale wants 1 <= MIN <= MAX")
        n_mq = autoscale[0]          # start at the floor, grow on depth
    pool = None
    if args.dispatch_backend == "mq-mock":
        pool = LocalWorkerPool(num_workers=n_mq, mode="thread",
                               lease_s=args.lease_s, fn=pool_fn)
    elif args.mq_fleet == "external":
        if not args.mq_dir:
            ap.error("--mq-fleet external needs the shared --mq-dir "
                     "the fleet-owning invocation uses")
        if autoscale:
            ap.error("--mq-autoscale cannot resize an external fleet "
                     "— only the invocation that owns it can")
    elif args.mq_fleet == "local":
        pool = LocalWorkerPool(num_workers=n_mq, mode="subprocess",
                               lease_s=args.lease_s)
    else:
        if not args.mq_dir:
            ap.error("--mq-fleet slurm|k8s needs an explicit --mq-dir "
                     "on a volume shared with the cluster workers — a "
                     "local temp dir would leave the fleet idling on "
                     "a path it cannot see")
        from repro_torch.runtime.batchq import (KubernetesScheduler,
                                                SlurmScheduler)
        # the fleet must outlive the whole run
        sched = (SlurmScheduler(partition=args.slurm_partition,
                                time_limit="7-00:00:00")
                 if args.mq_fleet == "slurm" else
                 KubernetesScheduler(namespace=args.k8s_namespace,
                                     image=args.k8s_image))
        pool = MQWorkerFleet(sched, n_mq, lease_s=args.lease_s)
    scaler = (FleetAutoscaler(pool, min_workers=autoscale[0],
                              max_workers=autoscale[1],
                              signal=args.mq_autoscale_signal,
                              metrics=obs_registry)
              if autoscale else None)
    return QueueBackend(
        fitness_fn, fn_spec=fn_spec, num_objectives=num_objectives,
        num_workers=workers, mq_dir=args.mq_dir, run_id=args.mq_run_id,
        priority=args.mq_priority, lease_s=args.lease_s,
        chunk_timeout_s=timeout, min_chunk_cost_s=args.min_chunk_cost_s,
        keep_jobs=keep, worker_pool=pool, autoscaler=scaler)


def install_metrics(args):
    """Install the metrics bus when any observability flag is given:
    ``(registry, [teardown callables])``, or ``(None, [])``."""
    if not (args.metrics_dir or args.metrics_port is not None
            or args.events_log):
        return None, []
    from repro_torch.obs import (PROM_FILENAME, EventLog,
                                 MetricsHTTPServer, MetricsRegistry,
                                 TextfileExporter)
    from repro_torch.runtime import metrics as runtime_metrics
    events = None
    if args.events_log:
        parent = os.path.dirname(args.events_log)
        if parent:
            os.makedirs(parent, exist_ok=True)
        events = EventLog(args.events_log)
    registry = MetricsRegistry(events=events)
    runtime_metrics.set_registry(registry)
    # run in reverse order after the backend's close(), so the
    # exporter's final write holds the end-of-run counters
    teardown = [lambda: runtime_metrics.set_registry(None)]
    if events is not None:
        teardown.append(events.close)
    if args.metrics_dir:
        os.makedirs(args.metrics_dir, exist_ok=True)
        exporter = TextfileExporter(
            registry, os.path.join(args.metrics_dir, PROM_FILENAME)).start()
        teardown.append(exporter.stop)
    if args.metrics_port is not None:
        http = MetricsHTTPServer(registry, port=args.metrics_port).start()
        print(f"metrics: http://127.0.0.1:{http.port}/metrics")
        teardown.append(http.stop)
    return registry, teardown


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=SCHEDULERS_HELP)
    ap.add_argument("--fitness", default="rastrigin")
    ap.add_argument("--genes", type=int, default=8)
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--gens-per-epoch", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid-size", type=int, default=60)
    ap.add_argument("--hvdc-lines", type=int, default=4)
    ap.add_argument("--contingencies", type=int, default=0)
    ap.add_argument("--screen-top-k", type=int, default=0)
    ap.add_argument("--lm-arch", default="tinyllama-1.1b")
    ap.add_argument("--lm-steps", type=int, default=6)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--wallclock-s", type=float, default=None)
    ap.add_argument("--dispatch-backend", default="inline",
                    choices=DISPATCH_BACKENDS,
                    help="inline: fitness evaluated on the device in the "
                         "GA's stream; host-*: decoupled simulation "
                         "backend on a host thread or process pool (named "
                         "benchmarks run fitness.hostsim's numpy "
                         "simulators; hvdc and lm run on their device "
                         "behind one lock under host-thread, and on the CPU of each "
                         "spawned worker under host-process, since a "
                         "card-resident fitness cannot be shipped to "
                         "spawned processes); slurm: array jobs via "
                         "sbatch; k8s: indexed Jobs via kubectl; mq: "
                         "persistent-worker message queue; mq-net: the "
                         "same queue over a TCP broker; *-mock: the same "
                         "path on local workers (see below)")
    ap.add_argument("--num-workers", type=int, default=None,
                    help="broker dispatch lanes (default: 1 inline, 4 for "
                         "decoupled backends)")
    ap.add_argument("--spool-dir", default=None,
                    help="batch-dispatch spool directory (slurm*, k8s*; "
                         "default: a fresh temp dir)")
    ap.add_argument("--chunk-timeout-s", type=float, default=None,
                    help="per-chunk straggler timeout for decoupled "
                         "backends, clocked on execution time (re-queued "
                         "up to 2 times); 0 disables, default: none for "
                         "host-*, 300 for slurm*, k8s* and mq*")
    ap.add_argument("--slurm-partition", default=None,
                    help="sbatch partition for --dispatch-backend slurm")
    ap.add_argument("--k8s-namespace", default="default",
                    help="namespace for --dispatch-backend k8s Jobs")
    ap.add_argument("--k8s-image", default="chambga-worker:latest",
                    help="worker container image for --dispatch-backend "
                         "k8s (must bundle repro_torch + mount the spool)")
    ap.add_argument("--keep-jobs", type=int, default=4,
                    help="completed job_* spool directories kept per "
                         "batch backend (-1 disables pruning); for mq "
                         "backends, completed queue jobs kept before "
                         "their files are swept")
    ap.add_argument("--min-chunk-cost-s", type=float, default=0.0,
                    help="fold cost-sized chunks predicted cheaper than "
                         "this into a neighbor; 0 disables")
    ap.add_argument("--mq-dir", default=None,
                    help="message-queue broker directory (mq backends; "
                         "default: a fresh temp dir); a volume shared by "
                         "every worker")
    ap.add_argument("--broker-addr", default=None, metavar="HOST:PORT",
                    help="socket broker server address (mq-net; start one "
                         "with `python -m repro_torch.runtime.netbroker "
                         "--serve`); default: a self-contained in-process "
                         "server plus thread workers")
    ap.add_argument("--lease-s", type=float, default=15.0,
                    help="mq task lease: workers heartbeat at lease/4; "
                         "the manager re-queues tasks whose lease goes "
                         "stale this long")
    ap.add_argument("--num-mq-workers", type=int, default=None,
                    help="persistent mq fleet size (default: the "
                         "dispatch lane count)")
    ap.add_argument("--mq-fleet", default="local",
                    choices=("local", "slurm", "k8s", "external"),
                    help="how --dispatch-backend mq gets its persistent "
                         "fleet: local numpy subprocesses, ONE long-lived "
                         "SLURM array / K8s indexed Job, or external")
    ap.add_argument("--mq-run-id", default=None,
                    help="run id namespacing this run's tasks in a "
                         "(possibly shared) broker directory")
    ap.add_argument("--mq-priority", type=int, default=0,
                    help="claim priority among runs sharing a fleet")
    ap.add_argument("--mq-autoscale", default=None, metavar="MIN:MAX",
                    help="elastic fleet between MIN and MAX workers "
                         "(owned fleets only)")
    ap.add_argument("--mq-autoscale-signal", default="depth",
                    choices=("depth", "cost"),
                    help="what --mq-autoscale scales on: outstanding "
                         "tasks (depth) or predicted outstanding cost "
                         "read from the metrics bus (cost)")
    ap.add_argument("--metrics-dir", default=None,
                    help="publish a Prometheus textfile (DIR/chambga.prom)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics on this port (0 picks a free "
                         "port)")
    ap.add_argument("--events-log", default=None,
                    help="append structured dispatch events (JSONL) here")
    ap.add_argument("--cost-ema", action="store_true",
                    help="learn the dispatch cost model online from "
                         "measured per-lane wall times (needs a "
                         "decoupled backend)")
    ap.add_argument("--ema-alpha", type=float, default=0.25,
                    help="EMA smoothing factor for --cost-ema")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="drain metrics every N epochs")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="epochs kept in flight before blocking on metrics")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the GPU (default; fails without one) or "
                         "the CPU")
    args = ap.parse_args(argv)
    if args.fitness not in BENCHMARKS + ("hvdc", "lm"):
        ap.error(f"unknown --fitness {args.fitness!r}")
    device = resolve_device(args.device)

    cfg, fitness_fn, cost_fn = build(args.fitness, args, device)
    if args.cost_ema:
        if args.dispatch_backend == "inline":
            ap.error("--cost-ema needs measured per-lane wall times — "
                     "use a decoupled backend (host-*, slurm*, k8s* "
                     "or mq*)")
        from repro_torch.core.broker import CostEMA
        # a fitness with a static cost model (HVDC) primes the EMA's slot
        # table, so even the first dispatch of a skewed workload is
        # balanced; wall times refine it online
        cost_fn = CostEMA(alpha=args.ema_alpha, prime_fn=cost_fn)
    # the metrics bus goes in before the backend, so the first job's
    # enqueue and claim events land
    obs_registry, obs_teardown = install_metrics(args)
    backend = None
    # decoupled backends default to 4 workers; the broker's lane count
    # must match them (1 lane would take the identity path and never
    # engage the cost model)
    workers = args.num_workers
    if args.dispatch_backend != "inline":
        workers = args.num_workers or 4
    # context-managed teardown: a crash anywhere past this point must
    # still drain in-flight host evaluations and free the pool, the
    # spool or the broker directory
    with contextlib.ExitStack() as stack:
        for fn in obs_teardown:
            stack.callback(fn)
        if args.dispatch_backend.startswith("host-"):
            from repro_torch.core.broker import HostPoolBackend
            executor = args.dispatch_backend.split("-")[1]
            backend = HostPoolBackend(
                host_fitness(args.fitness, fitness_fn, executor),
                num_objectives=cfg.num_objectives, num_workers=workers,
                executor=executor,
                # 0 disables the timeout
                chunk_timeout_s=args.chunk_timeout_s or None)
        elif args.dispatch_backend != "inline":
            queue_fn, pool_fn = queue_fitness(args.fitness, fitness_fn)
            backend = make_queue_backend(args, ap, queue_fn, pool_fn,
                                         cfg.num_objectives, workers,
                                         obs_registry)
        if backend is not None:
            stack.enter_context(backend)
        plan = plan_scaling(torch.cuda.device_count()
                            if device.type == "cuda" else 1,
                            pop_total=cfg.global_pop,
                            sim_parallelism=max(args.contingencies, 1))
        print(f"scaling plan: horizontal={plan.horizontal} "
              f"vertical={plan.vertical}")
        ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
        eng = GAEngine(cfg, fitness_fn, cost_fn=cost_fn, backend=backend,
                       num_workers=workers, checkpointer=ckpt,
                       checkpoint_every=2 if ckpt else 0,
                       sync_every=args.sync_every,
                       pipeline_depth=args.pipeline_depth,
                       device=device,
                       log_fn=lambda r: print(
                           f"epoch {r['epoch']:4d} best {r['best']:.5f} "
                           f"skew {r['skew']:.3f}"))
        pop, hist = eng.run(wallclock_s=args.wallclock_s)
        if ckpt is not None:
            ckpt.wait()
        g, f = eng.best(pop)
        stats = eng.broker.backend_stats()
        if stats:
            print("dispatch stats: " + " ".join(
                f"{k}={v}" for k, v in sorted(stats.items())))
    print(f"best fitness: {f[0]:.6f}")
    print(f"best genome:  {np.round(g, 4)}")
    return pop, hist


if __name__ == "__main__":
    main()
