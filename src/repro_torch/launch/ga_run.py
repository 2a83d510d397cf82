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
  # the paper's decoupled simulation backend: fitness on a host pool
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness rastrigin \
      --genes 128 --islands 32 --pop 1024 --epochs 3 \
      --dispatch-backend host-thread --num-workers 4 --cost-ema

``--fitness hvdc`` is the paper's §4.2 HVDC dispatch (batched AC Newton
power flow on a synthetic grid of ``--grid-size`` buses), with its cost
model driving the broker's balanced dispatch over ``--num-workers`` lanes.
Not ported yet: ``--fitness lm`` and the ``slurm*``, ``k8s*`` and ``mq*``
dispatch backends.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import GAConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import GAEngine
from repro_torch.core.scaling import plan_scaling
from repro_torch.fitness import get_benchmark

BENCHMARKS = ("rastrigin", "sphere", "rosenbrock", "ackley", "griewank")
NOT_PORTED_FITNESS = ("lm",)
PORTED_BACKENDS = ("inline", "host-thread", "host-process")
DISPATCH_BACKENDS = PORTED_BACKENDS + ("slurm", "slurm-mock", "k8s",
                                       "k8s-mock", "mq", "mq-mock", "mq-net")


def build(fitness_name: str, args, device):
    """(GAConfig, fitness_fn, cost_fn) for a fitness on ``device``."""
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


def host_fitness(fitness_name: str, fitness_fn, executor: str):
    """What the host pool evaluates: a named benchmark's numpy simulator
    (``fitness.hostsim``, on the host's cores: the decoupled container),
    or for ``hvdc`` a numpy adapter over the fitness — on its own device
    behind one lock under threads, rebuilt on the CPU of each spawned
    worker under processes."""
    if fitness_name in BENCHMARKS:
        from repro_torch.fitness import hostsim
        return getattr(hostsim, fitness_name)
    from repro_torch.fitness.powerflow import (LockedHostFitness,
                                               SpawnedHostFitness)
    if executor == "thread":
        return LockedHostFitness(fitness_fn)
    return SpawnedHostFitness(fitness_fn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--wallclock-s", type=float, default=None)
    ap.add_argument("--dispatch-backend", default="inline",
                    choices=DISPATCH_BACKENDS,
                    help="inline: fitness evaluated on the device in the "
                         "GA's stream; host-*: decoupled simulation "
                         "backend on a host thread or process pool (named "
                         "benchmarks run fitness.hostsim's numpy "
                         "simulators; hvdc runs on its device behind one "
                         "lock under host-thread, and on the CPU of each "
                         "spawned worker under host-process, since a "
                         "card-resident fitness cannot be shipped to "
                         "spawned processes); slurm*, k8s*, mq*: not yet "
                         "ported")
    ap.add_argument("--num-workers", type=int, default=None,
                    help="broker dispatch lanes (default: 1 inline, 4 for "
                         "host-*)")
    ap.add_argument("--chunk-timeout-s", type=float, default=None,
                    help="per-chunk straggler timeout for host-*, clocked "
                         "on execution time (re-queued up to 2 times); 0 "
                         "disables, default: none")
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
    if args.fitness in NOT_PORTED_FITNESS:
        ap.error(f"--fitness {args.fitness} is not yet ported to "
                 f"repro_torch")
    if args.fitness not in BENCHMARKS + ("hvdc",):
        ap.error(f"unknown --fitness {args.fitness!r}")
    if args.dispatch_backend not in PORTED_BACKENDS:
        ap.error(f"--dispatch-backend {args.dispatch_backend} is not yet "
                 f"ported to repro_torch")
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
    backend = None
    # decoupled backends default to 4 workers; the broker's lane count
    # must match them (1 lane would take the identity path and never
    # engage the cost model)
    workers = args.num_workers
    if args.dispatch_backend != "inline":
        workers = args.num_workers or 4
        from repro_torch.core.broker import HostPoolBackend
        executor = args.dispatch_backend.split("-")[1]
        backend = HostPoolBackend(
            host_fitness(args.fitness, fitness_fn, executor),
            num_objectives=cfg.num_objectives, num_workers=workers,
            executor=executor,
            # 0 disables the timeout
            chunk_timeout_s=args.chunk_timeout_s or None)
    # context-managed teardown: a crash anywhere past this point must
    # still drain in-flight host evaluations and free the pool
    with contextlib.ExitStack() as stack:
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
