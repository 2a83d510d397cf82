"""GA optimization driver — the paper's main entrypoint (CHAMB-GA Fig. 1),
in PyTorch.

Builds the GA configuration for a benchmark fitness, prints the scaling
plan and runs the island-model engine with the inline dispatch backend and
optional checkpointing. Runs on the GPU unless ``--device cpu`` is given;
without a GPU and without ``--device cpu`` it fails.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness rastrigin \
      --genes 128 --islands 32 --pop 1024 --epochs 3
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness rastrigin \
      --genes 8 --islands 4 --pop 48 --epochs 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.ga_run --fitness hvdc \
      --grid-size 2715 --hvdc-lines 18 --islands 2 --pop 16 --epochs 2 \
      --gens-per-epoch 2 --num-workers 4

``--fitness hvdc`` is the paper's §4.2 HVDC dispatch (batched AC Newton
power flow on a synthetic grid of ``--grid-size`` buses), with its cost
model driving the broker's balanced dispatch over ``--num-workers`` lanes.
Not ported yet: ``--fitness lm`` and every ``--dispatch-backend`` other
than ``inline``.
"""
from __future__ import annotations

import argparse

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
DISPATCH_BACKENDS = ("inline", "host-thread", "host-process", "slurm",
                     "slurm-mock", "k8s", "k8s-mock", "mq", "mq-mock",
                     "mq-net")


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
                         "GA's stream (the only backend ported so far)")
    ap.add_argument("--num-workers", type=int, default=None,
                    help="broker dispatch lanes (default: 1)")
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
    if args.dispatch_backend != "inline":
        ap.error(f"--dispatch-backend {args.dispatch_backend} is not yet "
                 f"ported to repro_torch")
    device = resolve_device(args.device)

    cfg, fitness_fn, cost_fn = build(args.fitness, args, device)
    plan = plan_scaling(torch.cuda.device_count() if device.type == "cuda"
                        else 1, pop_total=cfg.global_pop,
                        sim_parallelism=max(args.contingencies, 1))
    print(f"scaling plan: horizontal={plan.horizontal} "
          f"vertical={plan.vertical}")
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    eng = GAEngine(cfg, fitness_fn, cost_fn=cost_fn,
                   num_workers=args.num_workers, checkpointer=ckpt,
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
    print(f"best fitness: {f[0]:.6f}")
    print(f"best genome:  {np.round(g, 4)}")
    return pop, hist


if __name__ == "__main__":
    main()
