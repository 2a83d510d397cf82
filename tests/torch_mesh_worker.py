"""One rank of the port's mesh tests (``tests/test_torch_mesh.py``).

Every rank of a gloo process group on the CPU runs the same scenario;
rank 0 saves what the tests compare (``<dir>/<scenario>.pt``). Inputs made
by the test come in ``<dir>/inputs.npz``. This module imports the port
only, never JAX, so a rank starts in a few seconds.

    python tests/torch_mesh_worker.py SCENARIO RANK WORLD DIR
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import GAConfig
from repro_torch.core import collectives, island
from repro_torch.core.broker import Broker, CostEMA, HostPoolBackend
from repro_torch.core.engine import GAEngine
from repro_torch.core.hostbridge import (PureCallbackBridge,
                                         collect_chunk_results)
from repro_torch.core.population import (init_population,
                                         population_from_numpy,
                                         population_to_numpy)
from repro_torch.core.uniforms import ArrayUniforms
from repro_torch.fitness import (HVDCDispatchFitness, hostsim, rastrigin,
                                 sphere)
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.models.sharding import ShardingCtx
from repro_torch.powerflow.contingency import contingency_loadings
from repro_torch.powerflow.dc import screen_contingencies
from repro_torch.powerflow.grid import make_synthetic_grid
from repro_torch.powerflow.hvdc import apply_hvdc, scale_genome_to_dispatch
from repro_torch.powerflow.newton import newton_powerflow

# tests/test_multidevice.py:37-39, the reference's 8-device setting
EIGHT = dict(num_genes=5, pop_per_island=8, num_islands=8,
             generations_per_epoch=2, num_epochs=3, lower=-2.0, upper=2.0,
             fused_operators=False, seed=9)
# 6 islands on 4 ranks: blocks of 2, 2, 1, 1
SIX = dict(num_genes=8, pop_per_island=16, num_islands=6,
           generations_per_epoch=3, num_epochs=2, lower=-5.12, upper=5.12,
           mutation_prob=0.7, mutation_eta=20.0, crossover_prob=0.9,
           crossover_eta=15.0, fused_operators=True, seed=4,
           migration_pattern="torus")
MIGRATIONS = ("ring", "all")
BROKER_N, BROKER_G = 21, 5
HVDC_GRID = dict(n_bus=60, n_line=110, n_gen=15, n_hvdc=4, seed=1)
HVDC_SCREENS = (0, 4)
HVDC_CASES = 8
# elastic runs at EIGHT's shape: an epoch, then a resize to each later
# island count and an epoch after it, cost dispatch over RESIZE_WORKERS
# lanes rescaled with the islands (4 ranks: 4 -> 2 -> 6 lanes, so two
# ranks have none after the shrink)
RESIZES = {"four": ((8, 4, 12), 4), "eight": ((8, 16, 8), 8)}
# the learned cost model over a mesh: EMA_GENS evaluations of EMA_N x
# EMA_G genomes over EMA_W lanes (N pads to 24)
EMA_N, EMA_G, EMA_W, EMA_GENS, EMA_ALPHA = 21, 5, 4, 3, 0.5


def broker_cost(genomes):
    """A cost model that varies across rows, so the permutation moves
    them."""
    return 1.0 + 3.0 * genomes[:, 0].abs()


def hvdc_parts(fit, genomes, ctx=ShardingCtx()) -> dict:
    """The HVDC fitness's objectives, with the base case's convergence
    flags and the contingency loadings (cases over the ``tp`` axis of
    ``ctx``) from the functions it calls."""
    g = fit.gridt
    p_extra = apply_hvdc(g, scale_genome_to_dispatch(g, genomes))
    conv = newton_powerflow(g, p_extra=p_extra,
                            num_iters=fit.newton_iters).converged
    cases = (fit.outages if fit.dc_model is None else screen_contingencies(
        fit.dc_model, g["p_inj"] + p_extra, g["rate"], fit.screen_top_k))
    collectives.reset_counts()
    loadings = contingency_loadings(g, cases, p_extra=p_extra,
                                    num_iters=fit.newton_iters, ctx=ctx)
    calls = collectives.counts.get("model", {}).get("calls", 0)
    return {"objective": fit(genomes).numpy(), "converged": conv.numpy(),
            "loadings": loadings.numpy(), "model_calls": calls}


class TimedSphere(PureCallbackBridge):
    """A decoupled backend whose chunk "wall times" are a fixed function
    of the chunk's genomes, reported through ``collect_chunk_results`` as
    a host pool reports its clocks: a mesh's ranks and one rank learn the
    same table when they cut the same lanes. Keeps every permutation it
    is handed."""

    name = "timed-sphere"
    num_objectives = 1

    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self.cost_ema = None
        self.perms = []

    def _host_eval(self, genomes, perm=None, cost=None):
        if perm is not None:
            self.perms.append(perm)
        chunks = np.array_split(genomes, min(self.num_workers,
                                             max(1, len(genomes))))
        outs = [(hostsim.sphere(c), 1e-3 + float(np.abs(c).sum()))
                for c in chunks]
        return collect_chunk_results(outs, self.cost_ema, perm,
                                     [len(c) for c in chunks])

    def close(self):
        pass


def ema_genomes() -> np.ndarray:
    """(EMA_GENS, EMA_N, EMA_G) genomes, one batch a generation."""
    return np.random.default_rng(31).uniform(
        -1, 1, (EMA_GENS, EMA_N, EMA_G)).astype(np.float32)


def cost_table(cost_fn):
    """A CostEMA's slot table, None while it is cold."""
    est = getattr(cost_fn, "_est", None)
    return None if est is None else est.copy()


def ema_broker(backend, ctx=ShardingCtx(), prime_fn=None) -> list:
    """ema_genomes() through a Broker with a CostEMA over EMA_W lanes,
    this rank's rows of each batch: per generation the table after it,
    the global fitness and the dispatch stats."""
    ema = CostEMA(alpha=EMA_ALPHA, prime_fn=prime_fn)
    broker = Broker(cost_fn=ema, num_workers=EMA_W, backend=backend,
                    ctx=ctx)
    rows = ctx.sizes(EMA_N, ctx.dp)
    first, end = ctx.rows(EMA_N, ctx.dp)
    out = []
    for g in ema_genomes():
        fit, stats = broker.evaluate(torch.from_numpy(g[first:end]),
                                     rows=rows)
        out.append({"table": cost_table(ema),
                    "fitness": ctx.gather(fit, rows, ctx.dp).numpy(),
                    "stats": {k: v.item() for k, v in stats.items()}})
    return out


def resize_run(schedule, workers, ctx=ShardingCtx(), **engine_kw) -> dict:
    """EIGHT's GA on sphere: an epoch, then a resize to each island count
    of ``schedule[1:]`` and an epoch after it, cost dispatch over
    ``workers`` lanes (``broker_cost`` unless ``cost_fn`` is given). The
    first resize is handed the global population, as ``run`` returns it,
    the later ones this rank's block."""
    engine_kw.setdefault("cost_fn", broker_cost)
    eng = GAEngine(GAConfig(**dict(EIGHT, num_islands=schedule[0])), sphere,
                   num_workers=workers, ctx=ctx, device="cpu", **engine_kw)
    pop, hist = eng.run(eng.init(), epochs=1)
    lanes, tables = [], []
    for k, new in enumerate(schedule[1:]):
        if k:
            pop = island.constrain_pop(pop, ctx)
        pop = eng.resize(pop, new)
        lanes.append(eng.broker.num_workers)
        tables.append(cost_table(eng.broker.cost_fn))
        pop, more = eng.run(pop, epochs=1)
        hist += more
    return {"pop": population_to_numpy(pop),
            "trace": [h["trace"] for h in hist],
            "stats": [(h["skew"], h["balanced"]) for h in hist],
            "evals_host": eng.evals_host, "workers": lanes,
            "tables": tables, "final_table": cost_table(eng.broker.cost_fn)}


def gathered(value) -> list:
    """``value`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def run_engine(cfg, fitness, ctx) -> dict:
    """A whole run: the global population, the best trace, the counts and
    every rank's island block."""
    eng = GAEngine(cfg, fitness, ctx=ctx, device="cpu")
    local = eng.init()
    collectives.reset_counts()
    pop, hist = eng.run(local)
    return {"pop": population_to_numpy(pop),
            "trace": np.stack([h["trace"] for h in hist]),
            "evals_host": eng.evals_host,
            "islands": gathered(local.genomes.shape[0]),
            "counts": gathered(dict(collectives.counts))}


def eight(inputs) -> dict:
    ctx = ShardingCtx(mesh=make_local_mesh(8, 1, device="cpu"),
                      dp=("data",), tp="model", fsdp=())
    out = {"run": run_engine(GAConfig(**EIGHT), sphere, ctx)}
    # a wall-clock stop is rank 0's clock: every rank stops after epoch 1
    _, hist = GAEngine(GAConfig(**EIGHT), sphere, ctx=ctx,
                       device="cpu").run(wallclock_s=0.0)
    out["wallclock_epochs"] = gathered(len(hist))
    for topology in MIGRATIONS:
        cfg = GAConfig(**dict(EIGHT, migration_pattern=topology))
        pop = island.evaluate_population(cfg, Broker(sphere),
                                         init_population(cfg, 3, "cpu"))
        collectives.reset_counts()
        new = island.migrate_ring(cfg, island.constrain_pop(pop, ctx),
                                  torch.Generator().manual_seed(5), ctx)
        calls = collectives.counts["data"]["calls"]
        out[topology] = {"pop": population_to_numpy(
            island.gather_pop(new, ctx)), "calls": calls}
    out["resize"] = resize_run(*RESIZES["eight"], ctx)
    return out


def four_elastic(ctx, ctx22) -> dict:
    """Resize and the learned cost model on (data 4) and (data 2, model
    2): every rank's view where ranks must agree."""
    out = {"resize": resize_run(*RESIZES["four"], ctx),
           "resize22": gathered(resize_run(*RESIZES["four"], ctx22))}
    # below the data ranks: every rank refuses, and all reach the gather
    eng = GAEngine(GAConfig(**EIGHT), sphere, ctx=ctx, device="cpu")
    try:
        eng.resize(eng.init(), 2)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    out["refused"] = gathered(refused)
    for name, c, prime in (("ema", ctx, None), ("ema22", ctx22, broker_cost)):
        backend = TimedSphere(EMA_W)
        run = ema_broker(backend, c, prime)
        out[name] = gathered({"run": run, "perms": backend.perms})
        with HostPoolBackend(hostsim.sphere, num_workers=EMA_W) as pool:
            out[f"{name}_pool"] = gathered(ema_broker(pool, c))
    ema = CostEMA(alpha=EMA_ALPHA)
    out["ema_resize"] = gathered(resize_run(
        *RESIZES["four"], ctx, cost_fn=ema, backend=TimedSphere(4)))
    return out


def replay(inputs, ctx) -> dict:
    """One generation and one migration from the reference's draws."""
    cfg = GAConfig(**SIX)
    state = {k[6:]: v for k, v in inputs.items() if k.startswith("state_")}
    pop = island.constrain_pop(population_from_numpy(state, "cpu"), ctx)
    draws = [inputs[f"gen_{k}"] for k in range(int(inputs["n_gen"]))]
    src = ArrayUniforms(draws)
    gen = island.make_generation_step(cfg, Broker(rastrigin), "cpu", ctx=ctx)
    new, met = gen(pop, src)
    out = {"generation": population_to_numpy(island.gather_pop(new, ctx)),
           "best": ctx.gather(met["best"], cfg.num_islands, ctx.dp).numpy(),
           "left": src.remaining()}
    mig = ArrayUniforms([inputs[f"mig_{k}"]
                         for k in range(int(inputs["n_mig"]))])
    collectives.reset_counts()
    moved = island.migrate_ring(cfg, pop, mig, ctx)
    out["migration_calls"] = collectives.counts["data"]["calls"]
    out["migration"] = population_to_numpy(island.gather_pop(moved, ctx))
    return out


def four(inputs) -> dict:
    ctx = ShardingCtx(mesh=make_local_mesh(4, 1, device="cpu"),
                      dp=("data",), tp="model", fsdp=())
    out = {"six": run_engine(GAConfig(**SIX), rastrigin, ctx),
           "replay": replay(inputs, ctx)}

    # the data axes flattened over a (pod 2, data 2, model 1) mesh
    from torch.distributed.device_mesh import init_device_mesh
    pods = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    out["pods"] = run_engine(GAConfig(**SIX), rastrigin, ShardingCtx(
        mesh=pods, dp=("pod", "data"), tp="model"))

    # a checkpointed epoch, restored by a second engine for the next:
    # rank 0 writes, every rank reads
    where = Path(inputs["where"].item())

    def checkpointed():
        return GAEngine(GAConfig(**SIX), rastrigin, ctx=ctx, device="cpu",
                        checkpointer=Checkpointer(str(where / "ckpt")),
                        checkpoint_every=1)
    checkpointed().run(epochs=1)
    eng = checkpointed()
    pop, _ = eng.run(epochs=1)
    out["resumed"] = {"pop": population_to_numpy(pop),
                      "evals_host": eng.evals_host}

    # a (data 2, model 2) mesh over the same four ranks
    ctx22 = ShardingCtx(mesh=make_local_mesh(2, 2, device="cpu"),
                        dp=("data",), tp="model", fsdp=())
    genomes = torch.from_numpy(inputs["broker_genomes"])
    rows = ctx22.sizes(BROKER_N, ctx22.dp)
    first, end = ctx22.rows(BROKER_N, ctx22.dp)
    seen = []

    def fitness(x):
        seen.append(x.shape[0])
        return sphere(x)

    broker = Broker(fitness, broker_cost, num_workers=2, ctx=ctx22)
    fit, stats = broker.evaluate(genomes[first:end], rows=rows)
    out["broker"] = {"fitness": ctx22.gather(fit, rows, ctx22.dp).numpy(),
                     "stats": {k: v.item() for k, v in stats.items()},
                     "seen": gathered(seen)}

    out.update(four_elastic(ctx, ctx22))

    grid = make_synthetic_grid(**HVDC_GRID)
    genomes = torch.from_numpy(inputs["hvdc_genomes"])
    n = genomes.shape[0]
    first, end = ctx22.rows(n, ctx22.dp)
    for screen in HVDC_SCREENS:
        fit = HVDCDispatchFitness(grid, contingencies=HVDC_CASES,
                                  screen_top_k=screen, ctx=ctx22,
                                  device="cpu")
        res = hvdc_parts(fit, genomes, ctx22)
        broker = Broker(fit, fit.cost_model(), num_workers=2, ctx=ctx22)
        obj, _ = broker.evaluate(genomes[first:end],
                                 rows=ctx22.sizes(n, ctx22.dp))
        out[f"hvdc_{screen}"] = dict(
            res, dispatched=ctx22.gather(obj, n, ctx22.dp).numpy())
    return out


SCENARIOS = {"eight": eight, "four": four}


def main(argv) -> None:
    name, rank, world, where = argv[0], int(argv[1]), int(argv[2]), \
        Path(argv[3])
    torch.set_num_threads(1)
    init_distributed(rank, world, f"file://{where / 'store'}", device="cpu")
    try:
        path = where / "inputs.npz"
        inputs = dict(np.load(path)) if path.is_file() else {}
        out = SCENARIOS[name](inputs)
        if rank == 0:
            torch.save(out, where / f"{name}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
