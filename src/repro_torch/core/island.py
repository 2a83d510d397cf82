"""Asynchronous island-model GA (paper §3, Fig. 2), batched over islands.

One ``epoch_step`` runs M generations of island-local evolution on the
(I, P, G) population — every operation is island-local along the leading
axis, the port's form of the reference's collective-free ``vmap`` — then a
single migration over the island axis (``torch.roll``).

Randomness: a generation draws, in the reference's per-island order, the
tournament uniforms and then the variation uniforms, each batched over
islands, from a uniform source; migration draws each shift's victim
uniforms. ``epoch_step`` seeds a ``torch.Generator`` from ``pop.rng``, runs
the epoch from it and advances ``pop.rng``.

``hyper`` overrides {eta_cx, prob_cx, eta_mut, prob_mut, pop_active} with
numbers or 0-d tensors (the reference's meta-GA path): tensors go to the
operators, and to the fused kernel's (5,) row, where they lie, with no
host sync; ``pop_active`` masks the selection keys past the active slots
to 2**30, draws the tournament from [0, pop_active) and masks the
offspring's fitness there to +inf.

The island axis is split over the ``dp`` axes of ``ctx`` (a
``models.sharding.ShardingCtx``; the default has no mesh and one block of
every island): rank r holds islands ``tensor_split(arange(I), dp)[r]``
(uneven blocks allowed, as GSPMD pads) and ``pop.rng`` stays global on
every rank, I = ``pop.rng.shape[0]``. Each draw is made for all I islands
and the rank keeps its rows (``uniforms.IslandRows``), so a sharded run
is bit-identical to one rank. Migration all-gathers the (I, m) emigrants,
one collective per shift on a mesh, and each rank takes its rows of the
rolled array. The per-generation ``best`` trace is gathered once an
epoch, so metrics are global.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import GAConfig
from repro_torch.core import nsga2, operators
from repro_torch.core.broker import Broker
from repro_torch.core.population import Population, next_rng, rng_seed
from repro_torch.core.uniforms import (GeneratorUniforms, IslandRows,
                                       as_source)
from repro_torch.models.sharding import ShardingCtx


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, D), idx (..., K) -> x[..., idx, :] (..., K, D)."""
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(
        idx.shape + x.shape[-1:]))


def island_block(pop: Population, ctx: ShardingCtx) -> tuple:
    """(lo, hi, sizes) of this rank's islands and every rank's island
    count over the ``dp`` axes."""
    total = pop.rng.shape[0]
    lo, hi = ctx.rows(total, ctx.dp)
    return lo, hi, ctx.sizes(total, ctx.dp)


def constrain_pop(pop: Population, ctx: ShardingCtx) -> Population:
    """This rank's islands of a population: a global one (as many islands
    as ``pop.rng`` has rows) is cut to the rank's block, a rank's own
    block is returned as it is."""
    if pop.genomes.shape[0] != pop.rng.shape[0]:
        return pop
    return pop._replace(genomes=ctx.cs(pop.genomes, ctx.dp_spec),
                        fitness=ctx.cs(pop.fitness, ctx.dp_spec))


def gather_pop(pop: Population, ctx: ShardingCtx) -> Population:
    """The global population from every rank's islands (each rank gets
    it)."""
    i = pop.rng.shape[0]
    return pop._replace(genomes=ctx.gather(pop.genomes, i, ctx.dp),
                        fitness=ctx.gather(pop.fitness, i, ctx.dp))


def make_generation_step(cfg: GAConfig, broker: Broker, device,
                         hyper: Optional[dict] = None,
                         ctx: ShardingCtx = ShardingCtx()) -> Callable:
    """One NSGA-II generation for all islands (no cross-island traffic):
    ``generation(pop, rng) -> (pop, metrics)``, with ``rng`` a uniform
    source or a ``torch.Generator``. ``hyper`` optionally overrides
    {eta_cx, prob_cx, eta_mut, prob_mut, pop_active} (meta-GA path).
    ``pop`` holds this rank's islands of ``ctx``, ``rng`` draws for all
    of them, and metrics["best"] is this rank's."""
    lo_np, hi_np = cfg.bounds()
    lo = torch.as_tensor(lo_np, device=device)
    hi = torch.as_tensor(hi_np, device=device)
    h = hyper or {}
    # hyperparameters live on the device once: no host->device copy per
    # generation; tensor overrides are used where they lie
    hp = {k: torch.as_tensor(h.get(k, v), dtype=torch.float32, device=device)
          for k, v in (("eta_cx", cfg.crossover_eta),
                       ("prob_cx", cfg.crossover_prob),
                       ("eta_mut", cfg.mutation_eta),
                       ("prob_mut", cfg.mutation_prob),
                       ("indpb", cfg.indpb))}
    pop_active = h.get("pop_active")
    slot = torch.arange(cfg.pop_per_island, device=device)

    def generation(pop: Population, rng) -> Tuple[Population, dict]:
        i, p, g = pop.genomes.shape
        first, end, sizes = island_block(pop, ctx)
        rand = IslandRows(as_source(rng, pop.genomes.device), first, end,
                          pop.rng.shape[0])

        # island-local selection keys (rank, crowding)
        _, _, keys = nsga2.nsga2_keys(pop.fitness)             # (I, P)
        if pop_active is not None:
            keys = torch.where(slot < pop_active, keys, 2 ** 30)
        parents_idx = operators.tournament_select(
            rand, keys.to(torch.float32), cfg.pop_per_island,
            active=pop_active, tsize=cfg.tournament_size)      # (I, P)
        parents = take_rows(pop.genomes, parents_idx)
        offspring = operators.variation(
            rand, parents, lower=lo, upper=hi,
            use_kernel=cfg.fused_operators, **hp)

        # shared-pool evaluation (the broker = the paper's queue)
        fit_flat, stats = broker.evaluate(offspring.reshape(i * p, g),
                                          rows=[s * p for s in sizes])
        off_fit = fit_flat.reshape(i, p, -1)
        if pop_active is not None:
            off_fit = torch.where((slot < pop_active)[:, None], off_fit,
                                  torch.inf)

        # (mu+lambda) island-local survivor selection
        new_g, new_f = nsga2.survivor_select(
            torch.cat([pop.genomes, offspring], dim=1),
            torch.cat([pop.fitness, off_fit], dim=1), p)

        newpop = pop._replace(genomes=new_g, fitness=new_f,
                              generation=pop.generation + 1,
                              evals=pop.evals + sum(sizes) * p)
        metrics = {"best": torch.amin(new_f[..., 0], dim=1),   # per island
                   "skew": stats["skew"],
                   "balanced": stats["balanced"]}
        return newpop, metrics

    return generation


def _migration_shifts(topology: str, num_islands: int) -> list:
    """Island-axis shifts per topology (generalized island model,
    Izzo et al. 2012 — cited by the paper). Each shift s means: island k
    sends its elites to island (k+s) mod I."""
    if topology == "ring":
        return [1]
    if topology == "bidirectional":
        return [1, -1]
    if topology == "torus":
        # 2D neighbors on a near-square factorization of I
        a = max(1, int(num_islands ** 0.5))
        while num_islands % a:
            a -= 1
        return [1, num_islands // a] if a > 1 else [1]
    if topology == "all":
        return list(range(1, num_islands))
    raise ValueError(topology)


def migrate_ring(cfg: GAConfig, pop: Population, rng,
                 ctx: ShardingCtx = ShardingCtx()) -> Population:
    """Migration: best ``m`` of island k replace random non-elite slots of
    each neighbor per the configured topology (paper §4 uses "ring":
    "sending out the best individual and replacing a randomly selected
    individual"). Draws (I, m) victim uniforms per shift from ``rng``.
    ``pop`` holds this rank's islands of ``ctx`` and each shift
    all-gathers the emigrants over the ``dp`` axes."""
    m = cfg.num_migrants
    i, p, g = pop.genomes.shape
    total = pop.rng.shape[0]
    first, end, _ = island_block(pop, ctx)
    rand = IslandRows(as_source(rng, pop.genomes.device), first, end, total)
    genomes, fitness = pop.genomes, pop.fitness
    for shift in _migration_shifts(cfg.migration_pattern, total):
        _, _, keys = nsga2.nsga2_keys(fitness)
        order = torch.argsort(keys, dim=1, stable=True)    # best first
        best_idx = order[:, :m]                            # (I, m)
        send = torch.cat([take_rows(genomes, best_idx),
                          take_rows(fitness, best_idx)], -1)
        recv = torch.roll(ctx.gather(send, total, ctx.dp), shift,
                          dims=0)[first:end]
        recv_g, recv_f = recv[..., :g], recv[..., g:]

        # random non-elite victims: positions >= m in sorted order
        u = rand((i, m))
        victim_rank = (m + torch.floor(u * float(p - m))).to(
            torch.int64).clamp_(max=p - 1)
        victim = torch.gather(order, 1, victim_rank).unsqueeze(-1)
        genomes = genomes.scatter(1, victim.expand(i, m, g), recv_g)
        fitness = fitness.scatter(1, victim.expand(i, m, fitness.shape[-1]),
                                  recv_f)
    return pop._replace(genomes=genomes, fitness=fitness, epoch=pop.epoch + 1)


def make_epoch_step(cfg: GAConfig, broker: Broker, device,
                    hyper: Optional[dict] = None,
                    ctx: ShardingCtx = ShardingCtx()) -> Callable:
    """M island-local generations + one migration:
    ``epoch_step(pop) -> (pop, metrics)`` with metrics["best"] (M, I),
    of all I islands on a mesh too."""
    generation = make_generation_step(cfg, broker, device, hyper, ctx)

    def epoch_step(pop: Population) -> Tuple[Population, dict]:
        gen = torch.Generator(device=device)
        gen.manual_seed(rng_seed(pop.rng))
        rand = GeneratorUniforms(gen, device)
        trace = []
        for _ in range(cfg.generations_per_epoch):
            pop, metrics = generation(pop, rand)
            trace.append(metrics)
        pop = migrate_ring(cfg, pop, rand, ctx)
        pop = pop._replace(rng=next_rng(pop.rng))
        metrics = {k: torch.stack([t[k] for t in trace]) for k in trace[0]}
        metrics["best"] = ctx.gather(metrics["best"], pop.rng.shape[0],
                                     ctx.dp, dim=1)
        return pop, metrics

    return epoch_step


def evaluate_population(cfg: GAConfig, broker: Broker, pop: Population,
                        ctx: ShardingCtx = ShardingCtx()) -> Population:
    """Initial fitness evaluation of a fresh population (this rank's
    islands of ``ctx``)."""
    i, p, g = pop.genomes.shape
    sizes = island_block(pop, ctx)[2]
    fit, _ = broker.evaluate(pop.genomes.reshape(i * p, g),
                             rows=[s * p for s in sizes])
    return pop._replace(fitness=fit.reshape(i, p, -1),
                        evals=pop.evals + sum(sizes) * p)
