"""Elastic scaling: repartition a running GA population onto a resized
worker fleet (the paper's "dynamically adjust worker counts ... without
redeployment", §1).

Shrink (I -> I' < I): islands are merged in contiguous groups and each
merged pool goes through NSGA-II survivor selection, so no elite is lost.

Grow (I -> I' > I): existing islands are cloned round-robin and the clones
are re-seeded with mutation-perturbed copies (every new island inherits a
full survivor set, then diversifies), preserving the best individual
globally. Clones read +inf fitness until they are evaluated again.

Lane re-balance: repartitioning only reshapes the population; the
broker's dispatch lane count is engine state. ``GAEngine.resize`` wraps
this function and also recomputes ``num_workers`` and rebuilds the broker
and the epoch step for the new island count. On a mesh every rank calls it
on the global population with the same ``rng`` and keeps its block.

Streams: ``rng`` is a stream's key words (``core/population.py``). The
clones' mutation draws come from a ``torch.Generator`` seeded from it,
and island k's new stream is ``fold_rng(rng, k)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import GAConfig
from repro_torch.core import nsga2, operators
from repro_torch.core.population import Population, fold_rng, rng_seed
from repro_torch.core.uniforms import GeneratorUniforms


def repartition_islands(cfg: GAConfig, pop: Population, new_islands: int,
                        rng) -> Population:
    i, p, g = pop.genomes.shape
    if new_islands == i:
        return pop

    if new_islands < i:
        if i % new_islands:
            raise ValueError(f"cannot merge {i} islands into {new_islands}")
        grp = i // new_islands
        new_g, new_f = nsga2.survivor_select(
            pop.genomes.reshape(new_islands, grp * p, g),
            pop.fitness.reshape(new_islands, grp * p, -1), p)
    else:
        if new_islands % i:
            raise ValueError(f"cannot clone {i} islands into {new_islands}")
        rep = new_islands // i
        new_g = torch.repeat_interleave(pop.genomes, rep, dim=0)
        new_f = torch.repeat_interleave(pop.fitness, rep, dim=0)
        # diversify clones (every island beyond the first copy of each
        # source): polynomial mutation, fitness reset to +inf (re-eval)
        dev = pop.genomes.device
        lo, hi = (torch.as_tensor(b, device=dev) for b in cfg.bounds())
        gen = torch.Generator(device=dev)
        gen.manual_seed(rng_seed(rng))
        mutated = operators.polynomial_mutation(
            GeneratorUniforms(gen, dev), new_g, eta=cfg.mutation_eta,
            prob=1.0, indpb=cfg.indpb, lower=lo, upper=hi)
        is_clone = (torch.arange(new_islands, device=dev) % rep != 0
                    )[:, None, None]
        new_g = torch.where(is_clone, mutated, new_g)
        new_f = torch.where(is_clone, torch.inf, new_f)

    island_rngs = np.stack([fold_rng(rng, k) for k in range(new_islands)])
    return Population(genomes=new_g, fitness=new_f, rng=island_rngs,
                      generation=pop.generation, epoch=pop.epoch,
                      evals=pop.evals)
