"""Hierarchical meta-GA (paper §4.2.2, Tab. 4).

A governing GA evolves hyperparameter vectors; each meta-individual's
fitness is the best solution found by an *inner* GA configured with those
hyperparameters, min'd over ``num_seeds`` seeds ("the overall best found
solution is returned as fitness").

The inner runs are one batch: the N meta-individuals x S seeds are
R = N x S runs on leading (N, S) axes, where the reference ``vmap``s
``inner_run`` over them. Each run has its own hyperparameters, so one inner
generation for all R runs is one (N, S, p_max, G) variation: on the card,
one launch of the fused variation kernel with one hyperparameter row per
run; on the CPU, its plain version.

Variable population size is genome-encoded: the inner GA runs at a static
``p_max`` with the first ``round(P)`` slots active (masked selection and
masked fitness), as in the reference.

Common random numbers: every meta-individual runs seed s on the same draws,
taken from seed s's own ``torch.Generator`` (seeded from ``base_seed`` and
s, never from the outer GA's stream) and shared across the individuals
(``SeedUniforms``: one draw per seed, N times fewer random numbers). So
equal genomes get equal fitness, and a genome evaluated twice gets the
same value. The fused kernel reads run (n, s)'s uniforms from seed s's row
in place; nothing is expanded to (N, S, ...).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GAConfig
from repro_torch.core import operators
from repro_torch.core.island import take_rows
from repro_torch.core.population import rng_seed
from repro_torch.core.uniforms import SeedUniforms, as_source

# (name, low, high) — paper Tab. 4
META_GENE_SPEC = (
    ("pop_size", 12.0, 500.0),
    ("cx_prob", 0.0, 1.0),
    ("mut_prob", 0.0, 1.0),
    ("eta_mut", 0.01, 100.0),
    ("eta_cx", 0.01, 100.0),
)


def meta_bounds() -> Tuple[tuple, tuple]:
    lo = tuple(s[1] for s in META_GENE_SPEC)
    hi = tuple(s[2] for s in META_GENE_SPEC)
    return lo, hi


def decode_meta_genome(g: torch.Tensor) -> dict:
    """g: (..., 5) raw gene values -> hyperparameter dict of (...) tensors
    (views, no copy)."""
    return {"pop_size": g[..., 0], "cx_prob": g[..., 1],
            "mut_prob": g[..., 2], "eta_mut": g[..., 3],
            "eta_cx": g[..., 4]}


def active_size(pop_size: torch.Tensor, p_max: int) -> torch.Tensor:
    """The active population ``clip(round(pop_size), 2, p_max)``, float32;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(pop_size.to(torch.float32)), 2, p_max)


def make_inner_ga(inner_cfg: GAConfig, fitness_fn: Callable, *,
                  p_max: int, generations: int) -> Callable:
    """Returns ``inner_run(hyper_genomes (..., 5), rng) -> best (...)``.

    Each run is a single island at static width ``p_max`` with a masked
    active population; ``fitness_fn``: (N, G) -> (N,) or (N, 1). The runs'
    leading dims L are ``hyper_genomes.shape[:-1]``; ``rng`` is a uniform
    source or a ``torch.Generator`` whose draws have the leading dims L, or
    broadcast to them (``SeedUniforms``). Per generation: a tournament on
    the fitness over [0, p_act), the variation (the fused kernel for even
    ``p_max``), the whole width evaluated and masked, survivors by a stable
    argsort of the 2 p_max pool; the best is the minimum.
    """
    lo_np, hi_np = inner_cfg.bounds()
    g = inner_cfg.num_genes
    indpb = inner_cfg.indpb

    def eval_fit(genomes: torch.Tensor) -> torch.Tensor:
        f = fitness_fn(genomes.reshape(-1, g))
        f = f[..., 0] if f.dim() > 1 else f
        return f.reshape(genomes.shape[:-1])

    def inner_run(hgenomes: torch.Tensor, rng) -> torch.Tensor:
        dev = hgenomes.device
        lead = tuple(hgenomes.shape[:-1])
        lo = torch.as_tensor(lo_np, device=dev)
        hi = torch.as_tensor(hi_np, device=dev)
        ipb = torch.tensor(indpb, dtype=torch.float32, device=dev)
        hp = decode_meta_genome(hgenomes.to(torch.float32))
        p_act = active_size(hp["pop_size"], p_max)           # L
        active = torch.arange(p_max, device=dev) < p_act[..., None]
        rand = as_source(rng, dev)

        u = rand(lead + (p_max, g))
        genomes = (lo + u * (hi - lo)).expand(lead + (p_max, g))
        fit = torch.where(active, eval_fit(genomes), torch.inf)
        for _ in range(generations):
            parents = take_rows(genomes, operators.tournament_select(
                rand, fit, p_max, active=p_act))
            off = operators.variation(
                rand, parents, eta_cx=hp["eta_cx"], prob_cx=hp["cx_prob"],
                eta_mut=hp["eta_mut"], prob_mut=hp["mut_prob"], indpb=ipb,
                lower=lo, upper=hi, use_kernel=True)
            off_fit = torch.where(active, eval_fit(off), torch.inf)
            cf = torch.cat([fit, off_fit], dim=-1)
            order = torch.argsort(cf, dim=-1, stable=True)[..., :p_max]
            genomes = take_rows(torch.cat([genomes, off], dim=-2), order)
            fit = torch.gather(cf, -1, order)
        return torch.amin(fit, dim=-1)

    return inner_run


def seed_generators(base_seed: int, num_seeds: int, device) -> list:
    """Seed s's ``torch.Generator`` for s < num_seeds, from ``base_seed``
    and s alone (the reference folds ``base_seed + s`` into
    ``PRNGKey(base_seed)``)."""
    gens = []
    for s in range(num_seeds):
        gen = torch.Generator(device=device)
        gen.manual_seed(rng_seed(np.array([base_seed, base_seed + s],
                                          np.uint32)))
        gens.append(gen)
    return gens


def make_meta_fitness(inner_cfg: GAConfig, fitness_fn: Callable, *,
                      p_max: int = 64, generations: int = 20,
                      num_seeds: int = 5, base_seed: int = 17) -> Callable:
    """Meta fitness: (N, 5) hyperparameter genomes -> (N, 1), the best of
    ``num_seeds`` inner runs each, all N x S runs in one batch."""
    inner_run = make_inner_ga(inner_cfg, fitness_fn, p_max=p_max,
                              generations=generations)

    def meta_fitness(hgenomes: torch.Tensor) -> torch.Tensor:
        dev = hgenomes.device
        runs = hgenomes.unsqueeze(1).expand(
            hgenomes.shape[0], num_seeds, hgenomes.shape[-1])
        rand = SeedUniforms(seed_generators(base_seed, num_seeds, dev), dev)
        bests = inner_run(runs, rand)                       # (N, S)
        return torch.amin(bests, dim=-1, keepdim=True)

    return meta_fitness


def meta_ga_config(num_epochs: int = 4, pop_per_island: int = 32,
                   num_islands: int = 3, seed: int = 0) -> GAConfig:
    """Paper Fig. 6 setup: I=3 islands, NSGA-II, genes of Tab. 4."""
    lo, hi = meta_bounds()
    return GAConfig(
        num_genes=len(META_GENE_SPEC),
        pop_per_island=pop_per_island,
        num_islands=num_islands,
        generations_per_epoch=2,
        num_epochs=num_epochs,
        gene_lower=lo, gene_upper=hi,
        mutation_prob=0.3, mutation_eta=20.0,
        crossover_prob=0.9, crossover_eta=15.0,
        fused_operators=False,
        seed=seed)
