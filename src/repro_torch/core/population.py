"""Population state: (islands, pop, ...) tensors plus host-side counters.

Layout: genomes (I, P, G) float32 and fitness (I, P, O) float32 on the
device, islands on the leading axis as in the reference. Fitness is
minimized; +inf marks unevaluated slots.

``rng`` holds the state of the population's random stream as the
reference's key words: an (I, 2) uint32 numpy array on the host. Each epoch
seeds the engine's ``torch.Generator`` from it (:func:`rng_seed`) and
advances it (:func:`next_rng`), all on the host, so the stream never costs
a device sync and a checkpoint holds it in the reference's format.
``generation``, ``epoch`` and ``evals`` are Python integers: exact at any
count and readable without waiting for the device.

:func:`population_to_numpy` / :func:`population_from_numpy` carry state
between this package and the reference as numpy arrays with the
reference's field names, shapes and dtypes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import GAConfig


class Population(NamedTuple):
    genomes: torch.Tensor     # (I, P, G) float32
    fitness: torch.Tensor     # (I, P, O) float32 (minimize)
    rng: np.ndarray           # (I, 2) uint32 key words of the stream
    generation: int
    epoch: int
    evals: int                # fitness evaluations so far


def _key_words(rng) -> list:
    return [int(w) for w in np.asarray(rng, np.uint32).ravel()]


def rng_seed(rng) -> int:
    """The 64-bit torch seed that the key words ``rng`` stand for."""
    seq = np.random.SeedSequence(_key_words(rng))
    return int(seq.generate_state(1, np.uint64)[0])


def next_rng(rng) -> np.ndarray:
    """The key words that follow ``rng`` (same shape, uint32)."""
    rng = np.asarray(rng, np.uint32)
    seq = np.random.SeedSequence(_key_words(rng), spawn_key=(1,))
    return seq.generate_state(rng.size, np.uint32).reshape(rng.shape)


def seed_rng(seed: int) -> np.ndarray:
    """The (2,) uint32 key words of seed ``seed``, as ``PRNGKey(seed)``
    holds them: [0, seed]."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_rng(rng, data: int) -> np.ndarray:
    """(2,) uint32 key words derived from ``rng`` and the integer ``data``
    (the counterpart of ``jax.random.fold_in``): distinct ``data`` give
    independent streams."""
    seq = np.random.SeedSequence(_key_words(rng) + [int(data)])
    return seq.generate_state(2, np.uint32)


def init_population(cfg: GAConfig, seed: int, device) -> Population:
    i, p, g = cfg.num_islands, cfg.pop_per_island, cfg.num_genes
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand((i, p, g), generator=gen, device=device,
                   dtype=torch.float32)
    if cfg.gene_lower is None and cfg.gene_upper is None:
        genomes = cfg.lower + (cfg.upper - cfg.lower) * u
    else:
        # per-gene bounds: the reference draws every gene in [lower,
        # upper] regardless, which starts its meta-GA outside Tab. 4's
        # bounds (pop_size in [-1, 1]); the port draws inside them
        lo, hi = (torch.as_tensor(b, device=device) for b in cfg.bounds())
        genomes = lo + (hi - lo) * u
    fitness = torch.full((i, p, cfg.num_objectives), torch.inf,
                         dtype=torch.float32, device=device)
    rng = np.random.SeedSequence(int(seed)).generate_state(
        2 * i, np.uint32).reshape(i, 2)
    return Population(genomes=genomes, fitness=fitness, rng=rng,
                      generation=0, epoch=0, evals=0)


def best_of(pop: Population):
    """(genome, fitness) of the global best (first objective); ties go to
    the first index, as ``jnp.argmin`` does."""
    flat_f = pop.fitness[..., 0].reshape(-1)
    idx = torch.argmin(flat_f)
    flat_g = pop.genomes.reshape(-1, pop.genomes.shape[-1])
    return flat_g[idx], pop.fitness.reshape(-1, pop.fitness.shape[-1])[idx]


def population_to_numpy(pop: Population) -> dict:
    """The reference's ``Population`` fields as numpy arrays."""
    return {"genomes": np.array(pop.genomes.detach().cpu()),
            "fitness": np.array(pop.fitness.detach().cpu()),
            "rng": np.asarray(pop.rng, np.uint32).copy(),
            "generation": np.asarray(pop.generation, np.int32),
            "epoch": np.asarray(pop.epoch, np.int32),
            "evals": np.asarray(pop.evals, np.int64)}


def population_from_numpy(state: dict, device) -> Population:
    """A Population from the reference's fields as numpy arrays (a JAX
    population through ``jax.device_get``, or a checkpoint of either
    package). ``evals`` may be int32, int64 or a legacy float32."""
    return Population(
        genomes=torch.tensor(np.asarray(state["genomes"], np.float32),
                             device=device),
        fitness=torch.tensor(np.asarray(state["fitness"], np.float32),
                             device=device),
        rng=np.asarray(state["rng"], np.uint32).copy(),
        generation=int(state["generation"]),
        epoch=int(state["epoch"]),
        evals=int(np.asarray(state["evals"]).astype(np.int64)))
