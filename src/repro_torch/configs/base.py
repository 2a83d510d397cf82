"""GA configuration: the port's own copy of ``repro.configs.base.GAConfig``.

Field names, defaults and derived values (``global_pop``, ``indpb``,
``bounds()``) are those of the reference, so one set of keyword arguments
builds the same configuration in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """NSGA-II island-model settings (paper Tab. 3 / §4)."""

    num_genes: int
    pop_per_island: int = 64        # P
    num_islands: int = 4            # I
    num_objectives: int = 1
    generations_per_epoch: int = 5  # M (migration period)
    num_epochs: int = 10            # N_E
    # variation operators (paper: polynomial mutation + SBX crossover)
    mutation_prob: float = 0.7      # mu_mut
    mutation_eta: float = 34.6      # eta_mut (distribution index)
    crossover_prob: float = 1.0     # mu_cx
    crossover_eta: float = 97.5     # eta_cx
    tournament_size: int = 2
    # migration
    migration_pattern: str = "ring"
    num_migrants: int = 1           # paper: best individual migrates
    # bounds (scalar, or per-gene tuples of length num_genes)
    lower: float = -1.0
    upper: float = 1.0
    gene_lower: Optional[Tuple[float, ...]] = None
    gene_upper: Optional[Tuple[float, ...]] = None
    # per-gene mutation probability inside a mutating individual (DEAP
    # indpb); 0.0 -> 1/num_genes
    mutation_indpb: float = 0.0
    # engine
    seed: int = 0
    elitism: bool = True            # NSGA-II (mu+lambda) survivor selection
    fused_operators: bool = True    # use the fused variation CUDA kernel

    @property
    def global_pop(self) -> int:
        return self.pop_per_island * self.num_islands

    @property
    def indpb(self) -> float:
        return self.mutation_indpb or 1.0 / self.num_genes

    def bounds(self):
        """(lower, upper) as (G,) float32 numpy arrays."""
        lo = (np.asarray(self.gene_lower, np.float32)
              if self.gene_lower is not None
              else np.full((self.num_genes,), self.lower, np.float32))
        hi = (np.asarray(self.gene_upper, np.float32)
              if self.gene_upper is not None
              else np.full((self.num_genes,), self.upper, np.float32))
        return lo, hi
