"""Pluggable fitness backends: ``(N, G) -> (N, O)`` batched evaluation on
the genomes' device."""
from repro_torch.fitness.benchmarks import (ackley, griewank, rastrigin,
                                            rosenbrock, sphere, get_benchmark)

__all__ = ["ackley", "griewank", "rastrigin", "rosenbrock", "sphere",
           "get_benchmark"]
