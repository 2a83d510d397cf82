"""Pluggable fitness backends: ``(N, G) -> (N, O)`` batched evaluation on
the genomes' device.

``HVDCDispatchFitness`` resolves lazily (PEP 562): importing this package
does not import the powerflow stack.
"""
import importlib

from repro_torch.fitness.benchmarks import (ackley, griewank, rastrigin,
                                            rosenbrock, sphere, get_benchmark)

_LAZY = {"HVDCDispatchFitness": "repro_torch.fitness.powerflow"}

__all__ = ["ackley", "griewank", "rastrigin", "rosenbrock", "sphere",
           "get_benchmark", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
