"""Pluggable fitness backends: ``(N, G) -> (N, O)`` batched evaluation on
the genomes' device, and ``hostsim``'s numpy simulators for the host pool.

Every torch module resolves lazily (PEP 562): importing this package
imports no torch, so a spawned host-pool worker that unpickles
``repro_torch.fitness.hostsim.rastrigin`` stays numpy-only, and
``HVDCDispatchFitness`` does not pull in the powerflow stack until asked.
"""
import importlib

_BENCHMARKS = "repro_torch.fitness.benchmarks"
_LAZY = {**{name: _BENCHMARKS for name in (
    "ackley", "griewank", "rastrigin", "rosenbrock", "sphere",
    "get_benchmark", "delay_proxy")},
    "HVDCDispatchFitness": "repro_torch.fitness.powerflow"}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
