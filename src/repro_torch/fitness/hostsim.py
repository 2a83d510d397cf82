"""Numpy-only host simulators (the decoupled "simulation container").

A copy of ``repro.fitness.hostsim`` for the port's host-pool backend
(``repro_torch.core.broker.HostPoolBackend``): ``ga_run --dispatch-backend
host-thread|host-process`` evaluates the named benchmarks with these, on
the host's cores. The module imports numpy, ``os`` and ``time`` only, and
``repro_torch.fitness`` resolves its torch modules lazily, so a spawned
worker that unpickles one of these functions imports no torch. Same
contract as ``repro_torch.fitness.benchmarks``: genomes ``(N, G)`` ->
fitness ``(N, 1)`` float32, minimized.

``delay_sphere`` adds a real per-individual ``sleep`` (the paper §4.1
overhead study's load model, possible here because host workers can
block), giving the broker's cost model something heterogeneous to
balance. ``always_fail`` exercises the retry path. ``worker_pid`` reports
the evaluating interpreter's PID as the fitness, so a test can see which
worker served each genome.
"""
from __future__ import annotations

import os
import time

import numpy as np


def sphere(genomes) -> np.ndarray:
    g = np.asarray(genomes, np.float32)
    return np.sum(g * g, axis=-1, keepdims=True).astype(np.float32)


def rastrigin(genomes) -> np.ndarray:
    g = np.asarray(genomes, np.float32)
    return (10.0 * g.shape[-1]
            + np.sum(g * g - 10.0 * np.cos(2 * np.pi * g), axis=-1,
                     keepdims=True)).astype(np.float32)


def rosenbrock(genomes) -> np.ndarray:
    g = np.asarray(genomes, np.float32)
    x0, x1 = g[..., :-1], g[..., 1:]
    return np.sum(100.0 * (x1 - x0 ** 2) ** 2 + (1 - x0) ** 2, axis=-1,
                  keepdims=True).astype(np.float32)


def ackley(genomes) -> np.ndarray:
    g = np.asarray(genomes, np.float32)
    d = g.shape[-1]
    s1 = np.sqrt(np.sum(g * g, -1) / d)
    s2 = np.sum(np.cos(2 * np.pi * g), -1) / d
    return (-20.0 * np.exp(-0.2 * s1) - np.exp(s2)
            + 20.0 + np.e)[..., None].astype(np.float32)


def griewank(genomes) -> np.ndarray:
    g = np.asarray(genomes, np.float32)
    i = np.sqrt(np.arange(1, g.shape[-1] + 1, dtype=g.dtype))
    return (np.sum(g * g, -1) / 4000.0
            - np.prod(np.cos(g / i), -1) + 1.0)[..., None].astype(np.float32)


def delay_sphere(genomes, *, slow_s: float = 0.004,
                 base_s: float = 0.0) -> np.ndarray:
    """Sphere with a real sleep per *slow* individual (``genomes[:, 0] >
    0``): heterogeneous evaluation cost for cost-model tests/benchmarks.
    The sleep is per chunk (sum over its slow members), exactly the
    makespan a balanced dispatch should spread across lanes. ``base_s``
    adds a per-individual floor regardless of class — with it, equal-count
    chunks pay for the cheap riders sharing a chunk with a slow genome,
    which is what cost-*sized* chunking removes."""
    g = np.asarray(genomes, np.float32)
    time.sleep(base_s * g.shape[0] + slow_s * float(np.sum(g[:, 0] > 0)))
    return sphere(g)


def always_fail(genomes) -> np.ndarray:
    raise RuntimeError("hostsim.always_fail: simulated simulator crash")


def worker_pid(genomes) -> np.ndarray:
    """Fitness = the evaluating process id (constant per interpreter;
    exact in float32 up to Linux's pid_max of 2^22). Not a real
    objective — a probe for worker-identity assertions."""
    g = np.asarray(genomes, np.float32)
    return np.full((g.shape[0], 1), float(os.getpid()), np.float32)
