"""Standard continuous benchmark functions.

All functions take genomes (N, G) and return (N, 1) (minimization, global
optimum 0 at the stated point), on the genomes' device. The reference's
``delay_proxy`` (the paper's sleep-proxy load) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def sphere(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1, keepdim=True)


def rastrigin(x: torch.Tensor) -> torch.Tensor:
    return (10.0 * x.shape[-1]
            + torch.sum(x * x - 10.0 * torch.cos(2 * math.pi * x), dim=-1,
                        keepdim=True))


def rosenbrock(x: torch.Tensor) -> torch.Tensor:
    x0, x1 = x[..., :-1], x[..., 1:]
    return torch.sum(100.0 * (x1 - x0 ** 2) ** 2 + (1 - x0) ** 2, dim=-1,
                     keepdim=True)


def ackley(x: torch.Tensor) -> torch.Tensor:
    g = x.shape[-1]
    s1 = torch.sqrt(torch.sum(x * x, -1) / g)
    s2 = torch.sum(torch.cos(2 * math.pi * x), -1) / g
    return (-20.0 * torch.exp(-0.2 * s1) - torch.exp(s2)
            + 20.0 + math.e)[..., None]


def griewank(x: torch.Tensor) -> torch.Tensor:
    i = torch.sqrt(torch.arange(1, x.shape[-1] + 1, dtype=x.dtype,
                                device=x.device))
    return (torch.sum(x * x, -1) / 4000.0
            - torch.prod(torch.cos(x / i), -1) + 1.0)[..., None]


_BENCH = {"sphere": sphere, "rastrigin": rastrigin,
          "rosenbrock": rosenbrock, "ackley": ackley, "griewank": griewank}


def get_benchmark(name: str) -> Callable:
    return _BENCH[name]
