"""Standard continuous benchmark functions.

All functions take genomes (N, G) and return (N, 1) (minimization, global
optimum 0 at the stated point), on the genomes' device. ``delay_proxy``
reproduces the paper §4.1 overhead study: a calibrated on-device compute
chain standing in for ``sleep(s)``, run by the delay chain kernel
(``kernels/delay``) on the card.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.kernels.delay.ops import delay_chain


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


def delay_proxy(base_fn: Callable | None = None, *,
                flop_iters: int = 0,
                iters_fn: Callable | None = None) -> Callable:
    """Wrap a fitness with a calibrated compute delay (the paper's sleep s).

    flop_iters: fixed per-individual step count, or ``iters_fn(genomes) ->
    (N,) int`` for *heterogeneous* evaluation times (exercises the
    broker's balanced dispatch). Each lane runs a data-dependent chain of
    ``a = a + sin(a) * 1e-6`` steps seeded from its genome, which no
    compiler can elide; on the card one thread of the delay chain kernel
    runs it in registers, where a loop of torch ops would cost several
    launches a step.
    """
    inner = base_fn or sphere

    def fn(genomes: torch.Tensor) -> torch.Tensor:
        out = inner(genomes)
        if flop_iters or iters_fn is not None:
            n = genomes.shape[0]
            iters = (iters_fn(genomes) if iters_fn is not None
                     else torch.full((n,), flop_iters, dtype=torch.int32,
                                     device=genomes.device))
            # seed the chain from the genomes so it must re-run per batch
            acc0 = 1.0 + torch.sum(genomes.to(torch.float32), -1) * 1e-6
            acc = delay_chain(acc0, iters.to(torch.int32).contiguous())
            # 1e-30 * acc underflows against out in float32 (no fitness
            # change) but keeps a true data dependency on the chain
            out = out + (acc[:, None] * 1e-30)
        return out

    return fn
