"""Uniform sources: where every random draw of the port comes from.

JAX's threefry streams and torch's Philox streams never agree, so the port
draws every random number through a *uniform source*, a callable
``source(shape) -> float32 tensor`` of U[0, 1) values:

* :class:`GeneratorUniforms` draws from an explicit ``torch.Generator``
  (production);
* :class:`ArrayUniforms` hands out pre-drawn arrays in order (parity runs
  replay the reference's draws through it);
* :class:`SeedUniforms` draws one stream per seed, shared across a leading
  batch dim (the meta-GA's common random numbers: every individual runs
  seed s on the same draws);
* :class:`IslandRows` hands a rank of a mesh its islands' rows of draws
  made for every island, so a sharded run draws what an unsharded one
  does.

Operators take a source as their first argument, in the place of the
reference's ``rng`` key, and consume it in the reference's draw order.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable

import numpy as np
import torch


class GeneratorUniforms:
    """U[0, 1) float32 draws from one ``torch.Generator`` on ``device``."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = torch.device(device)

    def __call__(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)


class ArrayUniforms:
    """Pre-drawn uniforms, handed out in order; each request must match the
    next array's shape exactly (a replay out of step raises)."""

    def __init__(self, arrays: Iterable, device="cpu"):
        self.device = torch.device(device)
        self._queue = deque(np.array(a, np.float32) for a in arrays)

    def __call__(self, shape) -> torch.Tensor:
        if not self._queue:
            raise IndexError(f"no pre-drawn uniforms left for {tuple(shape)}")
        a = self._queue.popleft()
        if a.shape != tuple(shape):
            raise ValueError(f"pre-drawn uniforms have shape {a.shape}, "
                             f"the draw asked for {tuple(shape)}")
        return torch.from_numpy(a).to(self.device)

    def remaining(self) -> int:
        return len(self._queue)


class SeedUniforms:
    """One stream per seed, each from its own ``torch.Generator``, shared
    across a leading batch dim: a draw of shape (N, S, *rest) returns
    (S, *rest), row s drawn from seed s's generator as ``GeneratorUniforms``
    would draw it, which broadcasts against the requested shape. Seed s's
    draws do not depend on N."""

    def __init__(self, generators, device):
        self.generators = list(generators)
        self.device = torch.device(device)

    def __call__(self, shape) -> torch.Tensor:
        shape = tuple(shape)
        if len(shape) < 2 or shape[1] != len(self.generators):
            raise ValueError(f"a draw of shape {shape} has no axis of "
                             f"{len(self.generators)} seeds after the "
                             f"batch dim")
        return torch.stack([
            torch.rand(shape[2:], generator=gen, device=self.device,
                       dtype=torch.float32) for gen in self.generators])


class IslandRows:
    """Rows [lo, hi) of draws made for all ``total`` islands: a request of
    shape (hi - lo, *rest) draws (total, *rest) from ``source`` and keeps
    this rank's rows, bit for bit the rows an unsharded run draws."""

    def __init__(self, source: Callable, lo: int, hi: int, total: int):
        self.source, self.lo, self.hi, self.total = source, lo, hi, total

    def __call__(self, shape) -> torch.Tensor:
        shape = tuple(shape)
        if not shape or shape[0] != self.hi - self.lo:
            raise ValueError(f"a draw of shape {shape} does not lead with "
                             f"this rank's {self.hi - self.lo} islands")
        return self.source((self.total,) + shape[1:])[self.lo:self.hi]


_GOLDEN, _MIX1, _MIX2 = (-7046029254386353131, -4658895280553007687,
                         -7723592293110705685)
_OFFSET = 0x632BE59BD9B4E019


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 ``z``."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def fold_in(seed, data):
    """A new 64-bit seed from ``seed`` and ``data`` (splitmix64 of their
    combination, in int64 arithmetic that wraps): the port's
    ``jax.random.fold_in`` for generator seeds. ``seed`` and ``data`` are
    ints or integer tensors (a 0-d int64 tensor comes back on ``seed``'s
    device, with no host sync); ints give an int."""
    if not torch.is_tensor(seed):
        seed = (seed + (1 << 63)) % (1 << 64) - (1 << 63)   # as int64
        return int(fold_in(torch.tensor(seed, dtype=torch.int64), data))
    z = seed.to(torch.int64) * _GOLDEN + _OFFSET + torch.as_tensor(
        data, device=seed.device).to(torch.int64)
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def as_source(rng, device=None) -> Callable:
    """A uniform source from a source (returned as is) or a
    ``torch.Generator`` (drawing on ``device``, default the generator's)."""
    if isinstance(rng, torch.Generator):
        return GeneratorUniforms(rng, device if device is not None
                                 else rng.device)
    if callable(rng):
        return rng
    raise TypeError(f"not a uniform source or torch.Generator: {rng!r}")
