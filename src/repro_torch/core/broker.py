"""The evaluation broker, SPMD half: the port of ``repro.core.broker``'s
balanced dispatch, inline backend and ``Broker.evaluate``.

The paper's RabbitMQ queue load-balances heterogeneous fitness evaluations
across a shared worker pool. Here the broker computes a *static balanced
assignment* from a per-individual cost model, executes it as one
permutation, evaluates, and routes results back with the inverse
permutation.

Dispatch is *total*: when ``N % num_workers != 0`` the broker pads the batch
up to the next multiple of W with sentinel-cost entries. Padded lanes
evaluate a duplicate of genome 0 and are masked out of the load statistics
and the result gather. Snake (boustrophedon) assignment of the costs sorted
descending keeps per-lane cost within one item per round of optimal LPT.

For uniform costs (``cost_fn=None``) or one lane, dispatch is the identity.

Not ported yet: ``CostEMA`` and the decoupled backends (host pool, batch
schedulers, message queue).
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol, Tuple, runtime_checkable

import torch


def padded_size(n: int, num_workers: int) -> int:
    """Smallest multiple of ``num_workers`` that is >= n."""
    return -(-n // num_workers) * num_workers


def balanced_permutation(cost: torch.Tensor, num_workers: int) -> torch.Tensor:
    """perm (Np,) int64 with Np = padded_size(N, W), s.t. taking items in
    ``perm`` order and splitting into W contiguous equal chunks balances
    per-chunk total cost. Entries ``perm[j] >= N`` are padding
    (sentinel-cost slots that fill the partial final snake row)."""
    n = cost.shape[0]
    w = num_workers
    n_pad = padded_size(n, w)
    if n_pad != n:
        # sentinel pads: -inf cost sorts last under descending order, so
        # padding lands in the cheapest slots of the last snake row
        cost = torch.cat([cost, torch.full((n_pad - n,), -torch.inf,
                                           dtype=cost.dtype,
                                           device=cost.device)])
    rows = n_pad // w
    order = torch.argsort(-cost, stable=True)               # descending
    i = torch.arange(n_pad, device=cost.device)
    row, col = i // w, i % w
    worker = torch.where(row % 2 == 0, col, w - 1 - col)   # snake
    dest = worker * rows + row
    return torch.zeros(n_pad, dtype=torch.int64,
                       device=cost.device).scatter_(0, dest, order)


def padded_take(x: torch.Tensor, perm: torch.Tensor, n: int) -> torch.Tensor:
    """Gather rows of ``x`` (first n are real) in ``perm`` order; padded
    entries (perm[j] >= n) read row 0 — their results are dropped by the
    masked :func:`inverse_permutation` on the way back."""
    return torch.index_select(x, 0, torch.where(perm < n, perm, 0))


def inverse_permutation(perm: torch.Tensor,
                        n: Optional[int] = None) -> torch.Tensor:
    """inv (n,) with inv[i] = slot of original item i in ``perm``.

    ``n`` is the number of real items (defaults to len(perm)); padded
    entries ``perm[j] >= n`` are dropped from the scatter, so gathering
    results with ``inv`` never reads a padded lane.
    """
    n_pad = perm.shape[0]
    n = n_pad if n is None else n
    # dropped entries all land in one spare slot past the end
    slot = torch.where(perm < n, perm, n)
    inv = torch.zeros(n + 1, dtype=torch.int64, device=perm.device)
    inv.scatter_(0, slot, torch.arange(n_pad, device=perm.device))
    return inv[:n]


@runtime_checkable
class DispatchBackend(Protocol):
    """Executes a (possibly shuffled/padded) genome batch: (N, G) -> (N, O)."""

    name: str

    def __call__(self, genomes: torch.Tensor) -> torch.Tensor: ...


class InlineBackend:
    """Inline evaluation: the fitness function runs on the genomes' device
    in the caller's stream, with no copies."""

    name = "inline"

    def __init__(self, fitness_fn: Callable):
        self.fitness_fn = fitness_fn

    def __call__(self, genomes: torch.Tensor) -> torch.Tensor:
        return self.fitness_fn(genomes)


class Broker:
    """Shared-pool evaluation dispatcher.

    fitness_fn: (N, G) -> (N, O); ignored if ``backend`` is given
    cost_fn:    (N, G) -> (N,) predicted evaluation cost, or None (uniform)
    num_workers: number of horizontal lanes
    backend:    DispatchBackend executing the shuffled batch
                (default: InlineBackend(fitness_fn))
    """

    def __init__(self, fitness_fn: Optional[Callable] = None,
                 cost_fn: Optional[Callable] = None,
                 num_workers: int = 1,
                 backend: Optional[DispatchBackend] = None):
        if backend is None:
            if fitness_fn is None:
                raise ValueError("need fitness_fn or backend")
            backend = InlineBackend(fitness_fn)
        self.backend = backend
        self.fitness_fn = fitness_fn or getattr(backend, "fitness_fn", None)
        self.cost_fn = cost_fn
        self.num_workers = max(1, num_workers)

    @staticmethod
    def _identity_stats(device) -> dict:
        one = torch.ones((), device=device)
        return {"skew": one, "naive_skew": one,
                "balanced": torch.zeros((), device=device),
                "padded": torch.zeros((), dtype=torch.int32, device=device)}

    def evaluate(self, genomes: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """genomes: (N, G) -> (fitness (N, O), dispatch stats).

        Total: cost-balanced dispatch applies for EVERY N/num_workers
        combination when a cost model is given; padding absorbs
        N % W != 0.
        """
        n = genomes.shape[0]
        w = self.num_workers
        if self.cost_fn is None or w <= 1:
            return self.backend(genomes), self._identity_stats(genomes.device)
        cost = self.cost_fn(genomes)
        perm = balanced_permutation(cost, w)                # (Np,)
        n_pad = perm.shape[0]
        real = perm < n                                     # pad mask
        shuffled = padded_take(genomes, perm, n)
        # predicted per-slot cost in shuffled order (pads carry zero)
        lane_cost = torch.where(real, padded_take(cost, perm, n), 0.0)
        fit_shuf = self.backend(shuffled)
        fit = torch.index_select(fit_shuf, 0, inverse_permutation(perm, n))
        # stats: per-worker predicted load skew (max/mean), before/after;
        # padded lanes contribute zero load
        loads = torch.sum(lane_cost.reshape(w, n_pad // w), dim=1)
        cost_pad = (cost if n_pad == n else
                    torch.cat([cost, torch.zeros(n_pad - n, dtype=cost.dtype,
                                                 device=cost.device)]))
        naive = torch.sum(cost_pad.reshape(w, n_pad // w), dim=1)
        stats = {
            "skew": torch.max(loads) / torch.clamp_min(torch.mean(loads),
                                                       1e-9),
            "naive_skew": torch.max(naive) / torch.clamp_min(
                torch.mean(naive), 1e-9),
            "balanced": torch.ones((), device=genomes.device),
            "padded": torch.full((), n_pad - n, dtype=torch.int32,
                                 device=genomes.device),
        }
        return fit, stats
