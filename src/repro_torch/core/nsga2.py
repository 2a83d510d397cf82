"""NSGA-II in PyTorch: non-dominated sorting (front peeling) and crowding
distance [Deb et al. 2002], batched over any leading (island) axes.

Mirrors ``repro.core.nsga2`` exactly, integer keys included:

* the reference's ``lax.while_loop`` over at most N fronts is a Python loop
  that runs ``block`` iterations between host checks of "any rank still
  unassigned". Once every rank is assigned an extra iteration changes
  nothing (the front is empty), so the blocks give the reference's result
  with one host sync per block instead of one per front;
* ``lexsort`` is two stable sorts, and every ``argsort`` is stable, as
  ``jnp.argsort`` is;
* ``segment_max/min`` is ``scatter_reduce`` with ``amax``/``amin``.

With one objective every distinct fitness value is its own front, so the
peeling loop runs about N iterations, each a masked sum over the (N, N)
domination matrix, computed as a (1, N) x (N, N) float32 product per
island.
"""
from __future__ import annotations

from typing import Tuple

import torch

BIG = 1e30


def domination_matrix(fitness: torch.Tensor) -> torch.Tensor:
    """dom[..., i, j] = True iff i dominates j. fitness: (..., N, O),
    minimized."""
    fi = fitness.unsqueeze(-2)                              # (..., N, 1, O)
    fj = fitness.unsqueeze(-3)                              # (..., 1, N, O)
    leq = torch.all(fi <= fj, dim=-1)
    lt = torch.any(fi < fj, dim=-1)
    return leq & lt


def nondominated_ranks(fitness: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Front index per individual (0 = Pareto front). fitness: (..., N, O)
    -> (..., N) int64."""
    n = fitness.shape[-2]
    # 0/1 float32: every count below is an integer < 2^24, so exact, and
    # the per-front masked sum is one batched vector-matrix product
    dom = domination_matrix(fitness).to(torch.float32)
    ndom = dom.sum(dim=-2)                                  # dominators of j
    ranks = torch.full(fitness.shape[:-1], -1, dtype=torch.int64,
                       device=fitness.device)
    it = 0
    while it < n:
        for _ in range(min(block, n - it)):
            front = (ranks < 0) & (ndom == 0)
            ranks = torch.where(front, it, ranks)
            dec = torch.matmul(front.to(dom.dtype).unsqueeze(-2),
                               dom).squeeze(-2)
            ndom = torch.where(front, -1.0, ndom - dec)
            it += 1
        if not bool(torch.any(ranks < 0)):                  # host check
            break
    # degenerate safety: anything never assigned goes to the last front
    return torch.where(ranks < 0, n - 1, ranks)


def crowding_distance(fitness: torch.Tensor,
                      ranks: torch.Tensor) -> torch.Tensor:
    """Crowding distance within each front. fitness: (..., N, O) ->
    (..., N) float32."""
    n, o = fitness.shape[-2:]
    lead = tuple(fitness.shape[:-2])
    dist = torch.zeros(lead + (n,), dtype=torch.float32, device=fitness.device)
    seg = ranks.unsqueeze(-1).expand(lead + (n, o))
    fmax = torch.full_like(fitness, -torch.inf).scatter_reduce(
        -2, seg, fitness, "amax", include_self=False)       # per front
    fmin = torch.full_like(fitness, torch.inf).scatter_reduce(
        -2, seg, fitness, "amin", include_self=False)
    # clamp_min keeps NaN (an all-+inf front's inf - inf), as jnp.maximum
    span = torch.clamp_min(torch.gather(fmax - fmin, -2, seg), 1e-12)

    no = torch.zeros(lead + (1,), dtype=torch.bool, device=fitness.device)
    for m in range(o):
        obj = fitness[..., m]
        # lexsort((obj, ranks)): stable by obj, then stable by rank
        by_obj = torch.argsort(obj, dim=-1, stable=True)
        order = torch.gather(by_obj, -1, torch.argsort(
            torch.gather(ranks, -1, by_obj), dim=-1, stable=True))
        s_obj = torch.gather(obj, -1, order)
        s_rank = torch.gather(ranks, -1, order)
        same = s_rank[..., 1:] == s_rank[..., :-1]
        prev_ok = torch.cat([no, same], dim=-1)
        next_ok = torch.cat([same, no], dim=-1)
        prev_v = torch.cat([s_obj[..., :1], s_obj[..., :-1]], dim=-1)
        next_v = torch.cat([s_obj[..., 1:], s_obj[..., -1:]], dim=-1)
        contrib = torch.where(prev_ok & next_ok, next_v - prev_v, BIG)
        add = torch.zeros_like(dist).scatter(
            -1, order, contrib / torch.gather(span[..., m], -1, order))
        dist = dist + add
    return dist


def nsga2_keys(fitness: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rank, crowding, selection key), each (..., N). Lower key = better.

    The key is an exact integer lexicographic composite: rank * N +
    crowding-order-rank, so the crowding tie-break survives float32
    precision at any front index.
    """
    n = fitness.shape[-2]
    ranks = nondominated_ranks(fitness)
    crowd = crowding_distance(fitness, ranks)
    crowd_rank = torch.argsort(torch.argsort(-crowd, dim=-1, stable=True),
                               dim=-1, stable=True)         # 0 = most spread
    return ranks, crowd, ranks * n + crowd_rank


def survivor_select(genomes: torch.Tensor, fitness: torch.Tensor,
                    mu: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu+lambda) NSGA-II survivor selection from a combined pool.

    genomes: (..., N, G), fitness: (..., N, O); returns the best ``mu`` by
    (rank, -crowd), best first.
    """
    _, _, key = nsga2_keys(fitness)
    order = torch.argsort(key, dim=-1, stable=True)[..., :mu].unsqueeze(-1)
    return (torch.gather(genomes, -2, order.expand(
                order.shape[:-1] + genomes.shape[-1:])),
            torch.gather(fitness, -2, order.expand(
                order.shape[:-1] + fitness.shape[-1:])))
