"""N-1 contingency analysis (paper §4.2.1), batched over genomes x cases.

``contingency_loadings``: for a set of line outages per genome, re-solve
the AC powerflow per case and return per-case per-line loadings. Genomes x
cases are flattened into one system batch, which ``newton_powerflow``
evaluates in memory-sized chunks: the vertical scaling axis (the case
batch) and the horizontal one (the genomes) run as one batch on the card.

On a mesh (``ctx``) the case axis goes over its ``tp`` axis: rank t solves
its block of each genome's case positions (``tensor_split`` of the C
positions; with screening every genome has its own list, so positions,
not outage lines, are split), and the ranks all-gather the (B, C_t, L)
blocks into the whole loadings: the paper's vertical scaling, one fitness
evaluation computed by ``model``-many ranks.

The paper runs all 2004 cases with full AC per fitness evaluation; DC/LODF
screening (``dc.py``) is the option that prunes the case list to the
critical subset first.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.sharding import ShardingCtx
from repro_torch.powerflow.newton import line_flows, newton_powerflow


def select_contingency_lines(grid, num_cases: int, seed: int = 0):
    """Pick outage candidates: ``num_cases`` distinct lines drawn at random
    from the seed, sorted (the reference's picks)."""
    rng = np.random.default_rng(seed)
    nl = grid.n_line
    num_cases = min(num_cases, nl)
    return np.sort(rng.choice(nl, size=num_cases, replace=False))


def contingency_loadings(gridt: dict, outage_lines: torch.Tensor, *,
                         p_extra: Optional[torch.Tensor] = None,
                         num_iters: int = 10,
                         ctx: ShardingCtx = ShardingCtx()) -> torch.Tensor:
    """Outage line indices -> loadings (B, C, L) = flow / rate.

    outage_lines: (C,) shared by every genome, or (B, C) per genome.
    p_extra: optional (B, n) HVDC injections per genome. B comes from
    p_extra, else from a 2-D ``outage_lines``, else is 1. Each case is a
    full Newton re-solve (the paper's method); a case that does not
    converge (an islanding outage) reads 10.0 on every line. This rank
    solves its block of the case positions over the ``tp`` axis of ``ctx``
    (all of them without a mesh) and the blocks are gathered.
    """
    if p_extra is not None:
        b = p_extra.shape[0]
    else:
        b = outage_lines.shape[0] if outage_lines.dim() == 2 else 1
    total = outage_lines.shape[-1]
    lo, hi = ctx.rows(total, ctx.tp)
    cases = outage_lines.long().expand(b, total)[:, lo:hi]
    nl = gridt["rate"].shape[0]
    c = hi - lo
    if c == 0:
        return ctx.gather(gridt["rate"].new_zeros((b, 0, nl)), total,
                          ctx.tp, dim=1)
    mask = torch.ones((b * c, nl), dtype=torch.float32,
                      device=cases.device)
    mask[torch.arange(b * c, device=mask.device), cases.reshape(-1)] = 0.0
    extra = (None if p_extra is None
             else p_extra.repeat_interleave(c, dim=0))
    res = newton_powerflow(gridt, p_extra=extra, num_iters=num_iters,
                           line_mask=mask)
    fl = line_flows(gridt, res.vm, res.va, line_mask=mask)
    # non-converged cases are treated as fully overloaded (drives the GA
    # away from islanding dispatches)
    loadings = torch.where(res.converged[:, None], fl / gridt["rate"], 10.0)
    return ctx.gather(loadings.reshape(b, c, nl), total, ctx.tp, dim=1)


def penalized_objective(base_obj: torch.Tensor,
                        loadings: torch.Tensor) -> torch.Tensor:
    """Paper's penalty: +10% per critical case (any line > 100%), +1% per
    near-critical case (any line in [95%, 100%)), multiplicative.
    base_obj (B,), loadings (B, C, L) -> (B,)."""
    over = torch.any(loadings > 1.0, dim=-1)                  # (B, C)
    near = torch.any(loadings >= 0.95, dim=-1) & ~over
    factor = 1.0 + 0.10 * torch.sum(over.to(torch.float32), -1) \
                 + 0.01 * torch.sum(near.to(torch.float32), -1)
    return base_obj * factor
