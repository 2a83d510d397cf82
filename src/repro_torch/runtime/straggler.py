"""Straggler mitigation: speculative backup evaluation.

The paper's shared queue absorbs stragglers dynamically (an idle worker
just pulls the next message). The broker's cost-balanced dispatch bounds
*predicted* skew; for UNMODELED stragglers (a worker whose actual cost
exceeds the prediction) this duplicates the top ``backup_frac`` most
expensive individuals into extra lanes ("backup workers": MapReduce's
speculative execution). Both copies compute; results are combined with an
elementwise ``min`` (identical values for a deterministic fitness; on
real racing hardware, whichever finishes first).

The cost: ``backup_frac`` extra evaluations. This is the *planned*
mitigation: every duplicate is decided before dispatch. The decoupled
backends get the *reactive* counterpart instead: per-chunk timeout and
re-queue through ``repro_torch.core.broker.run_chunks_retry``.
``fitness_fn`` may be any ``DispatchBackend``: the duplicate batch is a
plain (N', G) evaluation.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.broker import (balanced_permutation,
                                     inverse_permutation, padded_take)


def backup_dispatch_eval(fitness_fn: Callable, genomes: torch.Tensor,
                         cost: torch.Tensor, num_workers: int,
                         backup_frac: float = 0.125
                         ) -> Tuple[torch.Tensor, dict]:
    """Evaluate with balanced dispatch + speculative duplicates.

    genomes: (N, G); cost: (N,). Dispatch is total: the broker's padded
    balanced permutation absorbs N % num_workers != 0, and the backup
    count stays a multiple of num_workers (cycling the top items when
    N < num_workers) so the full batch splits evenly over the lanes.
    """
    n = genomes.shape[0]
    w = num_workers
    nb = max(w, int(round(n * backup_frac / w)) * w)

    # primary balanced dispatch (padded when n % w != 0; padded lanes
    # re-evaluate genome 0 and are dropped by the masked inverse)
    perm = balanced_permutation(cost, w)
    n_pad = perm.shape[0]
    primary = padded_take(genomes, perm, n)

    # duplicates of the nb most expensive individuals, cycled to nb
    top = torch.argsort(-cost, stable=True)[:min(nb, n)]
    backup_idx = top.repeat(-(-nb // top.shape[0]))[:nb]
    backups = torch.index_select(genomes, 0, backup_idx)

    fit = fitness_fn(torch.cat([primary, backups], dim=0))
    fit_primary = torch.index_select(fit[:n_pad], 0,
                                     inverse_permutation(perm, n))
    fit_backup = fit[n_pad:]

    # combine: min (first finisher) over duplicates; scatter_reduce
    # handles the repeated indices of the cycled backup fill
    idx = backup_idx.reshape((nb,) + (1,) * (fit.dim() - 1)).expand(
        fit_backup.shape)
    combined = fit_primary.scatter_reduce(0, idx, fit_backup, "amin")
    stats = {"duplicated": nb, "extra_frac": nb / n}
    return combined, stats
