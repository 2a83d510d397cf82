"""Shared plumbing for decoupled (host-side) dispatch backends: the port of
``repro.core.hostbridge``.

``broker.HostPoolBackend``, ``runtime.batchq.SlurmArrayBackend`` and
``runtime.mq.QueueBackend`` (with its socket twin) bridge out of the device program through a
host-side ``_host_eval(genomes, perm=None, cost=None)`` that chunks the
batch (equally, or by the predicted per-slot ``cost`` when the dispatching
broker supplies one — sentinel pad slots arrive marked ``-inf``), executes
it somewhere, measures per-chunk wall times, and reports them to an
optional ``CostEMA``. This module holds that common surface once.

Import discipline: NO torch at module scope. A spawned process-pool
worker unpickles :func:`_timed_eval` from here and a fitness from
``repro_torch.fitness.hostsim``, and the queue workers
(``runtime.batchq``, ``runtime.mq``) import this module at startup; all
stay numpy-only. torch is imported inside the bridged calls, which only
ever run on the submitting host.

Multi-tenancy: every run owns its own ``CostEMA``, and the message-queue
backend carries the run id in its task names, so measured durations are
never attributed across runs that share one fleet.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.runtime import metrics as _metrics


class PureCallbackBridge:
    """Mixin: DispatchBackend surface over a host-side ``_host_eval``.

    Subclasses provide ``num_objectives``, ``close()``, and
    ``_host_eval(genomes, perm=None, cost=None) -> (N, O) float32``.
    The cost-dispatching broker calls ``eval_with_perm`` with all three
    operands, so ``_host_eval`` MUST accept ``cost`` (the predicted
    per-slot cost in shuffled order, sentinel pads marked ``-inf``) even if
    it ignores it, as ``HostPoolBackend`` does.

    The name is the reference's (``jax.pure_callback``). In eager PyTorch
    the bridge copies the genomes (and ``perm``, ``cost``) to the host,
    waits for the host evaluation and returns its float32 ``(N, O)``
    result as a tensor on the genomes' device.
    """

    def _bridge(self, genomes, *host_args):
        import torch
        out = self._host_eval(genomes.detach().cpu().numpy(),
                              *(a.detach().cpu().numpy() for a in host_args))
        return torch.from_numpy(out).to(genomes.device)

    def __call__(self, genomes):
        return self._bridge(genomes)

    def eval_with_perm(self, genomes, perm, cost=None):
        """Evaluate the shuffled batch with full dispatch context: ``perm``
        keys measured wall times back into ``cost_ema``; ``cost`` (the
        predicted per-slot cost in shuffled order, sentinel pads marked
        ``-inf`` so backends can skip them) lets a backend size its chunks
        by predicted cost instead of splitting equally."""
        if cost is None:
            return self._bridge(genomes, perm)
        return self._bridge(genomes, perm, cost)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False


def _timed_eval(fn: Callable, chunk: np.ndarray):
    """Evaluate one chunk, returning (fitness, wall_seconds). Module-level
    in this numpy-only module, so a process pool pickles it by reference
    alongside a picklable ``fn`` and its workers import no torch."""
    t0 = time.perf_counter()
    out = np.asarray(fn(chunk), np.float32).reshape(len(chunk), -1)
    return out, time.perf_counter() - t0


def cost_sized_chunk_sizes(cost, num_chunks: int, *,
                           min_chunk_cost: float = 0.0) -> List[int]:
    """Contiguous chunk sizes balancing *predicted cost*, not item count.

    Splits ``len(cost)`` items into ``min(num_chunks, n)`` contiguous
    chunks whose predicted total costs are as equal as integer boundaries
    allow. Boundaries are the real-valued crossings of the remaining-cost
    average (re-targeted after each chunk, so an oversized head item
    doesn't skew every later boundary), rounded half toward the pricier
    side.

    ``min_chunk_cost`` folds sub-floor chunks: a chunk whose predicted cost
    is below the floor is merged into its cheaper adjacent neighbor
    (cheapest sub-floor chunk first) until every remaining chunk clears
    the floor or only one chunk is left. Folding may return FEWER than
    ``num_chunks`` sizes; callers treat the returned length as the
    effective worker count. An all-zero cost vector degrades to the equal
    split without folding.

    Invariants: sizes sum to ``n``, every size >= 1, each unfolded chunk's
    predicted cost <= total/num_chunks + max(cost), and for distinct costs
    sorted descending the first (priciest) chunk is never larger than the
    last (cheapest). Non-finite or negative costs are treated as zero.
    """
    cost = np.asarray(cost, np.float64).ravel()
    n = int(cost.size)
    w = int(min(num_chunks, n))
    if w <= 0:
        return []
    if w == 1:
        return [n]
    c = np.where(np.isfinite(cost), cost, 0.0)
    c = np.clip(c, 0.0, None)
    cum = np.cumsum(c)
    total = float(cum[-1])
    if total <= 0.0:
        return [a.size for a in np.array_split(np.arange(n), w)]
    sizes: List[int] = []
    start = 0
    for k in range(w, 1, -1):                    # k chunks still to emit
        done = float(cum[start - 1]) if start else 0.0
        remaining = total - done
        if remaining <= 0.0:                     # zero-cost tail: equal
            for a in np.array_split(np.arange(n - start), k):
                sizes.append(a.size)
            return _fold_small_chunks(sizes, c, min_chunk_cost)
        target = done + remaining / k
        j = int(np.searchsorted(cum, target, side="left"))
        j = min(max(j, start), n - 1)
        before = float(cum[j - 1]) if j else 0.0
        frac = (target - before) / c[j] if c[j] > 0 else 1.0
        x = j + min(max(frac, 0.0), 1.0)         # real-valued boundary
        b = int(np.ceil(x - 0.5))                # round half toward the
        b = min(max(b, start + 1), n - (k - 1))  # pricier (earlier) side
        sizes.append(b - start)
        start = b
    sizes.append(n - start)
    return _fold_small_chunks(sizes, c, min_chunk_cost)


def _fold_small_chunks(sizes: List[int], c: np.ndarray,
                       min_chunk_cost: float) -> List[int]:
    """Merge chunks whose predicted cost is below ``min_chunk_cost`` into
    their cheaper adjacent neighbor (chunks are contiguous, so only
    neighbors preserve contiguity). Sum of sizes and the >=1 floor are
    preserved; merging only ever grows a chunk."""
    if min_chunk_cost <= 0.0 or len(sizes) <= 1:
        return sizes
    sizes = list(sizes)
    bounds = np.cumsum(sizes)
    costs = [float(s) for s in np.add.reduceat(
        c, np.concatenate([[0], bounds[:-1]]))]
    while len(sizes) > 1:
        below = [i for i, ck in enumerate(costs) if ck < min_chunk_cost]
        if not below:
            break
        i = min(below, key=lambda k: costs[k])   # cheapest sub-floor first
        if i == 0:
            j = 1
        elif i == len(sizes) - 1:
            j = i - 1
        else:
            j = i - 1 if costs[i - 1] <= costs[i + 1] else i + 1
        sizes[j] += sizes[i]
        costs[j] += costs[i]
        del sizes[i], costs[i]
    return sizes


def plan_cost_chunks(genomes: np.ndarray, perm: Optional[np.ndarray],
                     cost: np.ndarray, num_chunks: int, *,
                     min_chunk_cost: float = 0.0):
    """Cost-sized chunk planner for the decoupled dispatch backends.

    Drops sentinel pad slots (cost == -inf: they duplicate genome 0 at its
    true price and their results are discarded by the broker's masked
    inverse), re-orders the real rows pricier-first (stable, so the result
    scatter is deterministic), and cuts at predicted-cost quantiles with
    ``min_chunk_cost`` folding.

    Returns ``(chunks, sizes, order, perm)``: the genome chunks, their
    sizes, the pricier-first row order (scatter results back with it; pad
    rows get zeros), and ``perm`` re-ordered to match (keeps a ``CostEMA``
    keyed to the original slots).
    """
    cost = np.asarray(cost, np.float64).ravel()
    real_idx = np.nonzero(~np.isneginf(cost))[0]
    order = real_idx[np.argsort(-cost[real_idx], kind="stable")]
    genomes = np.asarray(genomes)[order]
    if perm is not None:
        perm = np.asarray(perm)[order]
    w = int(min(num_chunks, max(1, order.size)))
    sizes = cost_sized_chunk_sizes(cost[order], w,
                                   min_chunk_cost=min_chunk_cost)
    chunks = np.split(genomes, np.cumsum(sizes)[:-1])
    return chunks, sizes, order, perm


def scatter_chunk_results(out: np.ndarray, order: np.ndarray,
                          n: int) -> np.ndarray:
    """Inverse of :func:`plan_cost_chunks`' pricier-first re-order:
    scatter the concatenated chunk results back to the shuffled batch's
    row order. Dropped pad rows stay zero — the broker's masked inverse
    permutation never reads them."""
    full = np.zeros((n, out.shape[1]), np.float32)
    full[order] = out
    return full


def collect_chunk_results(outs: List[tuple], cost_ema,
                          perm: Optional[np.ndarray],
                          chunk_sizes: List[int]) -> np.ndarray:
    """Common epilogue of a chunked host evaluation: feed measured
    per-chunk durations to the EMA cost model (when dispatch supplied a
    permutation), publish the durations to the metrics bus, and
    concatenate the fitness chunks."""
    m = _metrics.get_registry()
    if m.enabled:
        for _, d in outs:
            m.observe("dispatch_chunk_duration_seconds", d)
    if cost_ema is not None and perm is not None:
        cost_ema.observe(perm, chunk_sizes, [d for _, d in outs])
    out = np.concatenate([o for o, _ in outs], axis=0)
    return np.ascontiguousarray(out, np.float32)
