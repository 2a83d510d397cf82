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

Evaluation itself is pluggable (the paper's decoupled "simulation backend"
microservice): a :class:`DispatchBackend` executes the shuffled batch.
:class:`InlineBackend` runs the fitness on the genomes' device in the
caller's stream; :class:`HostPoolBackend` copies the batch to the host and
fans chunks across a host thread or process pool, for simulators that do
not run on the device. Each chunk is waited on with an execution-time
timeout and re-queued on failure (:func:`run_chunks_retry`).

Cost-model learning: :class:`CostEMA` is a drop-in ``cost_fn`` that learns
an online EMA of measured per-lane wall times (reported by the host pool)
and feeds them back into :func:`balanced_permutation`.

The batch-scheduler and message-queue backends implement the same
``DispatchBackend`` protocol in ``repro_torch.runtime``: ``batchq``
(``SlurmArrayBackend`` over SLURM arrays or Kubernetes indexed Jobs),
``mq`` (``QueueBackend``, the persistent-worker file broker) and
``netbroker`` (``SocketQueueBackend``, the same queue over TCP). They
import no torch at module scope and reach ``ChunkFailure`` and
``run_chunks_retry`` from here inside their functions.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core.hostbridge import (PureCallbackBridge, _timed_eval,
                                         collect_chunk_results)
from repro_torch.runtime import metrics as _metrics


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


# ---------------------------------------------------------------------------
# Per-chunk timeout + retry (shared by every decoupled backend)
# ---------------------------------------------------------------------------

class ChunkFailure(RuntimeError):
    """A dispatched evaluation chunk failed (or straggled) beyond retry."""


def run_chunks_retry(chunks, submit: Callable, wait: Callable, *,
                     timeout_s: Optional[float] = None,
                     max_retries: int = 0,
                     on_retry: Optional[Callable] = None,
                     initial_tokens: Optional[list] = None) -> list:
    """Drive a set of evaluation chunks with per-chunk timeout + re-queue.

    All chunks are submitted up front (``submit(i, chunk, attempt) ->
    token``, or pass ``initial_tokens`` when attempt 0 was already
    submitted); each is then waited on (``wait(i, token, timeout_s) ->
    result``). How ``timeout_s`` is clocked is ``wait``'s choice: the host
    pool counts *execution* time only, so time queued behind a full pool
    never reads as straggling. ``wait`` raises ``TimeoutError`` for
    stragglers or any other exception for failed chunks, and the chunk is
    re-queued via a fresh ``submit`` up to ``max_retries`` times.
    """
    tokens = (list(initial_tokens) if initial_tokens is not None
              else [submit(i, c, 0) for i, c in enumerate(chunks)])
    attempts = [0] * len(chunks)
    results = [None] * len(chunks)
    for i, chunk in enumerate(chunks):
        while True:
            try:
                token = tokens[i]
                if isinstance(token, _FailedSubmit):
                    raise token.exc          # count against the budget
                results[i] = wait(i, token, timeout_s)
                break
            except Exception as exc:
                attempts[i] += 1
                if attempts[i] > max_retries:
                    raise ChunkFailure(
                        f"chunk {i}/{len(chunks)} failed after "
                        f"{attempts[i]} attempt(s): {exc!r}") from exc
                if on_retry is not None:
                    on_retry(i, attempts[i], exc)
                try:
                    tokens[i] = submit(i, chunk, attempts[i])
                except Exception as submit_exc:
                    # a failing re-queue is just another failed attempt,
                    # not an abort
                    tokens[i] = _FailedSubmit(submit_exc)
    return results


class _FailedSubmit:
    """Token marking a re-queue whose submission itself failed."""

    def __init__(self, exc: Exception):
        self.exc = exc


# ---------------------------------------------------------------------------
# Online cost-model learning
# ---------------------------------------------------------------------------

class CostEMA:
    """Learned cost model: an online EMA of measured per-lane wall times.

    Drop-in ``cost_fn`` for :class:`Broker`. Estimates are keyed by batch
    slot: slot ``i`` of the flattened ``(I*P)`` batch belongs to island
    ``i // P``, so island- and slot-level cost structure persists across
    generations even as individual genomes change.

    The host pool measures each chunk's wall time and calls
    :meth:`observe` with the dispatch permutation, attributing
    ``duration / chunk_size`` to every real slot in the chunk.
    ``__call__`` reads the current table on the host and returns it as a
    float32 tensor on the genomes' device, so each generation's
    :func:`balanced_permutation` sees fresh estimates. Requires a decoupled
    backend: inline evaluation exposes no per-lane timings.

    Cold start: by default the table initializes to a uniform
    ``init_cost``. ``prime_fn`` (a static cost model ``(N, G) -> (N,)`` on
    the genomes' device) seeds the slot table from its prediction on the
    first batch instead; measured wall times then refine it online.
    """

    def __init__(self, alpha: float = 0.25, init_cost: float = 1.0,
                 prime_fn: Optional[Callable] = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1]: {alpha}")
        self.alpha = float(alpha)
        self.init_cost = float(init_cost)
        self.prime_fn = prime_fn
        self._est: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self.updates = 0

    def snapshot(self, n: int, prime: Optional[np.ndarray] = None) -> np.ndarray:
        """Current (n,) cost estimates. A cold (or re-keyed after resize)
        table initializes from ``prime`` when given, else to uniform
        ``init_cost``."""
        with self._lock:
            if self._est is None or self._est.shape[0] != int(n):
                if prime is not None:
                    # a copy: observe() writes the table in place
                    self._est = np.array(prime, np.float32,
                                         copy=True).reshape(int(n))
                else:
                    self._est = np.full((int(n),), self.init_cost,
                                        np.float32)
            return self._est.copy()

    def observe(self, perm, chunk_sizes, durations) -> None:
        """Fold measured per-chunk wall times back into the estimates.

        perm: the (padded) dispatch permutation the chunks were taken
        from; entries ``>= n`` (sentinel pads) are skipped. Every real
        slot in chunk ``w`` is charged ``durations[w] / chunk_sizes[w]``.
        """
        perm = np.asarray(perm)
        with self._lock:
            if self._est is None:
                return                      # no reader yet — nothing keyed
            n = self._est.shape[0]
            a = self.alpha
            off = 0
            for size, dur in zip(chunk_sizes, durations):
                idx = perm[off:off + size]
                off += size
                idx = idx[idx < n]
                if idx.size:
                    per_item = np.float32(dur / max(size, 1))
                    self._est[idx] = ((1.0 - a) * self._est[idx]
                                      + a * per_item)
            self.updates += 1
            est = self._est
        m = _metrics.get_registry()
        if m.enabled:
            # per-slot costs, summarized: per-slot labels would blow the
            # registry's series cap on any real population
            m.inc("cost_ema_updates_total")
            m.set_gauge("cost_ema_mean_seconds", float(est.mean()))
            m.set_gauge("cost_ema_max_seconds", float(est.max()))
            m.set_gauge("cost_ema_min_seconds", float(est.min()))

    def reset(self) -> None:
        """Drop learned state (e.g. after a resize re-keys slots)."""
        with self._lock:
            self._est = None

    def __call__(self, genomes: torch.Tensor) -> torch.Tensor:
        n = genomes.shape[0]
        prime = None
        if self.prime_fn is not None:
            # the prediction is computed on the device every generation
            # and read only by a cold table, as in the reference: one (N,)
            # float32 copy to the host per generation
            prime = self.prime_fn(genomes).detach().cpu().numpy()
        return torch.from_numpy(self.snapshot(n, prime)).to(genomes.device)


# ---------------------------------------------------------------------------
# Dispatch backends — the paper's pluggable "simulation backend" container
# ---------------------------------------------------------------------------

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


class HostPoolBackend(PureCallbackBridge):
    """Decoupled evaluation on a host executor pool.

    For simulators that do not run on the device (subprocess powerflow
    binaries, numpy models). The batch is copied to the host and split into
    ``num_workers`` chunks, each submitted to the pool; the call blocks
    until all chunks return and hands the result back on the genomes'
    device.

    executor: "thread" (default; any callable) or "process" (true
    parallelism for GIL-bound python simulators; ``fitness_fn`` must be
    picklable, i.e. a module-level function or callable instance).
    Process pools use the *spawn* start method (forking a process that
    runs CUDA or other threads is unsafe) and are created at construction.

    Hardening: ``chunk_timeout_s`` bounds each chunk's *execution* wall
    time (time queued behind a full pool does not count); a straggling or
    failed chunk is re-submitted to the pool up to ``max_retries`` times
    (speculative re-queue — a hung worker thread keeps its slot, the
    retry races it). ``close()`` *drains* in-flight evaluations before
    shutting the pool down, and the class is a context manager.
    ``cost_ema`` (a :class:`CostEMA`) receives measured per-chunk wall
    times when the broker dispatches with a permutation.
    """

    name = "host-pool"

    def __init__(self, fitness_fn: Callable, *, num_objectives: int = 1,
                 num_workers: int = 4, executor: str = "thread",
                 chunk_timeout_s: Optional[float] = None,
                 max_retries: int = 2,
                 cost_ema: Optional[CostEMA] = None):
        if executor not in ("thread", "process"):
            raise ValueError(f"executor must be thread|process: {executor}")
        self.fitness_fn = fitness_fn
        self.num_objectives = num_objectives
        self.num_workers = max(1, num_workers)
        self.executor = executor
        self.chunk_timeout_s = chunk_timeout_s
        self.max_retries = max_retries
        self.cost_ema = cost_ema
        self.stats = {"retries": 0}
        self._cond = threading.Condition()
        self._inflight = 0
        self._closing = False
        import concurrent.futures as cf
        if executor == "thread":
            self._pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        else:
            import multiprocessing as mp
            self._pool = cf.ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"))

    def _host_eval(self, genomes: np.ndarray,
                   perm: Optional[np.ndarray] = None,
                   cost: Optional[np.ndarray] = None) -> np.ndarray:
        # `cost` (predicted per-slot cost) is accepted for protocol parity
        # with cost-sizing backends but unused here: this path keeps equal
        # splits, as the reference's host pool does
        with self._cond:
            if self._closing or self._pool is None:
                raise RuntimeError("HostPoolBackend used after close()")
            self._inflight += 1
            pool = self._pool
        try:
            n = genomes.shape[0]
            chunks = np.array_split(genomes,
                                    min(self.num_workers, max(1, n)))

            def submit(i, chunk, attempt):
                return pool.submit(_timed_eval, self.fitness_fn, chunk)

            def wait(i, fut, timeout_s):
                if timeout_s is None:
                    return fut.result()
                # the straggler clock starts when the chunk begins
                # executing — time queued behind a full pool must not
                # count as straggling
                while not (fut.running() or fut.done()):
                    time.sleep(0.005)
                return fut.result(timeout=timeout_s)

            def on_retry(i, attempt, exc):
                # two concurrent _host_eval calls can retry at once
                with self._cond:
                    self.stats["retries"] += 1

            outs = run_chunks_retry(chunks, submit, wait,
                                    timeout_s=self.chunk_timeout_s,
                                    max_retries=self.max_retries,
                                    on_retry=on_retry)
            return collect_chunk_results(outs, self.cost_ema, perm,
                                         [len(c) for c in chunks])
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def stats_snapshot(self) -> dict:
        """Consistent copy of the counters — increments run under
        ``self._cond``'s lock, so read under it too."""
        with self._cond:
            return dict(self.stats)

    def close(self):
        """Drain in-flight evaluations, then shut the pool down. Safe to
        call more than once. The drain guarantees every result anyone is
        waiting on has been delivered; shutdown then does NOT join the
        workers — a truly hung simulator thread (abandoned by a timed-out
        chunk whose retry won the race) would block close() forever."""
        with self._cond:
            if self._pool is None:
                return
            self._closing = True
            while self._inflight:
                self._cond.wait()
            pool, self._pool = self._pool, None
        pool.shutdown(wait=False)


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
        # learned cost model: wire the EMA into a decoupled backend that
        # can report measured per-chunk wall times back to it
        if (isinstance(cost_fn, CostEMA)
                and hasattr(backend, "cost_ema")
                and getattr(backend, "cost_ema") is None):
            backend.cost_ema = cost_fn

    def backend_stats(self) -> dict:
        """Snapshot of the dispatch backend's host-side counters (retries
        for the host pool; jobs, retries, timeouts, lease re-queues for
        the queue backends; empty for backends that keep none, e.g.
        inline). Returns a copy, read through the backend's locked
        ``stats_snapshot`` where it has one. A fleet autoscaled by the mq
        backend adds its own snapshot under ``autoscaler_*`` keys."""
        snap = getattr(self.backend, "stats_snapshot", None)
        stats = snap() if snap is not None \
            else dict(getattr(self.backend, "stats", None) or {})
        scaler = getattr(self.backend, "autoscaler", None)
        if scaler is not None:
            for k, v in scaler.stats_snapshot().items():
                stats[f"autoscaler_{k}"] = v
        return stats

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
        if hasattr(self.backend, "eval_with_perm"):
            # decoupled backend: `perm` keys measured per-chunk wall times
            # back into the EMA cost model; sentinel pads are marked -inf,
            # not their zero stats-cost: a pad slot re-evaluates a
            # duplicate of genome 0 at its true price, so a cost-sizing
            # backend must identify pads, not mistake them for free work
            pad_marked = torch.where(real, lane_cost, -torch.inf)
            fit_shuf = self.backend.eval_with_perm(shuffled, perm,
                                                   pad_marked)
        else:
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
