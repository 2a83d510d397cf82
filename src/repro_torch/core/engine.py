"""GAEngine: epoch orchestration, termination, checkpointing, logging.

The engine is the paper's "CHAMB-GA scripts" control hub (Fig. 1): it owns
the epoch step and the user-facing concerns — run control, wall-clock /
target termination, checkpoint/restart, history.

Pipelined metric reads: CUDA launches are asynchronous, so the host can
enqueue epoch e+1 while the device still runs epoch e. Each epoch's
metrics start a non-blocking device->host copy into pinned host buffers
followed by a CUDA event; ``_drain`` waits on that event only when the
metrics are read, which is deferred until ``pipeline_depth`` later epochs
have been enqueued (``sync_every`` batches how often the queue is
drained). The GA's results do not depend on when metrics are read: a run
gives the same population for any ``sync_every`` / ``pipeline_depth``.

With a host backend (``backend=HostPoolBackend(...)``) every generation
copies its offspring to the host and waits for their fitness, so the
device is idle while the host evaluates and pipelined metric reads
overlap nothing there. The engine keeps the one loop for both: the host
backend's call is synchronous and in order, so the results stay the same
for any ``sync_every`` / ``pipeline_depth`` there too.

``resize`` repartitions a running population onto another island count
(``runtime/elastic.repartition_islands``) and re-balances the broker's
lanes for the resized fleet.

On a mesh (``ctx=``, a ``models.sharding.ShardingCtx``; every rank builds
the same engine; the default has no mesh) each rank runs its islands
(``core.island``) and the broker gets ``ctx.dp_size`` lanes unless told
otherwise, as in the reference. ``init`` returns this rank's islands; ``run`` takes a global
population or a rank's block and returns the global population on every
rank. Metrics and ``evals_host`` count every island once. Checkpoints
hold the global population in the reference's layout: rank 0 writes
them, every rank restores and keeps its rows. ``resize`` on a mesh
repartitions the global population identically on every rank and keeps
the rank's block of the new island count (see its docstring).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import GAConfig
from repro_torch.core.broker import Broker, DispatchBackend
from repro_torch.core.device import resolve_device
from repro_torch.core.island import (constrain_pop, evaluate_population,
                                     gather_pop, make_epoch_step)
from repro_torch.core.population import (Population, best_of, fold_rng,
                                         init_population, seed_rng,
                                         population_from_numpy,
                                         population_to_numpy)
from repro_torch.models.sharding import ShardingCtx, sharded


class GAEngine:
    def __init__(self, cfg: GAConfig, fitness_fn: Optional[Callable] = None,
                 *, cost_fn: Optional[Callable] = None,
                 backend: Optional[DispatchBackend] = None,
                 ctx: ShardingCtx = ShardingCtx(),
                 num_workers: Optional[int] = None,
                 checkpointer=None, checkpoint_every: int = 0,
                 log_fn: Optional[Callable] = None,
                 sync_every: int = 1,
                 pipeline_depth: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ctx = ctx
        self._check_islands(cfg.num_islands)
        self.broker = Broker(fitness_fn, cost_fn, num_workers=(
            num_workers if num_workers is not None else ctx.dp_size),
            backend=backend, ctx=ctx)
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.log_fn = log_fn
        self.sync_every = max(1, sync_every)
        self.pipeline_depth = max(0, pipeline_depth)
        # exact host count of fitness evaluations, checkpointed as
        # "evals_host" (the reference's key for its unbounded counter)
        self.evals_host: int = 0
        self._build_steps()

    def _check_islands(self, islands: int) -> None:
        if islands < self.ctx.dp_size:
            raise ValueError(f"{islands} islands cannot cover the "
                             f"mesh's {self.ctx.dp_size} data ranks")

    def _build_steps(self) -> None:
        """(Re)build the epoch step for the current cfg and broker: at
        construction and after an elastic :meth:`resize`."""
        self._epoch_step = make_epoch_step(self.cfg, self.broker,
                                           self.device, ctx=self.ctx)

    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> Population:
        """A fresh, evaluated population (this rank's islands on a
        mesh)."""
        pop = init_population(self.cfg,
                              self.cfg.seed if seed is None else seed,
                              self.device)
        self.evals_host = self.cfg.global_pop
        return evaluate_population(self.cfg, self.broker,
                                   constrain_pop(pop, self.ctx), self.ctx)

    def restore(self, step: Optional[int] = None) -> Optional[Population]:
        """The population of a checkpoint (of this package or the
        reference), or None when there is none."""
        if self.checkpointer is None:
            return None
        state = self.checkpointer.restore(step)
        if state is None:
            return None
        host = state.pop("evals_host", None)
        pop = population_from_numpy(state, self.device)
        self.evals_host = (int(host) if host is not None
                           else max(0, pop.evals))
        return pop

    def _checkpoint_state(self, pop: Population) -> dict:
        state = population_to_numpy(pop)
        state["evals_host"] = np.uint64(self.evals_host)
        return state

    def _agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank of a mesh (a clock read on each
        rank would part them); ``flag`` itself without one."""
        if not sharded(self.ctx):
            return flag
        box = [flag]
        dist.broadcast_object_list(box, src=0)
        return bool(box[0])

    def _save(self, pop: Population, step: int, last: bool) -> None:
        """Checkpoint the global population: rank 0 writes it; on a mesh
        every rank takes part in the gather, and after the ``last`` save
        waits until the write is on disk, so a later restore on any rank
        reads it."""
        pop = gather_pop(pop, self.ctx)
        mesh = sharded(self.ctx)
        if not mesh or dist.get_rank() == 0:
            self.checkpointer.save(self._checkpoint_state(pop), step=step)
            if last and mesh:
                self.checkpointer.wait()
        if last and mesh:
            dist.barrier()

    # ------------------------------------------------------------------
    def resize(self, pop: Population, new_islands: int, *, rng=None,
               num_workers: Optional[int] = None) -> Population:
        """Elastic lane re-balance: repartition ``pop`` onto
        ``new_islands`` islands (``runtime/elastic.repartition_islands``;
        ``rng`` is a stream's key words, by default the seed's folded with
        1000 + new_islands, as in the reference) and rebuild the broker for
        the resized fleet: ``num_workers`` scales with the island count
        unless given, a backend with its own ``num_workers`` follows this
        rank's lanes, and a cost model with ``reset`` is reset (its slots
        changed). A grown population (clones at +inf) is evaluated before
        the engine goes on, and counted. Dispatch permutations never
        change fitness values, so a re-balanced run tracks a fixed-lane
        run exactly on a deterministic fitness.

        On a mesh every rank calls it alike, with the global population
        (as ``run`` returns it: the same on every rank, so nothing moves)
        or with its own block (gathered first). Every rank repartitions
        the global population with the same ``rng`` and returns its block
        of the new island count, evaluated: a run that goes on from it is
        bit for bit one rank's. Fewer islands than data ranks raise a
        ``ValueError`` on every rank before any collective. A lane count
        that falls below the data ranks leaves the ranks past it with no
        lane: they take part in the broker's gathers with empty blocks,
        so fitness and dispatch stats stay one rank's."""
        self._check_islands(new_islands)
        if pop.genomes.shape[0] != pop.rng.shape[0]:
            pop = gather_pop(pop, self.ctx)
        old_islands = pop.genomes.shape[0]
        if rng is None:
            rng = fold_rng(seed_rng(self.cfg.seed), 1000 + new_islands)
        from repro_torch.runtime.elastic import repartition_islands
        pop = repartition_islands(self.cfg, pop, new_islands, rng)
        self.cfg = dataclasses.replace(self.cfg, num_islands=new_islands)
        if num_workers is None:
            num_workers = max(
                1, self.broker.num_workers * new_islands // old_islands)
        self.broker = Broker(self.broker.fitness_fn, self.broker.cost_fn,
                             num_workers=num_workers,
                             backend=self.broker.backend, ctx=self.ctx)
        backend = self.broker.backend
        if hasattr(backend, "num_workers"):
            # decoupled backends chunk by their own num_workers; keep the
            # split aligned with this rank's lanes
            backend.num_workers = max(1, self.broker.lanes)
        if hasattr(self.broker.cost_fn, "reset"):
            self.broker.cost_fn.reset()      # slot-keyed EMA: N changed
        self._build_steps()
        # decided on the global population: every rank evaluates, or none
        grown = bool(torch.isinf(pop.fitness).any())
        pop = constrain_pop(pop, self.ctx)
        if grown:
            pop = evaluate_population(self.cfg, self.broker, pop, self.ctx)
            self.evals_host += self.cfg.global_pop
        return pop

    # ------------------------------------------------------------------
    def _start_host_copy(self, metrics: dict):
        """Start the device->host copy of an epoch's metrics: pinned
        buffers, non-blocking copies and a CUDA event on CUDA; on the CPU the
        metrics are already host tensors. Returns (host tensors, event or
        None)."""
        if self.device.type != "cuda":
            return metrics, None
        host = {}
        for k, v in metrics.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _drain(self, pending: list, history: list, keep: int = 0) -> None:
        """Read all but the newest ``keep`` pending epoch metrics into
        ``history`` (oldest first), waiting on each one's event."""
        while len(pending) > keep:
            ee, host, event = pending.pop(0)
            if event is not None:
                event.synchronize()
            best = host["best"].numpy()
            rec = {"epoch": ee,
                   "best_per_island": best[-1],
                   "best": float(np.min(best)),
                   "trace": best,
                   "skew": float(np.mean(host["skew"].numpy())),
                   "balanced": float(np.mean(host["balanced"].numpy()))}
            history.append(rec)
            if self.log_fn:
                self.log_fn(rec)

    def run(self, pop: Optional[Population] = None, *,
            epochs: Optional[int] = None,
            target: Optional[float] = None,
            wallclock_s: Optional[float] = None):
        """Run until an epoch/target/wall-clock limit. Returns
        (population, history) where history is a list of per-epoch dicts;
        on a mesh the population is the global one, on every rank."""
        cfg = self.cfg
        if pop is None:
            pop = self.restore() or self.init()
        elif self.evals_host == 0:
            # externally supplied population: seed the host counter
            self.evals_host = max(0, pop.evals)
        pop = constrain_pop(pop, self.ctx)
        epochs = epochs if epochs is not None else cfg.num_epochs
        history = []
        t0 = time.monotonic()
        pending = []                                   # in-flight metrics
        start_epoch = pop.epoch
        evals_per_epoch = (cfg.generations_per_epoch
                           * pop.rng.shape[0] * pop.genomes.shape[1])

        for e in range(start_epoch, start_epoch + epochs):
            pop, metrics = self._epoch_step(pop)
            self.evals_host += evals_per_epoch
            pending.append((e, *self._start_host_copy(metrics)))
            if (e + 1) % self.sync_every == 0:
                # keep `pipeline_depth` epochs in flight; with a target,
                # drain fully so the check sees the newest epoch
                self._drain(pending, history,
                            keep=0 if target is not None
                            else self.pipeline_depth)
                if target is not None and history and \
                        history[-1]["best"] <= target:
                    break
            if self.checkpointer and self.checkpoint_every and \
                    (e + 1) % self.checkpoint_every == 0:
                self._save(pop, e + 1, last=False)
            if wallclock_s is not None and self._agree(
                    time.monotonic() - t0 > wallclock_s):
                break
        self._drain(pending, history, keep=0)
        if self.checkpointer and self.checkpoint_every:
            self._save(pop, pop.epoch, last=True)
        return gather_pop(pop, self.ctx), history

    def best(self, pop: Population):
        g, f = best_of(pop)
        return g.cpu().numpy(), f.cpu().numpy()
