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

Not ported yet: the elastic ``resize`` (it needs ``runtime/elastic``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import GAConfig
from repro_torch.core.broker import Broker, DispatchBackend
from repro_torch.core.device import resolve_device
from repro_torch.core.island import evaluate_population, make_epoch_step
from repro_torch.core.population import (Population, best_of,
                                         init_population,
                                         population_from_numpy,
                                         population_to_numpy)


class GAEngine:
    def __init__(self, cfg: GAConfig, fitness_fn: Optional[Callable] = None,
                 *, cost_fn: Optional[Callable] = None,
                 backend: Optional[DispatchBackend] = None,
                 num_workers: Optional[int] = None,
                 checkpointer=None, checkpoint_every: int = 0,
                 log_fn: Optional[Callable] = None,
                 sync_every: int = 1,
                 pipeline_depth: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.broker = Broker(fitness_fn, cost_fn,
                             num_workers=num_workers or 1, backend=backend)
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.log_fn = log_fn
        self.sync_every = max(1, sync_every)
        self.pipeline_depth = max(0, pipeline_depth)
        # exact host count of fitness evaluations, checkpointed as
        # "evals_host" (the reference's key for its unbounded counter)
        self.evals_host: int = 0
        self._epoch_step = make_epoch_step(cfg, self.broker, self.device)

    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> Population:
        pop = init_population(self.cfg,
                              self.cfg.seed if seed is None else seed,
                              self.device)
        self.evals_host = self.cfg.global_pop
        return evaluate_population(self.cfg, self.broker, pop)

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
        (population, history) where history is a list of per-epoch dicts."""
        cfg = self.cfg
        if pop is None:
            pop = self.restore() or self.init()
        elif self.evals_host == 0:
            # externally supplied population: seed the host counter
            self.evals_host = max(0, pop.evals)
        epochs = epochs if epochs is not None else cfg.num_epochs
        history = []
        t0 = time.monotonic()
        pending = []                                   # in-flight metrics
        start_epoch = pop.epoch
        evals_per_epoch = (cfg.generations_per_epoch
                           * pop.genomes.shape[0] * pop.genomes.shape[1])

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
                self.checkpointer.save(self._checkpoint_state(pop),
                                       step=e + 1)
            if wallclock_s is not None and time.monotonic() - t0 > wallclock_s:
                break
        self._drain(pending, history, keep=0)
        if self.checkpointer and self.checkpoint_every:
            self.checkpointer.save(self._checkpoint_state(pop),
                                   step=pop.epoch)
        return pop, history

    def best(self, pop: Population):
        g, f = best_of(pop)
        return g.cpu().numpy(), f.cpu().numpy()
