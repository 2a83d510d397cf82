"""HVDC dispatch fitness (paper §4.2, eqs. 2-3), batched over genomes.

Objective: total transmitted power over all AC lines (grid-usage-fee
proxy), computed from a full AC Newton solve with the genome's HVDC
injections. With ``contingencies > 0`` the paper's N-1 penalty multiplies
the objective (+10% per critical case, +1% per near-critical).

Scaling axes (paper Fig. 3): the genome batch and the contingency batch
are flattened into one batch of systems on the device. On a mesh
(``ctx``): horizontal — the genome batch goes over the ``dp`` axes through
the broker; vertical — each genome's case list goes over the ``tp`` axis
(``powerflow.contingency``).

``screen_top_k > 0`` (with ``contingencies > 0``) enables the LODF
screening: DC-rank all single-line outages per genome, full-AC only the
top-K.

For a host pool of spawned processes (``ga_run --dispatch-backend
host-process`` and the queue fleets), :class:`SpawnedHostFitness` ships the
grid's numpy arrays and the fitness's arguments to the worker, which
rebuilds the fitness on the CPU. Threads run it on its own device through
``core.hostbridge.LockedHostFitness``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.sharding import ShardingCtx
from repro_torch.powerflow.contingency import (contingency_loadings,
                                               penalized_objective,
                                               select_contingency_lines)
from repro_torch.powerflow.dc import build_dc_model, screen_contingencies
from repro_torch.powerflow.grid import Grid
from repro_torch.powerflow.hvdc import apply_hvdc, scale_genome_to_dispatch
from repro_torch.powerflow.newton import line_flows, newton_powerflow


class HVDCDispatchFitness:
    """Callable (N, H) genomes in [-1, 1] -> (N, 1) objectives, on
    ``device``; with a mesh ``ctx`` the cases split over its ``tp``
    axis."""

    def __init__(self, grid: Grid, *, contingencies: int = 0,
                 newton_iters: int = 10, screen_top_k: int = 0,
                 ctx: ShardingCtx = ShardingCtx(), seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.ctx = ctx
        self.grid = grid
        self.gridt = grid.to_torch(self.device)
        self.newton_iters = newton_iters
        self.num_contingencies = contingencies
        self.screen_top_k = screen_top_k
        self.seed = seed
        if contingencies:
            self.outages = torch.as_tensor(
                select_contingency_lines(grid, contingencies, seed),
                device=self.device)
        else:
            self.outages = None
        self.dc_model = build_dc_model(self.gridt) if screen_top_k else None

    @property
    def num_genes(self) -> int:
        return self.grid.n_hvdc

    def __call__(self, genomes: torch.Tensor) -> torch.Tensor:
        gridt = self.gridt
        dispatch = scale_genome_to_dispatch(gridt, genomes)
        p_extra = apply_hvdc(gridt, dispatch)                 # (N, n)
        res = newton_powerflow(gridt, p_extra=p_extra,
                               num_iters=self.newton_iters)
        fl = line_flows(gridt, res.vm, res.va)
        base = torch.sum(fl, dim=-1)                          # eq. (2)
        base = torch.where(res.converged, base, base * 100.0)

        if self.outages is not None:
            if self.dc_model is not None:
                cases = screen_contingencies(
                    self.dc_model, gridt["p_inj"] + p_extra, gridt["rate"],
                    self.screen_top_k)                        # (N, K)
            else:
                cases = self.outages                          # (C,)
            loadings = contingency_loadings(
                gridt, cases, p_extra=p_extra, num_iters=self.newton_iters,
                ctx=self.ctx)
            base = penalized_objective(base, loadings)        # eq. (3)
        return base[:, None]

    def cost_model(self):
        """Predicted per-genome evaluation cost for the broker: Newton
        iteration count grows with dispatch magnitude (stress)."""
        pmax = self.gridt["hvdc_pmax"]

        def cost(genomes: torch.Tensor) -> torch.Tensor:
            stress = torch.sum(torch.abs(genomes) * pmax[None], dim=-1)
            return 4.0 + stress / torch.clamp_min(torch.sum(pmax), 1e-9) * 6.0

        return cost


class SpawnedHostFitness:
    """numpy (N, H) -> (N, 1) float32, picklable for a spawned process
    pool: it carries the grid's numpy arrays and the fitness's arguments,
    and each call rebuilds ``HVDCDispatchFitness`` on the CPU of the
    process that runs it (a card-resident fitness cannot be shipped to
    spawned processes, and a host pool is host cores by design)."""

    def __init__(self, fit: HVDCDispatchFitness):
        self.grid = fit.grid
        self.kwargs = dict(contingencies=fit.num_contingencies,
                           newton_iters=fit.newton_iters,
                           screen_top_k=fit.screen_top_k, seed=fit.seed)

    def __call__(self, genomes) -> np.ndarray:
        fit = HVDCDispatchFitness(self.grid, device="cpu", **self.kwargs)
        return fit(torch.as_tensor(np.asarray(genomes, np.float32))).numpy()
