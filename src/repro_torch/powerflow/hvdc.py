"""HVDC point-to-point injection model (paper §4.2), batched over genomes.

Each HVDC line is a controllable bidirectional power transfer x_i in
[-pmax, pmax]: withdraw x at the from-bus, inject (1 - loss) * x at the
to-bus. The 18 dispatch decisions are the GA genome.
"""
from __future__ import annotations

import torch

HVDC_LOSS = 0.015     # low-loss bulk transport


def apply_hvdc(gridt: dict, dispatch: torch.Tensor) -> torch.Tensor:
    """dispatch: (B, H) p.u. -> additional bus injections (B, n)."""
    n = gridt["bus_type"].shape[0]
    inj = torch.zeros(dispatch.shape[:-1] + (n,), dtype=torch.float32,
                      device=dispatch.device)
    inj.index_add_(-1, gridt["hvdc_f"], -dispatch)
    inj.index_add_(-1, gridt["hvdc_t"], (1.0 - HVDC_LOSS) * dispatch)
    return inj


def scale_genome_to_dispatch(gridt: dict,
                             genome01: torch.Tensor) -> torch.Tensor:
    """genome in [-1, 1]^H -> dispatch in [-pmax, pmax]."""
    return genome01 * gridt["hvdc_pmax"]
