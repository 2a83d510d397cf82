"""AC/DC powerflow substrate (paper §4.2's embedded simulation), in
PyTorch, batched over a leading system axis.

Synthetic German-like grid generation, batched full-Newton AC powerflow
(dense complex linear algebra), DC powerflow + LODF contingency screening,
and the HVDC dispatch objective.
"""
from repro_torch.powerflow.grid import (GERMAN_GRID_SPEC, Grid,
                                        make_synthetic_grid)
from repro_torch.powerflow.hvdc import apply_hvdc
from repro_torch.powerflow.newton import line_flows, newton_powerflow

__all__ = ["Grid", "make_synthetic_grid", "GERMAN_GRID_SPEC",
           "newton_powerflow", "line_flows", "apply_hvdc"]
