"""Horizontal / vertical scaling policy (paper §3 Fig. 3, §4.2.1): the
port's own copy of ``repro.core.scaling`` (pure Python).

Horizontal = number of parallel evaluation lanes; vertical = devices
cooperating on ONE fitness evaluation. The port feeds ``plan_scaling``
``torch.cuda.device_count()``.

``plan_scaling`` mirrors the paper's finding that neither axis dominates:
it picks the largest vertical extent that (a) the simulation can use
(``sim_parallelism``: e.g. 2004 contingency cases) and (b) still leaves at
least one individual per lane.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScalingPlan:
    horizontal: int      # parallel workers (lanes)
    vertical: int        # devices per worker

    @property
    def chips(self) -> int:
        return self.horizontal * self.vertical


# the paper's Tab. 3 presets (3072 cores total)
PRESET_HORIZONTAL = ScalingPlan(horizontal=384, vertical=8)    # (a)
PRESET_VERTICAL = ScalingPlan(horizontal=24, vertical=128)     # (b)


def plan_scaling(num_chips: int, *, pop_total: int,
                 sim_parallelism: int = 1,
                 prefer: str = "auto") -> ScalingPlan:
    if prefer == "horizontal":
        return ScalingPlan(num_chips, 1)
    if prefer == "vertical":
        v = _pow2_at_most(min(num_chips, sim_parallelism))
        return ScalingPlan(max(1, num_chips // v), v)
    # auto: grow vertical while every lane still gets >= 1 individual and the
    # sim has parallelism to absorb it
    v = 1
    while (v * 2 <= sim_parallelism
           and num_chips // (v * 2) >= 1
           and num_chips // (v * 2) <= pop_total):
        v *= 2
    h = max(1, num_chips // v)
    return ScalingPlan(h, v)


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p
