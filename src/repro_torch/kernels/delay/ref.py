"""Plain PyTorch version of the delay chain: the reference's masked loop
(``repro/fitness/benchmarks.py::delay_proxy``) in torch ops, on any device.

Every lane runs to the batch's largest count; a lane past its own count
adds ``0 * sin(a) * 1e-6``, an exact 0. Each step rounds the product
``(mask * sin(a)) * 1e-6`` and then the sum, as the reference does.
"""
from __future__ import annotations

import torch


def delay_chain_ref(acc0: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    """acc0 (N,) float32, iters (N,) int -> (N,) float32."""
    upper = int(iters.max()) if iters.numel() else 0
    a = acc0
    for i in range(upper):
        a = a + (i < iters).to(a.dtype) * torch.sin(a) * 1e-6
    return a
