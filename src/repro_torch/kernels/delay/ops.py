"""Public wrapper for the delay chain kernel.

``delay_chain(acc0, iters)`` takes (N,) float32 start values and (N,)
int32 step counts and returns the (N,) float32 end values of
``a = a + sin(a) * 1e-6``, run ``iters[i]`` times on lane i.

* On CPU tensors it runs the plain version (``ref.delay_chain_ref``).
* On CUDA tensors it checks dtype, device, shape and contiguity, then
  launches the CUDA kernel or raises. Nothing falls back.

``launches`` counts the kernel launches of this process; it grows only
where the kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.delay.delay import delay_chain_cuda
from repro_torch.kernels.delay.ref import delay_chain_ref

launches = 0


def delay_chain(acc0: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    """acc0 (N,) float32, iters (N,) int32 -> (N,) float32."""
    global launches
    if acc0.device.type == "cpu" and iters.device.type == "cpu":
        return delay_chain_ref(acc0, iters)
    if acc0.device.type != "cuda":
        raise ValueError(f"delay_chain runs on cuda or cpu tensors, not "
                         f"{acc0.device}")
    for name, t, dtype in (("acc0", acc0, torch.float32),
                           ("iters", iters, torch.int32)):
        if t.device != acc0.device or t.dtype != dtype:
            raise ValueError(f"delay_chain: {name} is {t.dtype} on "
                             f"{t.device}; the kernel takes {dtype} on "
                             f"{acc0.device}")
        if t.dim() != 1 or t.shape != acc0.shape:
            raise ValueError(f"delay_chain: {name} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"({acc0.shape[0]},)")
        if not t.is_contiguous():
            raise ValueError(f"delay_chain: {name} is not contiguous")
    out = delay_chain_cuda(acc0, iters)
    launches += 1
    return out
