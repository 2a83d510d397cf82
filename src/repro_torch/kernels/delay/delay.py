"""Build and launch of the delay chain CUDA kernel (``csrc/delay_chain.cu``;
it replaces the ``lax.fori_loop`` of ``repro/fitness/benchmarks.py::
delay_proxy``, which is not a Pallas kernel).

acc0 (N,) float32 and iters (N,) int32 are read in place; the chain's end
values come back as (N,) float32. One thread per lane. The library is
compiled and loaded at the first launch, never at import. Callers go
through ``ops.delay_chain``, which checks the arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "delay_chain"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
_entry: list = []


def _launcher():
    if not _entry:
        fn = _build.load(KERNEL).delay_chain_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


def delay_chain_cuda(acc0: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    """One launch on the current stream (arguments checked by the caller).
    Returns the (N,) float32 end values of the chains."""
    out = torch.empty_like(acc0)
    launch = _launcher()
    with torch.cuda.device(acc0.device):
        stream = torch.cuda.current_stream(acc0.device).cuda_stream
        err = launch(acc0.data_ptr(), iters.data_ptr(), out.data_ptr(),
                     acc0.numel(), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed with CUDA error "
                           f"{err} (N={acc0.numel()})")
    return out
