"""Build and launch of the SSD intra-chunk CUDA kernel
(``csrc/ssd_chunk.cu``; it replaces the TPU kernel
``repro/kernels/ssd/chunk_kernel.py::_kernel``, launched there by
``ssd_intra_chunk``).

x (B, L, H, P), dt (B, L, H), a (H,), B/C (B, L, N) with L a multiple of
the chunk Q are read in place; y_diag comes back as (B, L, H, P), the chunk
states as (B, NC, H, P, N) and in_decay as (B, NC, H, Q), all float32. One
block computes C B^T of a chunk once for a group of adjacent heads; the
C launcher picks the group from (H, P, N, Q) and the device's shared
memory. The library is compiled and loaded at the first launch, never at
import. Callers go through ``ops.ssd_intra_chunk``, which checks the
arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "ssd_chunk"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launcher():
    fn = _build.load(KERNEL).ssd_chunk_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk_cuda(x, dt, a, b_mat, c_mat, *, chunk: int):
    """One launch on the current stream (arguments checked by the caller).
    Returns (y_diag, states, in_decay)."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    nc = l // chunk
    y = torch.empty_like(x)
    states = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
    in_dec = torch.empty((bsz, nc, h, chunk), dtype=torch.float32,
                         device=x.device)
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                     b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
                     states.data_ptr(), in_dec.data_ptr(), bsz, nc, chunk,
                     h, p, n, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, N={n}, "
                           f"chunk={chunk})")
    return y, states, in_dec
