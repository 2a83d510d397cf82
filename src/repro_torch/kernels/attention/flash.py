"""Build and launch of the flash attention forward CUDA kernel
(``csrc/flash_attention.cu``; it replaces the TPU kernel
``repro/kernels/attention/flash.py::_kernel``, launched there by
``flash_attention_fwd``).

q (B, Sq, H, hd), k/v (B, T, KV, hd) and the output (B, Sq, H, hd) keep the
reference's layout; the kernel reads and writes them in place, with no
regrouping copy. The library is compiled and loaded at the first launch,
never at import. Callers go through ``ops.flash_attention``, which checks
the arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "flash_attention"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int64, ctypes.c_void_p])


def _launcher():
    fn = _build.load(KERNEL).flash_attention_fwd_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float, causal: bool,
                             window: int, attn_softcap: float,
                             q_offset: int) -> torch.Tensor:
    """One launch on the current stream (arguments checked by the caller).
    Returns the output in q's dtype."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, sq, t, h, kvh, hd,
                     int(q.dtype == torch.bfloat16), float(scale),
                     int(bool(causal)), int(window), float(attn_softcap),
                     int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    return out
