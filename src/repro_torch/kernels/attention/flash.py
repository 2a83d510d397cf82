"""Build and launch of the flash attention CUDA kernels: the forward
(``csrc/flash_attention.cu``; it replaces the TPU kernel
``repro/kernels/attention/flash.py::_kernel``, launched there by
``flash_attention_fwd``) and the backward (``csrc/flash_attention_bwd.cu``;
it stands beside ``repro/kernels/attention/ops.py::_bwd``, the reference's
custom VJP, which recomputes through XLA ops).

q (B, Sq, H, hd), k/v (B, T, KV, hd) and the outputs keep the reference's
layout; the kernels read and write them in place, with no regrouping copy.
The libraries are compiled and loaded at the first launch, never at
import. Callers go through ``ops.flash_attention``, which checks the
arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "flash_attention"
BWD_KERNEL = "flash_attention_bwd"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int64, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_int64, ctypes.c_void_p])


def _launcher(kernel: str, symbol: str, argtypes):
    fn = getattr(_build.load(kernel), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, kernel: str, q, k):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float, causal: bool,
                             window: int, attn_softcap: float,
                             q_offset: int, with_lse: bool = False):
    """One launch on the current stream (arguments checked by the caller).
    Returns the output in q's dtype, or (output, lse) with ``with_lse``:
    lse (B, Sq, H) float32 holds each row's log-sum-exp of its capped,
    masked scores (the clamped max for a fully masked row)."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    launch = _launcher(KERNEL, "flash_attention_fwd_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                     b, sq, t, h, kvh, hd, int(q.dtype == torch.bfloat16),
                     float(scale), int(bool(causal)), int(window),
                     float(attn_softcap), int(q_offset), stream)
    _raise_on(err, KERNEL, q, k)
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             scale: float, causal: bool, window: int,
                             attn_softcap: float, q_offset: int):
    """dq, dk, dv (float32, the shapes of q, k, v) of the forward that gave
    ``out`` and ``lse``, for the output gradient ``dout``: a row sum
    D = rowsum(dout * out) in torch, then the backward's two kernels (dk
    and dv per key tile, dq per row tile) on the current stream. Arguments
    checked by the caller."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dsum = (dout * out).sum(-1)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch = _launcher(BWD_KERNEL, "flash_attention_bwd_launch",
                       _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, t,
                     h, kvh, hd, float(scale), int(bool(causal)),
                     int(window), float(attn_softcap), int(q_offset),
                     stream)
    _raise_on(err, BWD_KERNEL, q, k)
    return dq, dk, dv
