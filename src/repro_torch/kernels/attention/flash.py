"""Build and launch of the flash attention CUDA kernels: the forward,
float32 (``csrc/flash_attention.cu``) and bfloat16
(``csrc/flash_attention_fwd_bf16.cu``); both replace the TPU kernel
``repro/kernels/attention/flash.py::_kernel``, launched there by
``flash_attention_fwd``); and the backward, float32
(``csrc/flash_attention_bwd.cu``) and bfloat16
(``csrc/flash_attention_bwd_bf16.cu``); both stand beside
``repro/kernels/attention/ops.py::_bwd``, the reference's custom VJP,
which recomputes through XLA ops.

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
FWD_BF16_KERNEL = "flash_attention_fwd_bf16"
BWD_KERNEL = "flash_attention_bwd"
BWD_BF16_KERNEL = "flash_attention_bwd_bf16"
#: both forwards' entry points (flash_attention_fwd_launch, float32;
#: flash_attention_fwd_bf16_launch)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int64, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int64]
                 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_int64, ctypes.c_void_p])
_BWD_BF16_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, ctypes.c_int64, ctypes.c_void_p])
_SCRATCH_ARGTYPES = [ctypes.c_int] * 8 + [ctypes.c_int64] * 2
#: bytes the float32 backward's dq partials may take: above them it runs
#: its key tiles in chunks that fit (the same bits), but never in less than
#: one key tile needs. tinyllama-1.1b's training shape needs 1 GiB, one
#: launch; longer sequences trade time for the bound (PERF.md). The bf16
#: backward keeps no partials (a dq pass of its own)
BWD_SCRATCH_BYTES = 2 << 30


def _launcher(kernel: str, symbol: str, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load(kernel), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
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
    """One launch on the current stream (arguments checked by the caller):
    the float32 forward, or for bfloat16 the bf16 forward (computed in
    float32, rounded once). Returns the output in q's dtype, or (output,
    lse) with ``with_lse``: lse (B, Sq, H) float32 holds each row's
    log-sum-exp of its capped, masked scores (the clamped max for a fully
    masked row)."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel, symbol = ((FWD_BF16_KERNEL, "flash_attention_fwd_bf16_launch")
                      if q.dtype == torch.bfloat16 else
                      (KERNEL, "flash_attention_fwd_launch"))
    launch = _launcher(kernel, symbol, _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                     b, sq, t, h, kvh, hd, float(scale), int(bool(causal)),
                     int(window), float(attn_softcap), int(q_offset), stream)
    _raise_on(err, kernel, q, k)
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             scale: float, causal: bool, window: int,
                             attn_softcap: float, q_offset: int):
    """dq, dk, dv (the dtypes and shapes of q, k, v) of the forward that
    gave ``out`` and ``lse``, for the output gradient ``dout``, on the
    current stream. float32: a row sum D = rowsum(dout * out) in torch, then
    the float32 backward's two kernels (dk, dv and per-key-tile dq partials
    per key tile; the partials summed in a fixed order), with the partials'
    float32 scratch, of the size the library asks for within
    BWD_SCRATCH_BYTES, allocated here. bfloat16: the bf16 backward's three
    kernels (D in float32 from the bf16 out, the dk / dv pass, the dq pass),
    computed in float32 and rounded once; D's float32 buffer allocated here.
    Arguments checked by the caller."""
    if q.dtype == torch.bfloat16:
        return _bwd_bf16(q, k, v, out, lse, dout, scale=scale, causal=causal,
                         window=window, attn_softcap=attn_softcap,
                         q_offset=q_offset)
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    masks = (int(bool(causal)), int(window))
    scratch = _launcher(BWD_KERNEL, "flash_attention_bwd_scratch_floats",
                        _SCRATCH_ARGTYPES, ctypes.c_int64)
    shape = (b, sq, t, h, kvh, hd, *masks, int(q_offset))
    floats = scratch(*shape, BWD_SCRATCH_BYTES // 4)
    if floats < 0:
        raise RuntimeError(f"{BWD_KERNEL} does not take q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}")
    dsum = (dout * out).sum(-1)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dq_part = torch.empty(floats, dtype=torch.float32, device=q.device)
    launch = _launcher(BWD_KERNEL, "flash_attention_bwd_launch",
                       _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     dq_part.data_ptr(), floats, b, sq, t, h, kvh, hd,
                     float(scale), *masks, float(attn_softcap),
                     int(q_offset), stream)
    _raise_on(err, BWD_KERNEL, q, k)
    return dq, dk, dv


def _bwd_bf16(q, k, v, out, lse, dout, *, scale, causal, window,
              attn_softcap, q_offset):
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out, lse = out.contiguous(), lse.contiguous()
    if out.dtype != q.dtype or out.data_ptr() % 16:
        raise ValueError(f"{BWD_BF16_KERNEL}: the forward's output is "
                         f"{out.dtype}, or not 16-byte aligned; the kernel "
                         f"reads it in {q.dtype} 16 bytes at a time")
    dsum = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch = _launcher(BWD_BF16_KERNEL, "flash_attention_bwd_bf16_launch",
                       _BWD_BF16_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                     dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), b, sq, t, h, kvh, hd, float(scale),
                     int(bool(causal)), int(window), float(attn_softcap),
                     int(q_offset), stream)
    _raise_on(err, BWD_BF16_KERNEL, q, k)
    return dq, dk, dv
