"""Public wrapper for the flash attention forward kernel.

``flash_attention(q, k, v, *, scale, causal, window, attn_softcap,
q_offset)`` takes q (B, Sq, H, hd) and k/v (B, T, KV, hd) and returns
(B, Sq, H, hd) in q's dtype.

* On CPU tensors it runs the plain version (``ref.flash_attention_blocked``).
* On CUDA tensors it checks dtype (float32 or bfloat16, the same for all
  three), shapes (hd in 32/64/128/256, H a multiple of KV), contiguity and
  16-byte alignment,
  then launches the CUDA kernel or raises. Nothing falls back.

Forward only: the kernel has no backward yet, so the wrapper refuses
tensors that require a gradient while autograd records (the training
path, with a backward kernel, is a later port).

``launches`` counts the kernel launches of this process; it grows only
where the kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.flash import flash_attention_fwd_cuda
from repro_torch.kernels.attention.ref import flash_attention_blocked

launches = 0

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


#: The plain PyTorch version, on any device: what the wrapper runs on the
#: CPU, and what the kernel is held against on the card.
flash_attention_plain = flash_attention_blocked


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be "
                         f"(B, Sq, H, hd) and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} both (B, T, KV, hd)")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match (same B and hd, "
                         f"H a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or \
                t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}; the kernel takes float32 or "
                             f"bfloat16, the same for q, k, v, on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the kernel copies 16-byte rows)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the kernel is forward only; "
                           "run it under torch.no_grad() or "
                           "torch.inference_mode()")


def flash_attention(q, k, v, *, scale, causal=True, window=0,
                    attn_softcap=0.0, q_offset=0):
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window,
                                     attn_softcap=attn_softcap,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check(q, k, v)
    out = flash_attention_fwd_cuda(q, k, v, scale=scale, causal=causal,
                                   window=window, attn_softcap=attn_softcap,
                                   q_offset=q_offset)
    launches += 1
    return out
