"""Blocked online-softmax attention and the attention implementation switch
(port of ``repro/models/attention.py``).

``flash_attention_blocked`` is the reference's ``flash_attention_xla``: the
flash algorithm in framework ops, a Python loop over KV blocks with running
(max, denom, acc). It is also the plain version of the CUDA flash kernel
(``repro_torch.kernels.attention``), which computes the same function.

Numerics: scores/softmax in float32 with the clamped-max trick, so fully
masked rows (sliding-window early blocks, a q_offset past every key)
produce zeros, not NaNs.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (attention_scores_mask, gqa_attention,
                                       softcap)

_MIN = -0.7 * torch.finfo(torch.float32).max

IMPLS = ("auto", "dense", "blocked", "kernel")


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float,
                            causal: bool = True, window: int = 0,
                            attn_softcap: float = 0.0, q_offset: int = 0,
                            block: int = 1024, return_lse: bool = False):
    """q: (B, Sq, H, hd); k/v: (B, T, KV, hd) -> (B, Sq, H, hd), q's dtype.

    The reference's ``flash_attention_xla``, with the KV blocks walked by a
    Python loop (the last block may be shorter; the reference pads it with
    masked keys, which contribute nothing). With ``return_lse`` it returns
    (out, lse): lse (B, Sq, H) float32 is each row's log-sum-exp,
    max(m, clamp) + log(l), the clamped max for a fully masked row (what
    the flash kernel's optional lse output holds)."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    block = min(block, t)
    dev = q.device
    qg = (q.float() * scale).reshape(b, sq, kvh, g, hd)
    qpos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, kvh, g, sq), -torch.inf, device=dev)
    l = torch.zeros((b, kvh, g, sq), device=dev)
    acc = torch.zeros((b, kvh, g, sq, hd), device=dev)
    for start in range(0, t, block):
        kblk = k[:, start:start + block].float()
        vblk = v[:, start:start + block].float()
        kp = torch.arange(start, start + kblk.shape[1], device=dev)
        s = softcap(torch.einsum("bskgd,btkd->bkgst", qg, kblk),
                    attn_softcap)
        rel = qpos[:, None] - kp[None, :]
        msk = torch.ones(rel.shape, dtype=torch.bool, device=dev)
        if causal:
            msk &= rel >= 0
        if window:
            msk &= rel < window
        s = torch.where(msk, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = m_new.clamp_min(_MIN)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m.clamp_min(_MIN) - m_safe)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                   vblk)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = m.clamp_min(_MIN) + torch.log(l_safe)
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


def attend(q, k, v, *, scale, causal=True, window=0, attn_softcap=0.0,
           q_offset=0, impl="auto", block=1024):
    """Dispatch between the dense reference, the blocked path and the
    flash kernel.

    impl: "auto" (blocked when T > 2*block, else dense), "dense",
    "blocked", "kernel" (``kernels.attention.ops.flash_attention``: the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors; under
    autograd its gradient is the backward kernel, or on the CPU that
    kernel's plain version). An error of the kernel reaches the caller;
    nothing falls back.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; use one of "
                         f"{IMPLS}")
    t = k.shape[1]
    if impl == "kernel":
        from repro_torch.kernels.attention import ops as attn_ops
        return attn_ops.flash_attention(
            q, k, v, scale=scale, causal=causal, window=window,
            attn_softcap=attn_softcap, q_offset=q_offset)
    if impl == "auto":
        impl = "blocked" if t > 2 * block else "dense"
    if impl == "blocked":
        return flash_attention_blocked(
            q, k, v, scale=scale, causal=causal, window=window,
            attn_softcap=attn_softcap, q_offset=q_offset, block=block)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(t, device=q.device)
    mask = attention_scores_mask(qpos, kpos, causal=causal, window=window)
    return gqa_attention(q, k, v, mask=mask, scale=scale,
                         attn_softcap=attn_softcap)
