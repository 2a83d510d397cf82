"""Plain PyTorch versions of the flash attention kernels.

Forward: the dense masked GQA attention (``models.layers.gqa_attention``)
and the blocked online-softmax formulation
(``models.attention.flash_attention_blocked``, the reference's
``flash_attention_xla``). The kernel must match both; the blocked one is
what its wrapper runs on CPU tensors. ``flash_attention_fwd_plain`` adds
the per-row log-sum-exp that the training path saves.

Backward: ``flash_attention_bwd_plain`` does the backward kernel's
arithmetic in torch ops, blockwise over keys: P recomputed from q, k and
the saved lse, D = rowsum(dO * O), dS = P (dP - D) times the softcap's
derivative. It is what the wrapper's backward runs on CPU tensors and
what the kernel is held against on the card.
"""
import torch

from repro_torch.models.attention import flash_attention_blocked
from repro_torch.models.layers import (attention_scores_mask, gqa_attention,
                                       softcap)


def dense_reference(q, k, v, *, scale, causal=True, window=0,
                    attn_softcap=0.0, q_offset=0):
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = attention_scores_mask(qpos, kpos, causal=causal, window=window)
    return gqa_attention(q, k, v, mask=mask, scale=scale,
                         attn_softcap=attn_softcap)


def flash_attention_fwd_plain(q, k, v, *, scale, causal=True, window=0,
                              attn_softcap=0.0, q_offset=0, block=1024):
    """(out, lse): the blocked forward and each row's log-sum-exp, lse
    (B, Sq, H) float32 (the clamped max for a fully masked row)."""
    return flash_attention_blocked(q, k, v, scale=scale, causal=causal,
                                   window=window, attn_softcap=attn_softcap,
                                   q_offset=q_offset, block=block,
                                   return_lse=True)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, scale,
                              causal=True, window=0, attn_softcap=0.0,
                              q_offset=0, block=1024):
    """dq, dk, dv of flash attention for the output gradient ``dout``, from
    the forward's ``out`` and ``lse`` (``flash_attention_fwd_plain``).
    q, out, dout (B, Sq, H, hd), k/v (B, T, KV, hd), lse (B, Sq, H). Float32
    arithmetic; the gradients come back in the dtypes of q, k, v. dk and dv
    sum over the H / KV query heads of each KV head; a fully masked row
    gets zero gradients."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device

    def rows(x):                      # (B, Sq, H, hd) -> (B, Sq, KV, G, hd)
        return x.float().reshape(b, sq, kvh, g, hd)

    qg, dog = rows(q), rows(dout)
    dsum = (dog * rows(out)).sum(-1).permute(0, 2, 3, 1)     # (B, KV, G, Sq)
    lse = lse.float().reshape(b, sq, kvh, g).permute(0, 2, 3, 1)
    qpos = q_offset + torch.arange(sq, device=dev)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for start in range(0, t, block):
        kblk = k[:, start:start + block].float()
        vblk = v[:, start:start + block].float()
        kp = torch.arange(start, start + kblk.shape[1], device=dev)
        s = softcap(torch.einsum("bskgd,btkd->bkgst", qg, kblk) * scale,
                    attn_softcap)
        rel = qpos[:, None] - kp[None, :]
        msk = torch.ones(rel.shape, dtype=torch.bool, device=dev)
        if causal:
            msk &= rel >= 0
        if window:
            msk &= rel < window
        p = torch.exp(torch.where(msk, s, -torch.inf) - lse[..., None])
        dp = torch.einsum("bskgd,btkd->bkgst", dog, vblk)
        ds = p * (dp - dsum[..., None])
        if attn_softcap:
            ds = ds * (1.0 - (s / attn_softcap) ** 2)
        dvs.append(torch.einsum("bkgst,bskgd->btkd", p, dog))
        dks.append(torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale)
        dq += torch.einsum("bkgst,btkd->bskgd", ds, kblk) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype),
            torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype))


__all__ = ["dense_reference", "flash_attention_blocked",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain"]
