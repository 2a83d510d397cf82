"""Plain PyTorch versions of the flash attention kernel: the dense masked
GQA attention (``models.layers.gqa_attention``) and the blocked
online-softmax formulation (``models.attention.flash_attention_blocked``,
the reference's ``flash_attention_xla``). The kernel must match both; the
blocked one is what its wrapper runs on CPU tensors."""
import torch

from repro_torch.models.attention import flash_attention_blocked
from repro_torch.models.layers import attention_scores_mask, gqa_attention


def dense_reference(q, k, v, *, scale, causal=True, window=0,
                    attn_softcap=0.0, q_offset=0):
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = attention_scores_mask(qpos, kpos, causal=causal, window=window)
    return gqa_attention(q, k, v, mask=mask, scale=scale,
                         attn_softcap=attn_softcap)


__all__ = ["dense_reference", "flash_attention_blocked"]
