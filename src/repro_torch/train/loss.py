"""Cross-entropy LM loss with padded-vocab masking and token masking
(port of ``repro/train/loss.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy.

    logits: (B, S, Vp) float32 (Vp = padded vocab); labels: (B, S) integer
    where label[t] is the target for position t (already shifted by the
    caller). mask: (B, S) {0, 1}, the positions that count in the loss.
    Returns (loss, metrics): loss, ppl_log, tokens, accuracy, as 0-d
    tensors.
    """
    vp = logits.shape[-1]
    # mask padded vocab columns out of the logsumexp
    col_valid = torch.arange(vp, device=logits.device) < cfg.vocab_size
    logits = torch.where(col_valid, logits, -1e30)
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = lse - gold
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        accuracy = ((logits.argmax(-1) == labels) * mask).sum() / denom
    metrics = {"loss": loss.detach(), "ppl_log": loss.detach(),
               "tokens": denom.detach(), "accuracy": accuracy}
    return loss, metrics


def shift_batch(tokens: torch.Tensor, frontend_len: int = 0):
    """inputs / labels / mask for next-token prediction.

    tokens: (B, S+1) raw stream -> inputs (B, S), labels (B, S), mask
    (B, S). With a frontend prefix of length F (VLM patches), the model's
    logit row F-1+t predicts token t+1; the caller aligns by slicing
    logits[:, F:].
    """
    inputs = tokens[:, :-1]
    labels = tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=tokens.device)
    return inputs, labels, mask
