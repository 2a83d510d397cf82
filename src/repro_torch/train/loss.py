"""Cross-entropy LM loss with padded-vocab masking and token masking
(port of ``repro/train/loss.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import ShardingCtx


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            ctx: Optional[ShardingCtx] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy.

    logits: (B, S, Vp) float32 (Vp = padded vocab); labels: (B, S) integer
    where label[t] is the target for position t (already shifted by the
    caller). mask: (B, S) {0, 1}, the positions that count in the loss.
    Returns (loss, metrics): loss, ppl_log, tokens, accuracy, as 0-d
    tensors.

    Over a mesh (``ctx``) the rows are this rank's block over dp and, where
    ``logits`` has fewer than Vp columns, the columns its block of the
    vocab over tp: the logsumexp takes its max and sum over tp, the padded
    columns are masked by their global index, and the argmax of
    ``accuracy`` is the (largest value, lowest global index) over tp, as
    ``jnp.argmax`` picks the first of ties. The numerator and the token
    count are summed over dp before the division, so the loss is the mean
    over the global tokens, as the reference's.
    """
    ctx = ctx or ShardingCtx()
    vp = logits.shape[-1]
    split = vp != cfg.padded_vocab
    lo = ctx.rows(cfg.padded_vocab, ctx.tp)[0] if split else 0
    # mask padded vocab columns out of the logsumexp
    col = lo + torch.arange(vp, device=logits.device)
    logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    labels = labels.long()
    tp = ctx.tp if split else None
    tp_sum = ctx.tp_g if split else (lambda x: x)
    m = ctx.all_reduce(logits.detach().amax(-1), tp, "max")
    lse = m + torch.log(tp_sum(torch.exp(logits - m[..., None]).sum(-1)))
    local = labels - lo
    inb = (local >= 0) & (local < vp)
    gold = torch.take_along_dim(logits, local.clamp(0, vp - 1)[..., None],
                                dim=-1)[..., 0]
    nll = lse - tp_sum(torch.where(inb, gold, 0.0))
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.float()
    with torch.no_grad():
        arg = logits.argmax(-1)
        if split:
            best = torch.take_along_dim(logits, arg[..., None], -1)[..., 0]
            top = ctx.all_reduce(best, tp, "max")
            arg = ctx.all_reduce(torch.where(best == top, arg + lo,
                                             cfg.padded_vocab), tp, "min")
        hits = ((arg == labels) * mask).sum()
    num, den, hits = ctx.dp_g(torch.stack([(nll * mask).sum(),
                                           mask.sum(), hits]))
    denom = torch.clamp_min(den, 1.0).detach()
    loss = num / denom
    metrics = {"loss": loss.detach(), "ppl_log": loss.detach(),
               "tokens": denom, "accuracy": (hits / denom).detach()}
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
