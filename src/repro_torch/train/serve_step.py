"""Serving steps: prefill, decode, and a simple generate loop (port of
``repro/train/serve_step.py``).

Greedy decoding takes the argmax over the real vocabulary
(``[:vocab_size]``, never the padding); temperature sampling draws through
an explicit ``torch.Generator``. The steps run under
``torch.inference_mode()``. A batch may carry ``frontend_embeds`` (VLM
patches, whisper frames), which the prefill hands to the model; decoding
starts after a VLM's patch prefix, as the reference's ``generate`` starts
it (``train_step.frontend_len``).

Over a device mesh (the model's ``ctx``, ``make_serve_ctx``) each rank
holds its block of the batch and of the logits' vocab. A greedy token is
the argmax over the whole real vocabulary: each rank takes the max of its
block and its lowest index, then the ranks of a tp group gather those
pairs (one all-gather) and take the max and, among the ranks that hold it,
the lowest index, as ``torch.argmax`` over the whole row does. Temperature sampling gathers
the whole probability rows of the whole batch and draws from the same
generator on every rank, so every rank draws one rank's tokens and keeps
its rows. Every rank of a tp group thus feeds the same token back, and
``generate`` returns this rank's block of the batch's tokens.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import Model
from repro_torch.train.train_step import frontend_len


def greedy(model: Model, logits: torch.Tensor) -> torch.Tensor:
    """(B,) argmax of (B, V) logits over the real vocabulary; over a mesh
    whose tp axis splits the vocab, of the whole row from every rank's
    block (ties to the lower index)."""
    v, block = model.cfg.vocab_size, model.logits_block()
    if block is None:
        return torch.argmax(logits[:, :v], dim=-1)
    ctx, (lo, hi) = model.ctx, block
    real = logits[:, :max(min(hi, v) - lo, 0)]
    if real.shape[1]:
        idx = torch.argmax(real, dim=-1) + lo
        best = real.gather(1, (idx - lo)[:, None])[:, 0]
    else:
        best = logits.new_full(logits.shape[:1], -torch.inf)
        idx = torch.full(logits.shape[:1], v, device=logits.device)
    # every tp rank's (max, its index) in one gather; float64 holds both
    # exactly
    pairs = ctx.gather(torch.stack([best.double(), idx.double()], -1)[None],
                       ctx.tp_size, ctx.tp, 0)
    top = pairs[..., 0].amax(0)
    return torch.where(pairs[..., 0] == top, pairs[..., 1],
                       torch.inf).amin(0).long()


def sample(model: Model, logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B,) tokens drawn from softmax(logits / temperature) over the real
    vocabulary; over a mesh from the whole rows of the whole batch (every
    rank draws alike), this rank's rows kept."""
    ctx = model.ctx
    if model.logits_block() is not None:
        logits = ctx.gather(logits, model.cfg.padded_vocab, ctx.tp, 1)
    dp = ctx.live(ctx.dp)
    if dp:
        rows = logits.shape[0] * ctx.axes_size(dp)
        logits = ctx.gather(logits, rows, dp, 0)
    probs = torch.softmax(logits[:, :model.cfg.vocab_size] / temperature,
                          dim=-1)
    tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return ctx.cs(tok, dp) if dp else tok


def make_prefill_step(model: Model, max_cache_len: int):
    @torch.inference_mode()
    def prefill_step(batch):
        """batch: ``tokens`` (B, S) and, where the model has a frontend,
        ``frontend_embeds``."""
        logits, cache = model.prefill(batch, max_cache_len)
        return greedy(model, logits[:, -1]), logits, cache
    return prefill_step


def make_decode_step(model: Model, *, temperature: float = 0.0):
    @torch.inference_mode()
    def decode_step(cache, tokens, pos: int,
                    generator: Optional[torch.Generator] = None):
        logits, cache = model.decode_step(cache, tokens, pos)
        if temperature > 0:
            next_tok = sample(model, logits[:, -1], temperature, generator)
        else:
            next_tok = greedy(model, logits[:, -1])
        return next_tok[:, None], logits, cache
    return decode_step


def generate(model: Model, batch, *, steps: int, max_cache_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             timings: Optional[dict] = None) -> torch.Tensor:
    """Greedy/temperature generation (host loop). Returns (B, steps) token
    ids: the prefill's next token, then ``steps - 1`` decoded ones (over a
    mesh, this rank's rows).

    ``timings``, where given, receives ``logits_finite`` (every logit of
    the prefill and the decode steps is finite; one host sync at the end),
    ``cache_bytes`` (the bytes of the cache, this rank's block over a
    mesh) and, where the model is on the GPU, ``prefill_ms`` and
    ``decode_ms_per_token`` measured with CUDA events.
    """
    if generator is None and temperature > 0:
        generator = torch.Generator(device=model.device).manual_seed(0)
    prefill = make_prefill_step(model, max_cache_len)
    decode = make_decode_step(model, temperature=temperature)
    timed = timings is not None and model.device.type == "cuda"
    if timed:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    tok, logits, cache = prefill(batch)
    finite = torch.isfinite(logits).all()
    if timed:
        ev[1].record()
    pos = batch["tokens"].shape[1] + frontend_len(model.cfg, batch)
    out = [tok[:, None]]
    cur = tok[:, None]
    for i in range(steps - 1):
        cur, logits, cache = decode(cache, cur, pos + i, generator)
        finite &= torch.isfinite(logits).all()
        out.append(cur)
    if timings is not None:
        timings["logits_finite"] = bool(finite)
        timings["cache_bytes"] = _nbytes(cache)
    if timed:
        ev[2].record()
        ev[2].synchronize()
        timings["prefill_ms"] = ev[0].elapsed_time(ev[1])
        timings["decode_ms_per_token"] = (ev[1].elapsed_time(ev[2])
                                          / max(steps - 1, 1))
    return torch.cat(out, dim=1)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.nbytes
