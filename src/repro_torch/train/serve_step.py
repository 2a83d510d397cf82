"""Serving steps: prefill, decode, and a simple generate loop (port of
``repro/train/serve_step.py``).

Greedy decoding takes the argmax over the real vocabulary
(``[:vocab_size]``, never the padding); temperature sampling draws through
an explicit ``torch.Generator``. The steps run under
``torch.inference_mode()``. A batch may carry ``frontend_embeds`` (VLM
patches, whisper frames), which the prefill hands to the model; decoding
starts after a VLM's patch prefix, as the reference's ``generate`` starts
it (``train_step.frontend_len``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import Model
from repro_torch.train.train_step import frontend_len


def make_prefill_step(model: Model, max_cache_len: int):
    @torch.inference_mode()
    def prefill_step(batch):
        """batch: ``tokens`` (B, S) and, where the model has a frontend,
        ``frontend_embeds``."""
        logits, cache = model.prefill(batch, max_cache_len)
        next_tok = torch.argmax(logits[:, -1, :model.cfg.vocab_size], dim=-1)
        return next_tok, logits, cache
    return prefill_step


def make_decode_step(model: Model, *, temperature: float = 0.0):
    @torch.inference_mode()
    def decode_step(cache, tokens, pos: int,
                    generator: Optional[torch.Generator] = None):
        logits, cache = model.decode_step(cache, tokens, pos)
        logit = logits[:, -1, :model.cfg.vocab_size]
        if temperature > 0:
            probs = torch.softmax(logit / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(logit, dim=-1)
        return next_tok[:, None], logits, cache
    return decode_step


def generate(model: Model, batch, *, steps: int, max_cache_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             timings: Optional[dict] = None) -> torch.Tensor:
    """Greedy/temperature generation (host loop). Returns (B, steps) token
    ids: the prefill's next token, then ``steps - 1`` decoded ones.

    ``timings``, where given, receives ``logits_finite`` (every logit of
    the prefill and the decode steps is finite; one host sync at the end)
    and, where the model is on the GPU, ``prefill_ms`` and
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
    if timed:
        ev[2].record()
        ev[2].synchronize()
        timings["prefill_ms"] = ev[0].elapsed_time(ev[1])
        timings["decode_ms_per_token"] = (ev[1].elapsed_time(ev[2])
                                          / max(steps - 1, 1))
    return torch.cat(out, dim=1)
