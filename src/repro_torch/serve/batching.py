"""Continuous batching for LM serving (port of ``repro/serve/batching.py``):
the paper's shared-queue broker applied to inference ("any idle worker
pulls the next message" -> "any free decode slot admits the next
request").

A fixed pool of ``slots`` decode lanes runs one decode tick per step. The
pool is one cache of batch ``slots`` (the reference stacks one
single-sequence cache per lane); each lane has its own position, so lanes
are at different depths, and a tick is one ``Model.decode_step`` over all
lanes with a (slots,) position tensor (per-lane rope angles, ring slots
and cache positions; an MoE layer dispatches each lane as its own group).
Finished sequences free their lane at once; a queued request is admitted
by a prefill at batch 1 whose whole cache (k, v and ``cache_pos``, or the
Mamba-2 conv and SSM state) overwrites the freed lane, so nothing of the
lane's previous request stays visible. As on the GA side, dynamic queue
semantics become static shapes: the tick always runs every lane, and
inactive lanes are ignored on the host. The one host read a tick is the
(slots,) next tokens; an admission reads its first token.

The batcher runs where the model lives (``model.device``). Requests are
token prompts only: an arch with a frontend (VLM patches, whisper frames)
is refused, as the reference's batcher cannot prefill one either (it
passes no ``frontend_embeds``). A model over a device mesh is refused:
``Model.decode_step`` serves a mesh at one position for the batch.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.sharding import sharded


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) integer token ids
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: only max_new_tokens terminates
    out: Optional[List[int]] = None


def _write_lane(pool, lane, slot: int) -> None:
    """Overwrite lane ``slot`` of the pool cache with a batch-1 cache of
    the same structure, leaf by leaf (a (T_cache,) ``cache_pos`` into the
    pool's (slots, T_cache) row)."""
    if isinstance(pool, dict):
        for key in pool:
            _write_lane(pool[key], lane[key], slot)
    elif isinstance(pool, list):
        for p, c in zip(pool, lane):
            _write_lane(p, c, slot)
    else:
        pool[slot].copy_(lane[0] if lane.ndim == pool.ndim else lane)


class ContinuousBatcher:
    @torch.inference_mode()
    def __init__(self, model: Model, *, slots: int = 4,
                 max_cache_len: int = 256):
        if model.cfg.frontend != "none":
            raise NotImplementedError(
                f"{model.cfg.name}: the continuous batcher takes token "
                f"prompts only, not a {model.cfg.frontend} frontend")
        if sharded(model.ctx):
            raise NotImplementedError(
                "the continuous batcher over a device mesh is not ported "
                "(lanes at their own positions need a cache block per "
                "lane); see ROADMAP.md")
        self.model = model
        self.slots = slots
        self.max_cache_len = max_cache_len
        dev = model.device
        self.cache = model.init_cache(slots, max_cache_len)
        for layers in self.cache.values():
            for layer in layers:
                if "attn" in layer:          # one row of positions a lane
                    cp = layer["attn"]["cache_pos"]
                    layer["attn"]["cache_pos"] = cp.expand(
                        slots, cp.shape[0]).clone()
        self.cur_tok = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self.active: Dict[int, Request] = {}            # slot -> request
        self.remaining = np.zeros(slots, np.int64)
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    @torch.inference_mode()
    def _admit(self):
        model = self.model
        vocab = model.cfg.vocab_size
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            s = len(req.prompt)
            prompt = torch.as_tensor(np.asarray(req.prompt),
                                     device=model.device)[None]
            logits, lane = model.prefill({"tokens": prompt},
                                         self.max_cache_len)
            _write_lane(self.cache, lane, slot)
            tok = torch.argmax(logits[0, -1, :vocab])
            self.cur_tok[slot, 0] = tok
            self.pos[slot] = s
            req.out.append(int(tok))
            self.remaining[slot] = req.max_new_tokens - 1
            self.active[slot] = req

    @torch.inference_mode()
    def step(self):
        """One decode tick across all lanes."""
        logits, self.cache = self.model.decode_step(self.cache, self.cur_tok,
                                                    self.pos)
        nxt = torch.argmax(logits[:, -1, :self.model.cfg.vocab_size], dim=-1)
        nxt_host = nxt.cpu().numpy()
        self.cur_tok = nxt[:, None]
        self.pos = self.pos + 1
        finished = []
        for slot, req in list(self.active.items()):
            tok = int(nxt_host[slot])
            req.out.append(tok)
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0 or tok == req.eos_id:
                finished.append(slot)
        for slot in finished:
            self.done.append(self.active.pop(slot))
        self._admit()

    def run(self, max_ticks: int = 1000) -> List[Request]:
        self._admit()
        t = 0
        while self.active or self.queue:
            if t >= max_ticks:
                break
            self.step()
            t += 1
        return self.done
