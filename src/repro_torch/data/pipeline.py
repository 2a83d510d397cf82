"""Synthetic token pipeline (port of ``repro/data/pipeline.py``).

Deterministic per-step batches (seeded by (seed, step)) in two modes:

* ``uniform`` — i.i.d. tokens; for shape/perf work.
* ``bigram``  — a fixed random bigram chain, so a model trained on it
  shows decreasing loss.

Batches are numpy arrays drawn exactly as the reference draws them, so both
packages give identical batches from one seed. ``place`` (the reference's
``SyntheticTokens.place``, a function here) puts a batch on the device,
and over a mesh keeps this rank's block of it over dp (every rank draws
the whole batch: the single-process stand-in for per-host loading, as the
reference's).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import ShardingCtx


def place(batch: Dict[str, np.ndarray], ctx: ShardingCtx, device,
          microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """Every array of ``batch`` as a tensor on ``device``; over a mesh, this
    rank's rows over the dp axes (``tokens``, ``frontend_embeds``,
    ``loss_mask``: every leading dim is the batch). With ``microbatches``
    the rows are this rank's block of each global microbatch in turn, so
    that the train step's microbatch i is its block of the reference's
    microbatch i. Raises where the batch does not split evenly (the
    reference's ``device_put`` needs it; the MoE dispatch groups are the
    data blocks)."""
    out = {}
    dp = ctx.dp_size
    for key, value in batch.items():
        x = torch.as_tensor(value)
        if ctx.mesh is not None and dp > 1:
            b = x.shape[0]
            if b % (dp * microbatches):
                raise ValueError(
                    f"place: {key} has a batch of {b}, which does not split "
                    f"into {microbatches} microbatch(es) over {dp} data "
                    f"ranks")
            per = b // microbatches
            x = torch.cat([ctx.cs(m, ctx.dp_spec)
                           for m in x.split(per)])
        out[key] = x.to(device)
    return out


class SyntheticTokens:
    def __init__(self, cfg: ModelConfig, batch_size: int, seq_len: int, *,
                 seed: int = 0, mode: str = "bigram",
                 frontend_seq: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.mode = mode
        self.frontend_seq = frontend_seq
        if mode == "bigram":
            rng = np.random.default_rng(seed)
            # sparse-ish bigram: each token has 4 plausible successors
            self._succ = rng.integers(
                0, cfg.vocab_size, size=(cfg.vocab_size, 4), dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch_size, self.seq_len
        if self.mode == "uniform":
            toks = rng.integers(0, self.cfg.vocab_size, size=(b, s + 1))
        else:
            toks = np.empty((b, s + 1), np.int64)
            toks[:, 0] = rng.integers(0, self.cfg.vocab_size, size=b)
            choice = rng.integers(0, 4, size=(b, s))
            for t in range(s):
                toks[:, t + 1] = self._succ[toks[:, t], choice[:, t]]
        out: Dict[str, np.ndarray] = {"tokens": toks.astype(np.int32)}
        if self.cfg.frontend != "none":
            fs = self.frontend_seq or (576 if self.cfg.frontend == "vision_patches"
                                       else self.cfg.encoder_seq)
            out["frontend_embeds"] = rng.standard_normal(
                (b, fs, self.cfg.d_model), dtype=np.float32) * 0.02
        return out
