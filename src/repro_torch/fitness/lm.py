"""LM-training fitness: the GA's hyperparameter search over the model zoo
(port of ``repro/fitness/lm.py``).

Genome (4 genes, in [0, 1], decoded below):
    g0 -> log10 lr      in [-4.5, -2.0]
    g1 -> beta1         in [0.80, 0.99]
    g2 -> warmup frac   in [0.0, 0.3]
    g3 -> weight decay  in [0.0, 0.3]

Fitness = the training loss of the last of ``steps`` steps of the reduced
config on the synthetic bigram stream (with the pipeline's frontend
embeddings for the VLM and audio archs, the VLM's patch rows left out of
the loss) (the loss of that step's forward,
before its update), every genome from one shared initialisation and on
the same batches. The update is the reference's own inner Adam, not
``train/optimizer.py``'s AdamW: beta2 0.95, eps 1e-8 added to sqrt(v), no
bias correction, decay ``wd * p`` added to the step of every leaf, linear
warmup over ``max(warmup_frac * steps, 1)`` steps, no clipping.

Batching: as the reference ``vmap``s one training run per genome, each
step here is one ``torch.func.vmap(torch.func.grad_and_value(loss))`` of
``functional_call`` over parameters stacked to (N, ...). Attention runs
the flash kernels (``attn_impl="kernel"``; on the CPU their plain
versions), whose vmap rules fold the runs into the kernels' batch axis:
each attention layer launches the forward and the backward kernel once a
step, whatever N. The SSM family trains through the plain chunked scan,
as the reference does. Genomes are trained in chunks sized from the
device's free memory; a run's result does not depend on its chunk.

The initialisation is drawn on the CPU from ``seed`` and moved to the
device, so a CPU rebuild (:class:`SpawnedLMFitness`, for spawned host-pool
and queue workers) starts from the card's weights.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from repro_torch.configs import get_config
from repro_torch.core.device import available_bytes, resolve_device
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.train.loss import lm_loss
from repro_torch.train.train_step import frontend_len

LM_GENE_SPEC = (
    ("log10_lr", -4.5, -2.0),
    ("beta1", 0.80, 0.99),
    ("warmup_frac", 0.0, 0.3),
    ("weight_decay", 0.0, 0.3),
)
NUM_LM_GENES = len(LM_GENE_SPEC)
BETA2, EPS = 0.95, 1e-8
# float32 values one run holds at its peak: per parameter (the parameter,
# two moments, the gradient, the update's temporaries), and per token per
# unit of width (activations saved for the backward, the logits, their
# masked copy and gradient)
PARAM_COPIES = 6
ACT_COPIES = 8


def decode_lm_genome(g01: torch.Tensor) -> dict:
    """Gene values by name from a (4,) genome in [0, 1], or per row of an
    (N, 4) batch."""
    return {name: lo + g01[..., i] * (hi - lo)
            for i, (name, lo, hi) in enumerate(LM_GENE_SPEC)}


class LMTrainFitness:
    """Callable (N, 4) genomes in [0, 1] -> (N, 1) float32 final training
    losses, on ``device``. Every run starts from ``self.model``'s
    parameters (drawn from ``seed``)."""

    def __init__(self, arch: str = "tinyllama-1.1b", *, steps: int = 8,
                 batch_size: int = 4, seq_len: int = 32, seed: int = 0,
                 device="cuda"):
        self.arch, self.steps, self.seed = arch, steps, seed
        self.batch_size, self.seq_len = batch_size, seq_len
        self.device = resolve_device(device)
        self.cfg = cfg = get_config(arch).reduced()
        init = Model(cfg, device="cpu", max_seq=seq_len + 8).init_params(
            torch.Generator().manual_seed(seed)).state_dict()
        self.model = Model(cfg, device=self.device, attn_impl="kernel",
                           use_ssd_kernel=False, max_seq=seq_len + 8)
        self.model.load_state_dict(init, strict=True)
        # aliases: loading another state dict into self.model changes them
        self._init = {n: p.detach() for n, p in
                      self.model.named_parameters()}
        data = SyntheticTokens(cfg, batch_size, seq_len, seed=seed,
                               mode="bigram")
        # each step's tokens and, where the arch has a frontend, the
        # pipeline's frontend_embeds (576 VLM patches, encoder_seq frames),
        # as the reference's batches carry them
        self._batches = [{k: torch.from_numpy(v).to(self.device)
                          for k, v in data.batch(i).items()}
                         for i in range(steps)]
        self._grad = grad_and_value(self._loss)
        self._batched_grad = vmap(self._grad, in_dims=(0, None))

    def _loss(self, params: dict, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        fl = frontend_len(self.cfg, batch)
        logits, aux = functional_call(
            self.model, params, ({**batch, "tokens": tokens[:, :-1]},))
        loss, _ = lm_loss(self.cfg, logits[:, fl:], tokens[:, 1:])
        return loss + self.cfg.router_aux_weight * aux

    def run_bytes(self) -> int:
        """Bytes one training run holds at its peak (an estimate)."""
        cfg = self.cfg
        width = (cfg.d_model + cfg.d_ff + cfg.num_heads * cfg.head_dim
                 + (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
                    if cfg.ssm_state else 0))
        fe = self._batches[0].get("frontend_embeds")
        tokens = self.batch_size * (self.seq_len
                                    + (0 if fe is None else fe.shape[1]))
        params = sum(p.numel() for p in self._init.values())
        return 4 * (PARAM_COPIES * params + ACT_COPIES * tokens
                    * ((cfg.num_layers + cfg.encoder_layers) * width
                       + cfg.padded_vocab))

    def chunk_runs(self) -> int:
        """Runs trained at once: as many as
        ``core.device.available_bytes`` holds."""
        return max(1, int(available_bytes(self.device) // self.run_bytes()))

    def _train(self, genomes: torch.Tensor, batched: bool = True):
        """Final losses (n,) of n runs, one per genome row: stacked and
        vmapped, or (``batched=False``, n = 1) one plain run."""
        n = genomes.shape[0]
        hp = decode_lm_genome(genomes.to(torch.float32))
        lr0 = 10.0 ** hp["log10_lr"]
        b1, wd = hp["beta1"], hp["weight_decay"]
        warm = torch.clamp_min(hp["warmup_frac"] * self.steps, 1.0)
        params = {k: p.expand(n, *p.shape).clone()
                  for k, p in self._init.items()}
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = None
        for i, batch in enumerate(self._batches):
            if batched:
                grads, loss = self._batched_grad(params, batch)
            else:
                grads, loss = self._grad(
                    {k: p[0] for k, p in params.items()}, batch)
                grads, loss = {k: g[None] for k, g in grads.items()}, \
                    loss[None]
            if i == self.steps - 1:
                break           # the fitness is this step's loss
            lr = lr0 * torch.clamp_max((i + 1.0) / warm, 1.0)
            for k, p in params.items():
                shape = (n,) + (1,) * (p.dim() - 1)
                g, b1k = grads.pop(k), b1.view(shape)
                m[k].mul_(b1k).add_((1 - b1k) * g)
                v[k].mul_(BETA2).add_((1 - BETA2) * g * g)
                delta = m[k] / (torch.sqrt(v[k]) + EPS) + wd.view(shape) * p
                p.sub_(lr.view(shape) * delta)
                del g, delta
        return loss

    def __call__(self, genomes: torch.Tensor) -> torch.Tensor:
        genomes = torch.as_tensor(genomes, device=self.device)
        step = self.chunk_runs()
        losses = [self._train(genomes[i:i + step])
                  for i in range(0, genomes.shape[0], step)]
        return torch.cat(losses).to(torch.float32)[:, None]

    def per_genome_loop(self, genomes: torch.Tensor) -> torch.Tensor:
        """The same (N, 1) losses, one plain run per genome: the yardstick
        the batched call is timed against."""
        genomes = torch.as_tensor(genomes, device=self.device)
        return torch.cat([self._train(genomes[i:i + 1], batched=False)
                          for i in range(genomes.shape[0])]
                         ).to(torch.float32)[:, None]


class SpawnedLMFitness:
    """numpy (N, 4) -> (N, 1) float32, picklable for spawned host-pool and
    queue workers: it carries the fitness's arguments, and each call
    rebuilds :class:`LMTrainFitness` on the CPU of the process that runs it
    (a card-resident fitness is never pickled). The initialisation is drawn
    on the CPU from the same seed, so the rebuild trains the card's
    weights."""

    def __init__(self, fit: LMTrainFitness):
        self.arch = fit.arch
        self.kwargs = dict(steps=fit.steps, batch_size=fit.batch_size,
                           seq_len=fit.seq_len, seed=fit.seed)

    def __call__(self, genomes):
        fit = LMTrainFitness(self.arch, device="cpu", **self.kwargs)
        return fit(torch.as_tensor(np.asarray(genomes, np.float32))).numpy()
