"""Training step: loss + grads (with microbatch accumulation), AdamW update
(port of ``repro/train/train_step.py``).

The reference's step is a pure function of (state, batch) under ``jit``;
here the parameters are the model's own (``Model.requires_grad_(True)``,
done by ``init_train_state``), the gradients come from
``torch.autograd.grad`` and ``adamw_update`` writes the new parameters in
place. ``state`` is {"params": {name: the model's parameter},
"opt": {"m", "v", "step"}, "rng"}, the reference's keys; "rng" is a 0-d
int64 seed on the device, folded with the step after every step
(``core.uniforms.fold_in``), from which the compressed pod reduce draws
(a state without it trains as well, without compression). Microbatches
are a Python loop where the reference has ``lax.scan``; the activation
peak is one microbatch's either way, and the gradients are summed in
float32.

Over a mesh (the model's ``ctx``) the parameters and moments are this
rank's blocks and the batch its block over dp (``data.pipeline.place``;
microbatch i is its block of the global microbatch i): the loss and the
MoE aux are global means, the fsdp blocks' gradients are reduced into the
blocks inside the backward, and a leaf every data rank holds whole has its
gradient summed over dp after it (``models.sharding``): the blocks'
gradients are always reduce-scattered, so ``shard_grads`` (in the
reference a hint to the partitioner that leaves the numbers as they are)
is accepted and changes nothing. ``compress_pod_reduce`` (a mesh with a "pod" axis, parameters
replicated over it: ``fsdp=("data",)``) takes each pod's gradients over
its own batch, then their int8 compressed mean over "pod"
(``train.compress``) with the metrics averaged over pods, as the
reference's ``_pod_compressed_grads``. ``reduced_train_step`` runs one
step from a fixed start, so that two devices can be compared.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core.uniforms import fold_in
from repro_torch.models.model import Model
from repro_torch.models.sharding import reduce_replicated_grads, sharded
from repro_torch.train.compress import compressed_psum_tree
from repro_torch.train.loss import lm_loss
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state, optimizer_for_arch)

_METRIC_KEYS = ("loss", "ppl_log", "tokens", "accuracy", "aux")


def frontend_len(cfg, batch=None) -> int:
    """Frontend prefix length inside the decoder stream (VLM patches)."""
    if cfg.frontend != "vision_patches":
        return 0
    if batch is not None and "frontend_embeds" in batch:
        return batch["frontend_embeds"].shape[1]
    return 576


def make_loss_fn(model: Model):
    """``loss_fn(batch) -> (total, metrics)`` with the model's current
    parameters: the LM loss of tokens[:, 1:] given tokens[:, :-1], plus
    ``router_aux_weight`` x aux; metrics loss, ppl_log, tokens, accuracy,
    aux (detached 0-d tensors)."""
    cfg = model.cfg

    def loss_fn(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        fl = frontend_len(cfg, batch)
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        fwd = {"tokens": inputs}
        if "frontend_embeds" in batch:
            fwd["frontend_embeds"] = batch["frontend_embeds"]
        logits, aux = model.forward(fwd)
        if fl:
            logits = logits[:, fl:]
        loss, metrics = lm_loss(cfg, logits, labels.to(logits.device),
                                batch.get("loss_mask"), model.ctx)
        total = loss + cfg.router_aux_weight * aux
        metrics = {**metrics, "aux": aux.detach()}
        return total, {k: metrics[k] for k in _METRIC_KEYS}

    return loss_fn


def make_compute_grads(model: Model, microbatches: int = 1):
    """``compute_grads(params, batch) -> (grads, metrics)``: the gradients
    of the loss with respect to ``params`` (the model's parameters, by
    name), averaged over ``microbatches`` equal slices of the batch and
    summed in float32, and the metrics averaged likewise. Over a mesh, the
    gradients of this rank's blocks of the global loss's."""
    loss_fn = make_loss_fn(model)

    def compute_grads(params, batch):
        grads, metrics = _grads(params, batch)
        return (reduce_replicated_grads(grads, model.layouts, model.ctx),
                metrics)

    def _grads(params, batch):
        names, leaves = list(params), list(params.values())
        if microbatches == 1:
            total, metrics = loss_fn(batch)
            grads = torch.autograd.grad(total, leaves)
            return dict(zip(names, grads)), metrics
        size = next(iter(batch.values())).shape[0]
        if size % microbatches:
            raise ValueError(f"batch of {size} does not split into "
                             f"{microbatches} microbatches")
        per = size // microbatches
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        macc = {}
        for i in range(microbatches):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            total, metrics = loss_fn(mb)
            grads = torch.autograd.grad(total, leaves)
            for acc, g in zip(gacc, grads):
                acc += g.float()
            macc = {k: macc.get(k, 0.0) + metrics[k] for k in _METRIC_KEYS}
            del total, grads
        grads = {n: g / microbatches for n, g in zip(names, gacc)}
        return grads, {k: v / microbatches for k, v in macc.items()}

    return compute_grads


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1,
                    compress_pod_reduce: bool = False,
                    shard_grads: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: gradients, then
    one AdamW update of the parameters in place. metrics: the loss metrics
    and ``lr`` and ``grad_norm`` (pre-clip). ``shard_grads`` is accepted
    as the reference's and changes nothing: the fsdp blocks' gradients are
    always reduce-scattered into the blocks. Without a "pod" axis
    ``compress_pod_reduce`` changes nothing, as in the reference."""
    del shard_grads
    ctx = model.ctx
    inner = model
    pods = (compress_pod_reduce and sharded(ctx)
            and "pod" in ctx.mesh.mesh_dim_names)
    if pods:
        if "pod" in ctx.fsdp:
            raise ValueError(
                "compress_pod_reduce needs the parameters replicated over "
                "the pod axis (fsdp without 'pod', as fsdp=('data',))")
        inner = inner.with_ctx(dataclasses.replace(
            inner.ctx, dp=tuple(a for a in ctx.dp if a != "pod")))
    compute_grads = make_compute_grads(inner, microbatches)

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = compute_grads(params, batch)
        if pods:
            grads = compressed_psum_tree(grads, "pod", int(state["rng"]),
                                         ctx, model.layouts)
            keys = list(metrics)
            mean = ctx.all_reduce(torch.stack([metrics[k] for k in keys]),
                                  "pod") / ctx.axes_size("pod")
            metrics = dict(zip(keys, mean.unbind()))
        params, new_opt, stats = adamw_update(opt_cfg, params, grads,
                                              state["opt"], ctx,
                                              model.layouts)
        del grads
        new = {"params": params, "opt": new_opt}
        if "rng" in state:
            new["rng"] = fold_in(state["rng"], state["opt"]["step"])
        return new, {**metrics, **stats}

    return train_step


def init_train_state(model: Model, generator: torch.Generator,
                     moment_dtype: str = "float32") -> dict:
    """Random parameters from ``generator`` (``Model.init_params``; over a
    mesh this rank's blocks of them), made trainable, zero AdamW moments
    and the "rng" seed: ``train_rng(generator.initial_seed(), 0)`` on the
    model's device."""
    model.init_params(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": init_opt_state(params, moment_dtype),
            "rng": train_rng(generator.initial_seed(), 0).to(model.device)}


def train_state_shapes(model: Model, moment_dtype: str = "float32") -> dict:
    """``init_train_state``'s state as ``meta`` tensors, allocating nothing
    (the reference's ``eval_shape`` of its ``init_train_state``): the
    parameters' shapes (``Model.param_shapes``), both moments in
    ``moment_dtype``, the int32 step and the 0-d int64 "rng" (the
    reference's is a (2,) uint32 key)."""
    params = model.param_shapes()
    return {"params": params, "opt": init_opt_state(params, moment_dtype),
            "rng": torch.empty((), dtype=torch.int64, device="meta")}


def train_rng(seed: int, step: int) -> torch.Tensor:
    """The state's "rng" before step ``step`` of a run from ``seed`` (a 0-d
    int64 CPU tensor): ``fold_in(seed, 1)``, as the reference's
    ``init_train_state``, then folded with each earlier step."""
    rng = torch.tensor(fold_in(seed, 1), dtype=torch.int64)
    for k in range(step):
        rng = fold_in(rng, k)
    return rng


def reduced_train_step(arch: str, device, *, microbatches: int = 1,
                       batch: int = 4, seq: int = 64, **model_kw):
    """One gradient evaluation and one train step of ``arch``'s reduced
    config on ``device``, attention through the flash kernels
    (``attn_impl="kernel"``; ``model_kw`` adds ``Model`` switches such as
    ``moe_impl`` or ``remat``), from parameters drawn on the CPU from seed
    0, tokens (batch, seq + 1) from seed 3 and, where the arch has a
    frontend, its embeddings from seed 4 (scaled by 0.02, as
    ``data.pipeline`` draws them): a VLM's (batch, 16, d) patches (as
    ``launch.train`` gives a reduced VLM), an encoder-decoder's (batch,
    encoder_seq, d) frames. Every device starts from the same state.
    Returns (step-1 grads, metrics as floats, parameters after the step),
    all on the CPU."""
    cfg = get_config(arch).reduced()
    init = Model(cfg, device="cpu", max_seq=seq + 8).init_params(
        torch.Generator().manual_seed(0))
    model = Model(cfg, device=device, attn_impl="kernel", max_seq=seq + 8,
                  **model_kw)
    model.load_state_dict(init.state_dict())
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": init_opt_state(params)}
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    data = {"tokens": toks.to(model.device)}
    if cfg.frontend != "none":
        fs = 16 if cfg.frontend == "vision_patches" else cfg.encoder_seq
        fe = torch.randn((batch, fs, cfg.d_model),
                         generator=torch.Generator().manual_seed(4)) * 0.02
        data["frontend_embeds"] = fe.to(model.device)
    grads, _ = make_compute_grads(model, microbatches)(params, data)
    grads = {n: g.cpu() for n, g in grads.items()}
    step = make_train_step(model, optimizer_for_arch(
        arch, lr=1e-3, warmup_steps=1, total_steps=10),
        microbatches=microbatches)
    _, metrics = step(state, data)
    return (grads, {k: float(v) for k, v in metrics.items()},
            {n: p.detach().cpu() for n, p in params.items()})
