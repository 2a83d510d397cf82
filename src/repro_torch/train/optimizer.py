"""AdamW + LR schedules (cosine / WSD / const), hand-rolled (port of
``repro/train/optimizer.py``).

Parameters, gradients and moments are flat dicts {name: tensor}, the
names of ``Model.named_parameters()``; the last component of a name is the
reference's leaf name, which decides weight decay (``_decay_mask``).
Moments are float32 or, with ``moment_dtype="bfloat16"``, bfloat16; the
update is computed in float32 either way.

Where the reference returns new arrays, ``adamw_update`` updates the
parameters in place and replaces the moments leaf by leaf, so a step
holds no second copy of the parameters and moments at full width. The
schedule and the statistics stay 0-d tensors on the parameters' device,
so a step needs no host sync.

Over a mesh the leaves are this rank's blocks (``models.sharding``;
``layouts`` by name): the update is elementwise, so AdamW runs on the
blocks as they are, and ``global_norm`` sums the squares of each distinct
block once (a block several ranks hold whole, such as a norm scale on every
tp rank, counts on one of them) and then over the mesh, so the norm and the
clip scale are one rank's.

The WSD (warmup-stable-decay) schedule reproduces MiniCPM
[arXiv:2404.06395] and is selected for the minicpm configs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.sharding import ShardingCtx


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    wsd_decay_frac: float = 0.1     # last 10% of steps decay (minicpm)
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # float32 | bfloat16


def schedule_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or integer tensor), a float32
    0-d tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = 1.0 - cfg.wsd_decay_frac
        frac = torch.where(
            t < decay_start, 1.0,
            cfg.min_lr_frac + (1 - cfg.min_lr_frac)
            * (1 - (t - decay_start) / cfg.wsd_decay_frac))
    else:
        frac = torch.ones_like(t)
    return cfg.lr * warm * frac


def init_opt_state(params: Dict[str, torch.Tensor],
                   moment_dtype: str = "float32") -> dict:
    md = getattr(torch, moment_dtype)
    device = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=md, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=md, device=p.device)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict[str, torch.Tensor],
                ctx: Optional[ShardingCtx] = None,
                layouts: Optional[dict] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; over a mesh,
    of every distinct block of the leaves once."""
    layouts = layouts or {}
    total = sum(torch.sum(torch.square(g.float()))
                for n, g in tree.items()
                if n not in layouts or layouts[n].counted(ctx))
    if ctx is not None and ctx.mesh is not None:
        if not torch.is_tensor(total):
            total = torch.zeros((), device=next(iter(tree.values())).device)
        total = ctx.all_reduce(total, ctx.mesh.mesh_dim_names)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, \
        norm


def _decay_mask(name: str) -> bool:
    """Weight decay applies to matmul weights only (not norms/biases/1D):
    by the leaf name, the last component of a parameter's name."""
    return name.rsplit(".", 1)[-1] not in (
        "scale", "bias", "A_log", "D", "dt_bias", "norm_scale", "conv_bias")


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: dict,
                 ctx: Optional[ShardingCtx] = None,
                 layouts: Optional[dict] = None
                 ) -> Tuple[Dict[str, torch.Tensor], dict, dict]:
    """One AdamW step. Updates ``params`` in place and replaces the
    moments of ``state`` leaf by leaf; returns (params, new state, {"lr",
    "grad_norm"}) with the pre-clip global gradient norm. The clip scale
    is applied leaf by leaf (as ``clip_by_global_norm`` computes it), so
    no clipped copy of all the gradients is held. Over a mesh (``ctx``,
    ``layouts``) the leaves are this rank's blocks."""
    raw_norm = global_norm(grads, ctx, layouts)
    clip = _clip_scale(raw_norm, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    md = getattr(torch, cfg.moment_dtype)
    for name, p in params.items():
        g = (grads[name].float() * clip).to(grads[name].dtype).float()
        m32 = b1 * state["m"][name].float() + (1 - b1) * g
        v32 = b2 * state["v"][name].float() + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if _decay_mask(name):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        state["m"][name] = m32.to(md)
        state["v"][name] = v32.to(md)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"lr": lr, "grad_norm": raw_norm}


def optimizer_for_arch(arch_name: str, **overrides) -> OptimizerConfig:
    kw: dict = {}
    if "minicpm" in arch_name:
        kw["schedule"] = "wsd"
    kw.update(overrides)
    return OptimizerConfig(**kw)
