"""Input stand-ins and shardings for every dry-run cell (the port of
``repro/launch/specs.py``).

A stand-in is a ``meta`` tensor, the port's ``ShapeDtypeStruct``: it has
a shape and a dtype and allocates nothing, so describing a cell of a
398B-parameter model is pure metadata work. A sharding is a
``ShardingCtx.named(...)`` placement list (one DTensor placement per mesh
dim; None without a mesh). Parameters and caches keep the port's layout:
one entry per layer (``Model.param_shapes``, ``Model.cache_shapes``),
where the reference stacks layers over periods.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import Model
from repro_torch.models.sharding import (ShardingCtx, cache_shardings,
                                         param_shardings)
from repro_torch.train.train_step import train_state_shapes

VLM_PATCHES = 576           # llava anyres base grid (24 x 24)


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_seq_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token positions inside the decoder stream for this cell."""
    if cfg.frontend == "vision_patches":
        return shape.seq_len - VLM_PATCHES
    return shape.seq_len


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardingCtx,
                *, train: bool, compute_dtype=torch.bfloat16):
    """(stand-in batch, placements batch) for fwd/train/prefill."""
    b = shape.global_batch
    s = token_seq_len(cfg, shape)
    batch = {"tokens": sds((b, s + (1 if train else 0)), torch.int32)}
    shard = {"tokens": ctx.named(ctx.dp_spec, None)}
    if cfg.frontend == "vision_patches":
        batch["frontend_embeds"] = sds((b, VLM_PATCHES, cfg.d_model),
                                       compute_dtype)
        shard["frontend_embeds"] = ctx.named(ctx.dp_spec, None, None)
    elif cfg.is_encoder_decoder:
        batch["frontend_embeds"] = sds((b, cfg.encoder_seq, cfg.d_model),
                                       compute_dtype)
        shard["frontend_embeds"] = ctx.named(ctx.dp_spec, None, None)
    return batch, shard


def train_specs(model: Model, moment_dtype: str = "float32"):
    """(state stand-ins, state placements) for train_step."""
    ctx = model.ctx
    shapes = train_state_shapes(model, moment_dtype)
    p_sh = param_shardings(shapes["params"], ctx)
    rep = ctx.named()
    opt_sh = {"m": p_sh, "v": p_sh, "step": rep}
    return shapes, {"params": p_sh, "opt": opt_sh, "rng": rep}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model: Model):
    """(cache stand-ins, cache placements, tokens stand-in, tokens
    placements, pos stand-in)."""
    ctx = model.ctx
    b = shape.global_batch
    cache = model.cache_shapes(b, shape.seq_len, dtype=model.compute_dtype)
    c_sh = cache_shardings(cache, ctx)
    tokens = sds((b, 1), torch.int32)
    tok_sh = ctx.named(ctx.dp_spec, None)
    pos = sds((), torch.int32)
    return cache, c_sh, tokens, tok_sh, pos


def input_specs(arch, shape, ctx: Optional[ShardingCtx] = None,
                model: Optional[Model] = None):
    """Public stand-in factory (the multi-pod dry-run contract): every
    model input for the given (arch x shape) cell as ``meta`` tensors,
    shardable, no device allocation.

    Returns a dict: train -> {"batch", "batch_shardings"}; prefill -> same;
    decode -> {"cache", "cache_shardings", "tokens", "tokens_sharding",
    "pos"}.
    """
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    ctx = ctx or ShardingCtx()
    if shp.kind in ("train", "prefill"):
        batch, sh = batch_specs(cfg, shp, ctx, train=shp.kind == "train")
        return {"batch": batch, "batch_shardings": sh}
    model = model or Model(cfg, device="meta", ctx=ctx,
                           compute_dtype="bfloat16", max_seq=shp.seq_len + 8)
    cache, c_sh, tokens, tok_sh, pos = decode_specs(cfg, shp, model)
    return {"cache": cache, "cache_shardings": c_sh, "tokens": tokens,
            "tokens_sharding": tok_sh, "pos": pos}
