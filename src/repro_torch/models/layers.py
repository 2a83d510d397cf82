"""Core layers: norms, RoPE, softcap, GQA attention, decode attention and
the gated FFN, as plain functions on tensors (port of
``repro/models/layers.py``).

Compute is done in the input dtype except where float32 is required for
numerics (norm statistics, attention softmax, logits). Layouts are the
reference's: q (B, S, H, hd), k/v (B, T, KV, hd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """``p`` maps "scale" (and "bias" for layernorm) to tensors."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for integer positions, shape (..., head_dim/2)."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); sin/cos: (B, S, hd/2) or (S, hd/2)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:                                         # (S, half)
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:                                                     # (B, S, half)
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Softcap
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Attention (reference path; the flash kernel is a drop-in in
# repro_torch.kernels.attention.ops, selected by models/attention.attend)
# ---------------------------------------------------------------------------

NEG_INF = -2.0e38


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                          causal: bool, window: int) -> torch.Tensor:
    """Boolean mask (..., S_q, S_k): True = attend."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    mask = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        mask &= rel >= 0
    if window:
        mask &= rel < window
    return mask


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mask: torch.Tensor, scale: float,
                  attn_softcap: float = 0.0) -> torch.Tensor:
    """Reference grouped-query attention.

    q: (B, S, H, hd); k/v: (B, T, KV, hd); mask: (B, S, T) or (S, T).
    Returns (B, S, H, hd). A fully masked row averages v uniformly (the
    masked logits are a finite NEG_INF), as the reference's does.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    logits = logits * scale
    logits = softcap(logits, attn_softcap)
    mask_b = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    logits = torch.where(mask_b, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len=0, scale: float, attn_softcap: float = 0.0,
                     cache_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-step decode attention against a (possibly ring-buffer) cache.

    q: (B, 1, H, hd); k/v: (B, T_cache, KV, hd). ``kv_len`` = number of
    valid cache entries (int or (B,) tensor). For ring buffers
    (sliding-window layers) ``cache_pos`` gives the absolute position of
    each slot, (B, T_cache) or (T_cache,); entries with position < 0 are
    invalid. No window mask: a ring cache holds only the window.
    """
    b, _, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float())
    logits = logits * scale
    logits = softcap(logits, attn_softcap)
    if cache_pos is not None:
        valid = cache_pos >= 0
        if valid.ndim == 1:
            valid = valid[None]
        mask = valid[:, None, None, :]
    else:
        idx = torch.arange(t, device=q.device)
        lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
        mask = (idx[None] < lens)[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, 1, h, hd)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, valid: torch.Tensor,
                             scale: float, attn_softcap: float = 0.0):
    """``decode_attention`` over one block of a cache's slots, left
    unnormalised (flash-decode's partial softmax): (o, m, l), float32, per
    (b, kv head, query head of the group): o (B, KV, G, hd) the sum of
    exp(logit - m) v over the block, m (B, KV, G, 1) the block's largest
    logit and l (B, KV, G, 1) the sum of exp(logit - m).

    q: (B, 1, H, hd); k/v: (B, T_block, KV, hd); ``valid`` (T_block,):
    the slots that hold a position. Masked slots take the finite
    ``NEG_INF``, so a block with no valid slot has m = NEG_INF and adds
    exactly 0 once ``combine_decode_partials`` rescales it."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    logits = softcap(logits, attn_softcap)
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o, m, p.sum(-1, keepdim=True)


def combine_decode_partials(o, m, l, all_reduce, dtype) -> torch.Tensor:
    """The attention output (B, 1, H, hd) in ``dtype`` from every block's
    ``decode_attention_partial`` (o, m, l), in two collectives over the
    blocks: ``all_reduce(m, "max")`` gives the row max M, then one
    ``all_reduce(., "sum")`` of [l e^(m - M), o e^(m - M)]."""
    top = all_reduce(m, "max")
    s = torch.exp(m - top)
    sums = all_reduce(torch.cat([l * s, o * s], -1), "sum")
    out = sums[..., 1:] / sums[..., :1]
    b, kvh, g, hd = o.shape
    return out.reshape(b, 1, kvh * g, hd).to(dtype)


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default
    # ("none", erf) differs by ~1e-3
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Gated FFN: wo( act(x@wg) * (x@wi) ). ``p`` maps wi/wg/wo."""
    a = act_fn(cfg.act)
    h = a(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init_(w: torch.Tensor, in_axis_dims: int,
                generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal fan-in init, in place: std 1/sqrt(fan_in), cut at
    two standard deviations (the reference's ``dense_init``). A weight of
    another dtype (bfloat16) is drawn in float32 and rounded to it, as the
    reference casts its float32 draw."""
    std = 1.0 / math.sqrt(max(in_axis_dims, 1))
    with torch.no_grad():
        t = w if w.dtype == torch.float32 else torch.empty(
            w.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        t.mul_(std)
        if t is not w:
            w.copy_(t)
    return w
