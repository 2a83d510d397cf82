"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Two interchangeable implementations (same math up to capacity drops):

* ``moe_dense``  — oracle: every expert computes every token, outputs are
  weighted by the (top-k-masked) router probabilities. Exact and
  dropless; FLOP overhead E/k.
* ``moe_sorted`` — the production path: sort-based capacity dispatch.
  Tokens are split into ``num_groups`` groups, each dispatched on its own
  into per-expert buffers (G, E, C, D) of capacity C; the expert products
  are one batched product over the experts. Tokens over capacity are
  dropped (standard capacity-factor semantics).

Router: softmax over expert logits in float32, top-k, weights
renormalized over the selected k (qwen/granite convention). A load-balance
auxiliary loss [arXiv:2101.03961 eq. 4] is returned for training.

Everything here is plain tensor code: the expert products are
``torch.einsum`` (batched matrix products), as the reference leaves them
to XLA. Orders follow the reference exactly where they decide a result:
top-k keeps the lower expert index first on ties (a stable descending
sort, as ``lax.top_k``), and the dispatch sorts each group's (token,
choice) pairs stably by expert, so a full expert drops the same tokens.
The router logits are a float32 product; on the GPU that needs TF32 off
for matrix products (PyTorch's default), or top-k choices flip.

Over a mesh (``ctx``, ``split``): every tp rank routes its data rank's
tokens alike; the load-balance aux is E x sum_e f_e p_e / k with f and p
means over the global tokens (their sums and the token count summed over
dp before the product); with the experts split over tp
(:class:`ExpertSplit`) each rank runs its experts (or its part of every
expert's d_ff) on the dispatched buffers and the combine is summed over
tp, with no all-to-all: tp peers hold the same tokens. Under sequence
parallelism the caller gathers those tokens over tp before routing, and
the combine is reduce-scattered into the rank's sequence block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn
from repro_torch.models.sharding import ShardingCtx


@dataclasses.dataclass(frozen=True)
class ExpertSplit:
    """How this rank holds the expert weights over ``ctx``'s tp axis:
    ``experts`` = [lo, hi) of the (padded) experts where they split by
    expert, None where every expert's d_ff splits; ``shared`` whether the
    shared expert's width splits too. The routed output is then a partial
    sum over tp. ``seq``: the output is this rank's sequence block (the
    partial sums reduce-scattered over tp) rather than summed whole."""
    ctx: ShardingCtx
    experts: Optional[Tuple[int, int]]
    shared: bool
    seq: bool = False


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot of ``idx`` by comparison (works under
    ``torch.func.vmap``, which ``F.one_hot`` does not)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_topk(cfg: ModelConfig, router_w: torch.Tensor,
                x: torch.Tensor, ctx: Optional[ShardingCtx] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (expert_idx (..., k) int64, weights (..., k) in x's dtype,
    aux_loss float32 scalar).

    The router weight may be padded to E_pad columns (expert-count padding,
    e.g. qwen 60 -> 64); padding experts are masked out of the softmax and
    can never win top-k. Over a mesh the aux's means run over the tokens
    of every data rank of ``ctx``.
    """
    logits = x.float() @ router_w.float()
    e_pad = logits.shape[-1]
    if e_pad > cfg.num_experts:
        col = torch.arange(e_pad, device=x.device) < cfg.num_experts
        logits = torch.where(col, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = srt[..., :k], order[..., :k]
    w = w / w.sum(-1, keepdim=True)                       # renormalize
    # load-balance aux: E * sum_e f_e * p_e (over real experts), f and p
    # means over the global tokens
    e = cfg.num_experts
    lead = tuple(range(probs.ndim - 1))
    f = _one_hot(idx, e, torch.float32).sum(-2).sum(lead)      # (E,)
    p = probs[..., :e].sum(lead)
    n = torch.full((1,), probs[..., 0].numel(), dtype=torch.float32,
                   device=probs.device)
    if ctx is not None:
        f, p, n = ctx.dp_g(torch.cat([f, p, n])).split([e, e, 1])
    aux = e * ((f / n) * (p / n)).sum() / k
    return idx, w.to(x.dtype), aux


def _expert_ffn(cfg: ModelConfig, p, h: torch.Tensor) -> torch.Tensor:
    """h: (..., E, C, D) grouped per expert; weights (E, D, F)/(E, F, D)."""
    a = act_fn(cfg.act)
    up = torch.einsum("...ecd,edf->...ecf", h, p["wi"])
    gate = torch.einsum("...ecd,edf->...ecf", h, p["wg"])
    return torch.einsum("...ecf,efd->...ecd", a(gate) * up, p["wo"])


def shared_expert(cfg: ModelConfig, p, x: torch.Tensor,
                  ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Always-on shared expert with sigmoid gate (qwen2-moe). With ``ctx``
    its width splits over tp: this rank's partial sum (the caller sums it
    over tp), the gate every tp rank computes alike."""
    a = act_fn(cfg.act)
    xs = x if ctx is None else ctx.tp_f(x)
    h = a(xs @ p["swg"]) * (xs @ p["swi"])
    gate = torch.sigmoid(x @ p["sgate"])
    return (h @ p["swo"]) * (gate if ctx is None else ctx.tp_f(gate))


def _finish(cfg: ModelConfig, p, x, out, split: Optional[ExpertSplit]):
    """The routed output ``out`` (a partial sum over tp under ``split``)
    plus the shared expert, summed over tp (into this rank's sequence block
    under ``split.seq``, where a shared expert that does not split keeps
    its rows)."""
    shared = cfg.num_shared_experts
    if split is None:
        return out + shared_expert(cfg, p, x) if shared else out
    ctx = split.ctx
    if shared and split.shared:
        out, shared = out + shared_expert(cfg, p, x, ctx), 0
    out = ctx.sp_scatter(out) if split.seq else ctx.tp_g(out)
    if shared:
        s = shared_expert(cfg, p, x)
        out = out + (ctx.cs_hidden(s) if split.seq else s)
    return out


def moe_dense(cfg: ModelConfig, p, x: torch.Tensor, *,
              ctx: Optional[ShardingCtx] = None,
              split: Optional[ExpertSplit] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle MoE: all experts on all tokens, top-k-masked weighted sum.

    x: (B, S, D). Returns (out, aux_loss). Under ``split``, this rank's
    experts (or d_ff part) only, summed over tp.
    """
    idx, w, aux = router_topk(cfg, p["router"], x, ctx)
    e_pad = p["router"].shape[-1]
    xd = x
    if split is not None:
        xd, w = split.ctx.tp_f(x), split.ctx.tp_f(w)
    a = act_fn(cfg.act)
    up = torch.einsum("bsd,edf->bsef", xd, p["wi"])
    gate = torch.einsum("bsd,edf->bsef", xd, p["wg"])
    y = torch.einsum("bsef,efd->bsed", a(gate) * up, p["wo"])   # (B,S,E,D)
    comb = torch.einsum("bske,bsk->bse", _one_hot(idx, e_pad, w.dtype), w)
    if split is not None and split.experts is not None:
        comb = comb[..., split.experts[0]:split.experts[1]]
    out = torch.einsum("bsed,bse->bsd", y, comb)
    return _finish(cfg, p, x, out, split), aux


def capacity(cfg: ModelConfig, tokens_per_group: int, factor: float = 1.25,
             multiple: int = 8) -> int:
    c = int(tokens_per_group * cfg.experts_per_token / cfg.num_experts
            * factor)
    c = max(multiple, (c + multiple - 1) // multiple * multiple)
    return min(c, tokens_per_group * cfg.experts_per_token)


def padded_experts(cfg: ModelConfig, multiple: int = 16) -> int:
    """Expert count padded for even expert sharding (60 -> 64 etc.)."""
    return -(-cfg.num_experts // multiple) * multiple


def _dispatch_one_group(cfg: ModelConfig, x: torch.Tensor, idx: torch.Tensor,
                        cap: int, num_experts: int):
    """Sort-based dispatch of one group (the reference's function; the port
    runs ``_dispatch`` on all groups at once, and the tests hold the two
    against each other).

    x: (T, D); idx: (T, k). Returns (buffer (E*C+1, D), slot (T, k),
    keep (T, k)) where slot indexes the buffer row for each (token,
    choice) and the last buffer row is the drop bin. ``num_experts`` may be
    the padded count (padded bins simply stay empty).
    """
    buffer, slot, keep = _dispatch(x[None], idx[None], cap, num_experts)
    return buffer[0], slot[0], keep[0]


def _dispatch(x: torch.Tensor, idx: torch.Tensor, cap: int, e: int):
    """``_dispatch_one_group`` on G groups at once: x (G, T, D), idx (G, T,
    k) -> buffer (G, E*C+1, D), slot (G, T, k) int64, keep (G, T, k)."""
    g, t, k = idx.shape
    c, dev = cap, x.device
    flat_e = idx.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)    # local sort
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts         # exclusive
    pos = (torch.arange(t * k, device=dev)
           - torch.gather(starts, 1, sorted_e))           # rank in expert
    slot_sorted = torch.where(pos < c, sorted_e * c + pos, e * c)
    # invert the sort: slot for each original (token, choice)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    rows = e * c + 1
    buffer = torch.zeros((g * rows, x.shape[-1]), dtype=x.dtype, device=dev)
    src_tok = torch.arange(t, device=dev).repeat_interleave(k)
    base = (torch.arange(g, device=dev) * rows)[:, None]
    # each real slot is written at most once; the drop bin is thrown away
    buffer.index_add_(0, (slot + base).reshape(-1),
                      x[:, src_tok].reshape(g * t * k, -1))
    keep = (slot < e * c).reshape(g, t, k)
    return buffer.reshape(g, rows, -1), slot.reshape(g, t, k), keep


def moe_sorted(cfg: ModelConfig, p, x: torch.Tensor, *,
               num_groups: int = 1, capacity_factor: float = 1.25,
               ctx: Optional[ShardingCtx] = None,
               split: Optional[ExpertSplit] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE with grouped local dispatch.

    x: (B, S, D). The B*S tokens are split into ``num_groups`` groups of
    consecutive tokens (one group where B*S does not divide), each with
    its own capacity ``capacity(cfg, tokens per group, capacity_factor)``.
    Returns (out, aux_loss). Under ``split``, this rank runs its experts'
    buffers (or every buffer through its d_ff part) and the combine is
    summed over tp.
    """
    b, s, d = x.shape
    e_pad = p["router"].shape[-1]
    k = cfg.experts_per_token
    idx, w, aux = router_topk(cfg, p["router"], x, ctx)
    t_total = b * s
    g = num_groups if t_total % num_groups == 0 else 1
    tg = t_total // g
    cap = capacity(cfg, tg, capacity_factor)
    xd = x
    if split is not None:
        xd, w = split.ctx.tp_f(x), split.ctx.tp_f(w)

    buffers, slots, keeps = _dispatch(xd.reshape(g, tg, d),
                                      idx.reshape(g, tg, k), cap, e_pad)
    # buffers: (G, E*C+1, D) -> (G, E, C, D) for the expert products
    h = buffers[:, :-1].reshape(g, e_pad, cap, d)
    lo, hi = (0, e_pad) if split is None or split.experts is None \
        else split.experts
    y = _expert_ffn(cfg, p, h[:, lo:hi])                  # (G, E', C, D)
    yflat = torch.cat([y.new_zeros((g, lo * cap, d)),
                       y.reshape(g, (hi - lo) * cap, d),
                       y.new_zeros((g, (e_pad - hi) * cap + 1, d))], dim=1)
    # combine: gather each (token, choice) back and weight
    gathered = torch.gather(
        yflat, 1, slots.reshape(g, tg * k, 1).expand(-1, -1, d))
    gathered = gathered.reshape(g, tg, k, d)
    wk = w.reshape(g, tg, k) * keeps
    out = (gathered * wk[..., None]).sum(2).reshape(b, s, d)
    return _finish(cfg, p, x, out, split), aux
