"""Model assembly for every family of the reference (port of
``repro/models/model.py``).

One :class:`Model` (an ``nn.Module``) covers all ten architectures through
``ModelConfig`` dispatch: dense llama/gemma-like stacks (attention + dense
FFN), MoE stacks (attention + routed experts, ``models.moe``), pure
Mamba-2 (SSD mixer, no FFN), the hybrid (jamba: Mamba-2 layers with one
attention layer per period, MoE on every other layer), the VLM backbone
(llava: patch embeddings in front of the token embeddings) and the
encoder-decoder (whisper: a bidirectional encoder over frame embeddings,
learned positions, cross-attention in every decoder layer). The
reference groups layers into ``scan_period``-sized periods with stacked
parameters under ``lax.scan``; here every layer is its own module and the
stack is a Python loop. The period still decides each layer's kinds:
layer ``i`` is sub-layer ``s = i % scan_period`` of period
``i // scan_period``, and ``cfg.is_local_layer(s)`` picks gemma2's
sliding-window layers, as in the reference.

Modes:
  * ``forward``  — logits over the full sequence (teacher forcing) and the
    MoE load-balance aux summed over layers
  * ``prefill``  — last-token logits + populated decode cache
  * ``decode_step`` — one token against the cache (updated in place), at
    one position for the batch or at a position per lane (the continuous
    batcher's lanes, ``serve.batching``)

Frontends (``batch["frontend_embeds"]``, as ``data.pipeline`` makes them):
a VLM's (B, P, d) patches are cast to the compute dtype and go in front of
the token embeddings, so positions run from 0 over patches and tokens and
prefill caches the prefix (decoding then starts at P + S,
``train.train_step.frontend_len``); whisper's (B, T_enc, d) frames go
through the encoder, whose output every decoder layer's cross-attention
reads (prefill stores its ``xk`` / ``xv``; decode reads them).

MoE: ``moe_impl`` "dense" (every expert on every token) or "sorted"
(capacity dispatch); "auto" takes "sorted" above 8 experts, as the
reference does. ``forward`` and ``prefill`` dispatch the tokens in
``moe_groups`` groups of consecutive tokens (default one a data rank: one
group on one device, the reference's ``max(ctx.dp_size, 1)``);
``decode_step`` makes each lane
its own group, so a lane's capacity and its tokens never depend on the
other lanes (what the reference's batcher gets from ``vmap``-ing
single-lane decode steps).

Dtypes: parameters are made in ``cfg.param_dtype`` (bfloat16 for llava
and jamba at their published widths) and each sub-layer's weights are
cast to ``compute_dtype`` (float32 by default, as the reference) as it
runs; an embedding table is indexed before its rows are cast.

Activation recomputation (``remat=True``, the reference's
``Model(remat=, remat_policy=)``): in ``forward`` under autograd, each
period of ``scan_period`` layers (8 on jamba, 1 elsewhere) is one
``torch.utils.checkpoint`` body, so only its input is kept and the
backward runs its forward again (the flash forward kernel and the MoE
router included). ``remat_policy="dots"`` keeps the outputs of the
products without batch dims (``aten.mm`` / ``addmm``: the weight and
router products) and recomputes the rest; any other policy keeps nothing.
The encoder is not recomputed, prefill and decode never are, and nothing
is checkpointed under ``torch.func`` (the LM fitness builds its model
without remat, as the reference's does).

The cache mirrors the reference's tree, with the period axis as a list:
``cache["sub{s}"][period]`` is one layer's ``{"attn": {k, v, cache_pos}}``
or ``{"ssm": {conv, state}}``, and whisper's layers also hold
``{"cross": {xk, xv}}``. ``models.convert.cache_to_numpy`` stacks it back
into the reference's layout.

Training over a device mesh (``ctx=``, a ``models.sharding.ShardingCtx``
with a mesh; one process per rank): every parameter is this rank's block
of its ``param_specs`` entry (``models.sharding.shard_params``; the model
is built on ``meta`` and only the blocks are made), and ``forward`` takes
this rank's block of the batch over dp (``data.pipeline.place``). Each
sub-layer gathers its fsdp blocks as it runs (``models.sharding.use``).
Attention splits its heads over tp (column-parallel q / k / v,
row-parallel o, the output summed over tp; the flash kernel sees this
rank's heads only; where the kv heads do not split, every rank reads the
whole k / v and picks the kv head of each of its query heads); the dense
FFN splits d_ff; the MoE FFN splits its experts (or their d_ff) and sums
the combine over tp, routing every token on every tp rank alike, with the
load-balance aux over the global tokens and the dispatch in
``moe_groups`` groups (default the dp size: one group a data rank, as the
reference's ``num_groups=max(ctx.dp_size, 1)``); the embedding and the
logits split the vocab (out-of-block ids masked, then summed over tp;
``train.loss`` reduces the logsumexp over tp). The Mamba-2 mixer runs
whole on every tp rank (its leaves gathered over both axes).

Sequence parallelism (``make_train_ctx``'s default, the reference's
``cs_hidden``): ``forward`` carries the hidden state between sub-layers as
this rank's block of the sequence over tp (uneven blocks in ``rows``
order), through the residual adds and the norms; the embedding's
vocab-parallel sum is reduce-scattered into the block (after a VLM's
patches, before the learned positions of its rows). Each sub-layer gathers
its normed block over tp and, in place of "f" and "g", reduce-scatters its
row-parallel output into the block; a sub-layer that runs whole on every
tp rank (Mamba-2, heads or d_ff or experts that do not split) keeps its
rows, and the MoE gathers before routing. Whisper's encoder runs whole,
as the reference's. The final norm runs on the block, then one gather
gives the logits their layout. ``models.sharding`` states the gradient
rule. Prefill and decode never split the sequence.

Serving over a device mesh (``ctx=make_serve_ctx(mesh, ...)``): the
parameters are blocks as in training (tp, and fsdp over the data axes for
models above 20e9 parameters), ``prefill`` / ``decode_step`` take this
rank's block of the batch over dp (all of it where the long-context cache
splits its sequence over the data axis instead) and return its block of
the logits, and each rank holds its ``cache_specs`` block of the cache:
the self-attention k / v with every kv head and this rank's block of the
slots (``cache_pos`` whole), whisper's ``xk`` / ``xv`` whole, the Mamba-2
``state`` / ``conv`` split over tp. Prefill computes attention on this
rank's heads (the flash kernel over them, as in training), then gathers
the kv heads over tp and keeps its block of the slots: the gather rather
than an all-to-all from heads to slots, since ``core.collectives`` has it
on NCCL and gloo with uneven blocks, and a prefill runs once a request
(the all-to-all would move 1/tp of its bytes). A ring cache is laid out
on the whole sequence first, then cut, so slot ``pos % T_cache`` keeps its
meaning. A decode step combines every block's partial softmax over the
slots' axes (flash-decode, ``Attention._decode``).

Parameters are created with ``requires_grad=False``, which serving wants;
training turns them on with ``model.requires_grad_(True)``
(``train.train_step.init_train_state``), and ``forward`` then runs under
autograd (with ``attn_impl="kernel"`` the flash kernel's backward is a
kernel too). The last component of every parameter name is the
reference's leaf name, which the optimizer's weight-decay mask reads.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.attention import IMPLS, attend
from repro_torch.models.sharding import (ShardingCtx, cache_seq_axes,
                                         cut_cache_leaf, gather_cache_leaf,
                                         shard_params, sharded, use)
from repro_torch.models.layers import (apply_norm, apply_rope,
                                       combine_decode_partials,
                                       decode_attention,
                                       decode_attention_partial, dense_init_,
                                       ffn, rope_tables, softcap)

MOE_IMPLS = ("auto", "dense", "sorted")

# products without batch dims (the weight products, the router's): the
# outputs that jax.checkpoint_policies.dots_with_no_batch_dims_saveable
# keeps. Batched products (aten.bmm: attention's plain versions, the MoE
# expert einsums over (E, C, .)) and the flash kernels are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXTS = {
    "nothing": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy)}


def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    p = nn.Parameter(t, requires_grad=False)
    p._fill = fill          # what a block made from ``meta`` is filled with
    return p


def _layout(p):
    return getattr(p, "_layout", None)


def _enter(x, split: bool, ctx, seq):
    """A sub-layer's normed input as it computes with it: under sequence
    parallelism (``seq``, the whole length, where ``x`` is this rank's
    block) the whole sequence gathered over tp, its gradient
    reduce-scattered where the sub-layer ``split``s over tp (each rank's
    products give part of it) and cut to the block where it runs whole on
    every tp rank; else ``x``, through "f" where it splits."""
    if seq is not None:
        return ctx.sp_gather(x, seq, "scatter" if split else "none")
    return ctx.tp_f(x) if split else x


def _leave(out, split: bool, ctx, seq):
    """``_enter``'s counterpart for the sub-layer's output (B, S, D): this
    rank's sequence block under sequence parallelism (its partial sums
    reduce-scattered where it splits over tp, its rows kept where it runs
    whole); else summed over tp ("g") where it splits."""
    if seq is not None:
        return ctx.sp_scatter(out) if split else ctx.cs_hidden(out)
    return ctx.tp_g(out) if split else out


class _Weights(nn.Module):
    """A module whose own parameters carry the reference's leaf names."""

    def weights(self, dtype, ctx: Optional[ShardingCtx] = None,
                tp: str = "whole") -> dict:
        """Own parameters by name, gathered over the mesh as ``tp`` says
        (``models.sharding.use``; as they are without one) and cast to the
        compute dtype (as the reference's ``_cast``; a no-op where the
        dtypes agree)."""
        return {k: (v if ctx is None else use(v, ctx, tp)).to(dtype)
                for k, v in self.named_parameters(recurse=False)}


class Norm(_Weights):
    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__()
        self.cfg = cfg
        self.scale = _param((d,), torch.float32, device, 1.0)
        if cfg.norm_type == "layernorm":
            self.bias = _param((d,), torch.float32, device, 0.0)

    def forward(self, x):
        return apply_norm(self.cfg, self.weights(torch.float32), x)


class Attention(_Weights):
    """Attention sub-layer: pre-norm, q/k/v/o projections, RoPE,
    ``attend`` for full sequences and ``decode_attention`` on the cache.

    ``cross=True`` is whisper's cross-attention (the reference's
    ``attn_p(cross=True)``): projections ``xq, xk, xv, xo`` and no
    post-norm; its keys and values come from the encoder's output,
    attended with no mask, and prefill stores them as the cache's ``xk``
    / ``xv``. ``causal=False`` is the encoder's bidirectional
    self-attention."""

    def __init__(self, cfg: ModelConfig, local: bool, dtype, device,
                 attn_impl: str, *, cross: bool = False,
                 causal: bool = True):
        super().__init__()
        self.cfg, self.local, self.attn_impl = cfg, local, attn_impl
        self.cross, self.causal = cross, causal
        self.pre = pre = "x" if cross else ""
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.ln = Norm(cfg, d, device)
        for name, shape in (("q", (d, h * hd)), ("k", (d, kv * hd)),
                            ("v", (d, kv * hd)), ("o", (h * hd, d))):
            setattr(self, pre + name, _param(shape, dtype, device))
        self.post_ln = (Norm(cfg, d, device) if cfg.post_norm and not cross
                        else None)

    def reset_parameters(self, gen):
        d, hhd = self.cfg.d_model, self.cfg.num_heads * self.cfg.head_dim
        for name, fan_in in (("q", d), ("k", d), ("v", d), ("o", hhd)):
            dense_init_(getattr(self, self.pre + name), fan_in, gen)

    def _tp_heads(self, ctx):
        """(first local query head, local query heads, whether the kv heads
        split alike) where the heads split over tp, else None."""
        if ctx is None:
            return None
        pre, h, t = self.pre, self.cfg.num_heads, ctx.tp_size
        lq = _layout(getattr(self, pre + "q"))
        lo = _layout(getattr(self, pre + "o"))
        if lq is None or lq.tdim != 1 or lo is None or lo.tdim != 0 or h % t:
            return None
        lk = _layout(getattr(self, pre + "k"))
        kv_local = (lk is not None and lk.tdim == 1
                    and self.cfg.num_kv_heads % t == 0)
        return ctx.coord(ctx.tp) * (h // t), h // t, kv_local

    def _head_weights(self, cd, ctx):
        """(q, k, v, o weights by their names without the "x", the heads
        plan of ``_tp_heads``): every head's, or this rank's query heads'
        with the k / v they read (local, or whole where the kv heads do
        not split over tp)."""
        pre = self.pre
        plan = self._tp_heads(ctx)
        if plan is None:
            w = self.weights(cd, ctx)
        else:
            kv = "local" if plan[2] else "partial"
            w = {pre + n: use(getattr(self, pre + n), ctx,
                              kv if n in "kv" else "local").to(cd)
                 for n in "qkvo"}
        return {n: w[pre + n] for n in "qkvo"}, plan

    def _kv_heads(self, k, v, plan):
        """k, v (B, T, K', hd) as this rank's query heads read them: query
        head h reads kv head h // (H / K)."""
        if plan is None or plan[2]:
            return k, v
        idx = torch.arange(plan[0], plan[0] + plan[1], device=k.device) \
            // (self.cfg.num_heads // self.cfg.num_kv_heads)
        return k[:, :, idx], v[:, :, idx]

    def _local_kv(self, k, v, plan):
        """``_kv_heads`` of k, v that hold every kv head (a cache): where
        the kv heads split alike, this rank's block of them."""
        if plan is not None and plan[2]:
            n = self.cfg.num_kv_heads * plan[1] // self.cfg.num_heads
            lo = plan[0] * self.cfg.num_kv_heads // self.cfg.num_heads
            return k.narrow(2, lo, n), v.narrow(2, lo, n)
        return self._kv_heads(k, v, plan)

    def _all_kv(self, k, v, plan, ctx):
        """k, v (B, T, KV, hd) with every kv head, for a cache: gathered
        over tp (together, one collective) where each rank computed its
        block of them."""
        if plan is not None and plan[2]:
            kv = ctx.gather(torch.cat([k, v], -1), self.cfg.num_kv_heads,
                            ctx.tp, 2)
            return kv.chunk(2, -1)
        return k, v

    def forward(self, h, *, sincos, mode, cache, pos, max_cache_len, cd,
                ctx=None, enc_out=None, seq=None):
        """(out, new cache). ``seq``: the whole sequence length where ``h``
        is this rank's sequence block (sequence parallelism: the normed
        block is gathered, and the output is this rank's block)."""
        if self.cross:
            return self._cross(h, mode=mode, cache=cache, enc_out=enc_out,
                               cd=cd, ctx=ctx, seq=seq)
        cfg = self.cfg
        hd = cfg.head_dim
        w, plan = self._head_weights(cd, ctx)
        x = _enter(self.ln(h), plan is not None, ctx, seq)
        b, s, _ = x.shape
        q = (x @ w["q"]).reshape(b, s, -1, hd)
        k = (x @ w["k"]).reshape(b, s, -1, hd)
        v = (x @ w["v"]).reshape(b, s, -1, hd)
        if sincos is not None:
            sin, cos = sincos
            q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        scale = (cfg.query_pre_attn_scalar or hd) ** -0.5
        window = cfg.sliding_window if self.local else 0
        new_cache = {}
        if mode == "decode":
            out = self._decode(q, k, v, cache, pos, scale, plan, ctx)
            new_cache = cache
        else:
            if mode == "prefill":
                tc = (min(window, max_cache_len) if (self.local and window)
                      else max_cache_len)
                new_cache = _build_prefill_cache(
                    *self._all_kv(k, v, plan, ctx), tc)
                if sharded(ctx):
                    new_cache = {n: cut_cache_leaf(n, c, ctx)
                                 for n, c in new_cache.items()}
            k, v = self._kv_heads(k, v, plan)
            out = attend(q, k, v, scale=scale, causal=self.causal,
                         window=window, attn_softcap=cfg.attn_softcap,
                         impl=self.attn_impl)
        out = out.reshape(b, s, -1) @ w["o"]
        return _leave(out, plan is not None, ctx, seq), new_cache

    def _decode(self, q, k, v, cache, pos, scale, plan, ctx):
        """One step's attention against the cache, after writing its k / v.

        Over a mesh the cache holds every kv head and this rank's block of
        the slots (``models.sharding.cache_seq_axes``; ``cache_pos`` whole):
        the step's k / v are gathered over tp where the kv heads split, and
        written by the rank whose block holds slot ``pos % T_cache``. Where
        the slots lie over live axes, q is gathered over tp (every head, so
        the block is read once for all of them), each rank takes the
        partial softmax of its block and the partials are combined over
        those axes (``layers.combine_decode_partials``); the rank then
        keeps its own heads for the row-parallel ``o``. Where the slots are
        whole on every rank, each rank attends its heads to their kv
        heads, exchanging nothing."""
        cfg = self.cfg
        cp = cache["cache_pos"]
        tc = cp.shape[-1]
        axes = ctx.live(cache_seq_axes(tc, ctx)) if sharded(ctx) else ()
        rows = ctx.rows(tc, axes) if axes else None
        _write_decode_kv(cache, *self._all_kv(k, v, plan, ctx), pos, rows)
        if not axes:
            ck, cv = self._local_kv(cache["k"], cache["v"], plan)
            return decode_attention(q, ck, cv, kv_len=0, cache_pos=cp,
                                    scale=scale,
                                    attn_softcap=cfg.attn_softcap)
        if plan is not None:
            q = ctx.gather(q, cfg.num_heads, ctx.tp, 2)
        o, m, l = decode_attention_partial(
            q, cache["k"], cache["v"], valid=cp[rows[0]:rows[1]] >= 0,
            scale=scale, attn_softcap=cfg.attn_softcap)
        out = combine_decode_partials(
            o, m, l, lambda x, op: ctx.all_reduce(x, axes, op), q.dtype)
        return out if plan is None else out.narrow(2, plan[0], plan[1])

    def _cross(self, h, *, mode, cache, enc_out, cd, ctx, seq):
        """Cross-attention: the queries as the self-attention's (gathered
        under sequence parallelism); ``enc_out`` whole on every tp rank."""
        cfg = self.cfg
        hd = cfg.head_dim
        w, plan = self._head_weights(cd, ctx)
        x = _enter(self.ln(h), plan is not None, ctx, seq)
        if plan is not None and enc_out is not None:   # decode reads the cache
            enc_out = ctx.tp_f(enc_out)
        b, s, _ = x.shape
        q = (x @ w["q"]).reshape(b, s, -1, hd)
        scale = (cfg.query_pre_attn_scalar or hd) ** -0.5
        new_cache = {}
        if mode == "decode":
            # the cache holds every kv head: each rank reads its heads'
            ck, cv = self._local_kv(cache["xk"], cache["xv"], plan)
            out = decode_attention(q, ck, cv, kv_len=ck.shape[1], scale=scale)
            new_cache = cache
        else:
            t = enc_out.shape[1]
            k = (enc_out @ w["k"]).reshape(b, t, -1, hd)
            v = (enc_out @ w["v"]).reshape(b, t, -1, hd)
            if mode == "prefill":
                xk, xv = self._all_kv(k, v, plan, ctx)
                new_cache = {"xk": xk, "xv": xv}
            k, v = self._kv_heads(k, v, plan)
            out = attend(q, k, v, scale=scale, causal=False,
                         impl=self.attn_impl)
        out = out.reshape(b, s, -1) @ w["o"]
        return _leave(out, plan is not None, ctx, seq), new_cache


class FFN(_Weights):
    """Dense gated FFN sub-layer (SwiGLU / GeGLU)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.ln = Norm(cfg, d, device)
        self.wi = _param((d, f), dtype, device)
        self.wg = _param((d, f), dtype, device)
        self.wo = _param((f, d), dtype, device)
        self.post_ln = Norm(cfg, d, device) if cfg.post_norm else None

    def reset_parameters(self, gen):
        d, f = self.cfg.d_model, self.cfg.d_ff
        for w, fan_in in ((self.wi, d), (self.wg, d), (self.wo, f)):
            dense_init_(w, fan_in, gen)

    def forward(self, h, cd, ctx=None, seq=None):
        """The FFN's output; over a mesh with d_ff split over tp, wi / wg
        column-parallel and wo row-parallel, summed over tp (``seq``: as
        ``Attention.forward``'s)."""
        lay = _layout(self.wi)
        split = lay is not None and lay.tdim == 1
        x = _enter(self.ln(h), split, ctx, seq)
        out = ffn(self.cfg, self.weights(cd, ctx, "local" if split
                                         else "whole"), x)
        return _leave(out, split, ctx, seq)


class MoE(_Weights):
    """MoE FFN sub-layer (``models.moe``): a float32 router, ``e`` routed
    experts and, where the config has them, the gated shared expert."""

    def __init__(self, cfg: ModelConfig, dtype, device, impl: str,
                 capacity_factor: float, e: int):
        super().__init__()
        self.cfg, self.impl = cfg, impl
        self.capacity_factor = capacity_factor
        d, f = cfg.d_model, cfg.moe_d_ff
        self.ln = Norm(cfg, d, device)
        self.router = _param((d, e), torch.float32, device)
        self.wi = _param((e, d, f), dtype, device)
        self.wg = _param((e, d, f), dtype, device)
        self.wo = _param((e, f, d), dtype, device)
        if cfg.num_shared_experts:
            sf = cfg.shared_d_ff or cfg.moe_d_ff * cfg.num_shared_experts
            self.swi = _param((d, sf), dtype, device)
            self.swg = _param((d, sf), dtype, device)
            self.swo = _param((sf, d), dtype, device)
            self.sgate = _param((d, 1), dtype, device)
        self.post_ln = Norm(cfg, d, device) if cfg.post_norm else None

    def reset_parameters(self, gen):
        d = self.cfg.d_model
        for name, w in self.named_parameters(recurse=False):
            # fan-in: the model width, or the hidden width into wo / swo
            dense_init_(w, w.shape[-2] if name in ("wo", "swo") else d, gen)

    def forward(self, h, cd, num_groups: int, ctx=None, seq=None):
        """(out, aux). ``num_groups``: the sorted dispatch's groups. Over a
        mesh whose tp axis splits the experts (or their d_ff), this rank
        runs its part and the combine is summed over tp
        (``models.moe.ExpertSplit``); the aux is taken over the global
        tokens. Under sequence parallelism (``seq``) the normed block is
        gathered before routing, so every tp rank routes its data rank's
        tokens alike in the reference's groups, and the combine is
        reduce-scattered into this rank's block."""
        x = _enter(self.ln(h), False, ctx, seq)
        lay = _layout(self.wi)
        split = None
        if lay is None or lay.tdim is None:
            w = self.weights(cd, ctx)
        else:
            w = self.weights(cd, ctx, "local")
            shared = _layout(getattr(self, "swi", None))
            split = MOE.ExpertSplit(
                ctx, ctx.rows(lay.shape[0], ctx.tp) if lay.tdim == 0
                else None, shared is not None and shared.tdim == 1,
                seq is not None)
        if self.impl == "dense":
            out, aux = MOE.moe_dense(self.cfg, w, x, ctx=ctx, split=split)
        else:
            out, aux = MOE.moe_sorted(self.cfg, w, x, num_groups=num_groups,
                                      capacity_factor=self.capacity_factor,
                                      ctx=ctx, split=split)
        if split is None:               # every tp rank ran the whole MoE
            out = _leave(out, False, ctx, seq)
        return out, aux


class Mamba2(_Weights):
    """Mamba-2 mixer sub-layer (``models.ssm``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, use_kernel: bool):
        super().__init__()
        self.cfg, self.use_kernel = cfg, use_kernel
        d, d_in, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = d_in + 2 * n
        self.ln = Norm(cfg, d, device)
        self.in_proj = _param((d, 2 * d_in + 2 * n + nh), dtype, device)
        self.conv = _param((cfg.ssm_conv_width, conv_ch), dtype, device)
        self.conv_bias = _param((conv_ch,), dtype, device, 0.0)
        self.A_log = _param((nh,), torch.float32, device)
        self.D = _param((nh,), torch.float32, device, 1.0)
        self.dt_bias = _param((nh,), torch.float32, device)
        self.norm_scale = _param((d_in,), torch.float32, device, 1.0)
        self.out_proj = _param((d_in, d), dtype, device)

    def reset_parameters(self, gen):
        cfg = self.cfg
        dense_init_(self.in_proj, cfg.d_model, gen)
        dense_init_(self.conv, cfg.ssm_conv_width, gen)
        dense_init_(self.out_proj, cfg.d_inner, gen)
        with torch.no_grad():
            self.conv_bias.zero_()
            self.D.fill_(1.0)
            self.norm_scale.fill_(1.0)
            # A = -exp(A_log) with A_log = log U(1, 16) (mamba2)
            self.A_log.uniform_(1.0, 16.0, generator=gen).log_()
            # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2)
            self.dt_bias.uniform_(math.log(1e-3), math.log(1e-1),
                                  generator=gen)
            self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(
                self.dt_bias))))

    def forward(self, h, *, mode, cache, cd, ctx=None, seq=None):
        """Over a mesh every tp rank runs the whole mixer (its leaves
        gathered over both axes): no tensor-parallel SSM yet; under
        sequence parallelism (``seq``) on the gathered sequence, keeping
        this rank's rows of its output. Each rank holds its
        ``cache_specs`` block of the cache (``state``'s heads and
        ``conv``'s channels over tp): a decode step gathers the whole cache
        first, and prefill and decode keep the rank's block of the cache
        they compute."""
        x = _enter(self.ln(h), False, ctx, seq)
        w = self.weights(cd, ctx)
        if mode == "fwd":
            return _leave(SSM.mamba2_forward(self.cfg, w, x,
                                             use_kernel=self.use_kernel),
                          False, ctx, seq), {}
        if mode == "decode":
            if sharded(ctx):
                cache = {n: gather_cache_leaf(n, c, self._cache_shape(n, c),
                                              ctx) for n, c in cache.items()}
            out, new = SSM.mamba2_decode(self.cfg, w, x, cache)
        else:
            out, new = SSM.mamba2_forward(self.cfg, w, x, return_cache=True,
                                          use_kernel=self.use_kernel)
        if sharded(ctx):
            new = {n: cut_cache_leaf(n, c, ctx) for n, c in new.items()}
        return out, new

    def _cache_shape(self, name, block):
        """The whole shape of a cache leaf from this rank's block of it."""
        cfg = self.cfg
        whole = {"state": (1, cfg.ssm_heads),
                 "conv": (2, cfg.d_inner + 2 * cfg.ssm_state)}[name]
        shape = list(block.shape)
        shape[whole[0]] = whole[1]
        return tuple(shape)


class Block(nn.Module):
    """One layer: a mixer (attention or Mamba-2), whisper's cross-attention
    where the config is an encoder-decoder, and, where the config has one,
    a dense or MoE FFN, each with its residual (and gemma2's
    post-norms)."""

    def __init__(self, cfg: ModelConfig, sub: int, dtype, device,
                 attn_impl: str, use_ssd_kernel: bool, moe_impl: str,
                 moe_capacity_factor: float, num_experts: int):
        super().__init__()
        self.cfg = cfg
        mix, f = cfg.mixer_kind(sub), cfg.ffn_kind(sub)
        self.attn = (Attention(cfg, cfg.is_local_layer(sub), dtype, device,
                               attn_impl) if mix == "attn" else None)
        self.ssm = (Mamba2(cfg, dtype, device, use_ssd_kernel)
                    if mix == "ssm" else None)
        self.cross = (Attention(cfg, False, dtype, device, attn_impl,
                                cross=True)
                      if cfg.is_encoder_decoder else None)
        self.ffn = FFN(cfg, dtype, device) if f == "dense" else None
        self.moe = (MoE(cfg, dtype, device, moe_impl, moe_capacity_factor,
                        num_experts) if f == "moe" else None)

    def _residual(self, h, out, post_ln):
        if post_ln is not None:
            out = post_ln(out)
        return h + self.cfg.residual_scale * out

    def forward(self, h, *, sincos, mode, cache, pos, max_cache_len, cd,
                enc_out=None, ctx=None, moe_groups: int = 1, seq=None):
        """(h, this layer's new cache, MoE aux or None). ``moe_groups``:
        the MoE dispatch's groups of a forward or prefill (decode makes
        each lane its own). ``seq``: the whole sequence length where ``h``
        is this rank's sequence block (sequence parallelism), which every
        sub-layer's output and residual stay."""
        nc = {}
        if self.attn is not None:
            out, c = self.attn(h, sincos=sincos, mode=mode,
                               cache=cache["attn"] if cache else None,
                               pos=pos, max_cache_len=max_cache_len, cd=cd,
                               ctx=ctx, seq=seq)
            h = self._residual(h, out, self.attn.post_ln)
            if c:
                nc["attn"] = c
        else:
            out, c = self.ssm(h, mode=mode,
                              cache=cache["ssm"] if cache else None, cd=cd,
                              ctx=ctx, seq=seq)
            h = self._residual(h, out, None)
            if c:
                if cache:
                    cache["ssm"].update(c)      # decode: in place
                    c = cache["ssm"]
                nc["ssm"] = c
        if self.cross is not None:
            out, c = self.cross(h, sincos=None, mode=mode,
                                cache=cache["cross"] if cache else None,
                                pos=pos, max_cache_len=max_cache_len, cd=cd,
                                ctx=ctx, enc_out=enc_out, seq=seq)
            h = self._residual(h, out, None)
            if c:
                nc["cross"] = c
        aux = None
        if self.ffn is not None:
            h = self._residual(h, self.ffn(h, cd, ctx, seq),
                               self.ffn.post_ln)
        elif self.moe is not None:
            # decode: each lane is its own dispatch group
            out, aux = self.moe(h, cd, h.shape[0] if mode == "decode"
                                else moe_groups, ctx, seq)
            h = self._residual(h, out, self.moe.post_ln)
        return h, nc, aux


class EncoderBlock(nn.Module):
    """One layer of whisper's encoder (the reference's ``_encode`` body):
    bidirectional self-attention without positions, then the dense FFN,
    each with its residual and no post-norm."""

    def __init__(self, cfg: ModelConfig, dtype, device, attn_impl: str):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, False, dtype, device, attn_impl,
                              causal=False)
        self.ffn = FFN(cfg, dtype, device)

    def forward(self, h, cd, ctx=None):
        out, _ = self.attn(h, sincos=None, mode="fwd", cache=None, pos=None,
                           max_cache_len=0, cd=cd, ctx=ctx)
        h = h + self.cfg.residual_scale * out
        return h + self.cfg.residual_scale * self.ffn(h, cd, ctx)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig | str, *, device="cuda",
                 compute_dtype: str = "float32", attn_impl: str = "auto",
                 moe_impl: str = "auto", use_ssd_kernel: bool = False,
                 max_seq: int = 4096, pad_experts: bool = False,
                 moe_capacity_factor: float = 1.25, remat: bool = False,
                 remat_policy: str = "nothing",
                 ctx: Optional[ShardingCtx] = None,
                 moe_groups: Optional[int] = None):
        super().__init__()
        self.cfg = cfg = get_config(cfg) if isinstance(cfg, str) else cfg
        if attn_impl not in IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; use one of "
                             f"{IMPLS}")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {moe_impl!r}; use one of "
                             f"{MOE_IMPLS}")
        if moe_impl == "auto":
            moe_impl = "sorted" if cfg.num_experts > 8 else "dense"
        self.moe_impl = moe_impl
        # pad_experts: E padded to a multiple of 16 (qwen 60 -> 64); the
        # padded experts are router-masked, never used
        num_experts = (MOE.padded_experts(cfg) if pad_experts
                       else cfg.num_experts)
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, compute_dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)
        self.attn_impl = attn_impl
        self.use_ssd_kernel = use_ssd_kernel
        self.max_seq = max_seq
        # remat: recompute each period's activations in the backward;
        # "dots" keeps the weight products' outputs, any other policy
        # keeps nothing (as the reference)
        self.remat = remat
        self.remat_policy = "dots" if remat_policy == "dots" else "nothing"
        # a mesh: the parameters are made as this rank's blocks only
        self.ctx = ctx or ShardingCtx()
        self.moe_groups = moe_groups
        dt, d = self.param_dtype, cfg.d_model
        dev = torch.device("meta") if sharded(self.ctx) else self.device
        self.embed = nn.ParameterDict(
            {"tokens": _param((cfg.padded_vocab, d), dt, dev)})
        self.layers = nn.ModuleList(
            Block(cfg, i % cfg.scan_period, dt, dev, attn_impl,
                  use_ssd_kernel, moe_impl, moe_capacity_factor,
                  num_experts) for i in range(cfg.num_layers))
        self.final_norm = Norm(cfg, d, dev)
        self.unembed = (None if cfg.tie_embeddings
                        else _param((d, cfg.padded_vocab), dt, dev))
        self.pos = (nn.ParameterDict(
            {"table": _param((max_seq, d), dt, dev)})
            if cfg.pos_embedding == "learned" else None)
        if cfg.is_encoder_decoder:
            self.enc_layers = nn.ModuleList(
                EncoderBlock(cfg, dt, dev, attn_impl)
                for _ in range(cfg.encoder_layers))
            self.enc_pos = nn.ParameterDict({"table": _param(
                (max(cfg.encoder_seq, 1), d), dt, dev)})
            self.enc_norm = Norm(cfg, d, dev)
        else:
            self.enc_layers = self.enc_pos = self.enc_norm = None
        self.layouts = (shard_params(self, self.ctx, self.device)
                        if sharded(self.ctx) else {})

    def with_ctx(self, ctx: ShardingCtx) -> "Model":
        """This model (its parameters shared) under another context on the
        same mesh with the same fsdp and tp axes (the reference's
        ``with_ctx``; the compressed pod reduce's per-pod model)."""
        if (ctx.mesh, ctx.fsdp, ctx.tp) != (self.ctx.mesh, self.ctx.fsdp,
                                            self.ctx.tp):
            raise ValueError("with_ctx keeps the mesh, fsdp and tp axes "
                             "the parameters are blocked over")
        m = copy.copy(self)
        m.ctx = ctx
        return m

    # ------------------------------------------------------------------
    # Parameter init
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> "Model":
        """Random parameters from ``generator`` (on the model's device), in
        place: truncated-normal fan-in projections (the MoE router
        included, float32), ones for norms, the Mamba-2 A_log / dt_bias
        distributions, the learned position tables. Returns the model."""
        d = self.cfg.d_model
        with self._whole(self.embed):
            dense_init_(self.embed["tokens"], d, generator)
        for layer in self.layers:
            for sub in (layer.attn, layer.ssm, layer.cross, layer.ffn,
                        layer.moe):
                if sub is not None:
                    with self._whole(sub):
                        sub.reset_parameters(generator)
        if self.unembed is not None:
            with self._whole(self):
                dense_init_(self.unembed, d, generator)
        if self.pos is not None:
            with self._whole(self.pos):
                dense_init_(self.pos["table"], d, generator)
        if self.enc_layers is not None:
            for layer in self.enc_layers:
                for sub in (layer.attn, layer.ffn):
                    with self._whole(sub):
                        sub.reset_parameters(generator)
            with self._whole(self.enc_pos):
                dense_init_(self.enc_pos["table"], d, generator)
        return self

    def param_shapes(self) -> dict:
        """{name: a ``meta`` tensor of the parameter's shape and dtype},
        allocating nothing (the reference's ``eval_shape`` of its
        ``init_params``); over a mesh the whole leaves', not this rank's
        blocks."""
        return {n: torch.empty(self.layouts[n].shape if n in self.layouts
                               else p.shape, dtype=p.dtype, device="meta")
                for n, p in self.named_parameters()}

    @contextlib.contextmanager
    def _whole(self, module):
        """Over a mesh, ``module``'s own parameters at their whole shapes
        inside the block (so an init draws what one rank draws, in the
        same order), then cut back to this rank's blocks."""
        own = [p for p in module._parameters.values()
               if p is not None and _layout(p) is not None]
        for p in own:
            p.data = torch.empty(_layout(p).shape, dtype=p.dtype,
                                 device=p.device)
        try:
            yield
        finally:
            for p in own:
                p.data = _layout(p).block(p.data, self.ctx).clone()

    # ------------------------------------------------------------------
    # Stack
    # ------------------------------------------------------------------
    def _moe_groups(self) -> int:
        """This rank's MoE dispatch groups in a forward or prefill: the
        global groups (``moe_groups``, default one a data rank) over the
        data ranks."""
        dp = max(self.ctx.dp_size, 1)
        groups = self.moe_groups or dp
        if groups % dp:
            raise ValueError(f"moe_groups={groups} does not split over "
                             f"{dp} data ranks")
        return groups // dp

    def _run_stack(self, h, *, sincos, mode, cache, pos, max_cache_len,
                   enc_out=None, seq=None):
        """(h, cache, aux): aux is the MoE load-balance loss summed over
        the layers (float32, 0 without MoE layers). Under ``remat`` each
        period of a ``forward`` that autograd records is one checkpointed
        body (the reference's ``jax.checkpoint`` around its scan body),
        which keeps ``h`` as it enters: under sequence parallelism
        (``seq``) this rank's block, and recomputation runs the period's
        gathers again, in the same order on every rank."""
        period = self.cfg.scan_period
        new_cache = {f"sub{s}": [] for s in range(period)}
        ctx, groups = self.ctx, self._moe_groups()

        def run_period(h, aux, per):
            for s in range(period):
                layer = self.layers[per * period + s]
                lc = cache[f"sub{s}"][per] if mode == "decode" else None
                h, nc, a = layer(h, sincos=sincos, mode=mode, cache=lc,
                                 pos=pos, max_cache_len=max_cache_len,
                                 cd=self.compute_dtype, enc_out=enc_out,
                                 ctx=ctx, moe_groups=groups, seq=seq)
                if a is not None:
                    aux = aux + a
                new_cache[f"sub{s}"].append(nc)
            return h, aux

        remat = self.remat and mode == "fwd" and torch.is_grad_enabled()
        aux = torch.zeros((), device=self.device)
        for per in range(self.cfg.num_periods):
            if remat:
                h, aux = checkpoint(run_period, h, aux, per,
                                    use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=_REMAT_CONTEXTS[
                                        self.remat_policy])
            else:
                h, aux = run_period(h, aux, per)
        return h, (new_cache if mode == "prefill" else cache), aux

    def _encode(self, frames):
        """Whisper's encoder: bidirectional attention over the frame
        embeddings (B, T_enc, d) plus learned positions, then a norm."""
        cd = self.compute_dtype
        h = frames.to(self.device, cd)
        h = h + self.enc_pos["table"][:h.shape[1]].to(cd)
        for layer in self.enc_layers:
            h = layer(h, cd, self.ctx)
        return self.enc_norm(h)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def _vocab_block(self, p):
        """[lo, hi) of the vocab rows this rank holds of ``p`` (the
        embedding, dim 0, or the unembedding, dim 1) where the vocab splits
        over tp, else None."""
        lay = _layout(p)
        want = 0 if p is self.embed["tokens"] else 1
        if lay is None or lay.tdim != want:
            return None
        return self.ctx.rows(lay.shape[want], self.ctx.tp)

    def _embed(self, tokens, sizes=None):
        """The token embeddings (B, S, D); with ``sizes`` (sequence
        parallelism: every tp rank's rows of the tokens, in rank order)
        this rank's rows of them."""
        ids = tokens.to(self.device).long()
        table = self.embed["tokens"]
        block = self._vocab_block(table)
        if block is None:
            h = use(table, self.ctx)[ids].to(self.compute_dtype)
            if sizes is not None:
                h = self.ctx.cs_hidden(h, sizes)
        else:
            # vocab-parallel: this rank's rows, out-of-block ids masked,
            # then summed over tp (reduce-scattered into this rank's rows
            # of the sequence with ``sizes``)
            lo, hi = block
            inb = (ids >= lo) & (ids < hi)
            rows = use(table, self.ctx, "local")[torch.where(inb, ids - lo,
                                                             0)]
            part = torch.where(inb[..., None], rows.to(self.compute_dtype),
                               0.0)
            h = (self.ctx.tp_g(part) if sizes is None
                 else self.ctx.sp_scatter(part, sizes))
        if self.cfg.embed_scale != 1.0:
            h = h * self.cfg.embed_scale
        return h

    def _assemble_inputs(self, batch, split: bool = False):
        """(h, sincos, enc_out, seq) of a forward or prefill: the token
        embeddings with a VLM's patches in front and the positions (RoPE's
        tables, or the learned rows added), whisper's encoder output or
        None. With ``split`` (sequence parallelism, the reference's
        ``cs_hidden`` after the positions) ``h`` is this rank's block over
        tp of the ``seq`` rows of patches and tokens: its rows of the token
        embeddings (their vocab-parallel sum reduce-scattered) after its
        rows of the patches, with its rows' learned positions; RoPE's
        tables span all rows. Else ``h`` is whole and ``seq`` None."""
        cfg, ctx = self.cfg, self.ctx
        tokens = batch["tokens"]
        fe = None
        if cfg.frontend == "vision_patches":
            fe = batch["frontend_embeds"].to(self.device, self.compute_dtype)
        p = 0 if fe is None else fe.shape[1]
        n = p + tokens.shape[1]
        lo, hi, sizes = 0, n, None
        if split:
            # each rank's rows of the tokens: its block's overlap with [p, n)
            ends = list(itertools.accumulate(ctx.sizes(n, ctx.tp)))
            sizes = [max(e, p) - max(b, p)
                     for b, e in zip([0] + ends[:-1], ends)]
            lo, hi = ctx.rows(n, ctx.tp)
        h = self._embed(tokens, sizes)
        if fe is not None:
            h = torch.cat([fe[:, lo:min(hi, p)], h], dim=1)
        enc_out = (self._encode(batch["frontend_embeds"])
                   if cfg.is_encoder_decoder else None)
        h, sincos = self._pos_tables(h, torch.arange(n, device=self.device),
                                     rows=(lo, hi))
        return h, sincos, enc_out, (n if split else None)

    def _pos_tables(self, h, positions, rows=None):
        """(h, sincos): RoPE's tables for ``positions``, or h plus the
        learned table's rows at them (sincos None); with ``rows`` = [lo,
        hi), ``h`` holds those of the positions only."""
        cfg = self.cfg
        if cfg.pos_embedding == "rope" and cfg.num_heads:
            return h, rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        if cfg.pos_embedding == "learned":
            if rows is not None:
                positions = positions[rows[0]:rows[1]]
            h = h + self.pos["table"][positions].to(h.dtype)
        return h, None

    def _logits(self, h, last_only: bool = False, seq=None):
        """float32 logits; over a mesh whose tp axis splits the vocab, this
        rank's columns (the reference's ``(dp, None, tp)``). Under sequence
        parallelism (``seq``) the final norm runs on this rank's block,
        whose whole sequence is then gathered over tp."""
        cfg, ctx = self.cfg, self.ctx
        if last_only:
            h = h[:, -1:]
        w = self.embed["tokens"] if cfg.tie_embeddings else self.unembed
        split = self._vocab_block(w) is not None
        h = _enter(self.final_norm(h), split, ctx, seq)
        w = use(w, ctx, "local" if split else "whole").to(self.compute_dtype)
        logits = h @ (w.t() if cfg.tie_embeddings else w)
        return softcap(logits.float(), cfg.final_softcap)

    def forward(self, batch):
        """Full-sequence logits. Returns (logits_f32 (B, P + S,
        padded_vocab), aux): P a VLM's patches (0 otherwise); aux is the
        MoE load-balance loss summed over the layers, float32 (0 for the
        families without MoE layers). Over a mesh, ``batch`` is this rank's
        block over dp and the logits are its block of (B, P + S, vocab)
        (the vocab over tp where it splits). Under sequence parallelism
        (``ShardingCtx.seq_split``) the hidden state between sub-layers is
        this rank's block of the sequence over tp."""
        h, sincos, enc_out, seq = self._assemble_inputs(
            batch, self.ctx.seq_split)
        h, _, aux = self._run_stack(h, sincos=sincos, mode="fwd",
                                    cache=None, pos=None, max_cache_len=0,
                                    enc_out=enc_out, seq=seq)
        return self._logits(h, seq=seq), aux

    def prefill(self, batch, max_cache_len: int):
        """Populate the decode cache; returns (last_logits (B, 1, V),
        cache). A VLM's patches are cached as the first P positions. Over
        a mesh (``make_serve_ctx``), ``batch`` is this rank's block over dp,
        the logits are its block (the vocab over tp where it splits,
        ``logits_block``) and the cache is its ``cache_specs`` block."""
        h, sincos, enc_out, _ = self._assemble_inputs(batch)
        h, cache, _ = self._run_stack(h, sincos=sincos, mode="prefill",
                                      cache=None, pos=None,
                                      max_cache_len=max_cache_len,
                                      enc_out=enc_out)
        return self._logits(h, last_only=True), cache

    def logits_block(self):
        """[lo, hi) of the vocab columns this rank's logits hold where the
        vocab splits over tp, else None (every column)."""
        return self._vocab_block(self.embed["tokens"] if self.cfg.tie_embeddings
                                 else self.unembed)

    def decode_step(self, cache, tokens, pos):
        """One decode step. tokens: (B, 1); pos: the next index, an int for
        the whole batch, or a (B,) integer tensor with one per lane (each
        lane's rope angle or learned position row, ring slot
        ``pos[b] % T_cache`` and cache positions its own, so the attention
        caches' ``cache_pos`` must be (B, T_cache), as the continuous
        batcher's pool holds them; nothing is read back to the host).
        Returns (logits (B, 1, V), cache); the cache is updated in place.
        Over a mesh ``tokens`` and the logits are this rank's blocks, as in
        ``prefill``, the cache is its ``cache_specs`` block and ``pos`` an
        int."""
        h = self._embed(tokens)
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            if sharded(self.ctx):
                raise NotImplementedError(
                    "decode at a position per lane over a mesh (the "
                    "continuous batcher) is not ported; see ROADMAP.md")
            pos = pos.to(self.device)
            positions = pos[:, None]                          # (B, 1)
        else:
            pos = int(pos)
            positions = torch.tensor([pos], device=self.device)
        h, sincos = self._pos_tables(h, positions=positions)
        h, cache, _ = self._run_stack(h, sincos=sincos, mode="decode",
                                      cache=cache, pos=pos, max_cache_len=0)
        return self._logits(h), cache

    # ------------------------------------------------------------------
    # Cache init (for decode-only entry)
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_cache_len: int, dtype=None,
                   device=None):
        """Zero caches on ``device`` (default the model's; ``meta``
        allocates nothing)."""
        cfg = self.cfg
        dtype = dtype or self.compute_dtype
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        dev = self.device if device is None else device
        cache = {f"sub{s}": [] for s in range(cfg.scan_period)}
        for i in range(cfg.num_layers):
            s = i % cfg.scan_period
            if cfg.mixer_kind(s) == "attn":
                tc = (min(cfg.sliding_window, max_cache_len)
                      if cfg.is_local_layer(s) and cfg.sliding_window
                      else max_cache_len)
                layer = {"attn": {
                    "k": torch.zeros((batch_size, tc, kvh, hd), dtype=dtype,
                                     device=dev),
                    "v": torch.zeros((batch_size, tc, kvh, hd), dtype=dtype,
                                     device=dev),
                    "cache_pos": torch.full((tc,), -1, dtype=torch.int32,
                                            device=dev)}}
            else:
                layer = {"ssm": SSM.mamba2_init_cache(cfg, batch_size, dtype,
                                                      dev)}
            if cfg.is_encoder_decoder:
                shape = (batch_size, cfg.encoder_seq, kvh, hd)
                layer["cross"] = {
                    "xk": torch.zeros(shape, dtype=dtype, device=dev),
                    "xv": torch.zeros(shape, dtype=dtype, device=dev)}
            cache[f"sub{s}"].append(layer)
        return cache

    def cache_shapes(self, batch_size: int, max_cache_len: int, dtype=None):
        """``init_cache``'s structure as ``meta`` tensors, allocating
        nothing (the reference's ``eval_shape`` of its ``init_cache``)."""
        return self.init_cache(batch_size, max_cache_len, dtype,
                               device="meta")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _write_decode_kv(cache: dict, k: torch.Tensor, v: torch.Tensor,
                     pos, rows=None) -> None:
    """Write one step's k/v (B, 1, KV, hd) into a ring cache in place, at
    slot ``pos % T_cache``: one slot for the batch (int ``pos``) or one per
    lane ((B,) tensor ``pos`` and a (B, T_cache) ``cache_pos``). With
    ``rows`` = [lo, hi), the cache's k / v hold only those slots (a mesh
    rank's block; ``cache_pos`` stays whole): the step is written only
    where its slot falls in them."""
    tc = cache["cache_pos"].shape[-1]
    kd, vd = k[:, 0].to(cache["k"].dtype), v[:, 0].to(cache["v"].dtype)
    if isinstance(pos, int):
        slot = pos % tc
        lo, hi = rows or (0, tc)
        if lo <= slot < hi:
            cache["k"][:, slot - lo] = kd
            cache["v"][:, slot - lo] = vd
        cache["cache_pos"][..., slot] = pos
        return
    lanes = torch.arange(k.shape[0], device=k.device)
    slot = pos % tc
    cache["k"][lanes, slot] = kd
    cache["v"][lanes, slot] = vd
    cache["cache_pos"][lanes, slot] = pos.to(cache["cache_pos"].dtype)


def _build_prefill_cache(k: torch.Tensor, v: torch.Tensor, tc: int) -> dict:
    """Pack computed K/V (B, S, KV, hd) into a ring cache of length tc."""
    s = k.shape[1]
    dev = k.device
    if s <= tc:
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, tc - s))
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, tc - s))
        idx = torch.arange(tc, device=dev)
        cp = torch.where(idx < s, idx, -1)
    else:
        # keep the last tc entries, laid out at slot = abs_pos % tc
        shift = s % tc
        kc = torch.roll(k[:, s - tc:], shift, dims=1)
        vc = torch.roll(v[:, s - tc:], shift, dims=1)
        cp = torch.roll(torch.arange(s - tc, s, device=dev), shift)
    return {"k": kc, "v": vc, "cache_pos": cp.to(torch.int32)}


def build_model(arch: str | ModelConfig, **kw) -> Model:
    return Model(arch, **kw)


def init_params(model: Model, generator: torch.Generator) -> Model:
    return model.init_params(generator)
