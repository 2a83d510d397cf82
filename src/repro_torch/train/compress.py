"""Gradient compression for the cross-pod reduction (port of
``repro/train/compress.py``; beyond the paper).

At 2+ pods the gradient reduction over the ``pod`` axis crosses the slower
inter-pod links, while the intra-pod reduction stays on the fast ones.
Quantizing the pod-crossing traffic to int8 with stochastic rounding cuts
those bytes 4x at <1e-2 relative error per element (unbiased).

Per-leaf symmetric quantization. The reduction is an all-gather of the
int8 values (and of each rank's float32 scale) plus a local sum, so the
wire format really is 8-bit (a sum of int8 would move wider partials):
``core.collectives`` counts the int8 bytes on the ``pod`` axis.

The rounding draws come from a uniform source (``core.uniforms``), in the
place of the reference's key: one source per leaf, ``rng`` an int seed
(leaf i draws from a generator seeded by
``core.uniforms.fold_in(rng, i)``) or a sequence
of sources, one per leaf (parity tests feed the reference's
``jax.random.uniform`` draws through ``ArrayUniforms``). A leaf that is a
block of a whole tensor (``layouts``) draws the whole tensor's uniforms
and keeps its block, as the reference draws per leaf of the global shape.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from repro_torch.core import collectives
from repro_torch.core.uniforms import GeneratorUniforms, fold_in
from repro_torch.models.sharding import ShardingCtx

def quantize(x: torch.Tensor, uniforms: Callable, bits: int = 8):
    """Unbiased stochastic-rounding quantization: (q int8, scale), one
    U[0, 1) draw of ``x``'s shape from ``uniforms`` deciding each
    element's rounding up."""
    qmax = 2 ** (bits - 1) - 1
    x32 = x.float()
    scale = x32.abs().max() / qmax + 1e-30
    y = x32 / scale
    lo = torch.floor(y)
    up = uniforms(tuple(x.shape)).to(x.device) < (y - lo)
    q = torch.clamp(lo + up.float(), -qmax - 1, qmax)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _sources(rng: Union[int, Sequence[Callable]], n: int, device
             ) -> Sequence[Callable]:
    if isinstance(rng, int):
        return [GeneratorUniforms(torch.Generator(device=device).manual_seed(
            fold_in(rng, i)), device) for i in range(n)]
    if len(rng) != n:
        raise ValueError(f"{len(rng)} uniform sources for {n} leaves")
    return rng


def _block_source(source: Callable, lay, ctx: ShardingCtx) -> Callable:
    """A source whose draw of a block's shape is that block of a draw of
    the whole leaf's."""
    return lambda shape: lay.block(source(lay.shape), ctx)


def compressed_psum_tree(grads: Dict[str, torch.Tensor], axis_name: str,
                         rng, ctx: ShardingCtx,
                         layouts: Optional[dict] = None
                         ) -> Dict[str, torch.Tensor]:
    """The mean over ``axis_name`` of every leaf of ``grads`` (by name),
    each rank's leaf quantized to int8 (the same draws on every rank of the
    axis, as the reference's shared key), all-gathered as int8 with its
    scale, dequantized and summed in rank order."""
    layouts = layouts or {}
    axes = ctx.live(axis_name)
    n = ctx.axes_size(axis_name)
    device = next(iter(grads.values())).device
    out = {}
    for (name, x), src in zip(grads.items(),
                              _sources(rng, len(grads), device)):
        if name in layouts:
            src = _block_source(src, layouts[name], ctx)
        q, scale = quantize(x, src)
        if axes:
            group, label = ctx.group(axes), "+".join(axes)
            qg = collectives.all_gather(q[None], [1] * n, group, label)
            sg = collectives.all_gather(scale.reshape(1), [1] * n, group,
                                        label)
        else:
            qg, sg = q[None], scale.reshape(1)
        summed = (qg.float() * sg.reshape((-1,) + (1,) * x.ndim)).sum(0)
        out[name] = (summed / n).to(x.dtype)
    return out


def compressed_allgather_mean(stacked: Dict[str, torch.Tensor],
                              rng) -> Dict[str, torch.Tensor]:
    """The compressed mean of leaves that carry a leading per-pod axis, on
    one rank (the reference's GSPMD formulation without a mesh): each
    pod's slice quantized with its own draws (``rng``: an int seed, or per
    leaf a sequence of per-pod sources), dequantized and averaged."""
    device = next(iter(stacked.values())).device
    out = {}
    for i, (name, x) in enumerate(stacked.items()):
        n = x.shape[0]
        pods = (rng[i] if not isinstance(rng, int) else
                _sources(fold_in(rng, i), n, device))
        qs = [quantize(x[j], pods[j]) for j in range(n)]
        q = torch.stack([a for a, _ in qs])
        scale = torch.stack([b for _, b in qs])
        summed = (q.float() * scale.reshape((n,) + (1,) * (q.ndim - 1))
                  ).sum(0)
        out[name] = (summed / n).to(x.dtype)
    return out
