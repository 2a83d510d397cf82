"""Collectives over a mesh axis: what GSPMD inserts into the reference's
sharded programs, written out for the port's process groups.

``all_gather(x, sizes, group, axis)`` concatenates every rank's block of
rows (uneven blocks allowed: ``sizes[r]`` is rank r's length along
``dim``, in the group's rank order, the order of ``torch.tensor_split``
that every caller shards with). Each block is padded to the longest, so
one ``torch.distributed.all_gather`` of equal buffers carries them.
``reduce_scatter(x, sizes, group, axis)`` is its transpose: the sum over
the group of every rank's whole ``x``, of which each rank keeps its block
(padded the same way). ``all_reduce(x, group, axis, op)`` sums (or takes
the max or min) elementwise over the group.

* CUDA tensors on an NCCL group go to NCCL as they are.
* CUDA tensors on a gloo group (ranks sharing one card) are staged through
  host memory explicitly: copied to pinned CPU buffers, reduced or
  gathered, copied back. A gloo group never sees a CUDA tensor, and
  nothing tries NCCL first.

``counts`` records per mesh axis the calls and the bytes of each call's
full-size buffer (the gathered buffer of an all-gather, the input of a
reduce-scatter, the tensor of an all-reduce; padding included), the
staged calls and bytes among them, and the calls and bytes by kind
("ops", "op_bytes"), so tests, ``chip_smoke.py`` and the dry run can show
which collectives ran.
``reset_counts()`` zeroes them.

The autograd pairs that training over a mesh needs carry a collective in
one direction and its transpose in the other: ``Gather``, an all-gather
whose gradient is reduce-scattered (or cut to the block where every rank
computed it whole); ``CopyToTP``, the identity whose gradient is
all-reduced ("f"); ``ReduceFromTP``, the all-reduce whose gradient passes
through ("g"). Sequence parallelism replaces "f" and "g" by two pairs
along the sequence: ``Gather`` before a column-parallel product, and
``ReduceScatter`` after a row-parallel one, whose gradient is
all-gathered; ``Split`` cuts a tensor every rank holds whole into the
rank's block, its gradient all-gathered too.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

#: {axis: {"calls", "bytes", "staged_calls", "staged_bytes", "ops",
#: "op_bytes"}} of this process
counts: dict = {}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def reset_counts() -> None:
    counts.clear()


def _count(axis: str, nbytes: int, staged: bool, op: str) -> None:
    c = counts.setdefault(axis, {"calls": 0, "bytes": 0, "staged_calls": 0,
                                 "staged_bytes": 0, "ops": {},
                                 "op_bytes": {}})
    c["ops"][op] = c["ops"].get(op, 0) + 1
    c["op_bytes"][op] = c["op_bytes"].get(op, 0) + nbytes
    c["calls"] += 1
    c["bytes"] += nbytes
    if staged:
        c["staged_calls"] += 1
        c["staged_bytes"] += nbytes


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _pinned(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``x`` (a staging buffer)."""
    return _pinned(x.shape, x.dtype).copy_(x)


def _pad_rows(x: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    if x.shape[dim] >= width:
        return x
    pad = list(x.shape)
    pad[dim] = width - x.shape[dim]
    return torch.cat([x, x.new_zeros(pad)], dim)


def all_gather(x: torch.Tensor, sizes: Sequence[int], group, axis: str,
               dim: int = 0) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, concatenated in the
    group's rank order; ``sizes`` holds each rank's block length."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    sizes = [int(s) for s in sizes]
    if len(sizes) != world or x.shape[dim] != sizes[rank]:
        raise ValueError(f"all_gather over {axis!r}: rank {rank} of {world} "
                         f"holds {x.shape[dim]} rows along dim {dim}, block "
                         f"sizes {sizes}")
    x = _pad_rows(x, max(sizes), dim)
    staged = _staged(x, group)
    buf = _to_host(x) if staged else x.contiguous()
    parts = [_pinned(buf.shape, buf.dtype) if staged else
             torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf, group=group)
    blocks = [p.narrow(dim, 0, s) for p, s in zip(parts, sizes)]
    _count(axis, world * buf.numel() * buf.element_size(), staged,
           "all_gather")
    if not staged:
        return torch.cat(blocks, dim)
    shape = list(x.shape)
    shape[dim] = sum(sizes)
    return torch.cat(blocks, dim, out=_pinned(shape, x.dtype)).to(x.device)


def reduce_scatter(x: torch.Tensor, sizes: Sequence[int], group, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """This rank's block (``sizes`` in the group's rank order along
    ``dim``) of the sum over the group of every rank's whole ``x``."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    sizes = [int(s) for s in sizes]
    if len(sizes) != world or x.shape[dim] != sum(sizes):
        raise ValueError(f"reduce_scatter over {axis!r}: {x.shape[dim]} rows "
                         f"along dim {dim} for blocks {sizes}")
    width = max(sizes)
    blocks = [_pad_rows(b, width, dim)
              for b in torch.split(x, sizes, dim)]
    flat = torch.cat([b.movedim(dim, 0) for b in blocks], 0)
    staged = _staged(x, group)
    buf = _to_host(flat) if staged else flat.contiguous()
    shape = (width,) + tuple(buf.shape[1:])
    out = (_pinned(shape, buf.dtype) if staged else
           torch.empty(shape, dtype=buf.dtype, device=buf.device))
    dist.reduce_scatter(out, list(buf.chunk(world, 0)), group=group)
    _count(axis, buf.numel() * buf.element_size(), staged, "reduce_scatter")
    out = out.narrow(0, 0, sizes[rank]).movedim(0, dim)
    return out.to(x.device) if staged else out


def all_reduce(x: torch.Tensor, group, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """The elementwise ``op`` ("sum", "max" or "min") of ``x`` over the
    group, as a new tensor (``x`` is left as it is)."""
    staged = _staged(x, group)
    buf = _to_host(x.detach()) if staged else x.detach().clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    _count(axis, buf.numel() * buf.element_size(), staged,
           f"all_reduce_{op}")
    return buf.to(x.device) if staged else buf


class Gather(torch.autograd.Function):
    """All-gather along ``dim`` in the forward; in the backward, the
    gradient summed over the group into this rank's block (``grad=
    "scatter"``: one reduce-scatter), or only cut to it (``"none"``: every
    rank computed the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, sizes, group, axis, dim, grad):
        ctx.args = (sizes, group, axis, dim, grad)
        return all_gather(x, sizes, group, axis, dim)

    @staticmethod
    def backward(ctx, g):
        sizes, group, axis, dim, grad = ctx.args
        if grad == "scatter":
            return reduce_scatter(g, sizes, group, axis, dim), \
                None, None, None, None, None
        lo = sum(sizes[:dist.get_rank(group)])
        return g.narrow(dim, lo, sizes[dist.get_rank(group)]).contiguous(), \
            None, None, None, None, None


class CopyToTP(torch.autograd.Function):
    """"f": the identity in the forward, the gradient all-reduced over the
    group in the backward (the input of column-parallel products, whose
    every rank contributes part of its gradient)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


class ReduceFromTP(torch.autograd.Function):
    """"g": the sum over the group in the forward, the gradient passed
    through in the backward (partial sums of row-parallel products; and
    a replicated loss's sums over ranks)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        return all_reduce(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` in the forward (every rank's partial
    sums, of which this rank keeps its block of ``sizes``); the gradient
    all-gathered in the backward."""

    @staticmethod
    def forward(ctx, x, sizes, group, axis, dim):
        ctx.args = (sizes, group, axis, dim)
        return reduce_scatter(x, sizes, group, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None, None


class Split(torch.autograd.Function):
    """This rank's block (of ``sizes``, along ``dim``) of a tensor every
    rank of the group holds whole and alike, as a tensor of its own; in the
    backward, every rank's block of the gradient all-gathered, so each rank
    holds the whole gradient, as every rank's whole computation before the
    split needs it."""

    @staticmethod
    def forward(ctx, x, sizes, group, axis, dim):
        ctx.args = (sizes, group, axis, dim)
        rank = dist.get_rank(group)
        return x.narrow(dim, sum(sizes[:rank]), sizes[rank]).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None, None
