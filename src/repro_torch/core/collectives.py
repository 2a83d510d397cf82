"""Collectives over a mesh axis: what GSPMD inserts into the reference's
sharded programs, written out for the port's process groups.

``all_gather(x, sizes, group, axis)`` concatenates every rank's block of
rows (uneven blocks allowed: ``sizes[r]`` is rank r's length along
``dim``, in the group's rank order, the order of ``torch.tensor_split``
that every caller shards with). Each block is padded to the longest, so
one ``torch.distributed.all_gather`` of equal buffers carries them.

* CUDA tensors on an NCCL group go to NCCL as they are.
* CUDA tensors on a gloo group (ranks sharing one card) are staged through
  host memory explicitly: copied to the CPU, gathered, copied back. A gloo
  group never sees a CUDA tensor, and nothing tries NCCL first.

``counts`` records per mesh axis the calls and the bytes each rank
received (the gathered buffer, padding included), and the staged calls
and bytes among them, so tests and ``chip_smoke.py`` can show that a
collective ran. ``reset_counts()`` zeroes them.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

#: {axis: {"calls", "bytes", "staged_calls", "staged_bytes"}} of this process
counts: dict = {}


def reset_counts() -> None:
    counts.clear()


def _count(axis: str, nbytes: int, staged: bool) -> None:
    c = counts.setdefault(axis, {"calls": 0, "bytes": 0, "staged_calls": 0,
                                 "staged_bytes": 0})
    c["calls"] += 1
    c["bytes"] += nbytes
    if staged:
        c["staged_calls"] += 1
        c["staged_bytes"] += nbytes


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
    width = max(sizes)
    if x.shape[dim] < width:
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)
    _count(axis, world * buf.numel() * buf.element_size(), staged)
    return out.to(x.device) if staged else out

