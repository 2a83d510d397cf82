"""Device meshes (the port of ``repro.launch.mesh``) and the process group
under them.

The reference makes its meshes from the devices JAX sees. The port's mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, one rank per process, with the reference's axis
names and order. :func:`init_distributed` sets that group up for a
caller: NCCL where every rank of a node has a card of its own, gloo where
ranks share a card or run on the CPU (``core.collectives`` stages CUDA tensors
through host memory for gloo). Nothing here touches a process group at
import.

Single pod: 16x16 = 256 ranks, axes (data, model).
Multi-pod:  2 pods = 512 ranks, axes (pod, data, model) — `pod` is pure
data parallelism across the inter-pod links.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

POD = (16, 16)


def init_distributed(rank: int, world_size: int, init_method: str, *,
                     device="cuda",
                     local_world_size: Optional[int] = None) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's device. On ``cuda`` rank r takes card
    ``r % device_count`` (raising without a GPU), over NCCL when the node
    has at least as many cards as ranks and over gloo when ranks share a
    card; on ``cpu`` the group is gloo. The node's ranks are
    ``local_world_size``, else the launcher's ``LOCAL_WORLD_SIZE``, else
    ``world_size`` (one node). ``init_method`` is a ``file://`` or
    ``tcp://`` address every rank is given."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        if local_world_size is None:
            local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                                  world_size))
        backend = "nccl" if local_world_size <= cards else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def _mesh(shape: tuple, axes: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"a {shape} mesh over {axes} needs {n} ranks; the process group "
            f"has {world or 'none (call init_distributed first)'}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): 256 or 512 ranks."""
    if multi_pod:
        return _mesh((2,) + POD, ("pod", "data", "model"), device)
    return _mesh(POD, ("data", "model"), device)


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """(data, model) mesh over ("data", "model"): the process group must
    have data x model ranks (tests / examples)."""
    return _mesh((data, model), ("data", "model"), device)
