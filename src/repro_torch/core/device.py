"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A run that
asked for the GPU on a machine without one raises here: it never continues
on the CPU in its place. ``meta`` builds shapes without data (a model at
published widths for its sharding specs). A batched computation sizes its chunks from
:func:`available_bytes`.
"""
from __future__ import annotations

import torch

# share of the device's available memory a chunk of work may take; on the
# CPU, the bytes a chunk may take
MEMORY_SHARE = 0.5
CPU_CHUNK_BYTES = 4 << 30


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device`` ("cuda", "cuda:N", "cpu", "meta"
    or a torch.device); raises RuntimeError when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev


def available_bytes(device: torch.device) -> float:
    """Bytes one chunk of work may take: on CUDA, MEMORY_SHARE of the free
    device memory plus what PyTorch's allocator holds unused; on the CPU,
    CPU_CHUNK_BYTES."""
    if device.type != "cuda":
        return CPU_CHUNK_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    return MEMORY_SHARE * (free + torch.cuda.memory_reserved(device)
                           - torch.cuda.memory_allocated(device))
