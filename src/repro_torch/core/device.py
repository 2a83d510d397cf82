"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A run that
asked for the GPU on a machine without one raises here: it never continues
on the CPU in its place.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device`` ("cuda", "cuda:N", "cpu" or a
    torch.device); raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
