"""Build and launch of the fused variation CUDA kernel
(``csrc/fused_variation.cu``; it replaces the TPU kernel
``repro/kernels/genetic/fused_variation.py::_kernel``).

SBX crossover -> polynomial mutation -> bound clip in one pass over
pre-drawn uniforms. Parents are the flattened (R, G) matrix, R = I*P even,
paired as rows (2r, 2r+1); the offspring come back interleaved in the same
(R, G) layout. The library is compiled and loaded at the first launch,
never at import. Callers go through ``ops.fused_variation``, which checks
the arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "fused_variation"
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_void_p]


def _launcher():
    fn = _build.load(KERNEL).fused_variation_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_variation_cuda(parents: torch.Tensor, rnd: dict,
                         scalars: torch.Tensor, lower: torch.Tensor,
                         upper: torch.Tensor) -> torch.Tensor:
    """parents (R, G); rnd: u_cx (R/2, G), m_pair (R/2, 1), m_gene (R/2, G),
    u_mut (R, G), m_ind (R, 1), m_genem (R, G); scalars (5,) =
    [eta_cx, prob_cx, eta_mut, prob_mut, indpb]; lower/upper (G,). All
    float32, contiguous, on one CUDA device (checked by the caller).
    Launches on the current stream and returns the offspring (R, G)."""
    rows, genes = parents.shape
    out = torch.empty_like(parents)
    launch = _launcher()
    with torch.cuda.device(parents.device):
        stream = torch.cuda.current_stream(parents.device).cuda_stream
        err = launch(parents.data_ptr(), rnd["u_cx"].data_ptr(),
                     rnd["m_pair"].data_ptr(), rnd["m_gene"].data_ptr(),
                     rnd["u_mut"].data_ptr(), rnd["m_ind"].data_ptr(),
                     rnd["m_genem"].data_ptr(), lower.data_ptr(),
                     upper.data_ptr(), scalars.data_ptr(), out.data_ptr(),
                     rows // 2, genes, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed with CUDA error "
                           f"{err} (rows={rows}, genes={genes})")
    return out
