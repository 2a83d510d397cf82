"""Build and launch of the fused variation CUDA kernel
(``csrc/fused_variation.cu``; it replaces the TPU kernel
``repro/kernels/genetic/fused_variation.py::_kernel``).

SBX crossover -> polynomial mutation -> bound clip in one pass over
pre-drawn uniforms. Parents are the (..., P, G) matrix, read as rows of
the flattened (R, G) matrix, R = I*P even, paired as rows (2r, 2r+1); the
offspring come back interleaved in the same layout. The hyperparameters
are one (5,) row, or one row per run ((..., 5) with the parents' leading
dims); the uniforms may drop leading dims of the parents and are then
shared across them (pair row r reads uniform row r % rnd_pairs). Either
form takes the kernel's BATCHED template. The C launcher picks
the kernel's template: each lane loads a float4 of a pair row where
G % 4 == 0 and the streams are 16-byte aligned, else four pair-genes 32
apart with scalar loads; 64-bit index math where pairs * G >= 2^31. The
library is compiled and loaded at the first launch, never at import, and
its ctypes signatures are set once then.
Callers go through ``ops.fused_variation``, which checks the arguments.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = "fused_variation"
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: C entry point -> argtypes; both return an int
_SIGNATURES = {
    "fused_variation_launch": [_PTR] * 11 + [_I64, _INT, _I64, _I64, _PTR],
    "fused_variation_template": [_PTR] * 8 + [_I64, _INT],
}
_entry: dict = {}


def _c(name: str):
    """The library's C entry point ``name``, with its ctypes signature set
    when the library is first loaded."""
    if not _entry:
        lib = _build.load(KERNEL)
        for fn_name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entry[fn_name] = fn
    return _entry[name]


def template(parents: torch.Tensor, rnd: dict, lower: torch.Tensor,
             upper: torch.Tensor, out: torch.Tensor) -> tuple:
    """(floats per load, index bits) of the template a launch on these
    tensors takes: (4 or 1, 32 or 64), as the C launcher picks it."""
    genes = parents.shape[-1]
    code = _c("fused_variation_template")(
        parents.data_ptr(), rnd["u_cx"].data_ptr(), rnd["m_gene"].data_ptr(),
        rnd["u_mut"].data_ptr(), rnd["m_genem"].data_ptr(), lower.data_ptr(),
        upper.data_ptr(), out.data_ptr(), parents.numel() // genes // 2,
        genes)
    return (4 if code & 1 else 1, 64 if code & 2 else 32)


def fused_variation_cuda(parents: torch.Tensor, rnd: dict,
                         scalars: torch.Tensor, lower: torch.Tensor,
                         upper: torch.Tensor) -> torch.Tensor:
    """parents (..., P, G); rnd: u_cx (..., P/2, G), m_pair (..., P/2, 1),
    m_gene (..., P/2, G), u_mut (..., P, G), m_ind (..., P, 1),
    m_genem (..., P, G), where ``...`` may be a suffix of the parents'
    leading dims; scalars (5,) or (..., 5) with the parents' leading dims
    = [eta_cx, prob_cx, eta_mut, prob_mut, indpb]; lower/upper (G,). All
    float32, contiguous, on one CUDA device (checked by the caller).
    Launches on the current stream and returns the offspring, shaped as
    ``parents``."""
    genes = parents.shape[-1]
    pairs = parents.numel() // genes // 2
    rnd_pairs = rnd["u_cx"].numel() // genes
    run_pairs = pairs // (scalars.numel() // 5)
    index = parents.device.index
    out = torch.empty_like(parents)
    # the launch goes to the current device: switch only where the tensors
    # lie on another one. The current stream is read as a raw handle: a
    # torch.cuda.Stream object costs several µs of host time per call,
    # about a fifth of the kernel's time at the main shape
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = _c("fused_variation_launch")(
            parents.data_ptr(), rnd["u_cx"].data_ptr(),
            rnd["m_pair"].data_ptr(), rnd["m_gene"].data_ptr(),
            rnd["u_mut"].data_ptr(), rnd["m_ind"].data_ptr(),
            rnd["m_genem"].data_ptr(), lower.data_ptr(), upper.data_ptr(),
            scalars.data_ptr(), out.data_ptr(), pairs, genes, rnd_pairs,
            run_pairs, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed with CUDA error "
                           f"{err} (shape={tuple(parents.shape)})")
    return out
