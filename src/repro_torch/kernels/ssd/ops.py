"""Public wrappers for the SSD kernel: the full chunked SSD scan =
intra-chunk kernel + inter-chunk recurrence + off-diagonal correction
(port of ``repro/kernels/ssd/ops.py``).

``ssd_chunked(x, dt, a, b_mat, c_mat, chunk, init_state)`` matches
``models.ssm.ssd_chunked_ref``: it returns (y, final_state). It keeps the
reference's split: it pads L to a multiple of the chunk with dt = 0 steps
(state-neutral), runs ``ssd_intra_chunk`` for the intra-chunk part, then
the inter-chunk recurrence as a loop over chunks and the ``y_off``
product in torch ops.

``ssd_intra_chunk`` runs the plain version (``ref.ssd_intra_chunk_plain``)
on CPU tensors. On CUDA tensors it checks dtype (float32 only), shapes
(P in 32/64/128, N in 16/64/128, L a multiple of the chunk),
contiguity and 16-byte alignment, then launches the CUDA kernel or raises. Nothing falls back.

Forward only: the kernel has no backward (training mamba2 on the card
needs one, ROADMAP), and its outputs would carry no gradient history, so
on CUDA tensors the wrapper refuses inputs that require a gradient while
autograd records. On CPU tensors the plain version is differentiable.

``launches`` counts the kernel launches of this process; it grows only
where the kernel is launched.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.chunk_kernel import ssd_intra_chunk_cuda
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain

launches = 0

HEAD_DIMS = (32, 64, 128)
STATE_DIMS = (16, 64, 128)


def _check(x, dt, a, b_mat, c_mat, chunk):
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    expected = {"x": (bsz, l, h, p), "dt": (bsz, l, h), "a": (h,),
                "b_mat": (bsz, l, n), "c_mat": (bsz, l, n)}
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b_mat", b_mat),
                    ("c_mat", c_mat)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"ssd_intra_chunk: {name} is {t.dtype} on "
                             f"{t.device}; the kernel takes float32 on "
                             f"{x.device}")
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"ssd_intra_chunk: {name} has shape "
                             f"{tuple(t.shape)}, expected {expected[name]}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_intra_chunk: {name} is not 16-byte "
                             f"aligned (the kernel copies 16-byte rows)")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_intra_chunk: (P, N) = ({p}, {n}); the kernel "
                         f"takes P in {HEAD_DIMS} and N in {STATE_DIMS}")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"ssd_intra_chunk: L={l} is not a multiple of the "
                         f"chunk {chunk}")


def ssd_intra_chunk(x, dt, a, b_mat, c_mat, *, chunk: int):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b/c: (B, L, N);
    L % chunk == 0. Returns (y_diag (B, L, H, P), states (B, NC, H, P, N),
    in_decay (B, NC, H, Q)), float32."""
    global launches
    if x.device.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, a, b_mat, c_mat, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu tensors, "
                         f"not {x.device}")
    _check(x, dt, a, b_mat, c_mat, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b_mat, c_mat)):
        raise RuntimeError("ssd_intra_chunk: the kernel is forward only; "
                           "run it under torch.no_grad() or "
                           "torch.inference_mode()")
    out = ssd_intra_chunk_cuda(x, dt, a, b_mat, c_mat, chunk=chunk)
    launches += 1
    return out


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    bsz, l0, h, p = x.shape
    n = b_mat.shape[-1]
    if l0 % chunk:
        pad = chunk - l0 % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    l = x.shape[1]
    nc = l // chunk
    y_diag, states, in_dec = ssd_intra_chunk(
        x.contiguous(), dt.contiguous(), a.contiguous(),
        b_mat.contiguous(), c_mat.contiguous(), chunk=chunk)

    # inter-chunk recurrence (sequential over the NC chunks, small)
    chunk_decay = in_dec[..., -1]                        # (B, NC, H)
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)                                   # state BEFORE chunk
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B, NC, H, P, N)

    cc = c_mat.reshape(bsz, nc, chunk, n).float()
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc, prev_states, in_dec)
    y = (y_diag.reshape(bsz, nc, chunk, h, p) + y_off).reshape(bsz, l, h, p)
    return y[:, :l0].to(x.dtype), s
