"""Plain PyTorch versions for the SSD kernel: ``ssd_intra_chunk_plain``
computes what the CUDA kernel computes (the intra-chunk dual form), in the
TPU kernel's order of operations; ``ssd_chunked_ref`` (from
``models.ssm``) is the whole chunked scan, the oracle of ``ssd_chunked``."""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunked_ref, ssd_decode_step


def ssd_intra_chunk_plain(x, dt, a, b_mat, c_mat, *, chunk: int):
    """x: (B, L, H, P); dt: (B, L, H) (softplus'd); a: (H,); b/c: (B, L, N);
    L % chunk == 0. Returns (y_diag (B, L, H, P), states (B, NC, H, P, N),
    in_decay (B, NC, H, Q)), all float32."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    nc, q = l // chunk, chunk
    f32 = torch.float32
    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32).transpose(2, 3)   # (B,NC,H,Q)
    bc = b_mat.reshape(bsz, nc, q, n).to(f32)
    cc = c_mat.reshape(bsz, nc, q, n).to(f32)
    da = dtc * a.to(f32)[None, None, :, None]
    cum = torch.cumsum(da, dim=-1)                             # (B,NC,H,Q)
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # exp only on and below the diagonal: above it the exponent is
    # positive and may overflow
    diff = cum[..., :, None] - cum[..., None, :]
    lmat = torch.exp(torch.where(tril, diff, -torch.inf))      # (B,NC,H,Q,Q)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)               # (B,NC,Q,Q)
    w = cb[:, :, None] * lmat * dtc[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", w, xc).reshape(bsz, l, h, p)
    dec_end = torch.exp(cum[..., -1:] - cum) * dtc             # (B,NC,H,Q)
    states = torch.einsum("bcjhp,bcjn,bchj->bchpn", xc, bc, dec_end)
    return y, states, torch.exp(cum)


__all__ = ["ssd_chunked_ref", "ssd_decode_step", "ssd_intra_chunk_plain"]
