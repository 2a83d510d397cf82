"""Mamba-2 (SSD — state-space duality) sequence mixer [arXiv:2405.21060]
(port of ``repro/models/ssm.py``).

Block layout follows the official Mamba-2:

    u -> in_proj -> [z | x | B | C | dt]
    [x|B|C] -> causal depthwise conv (width W) -> silu
    y = SSD(x, dt, A, B, C) + D * x
    y = RMSNorm(y * silu(z))          (gated norm)
    out = y @ out_proj

SSD is computed with the chunked dual form: intra-chunk attention-like
dense products + an inter-chunk state recurrence. ``n_groups = 1``: B and C
are shared across heads. ``ssd_chunked_ref`` below is the plain oracle; the
CUDA kernel in ``repro_torch.kernels.ssd`` is a drop-in for the intra-chunk
part (``mamba2_forward(use_kernel=True)``).

Decode keeps O(1) state: (conv tail, SSD state (H, P, N)).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': out[..., i, j] = sum_{k=j+1..i} a[..., k]
    for i >= j, -inf otherwise. a: (..., Q) -> (..., Q, Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (plain oracle).

    x:     (B, L, H, P)    inputs per head
    dt:    (B, L, H)       softplus'd timesteps (>0)
    a:     (H,)            negative state decay rates (A = -exp(A_log))
    b_mat: (B, L, N)       input->state projection (n_groups=1)
    c_mat: (B, L, N)       state->output projection
    Returns (y (B, L, H, P), final_state (B, H, P, N)).
    """
    bsz, l0, h, p = x.shape
    n = b_mat.shape[-1]
    if l0 % chunk:
        # pad with dt=0 steps: decay exp(0)=1 and zero update, so padding is
        # state-neutral and valid outputs are unaffected.
        pad = chunk - l0 % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    l = x.shape[1]
    nc = l // chunk
    f32 = torch.float32

    xc = x.reshape(bsz, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, h).to(f32)
    bc = b_mat.reshape(bsz, nc, chunk, n).to(f32)
    cc = c_mat.reshape(bsz, nc, chunk, n).to(f32)
    da = dtc * a.to(f32)[None, None, None, :]               # (B,NC,Q,H) <= 0

    # ---- intra-chunk (diagonal) term -------------------------------------
    da_h = da.movedim(-1, 2)                                # (B,NC,H,Q)
    lmat = torch.exp(_segsum(da_h))                         # (B,NC,H,Q,Q)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)            # (B,NC,Q,Q)
    w = cb[:, :, None] * lmat                               # (B,NC,H,Q,Q)
    y_diag = torch.einsum("bchij,bcjh,bcjhp->bcihp", w, dtc, xc)

    # ---- chunk states -----------------------------------------------------
    cum = torch.cumsum(da_h, dim=-1)                        # (B,NC,H,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    sbx = torch.einsum("bchj,bcjh,bcjn,bcjhp->bchpn",
                       decay_to_end, dtc, bc, xc)           # (B,NC,H,P,N)

    # ---- inter-chunk recurrence ------------------------------------------
    chunk_decay = torch.exp(da_h.sum(-1))                   # (B,NC,H)
    s = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(s)                                      # state BEFORE chunk
        s = s * chunk_decay[:, c, :, None, None] + sbx[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,NC,H,P,N)

    # ---- inter-chunk output: C_i . exp(cum_i) . state_prev ----------------
    in_decay = torch.exp(cum)
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc, prev_states, in_decay)

    y = (y_diag + y_off).reshape(bsz, l, h, p)[:, :l0]
    return y.to(x.dtype), s


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence.

    state: (B,H,P,N); x: (B,H,P); dt: (B,H); b/c: (B,N).
    y_t = C . state_t ; state_t = exp(dt*a)*state_{t-1} + dt * x B^T.
    """
    f32 = torch.float32
    dec = torch.exp(dt.to(f32) * a.to(f32)[None])           # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt.to(f32), x.to(f32),
                       b_mat.to(f32))
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c_mat.to(f32), new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba-2 block (p maps the reference's parameter names to tensors)
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)


def mamba2_forward(cfg: ModelConfig, p, u: torch.Tensor, *,
                   use_kernel: bool = False, return_cache: bool = False):
    """Train/prefill path. u: (B, L, D) -> (B, L, D) [, decode cache]."""
    bsz, l, _ = u.shape
    d_in, n, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_head_dim)
    w = cfg.ssm_conv_width

    proj = u @ p["in_proj"]                                 # (B,L,2*din+2N+nh)
    z, xbc_x, b_mat, c_mat, dt = _split_proj(cfg, proj)
    xbc = torch.cat([xbc_x, b_mat, c_mat], dim=-1)          # conv over x|B|C

    # causal depthwise conv, width W, as the sum of W shifted products
    # (F.conv1d would go through cuDNN, in TF32 by default on the card)
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    conv = sum(pad[:, i:i + l] * p["conv"][i][None, None] for i in range(w))
    conv = conv + p["conv_bias"][None, None]
    conv = F.silu(conv)
    x, b_mat, c_mat = torch.split(conv, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    a = -torch.exp(p["A_log"].float())                      # (H,)

    xh = x.reshape(bsz, l, nh, hd)
    if use_kernel:
        from repro_torch.kernels.ssd import ops as ssd_ops
        y, final_state = ssd_ops.ssd_chunked(xh, dt, a, b_mat, c_mat,
                                             cfg.ssm_chunk)
    else:
        y, final_state = ssd_chunked_ref(xh, dt, a, b_mat, c_mat,
                                         cfg.ssm_chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, l, d_in)

    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_cache:
        return out
    conv_tail = (xbc[:, l - (w - 1):] if l >= w - 1
                 else F.pad(xbc, (0, 0, w - 1 - l, 0)))
    return out, {"conv": conv_tail.contiguous(), "state": final_state}


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype,
                      device="cpu") -> dict:
    d_conv_in = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_conv_in),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }


def mamba2_decode(cfg: ModelConfig, p, u: torch.Tensor,
                  cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token decode. u: (B, 1, D) -> ((B, 1, D), new cache)."""
    bsz = u.shape[0]
    d_in, n, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_head_dim)

    proj = u[:, 0] @ p["in_proj"]                           # (B, ...)
    z, x_new, b_new, c_new, dt = _split_proj(cfg, proj)
    xbc_new = torch.cat([x_new, b_new, c_new], dim=-1)

    hist = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)  # (B, W, C)
    conv = (hist * p["conv"][None]).sum(1) + p["conv_bias"]
    conv = F.silu(conv)
    x, b_mat, c_mat = torch.split(conv, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None])
    a = -torch.exp(p["A_log"].float())

    xh = x.reshape(bsz, nh, hd)
    y, new_state = ssd_decode_step(cache["state"], xh, dt, a, b_mat, c_mat)
    y = y + xh * p["D"].to(y.dtype)[None, :, None]
    y = y.reshape(bsz, d_in)

    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv": hist[:, 1:], "state": new_state}
