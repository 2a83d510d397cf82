"""DC powerflow, PTDF and LODF: fast contingency screening, batched over
genomes.

DC approximation: B' theta = P with B' the susceptance Laplacian. PTDF maps
injections to line flows; LODF gives post-outage flows without re-solving:

    f_k(outage l) = f_k + LODF[k, l] * f_l

One (n, n) solve at build time, then matrix products per evaluation: all
single-line outages of a genome collapse into one (L, L) product, and full
AC runs only on the top-K screened cases.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.device import available_bytes


class DCModel(NamedTuple):
    ptdf: torch.Tensor          # (L, n)  injection -> flow sensitivity
    lodf: torch.Tensor          # (L, L)  outage distribution factors
    f0_coeff: torch.Tensor      # (L, n)  == ptdf (alias for clarity)
    slack: torch.Tensor         # () int64
    bridge_score: torch.Tensor  # (L,) 1/|1 - PTDF_l|: huge for islanding lines


# bytes of one genome's (L, L) post-outage loadings, per L², in the screen
SCREEN_BYTES_PER_L2 = 8


def build_dc_model(gridt: dict) -> DCModel:
    """Dense PTDF/LODF from branch data. O(n^3) once, reused per eval."""
    f, t = gridt["f_bus"].long(), gridt["t_bus"].long()
    n = gridt["bus_type"].shape[0]
    nl = f.shape[0]
    device = f.device
    b = -torch.imag(1.0 / (1.0 / gridt["y_series"]))          # 1/x
    b = torch.nan_to_num(b, nan=0.0, posinf=0.0, neginf=0.0)

    # incidence (L, n) and Laplacian
    rows = torch.arange(nl, device=device)
    a = torch.zeros((nl, n), device=device)
    a[rows, f] = 1.0
    a[rows, t] = -1.0
    bdiag = b[:, None] * a                                    # (L, n)
    lap = a.T @ bdiag                                         # (n, n)

    slack = torch.argmax((gridt["bus_type"] == 2).to(torch.int32))
    # ground the slack row/col
    e = torch.zeros((n,), device=device)
    e[slack] = 1.0
    lap_g = lap + torch.outer(e, e) * (1.0 + torch.amax(torch.abs(lap)))
    x_inv = torch.linalg.solve_ex(
        lap_g, torch.eye(n, device=device)).result
    ptdf = bdiag @ x_inv                                      # (L, n)
    ptdf = ptdf - ptdf[:, slack][:, None]                     # slack-ref

    # LODF[k, l] = PTDF_k(e_f(l) - e_t(l)) / (1 - PTDF_l(e_f - e_t))
    h = ptdf[:, f] - ptdf[:, t]                               # (L, L)
    denom_raw = 1.0 - torch.diagonal(h)
    denom = torch.where(torch.abs(denom_raw) < 1e-6,
                        torch.where(denom_raw < 0, -1e-6, 1e-6), denom_raw)
    eye = torch.eye(nl, device=device)
    lodf = h / denom[None, :]
    lodf = lodf * (1.0 - eye)                                 # outaged line: 0
    lodf = lodf - eye                                         # own: -f_l
    # |1 - PTDF_l| -> 0 means outaging l (near-)islands the network: the
    # post-outage flows diverge and AC Newton will not converge. Rank those
    # outages maximally critical during screening.
    bridge = 1.0 / torch.clamp_min(torch.abs(denom_raw), 1e-9)
    return DCModel(ptdf=ptdf, lodf=lodf, f0_coeff=ptdf, slack=slack,
                   bridge_score=bridge)


def dc_flows(model: DCModel, p_inj: torch.Tensor) -> torch.Tensor:
    """Base-case DC flows (B, L) from net injections (B, n)."""
    return p_inj @ model.ptdf.T


def screen_contingencies(model: DCModel, p_inj: torch.Tensor,
                         rate: torch.Tensor, top_k: int) -> torch.Tensor:
    """Rank all single-line outages by worst post-outage relative loading
    and return the indices (B, top_k) of the top_k most critical ones per
    genome, p_inj (B, n). Among equal scores the lower index comes first,
    as ``jax.lax.top_k`` orders them: a stable descending sort. Genomes are
    scored in chunks sized to the memory of their (L, L) loadings."""
    nl = rate.shape[0]
    step = max(1, int(available_bytes(p_inj.device)
                      // (SCREEN_BYTES_PER_L2 * nl * nl)))
    return torch.cat([_screen(model, p_inj[s:s + step], rate, top_k)
                      for s in range(0, p_inj.shape[0], step)])


def _screen(model, p_inj, rate, top_k):
    f0 = dc_flows(model, p_inj)                               # (B, L)
    # (B, k lines, l outages)
    post = f0[:, :, None] + model.lodf[None] * f0[:, None, :]
    worst = torch.amax(torch.abs(post) / rate[:, None], dim=1)  # per outage
    del post
    # islanding outages (bridge_score >> 1) are maximally critical
    worst = worst + torch.where(model.bridge_score > 50.0, 1e6, 0.0) \
                  + torch.clamp_max(model.bridge_score, 50.0) * 1e-3
    idx = torch.sort(worst, dim=-1, descending=True, stable=True).indices
    return idx[:, :top_k]
