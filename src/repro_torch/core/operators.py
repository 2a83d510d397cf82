"""Genetic variation operators (Deb's NSGA-II forms, bounded).

* binary tournament selection on (rank, -crowding) lexicographic keys
* simulated binary crossover (SBX) [Deb & Agrawal 1995]
* polynomial mutation [Deb et al. 2002]

Every operator acts on (..., N, G) genome blocks: a leading island axis
takes the place of the reference's ``vmap``. The first argument ``rng`` is
a uniform source (``repro_torch.core.uniforms``) or a ``torch.Generator``,
consumed in the reference's draw order, so parity tests can feed the
reference's own draws. Hyperparameters (eta, probabilities) may be 0-d
tensors, as the meta-GA needs.

``variation`` dispatches to the fused CUDA kernel in
``repro_torch.kernels.genetic`` when asked to and P is even; these
functions are its unfused counterpart.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.uniforms import as_source
from repro_torch.kernels.genetic import ops as gk
from repro_torch.kernels.genetic.ref import draw_uniforms

EPS = 1e-14


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def tournament_select(rng, key: torch.Tensor, num: int, active=None,
                      tsize: int = 2) -> torch.Tensor:
    """Select ``num`` indices by binary tournament on minimizing ``key``
    (..., P) -> (..., num) int64.

    ``active``: optional bound (number or 0-d tensor) — candidates are drawn
    from [0, active) (meta-GA variable population size). Ties between
    candidates go to the first one drawn, as ``jnp.argmin`` does.
    """
    p = key.shape[-1]
    hi = float(p) if active is None else _f32(active, key.device)
    u = as_source(rng, key.device)(tuple(key.shape[:-1]) + (num, tsize))
    # gather clamps like the reference's out-of-range index semantics
    cand = torch.floor(u * hi).to(torch.int64).clamp_(0, p - 1)
    cand_keys = torch.gather(key, -1, cand.flatten(-2)).view(cand.shape)
    winner = torch.argmin(cand_keys, dim=-1, keepdim=True)
    return torch.gather(cand, -1, winner).squeeze(-1)


def sbx_crossover(rng, x1: torch.Tensor, x2: torch.Tensor, *,
                  eta, prob, lower, upper) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded simulated binary crossover. x1/x2: (..., N, G)."""
    rand = as_source(rng, x1.device)
    eta, prob, lower, upper = (_f32(v, x1.device)
                               for v in (eta, prob, lower, upper))
    do_pair = rand(x1.shape[:-1]) < prob                       # (..., N)
    do_gene = rand(x1.shape) < 0.5                             # per-gene
    u = rand(x1.shape)

    y1 = torch.minimum(x1, x2)
    y2 = torch.maximum(x1, x2)
    span = torch.clamp_min(y2 - y1, EPS)

    def betaq_for(beta):
        alpha = 2.0 - torch.pow(beta, -(eta + 1.0))
        inside = u <= 1.0 / alpha
        return torch.where(
            inside,
            torch.pow(u * alpha, 1.0 / (eta + 1.0)),
            torch.pow(1.0 / torch.clamp_min(2.0 - u * alpha, EPS),
                      1.0 / (eta + 1.0)))

    beta1 = 1.0 + 2.0 * (y1 - lower) / span
    beta2 = 1.0 + 2.0 * (upper - y2) / span
    c1 = 0.5 * ((y1 + y2) - betaq_for(beta1) * (y2 - y1))
    c2 = 0.5 * ((y1 + y2) + betaq_for(beta2) * (y2 - y1))
    c1 = torch.minimum(torch.maximum(c1, lower), upper)
    c2 = torch.minimum(torch.maximum(c2, lower), upper)

    apply = do_pair[..., None] & do_gene
    o1 = torch.where(apply, c1, x1)
    o2 = torch.where(apply, c2, x2)
    return o1, o2


def polynomial_mutation(rng, x: torch.Tensor, *, eta, prob, indpb, lower,
                        upper) -> torch.Tensor:
    """Bounded polynomial mutation. x: (..., N, G).

    ``prob`` gates whole individuals (paper Tab. 3/4 semantics); ``indpb``
    gates genes within a mutating individual (DEAP's indpb).
    """
    rand = as_source(rng, x.device)
    eta, prob, indpb, lower, upper = (_f32(v, x.device)
                                      for v in (eta, prob, indpb, lower,
                                                upper))
    do_ind = rand(x.shape[:-1]) < prob
    do_gene = rand(x.shape) < indpb
    u = rand(x.shape)

    span = upper - lower
    d1 = (x - lower) / span
    d2 = (upper - x) / span
    mut_pow = 1.0 / (eta + 1.0)

    lo_branch = torch.pow(
        torch.clamp_min(2.0 * u + (1.0 - 2.0 * u)
                        * torch.pow(1.0 - d1, eta + 1.0), EPS), mut_pow) - 1.0
    hi_branch = 1.0 - torch.pow(
        torch.clamp_min(2.0 * (1.0 - u) + 2.0 * (u - 0.5)
                        * torch.pow(1.0 - d2, eta + 1.0), EPS), mut_pow)
    deltaq = torch.where(u < 0.5, lo_branch, hi_branch)

    x_new = torch.minimum(torch.maximum(x + deltaq * span, lower), upper)
    apply = do_ind[..., None] & do_gene
    return torch.where(apply, x_new, x)


def variation(rng, parents: torch.Tensor, *, eta_cx, prob_cx, eta_mut,
              prob_mut, indpb, lower, upper,
              use_kernel: bool = False) -> torch.Tensor:
    """SBX over consecutive parent pairs, then polynomial mutation.

    parents: (P, G) or (I, P, G) -> offspring of the same shape. With
    ``use_kernel`` and P even this is the fused kernel, which runs or
    raises. With P odd the unpaired last parent skips crossover and goes
    through mutation only; the kernel pairs parents, so odd P takes the
    unfused path.
    """
    p, g = parents.shape[-2:]
    dev = parents.device
    if use_kernel and p % 2 == 0:
        islands = parents.shape[0] if parents.dim() == 3 else None
        rnd = draw_uniforms(rng, p, g, dev, islands=islands)
        lo = _f32(lower, dev).expand(g).contiguous()
        hi = _f32(upper, dev).expand(g).contiguous()
        scalars = gk.pack_scalars(eta_cx, prob_cx, eta_mut, prob_mut, indpb,
                                  device=dev)
        return gk.fused_variation(parents, rnd, scalars, lo, hi)
    rand = as_source(rng, dev)
    paired = parents[..., :p - 1, :] if p % 2 else parents
    p1, p2 = paired[..., 0::2, :], paired[..., 1::2, :]
    o1, o2 = sbx_crossover(rand, p1, p2, eta=eta_cx, prob=prob_cx,
                           lower=lower, upper=upper)
    off = torch.stack([o1, o2], dim=-2).reshape(paired.shape)
    if p % 2:
        off = torch.cat([off, parents[..., p - 1:, :]], dim=-2)
    return polynomial_mutation(rand, off, eta=eta_mut, prob=prob_mut,
                               indpb=indpb, lower=lower, upper=upper)
