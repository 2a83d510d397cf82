"""Genetic variation operators (Deb's NSGA-II forms, bounded).

* binary tournament selection on (rank, -crowding) lexicographic keys
* simulated binary crossover (SBX) [Deb & Agrawal 1995]
* polynomial mutation [Deb et al. 2002]

Every operator acts on (..., N, G) genome blocks: a leading island axis
takes the place of the reference's ``vmap``. The first argument ``rng`` is
a uniform source (``repro_torch.core.uniforms``) or a ``torch.Generator``,
consumed in the reference's draw order, so parity tests can feed the
reference's own draws. Hyperparameters (eta, probabilities, the
tournament's ``active`` bound) may be 0-d tensors, or per-run tensors with
the leading dims of the genome block: the meta-GA's inner GAs, one run per
(individual, seed), each with its own hyperparameters. A per-run tensor is
reshaped to broadcast over the trailing (N[, G]) axes. A source may return
draws that broadcast to the requested shape (``SeedUniforms``: one draw
per seed, shared across individuals).

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


def _per_run(v, device, trailing: int) -> torch.Tensor:
    """``v`` as a float32 tensor; a per-run tensor (the runs' leading dims)
    gains ``trailing`` unit dims so that it broadcasts over the trailing
    axes of the genome block."""
    t = _f32(v, device)
    return t.reshape(t.shape + (1,) * trailing) if t.dim() else t


def tournament_select(rng, key: torch.Tensor, num: int, active=None,
                      tsize: int = 2) -> torch.Tensor:
    """Select ``num`` indices by binary tournament on minimizing ``key``
    (..., P) -> (..., num) int64.

    ``active``: optional bound (number, 0-d tensor, or a tensor with key's
    leading dims) — candidates are drawn from [0, active) (meta-GA variable
    population size). Ties between candidates go to the first one drawn,
    as ``jnp.argmin`` does.
    """
    p = key.shape[-1]
    lead = tuple(key.shape[:-1])
    if active is None:
        hi = float(p)
    elif isinstance(active, torch.Tensor):
        hi = _per_run(active, key.device, 2)
    else:
        hi = float(active)
    u = as_source(rng, key.device)(lead + (num, tsize))
    # gather clamps like the reference's out-of-range index semantics
    cand = torch.floor(u * hi).to(torch.int64).clamp_(0, p - 1).expand(
        lead + (num, tsize))
    cand_keys = torch.gather(key, -1, cand.reshape(lead + (num * tsize,))
                             ).view(cand.shape)
    winner = torch.argmin(cand_keys, dim=-1, keepdim=True)
    return torch.gather(cand, -1, winner).squeeze(-1)


def sbx_crossover(rng, x1: torch.Tensor, x2: torch.Tensor, *,
                  eta, prob, lower, upper) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded simulated binary crossover. x1/x2: (..., N, G)."""
    rand = as_source(rng, x1.device)
    eta, prob = _per_run(eta, x1.device, 2), _per_run(prob, x1.device, 1)
    lower, upper = _f32(lower, x1.device), _f32(upper, x1.device)
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
    eta, indpb = _per_run(eta, x.device, 2), _per_run(indpb, x.device, 2)
    prob = _per_run(prob, x.device, 1)
    lower, upper = _f32(lower, x.device), _f32(upper, x.device)
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

    parents: (..., P, G) -> offspring of the same shape (a leading island
    axis, or the meta-GA's (individuals, seeds) runs, whose hyperparameters
    may be per-run tensors). With ``use_kernel`` and P even this is the
    fused kernel, which runs or raises: one launch for every leading dim,
    with one hyperparameter row per run. With P odd the unpaired last
    parent skips crossover and goes through mutation only; the kernel
    pairs parents, so odd P takes the unfused path.
    """
    p, g = parents.shape[-2:]
    dev = parents.device
    if use_kernel and p % 2 == 0:
        rnd = draw_uniforms(rng, p, g, dev,
                            islands=tuple(parents.shape[:-2]))
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
