"""Plain PyTorch version of the fused variation kernel.

A line-for-line mirror of ``repro/kernels/genetic/ref.py``: the math of
``operators.sbx_crossover`` + ``operators.polynomial_mutation``, phrased
over pre-drawn uniforms so the CUDA kernel (which receives the same
uniforms) can be held against it. It runs on any device and takes any
number of leading (island) dimensions. The five hyperparameters are cast
to float32 tensors first, so every exponent is formed in float32 as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.uniforms import as_source

EPS = 1e-14


def fused_variation_ref(x1, x2, rnd, *, eta_cx, prob_cx, eta_mut, prob_mut,
                        indpb, lower, upper):
    """x1/x2: (..., P2, G) parent pairs; rnd: dict of pre-drawn uniforms:
       u_cx (..., P2, G), m_pair (..., P2, 1), m_gene (..., P2, G),
       u_mut (..., P, G), m_ind (..., P, 1), m_genem (..., P, G)  [P = 2*P2]
    Returns offspring (..., P, G) interleaved (o1, o2 per pair)."""
    f32 = dict(dtype=torch.float32, device=x1.device)
    eta_cx, prob_cx, eta_mut, prob_mut, indpb, lower, upper = (
        torch.as_tensor(v, **f32)
        for v in (eta_cx, prob_cx, eta_mut, prob_mut, indpb, lower, upper))
    u = rnd["u_cx"]
    y1 = torch.minimum(x1, x2)
    y2 = torch.maximum(x1, x2)
    span = torch.clamp_min(y2 - y1, EPS)

    def betaq(beta):
        alpha = 2.0 - torch.pow(beta, -(eta_cx + 1.0))
        return torch.where(
            u <= 1.0 / alpha,
            torch.pow(u * alpha, 1.0 / (eta_cx + 1.0)),
            torch.pow(1.0 / torch.clamp_min(2.0 - u * alpha, EPS),
                      1.0 / (eta_cx + 1.0)))

    b1 = 1.0 + 2.0 * (y1 - lower) / span
    b2 = 1.0 + 2.0 * (upper - y2) / span
    c1 = _clip(0.5 * ((y1 + y2) - betaq(b1) * (y2 - y1)), lower, upper)
    c2 = _clip(0.5 * ((y1 + y2) + betaq(b2) * (y2 - y1)), lower, upper)

    apply_cx = (rnd["m_pair"] < prob_cx) & (rnd["m_gene"] < 0.5)
    o1 = torch.where(apply_cx, c1, x1)
    o2 = torch.where(apply_cx, c2, x2)
    off = torch.stack([o1, o2], dim=-2).reshape(
        *x1.shape[:-2], -1, x1.shape[-1])                    # (..., P, G)

    # polynomial mutation
    u2 = rnd["u_mut"]
    span2 = upper - lower
    d1 = (off - lower) / span2
    d2 = (upper - off) / span2
    mp = 1.0 / (eta_mut + 1.0)
    lo_b = torch.pow(torch.clamp_min(
        2.0 * u2 + (1.0 - 2.0 * u2) * torch.pow(1.0 - d1, eta_mut + 1.0),
        EPS), mp) - 1.0
    hi_b = 1.0 - torch.pow(torch.clamp_min(
        2.0 * (1.0 - u2) + 2.0 * (u2 - 0.5) * torch.pow(1.0 - d2,
                                                        eta_mut + 1.0),
        EPS), mp)
    deltaq = torch.where(u2 < 0.5, lo_b, hi_b)
    mut = _clip(off + deltaq * span2, lower, upper)
    apply_m = (rnd["m_ind"] < prob_mut) & (rnd["m_genem"] < indpb)
    return torch.where(apply_m, mut, off)


def _clip(x, lower, upper):
    """jnp.clip: minimum(maximum(x, lower), upper), NaN-propagating."""
    return torch.minimum(torch.maximum(x, lower), upper)


def draw_uniforms(generator, p: int, g: int, device=None,
                  islands: int | tuple | None = None) -> dict:
    """The reference's uniform dict (same keys, shapes and draw order), from
    a ``torch.Generator`` or a uniform source; with ``islands`` (a count or
    a tuple of leading dims) every array gains those leading axes. A source
    may return arrays that broadcast to them (``SeedUniforms``)."""
    rand = as_source(generator, device)
    lead = (() if islands is None else
            tuple(islands) if isinstance(islands, tuple) else (islands,))
    p2 = p // 2
    return {
        "u_cx": rand(lead + (p2, g)),
        "m_pair": rand(lead + (p2, 1)),
        "m_gene": rand(lead + (p2, g)),
        "u_mut": rand(lead + (p, g)),
        "m_ind": rand(lead + (p, 1)),
        "m_genem": rand(lead + (p, g)),
    }
