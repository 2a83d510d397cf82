"""Public wrapper for the fused variation kernel.

``fused_variation(parents, rnd, scalars, lower, upper)`` takes parents
(..., P, G) with P even, the pre-drawn uniforms of ``ref.draw_uniforms``
(same leading dims), the (5,) float32 hyperparameters
[eta_cx, prob_cx, eta_mut, prob_mut, indpb] and (G,) bounds, and returns the
offspring (..., P, G).

* On CPU tensors it runs the plain version (``ref.fused_variation_ref``).
* On CUDA tensors it checks dtype, contiguity, shapes and even P, then
  launches the CUDA kernel or raises. Nothing falls back.

``launches`` counts the kernel launches of this process; it grows only
where the kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.genetic.fused_variation import fused_variation_cuda
from repro_torch.kernels.genetic.ref import fused_variation_ref

launches = 0


def pack_scalars(eta_cx, prob_cx, eta_mut, prob_mut, indpb,
                 device=None) -> torch.Tensor:
    """The kernel's (5,) float32 hyperparameter tensor. Numbers are copied
    to ``device`` once; tensors are stacked where they lie, so tensor
    hyperparameters never force a host sync."""
    vals = (eta_cx, prob_cx, eta_mut, prob_mut, indpb)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return torch.tensor([float(v) for v in vals], dtype=torch.float32,
                            device=device)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device).reshape(())
                        for v in vals])


def fused_variation_plain(parents: torch.Tensor, rnd: dict,
                          scalars: torch.Tensor, lower: torch.Tensor,
                          upper: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version under the wrapper's signature, on any
    device: what the wrapper runs on the CPU, and what the kernel is held
    against on the card."""
    eta_cx, prob_cx, eta_mut, prob_mut, indpb = scalars.unbind()
    return fused_variation_ref(
        parents[..., 0::2, :], parents[..., 1::2, :], rnd,
        eta_cx=eta_cx, prob_cx=prob_cx, eta_mut=eta_mut,
        prob_mut=prob_mut, indpb=indpb, lower=lower, upper=upper)


def fused_variation(parents: torch.Tensor, rnd: dict, scalars: torch.Tensor,
                    lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """parents: (..., P, G) with P even -> offspring (..., P, G)."""
    global launches
    p, g = parents.shape[-2:]
    if p % 2:
        raise ValueError(f"fused_variation pairs parents: P={p} is odd")
    if parents.device.type == "cpu":
        return fused_variation_plain(parents, rnd, scalars, lower, upper)
    if parents.device.type != "cuda":
        raise ValueError(f"fused_variation runs on cuda or cpu tensors, "
                         f"not {parents.device}")
    lead = tuple(parents.shape[:-2])
    expected = {"u_cx": lead + (p // 2, g), "m_pair": lead + (p // 2, 1),
                "m_gene": lead + (p // 2, g), "u_mut": lead + (p, g),
                "m_ind": lead + (p, 1), "m_genem": lead + (p, g)}
    args = {"parents": parents, "scalars": scalars, "lower": lower,
            "upper": upper, **{k: rnd[k] for k in expected}}
    expected.update(parents=tuple(parents.shape), scalars=(5,), lower=(g,),
                    upper=(g,))
    for name, t in args.items():
        if t.device != parents.device or t.dtype != torch.float32:
            raise ValueError(f"fused_variation: {name} is {t.dtype} on "
                             f"{t.device}; the kernel takes float32 on "
                             f"{parents.device}")
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"fused_variation: {name} has shape "
                             f"{tuple(t.shape)}, expected {expected[name]}")
        if not t.is_contiguous():
            raise ValueError(f"fused_variation: {name} is not contiguous")
    flat = {k: rnd[k].reshape(-1, rnd[k].shape[-1]) for k in
            ("u_cx", "m_pair", "m_gene", "u_mut", "m_ind", "m_genem")}
    out = fused_variation_cuda(parents.reshape(-1, g), flat, scalars,
                               lower, upper)
    launches += 1
    return out.reshape(parents.shape)
