"""Public wrapper for the fused variation kernel.

``fused_variation(parents, rnd, scalars, lower, upper)`` takes parents
(..., P, G) with P even, the pre-drawn uniforms of ``ref.draw_uniforms``
(with the parents' leading dims, or a suffix of them: the uniforms are then
shared across the dims they lack, as the meta-GA's seeds are across its
individuals), the float32 hyperparameters [eta_cx, prob_cx, eta_mut,
prob_mut, indpb] as one (5,) row or one row per run ((..., 5) with the
parents' leading dims), and (G,) bounds, and returns the offspring
(..., P, G).

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
    """The kernel's float32 hyperparameter tensor: (5,) from numbers or
    0-d tensors, (..., 5) from per-run tensors (broadcast against each
    other). Numbers are copied to ``device`` once; tensors are stacked
    where they lie, so tensor hyperparameters never force a host sync."""
    vals = (eta_cx, prob_cx, eta_mut, prob_mut, indpb)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return torch.tensor([float(v) for v in vals], dtype=torch.float32,
                            device=device)
    return torch.stack(torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=torch.float32, device=device)
        for v in vals)), dim=-1)


def fused_variation_plain(parents: torch.Tensor, rnd: dict,
                          scalars: torch.Tensor, lower: torch.Tensor,
                          upper: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version under the wrapper's signature, on any
    device: what the wrapper runs on the CPU, and what the kernel is held
    against on the card. Per-run rows broadcast over (P/2, G)."""
    eta_cx, prob_cx, eta_mut, prob_mut, indpb = (
        v.reshape(v.shape + (1, 1)) if v.dim() else v
        for v in scalars.unbind(-1))
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
    args = _expected(parents, rnd, scalars, lower, upper)
    dev, f32 = parents.device, torch.float32
    if not all(t.dtype == f32 and t.device == dev and t.shape == shape
               and t.is_contiguous() for _, t, shape in args):
        _reject(args, dev)
    out = fused_variation_cuda(parents, rnd, scalars, lower, upper)
    launches += 1
    return out


def _expected(parents, rnd, scalars, lower, upper) -> tuple:
    """(name, tensor, expected shape) of every argument the kernel reads.
    The uniforms' leading dims are the suffix of the parents' that
    ``u_cx`` has; the scalars' are none or all of them."""
    *lead, p, g = parents.shape
    drop = min(max(len(lead) + 2 - rnd["u_cx"].dim(), 0), len(lead))
    half, full = (*lead[drop:], p // 2), (*lead[drop:], p)
    rows = (5,) if scalars.dim() <= 1 else (*lead, 5)
    return (("parents", parents, parents.shape), ("scalars", scalars, rows),
            ("lower", lower, (g,)), ("upper", upper, (g,)),
            ("u_cx", rnd["u_cx"], (*half, g)),
            ("m_pair", rnd["m_pair"], (*half, 1)),
            ("m_gene", rnd["m_gene"], (*half, g)),
            ("u_mut", rnd["u_mut"], (*full, g)),
            ("m_ind", rnd["m_ind"], (*full, 1)),
            ("m_genem", rnd["m_genem"], (*full, g)))


def _reject(args, device):
    """Raise for the first argument the kernel does not take: type or
    device, then shape, then contiguity."""
    for name, t, shape in args:
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"fused_variation: {name} is {t.dtype} on "
                             f"{t.device}; the kernel takes float32 on "
                             f"{device}")
        if t.shape != shape:
            raise ValueError(f"fused_variation: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_variation: {name} is not contiguous")
