"""Batched full-Newton AC powerflow in polar form, over a leading system
axis.

Dense complex linear algebra throughout (MATPOWER's dSbus_dV formulation),
with the derivatives written as row and column scalings of Ybus (O(n²) per
system) rather than products with diagonal matrices. The base case shares
one Ybus: the currents of all systems are one complex GEMM, (n, n) @
(n, B). A contingency case carries its own (n, n) Ybus, rebuilt from branch
data under its line mask.

Iteration count is static (``num_iters``) with a convergence mask freezing
finished systems, as in the reference (``repro.powerflow.newton``): every
system runs every iteration, a finished one updates by ``dx * 0`` (so a
NaN there still propagates), ``iters`` counts only the iterations a system
was not yet done, and ``converged`` is ``final_err < tol``.

The solve is ``torch.linalg.solve_ex`` on the batched float32 (2n, 2n)
Jacobian: a singular system (an islanded contingency) gives inf/NaN and an
``info`` code instead of an error, and ``converged`` masks it; on CUDA it
also takes no host sync. A batch is evaluated in chunks whose size comes
from the bytes one system holds at this n and the memory the device has
free.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.device import available_bytes


class PFResult(NamedTuple):
    vm: torch.Tensor          # (B, n) voltage magnitudes
    va: torch.Tensor          # (B, n) voltage angles (rad)
    mismatch: torch.Tensor    # (B,) final max |mismatch| p.u.
    converged: torch.Tensor   # (B,) bool
    iters: torch.Tensor       # (B,) int32 iterations to convergence


# bytes one system holds during a Newton iteration, per n²: the float32
# (2n, 2n) Jacobian three times over (its four blocks, their concatenation,
# the LU's copy: 48), the two complex (n, n) derivatives and their
# temporaries (32), and a contingency case's own complex Ybus (8)
SYSTEM_BYTES_PER_N2 = 80
OWN_YBUS_BYTES_PER_N2 = 8


def system_bytes(n: int, own_ybus: bool) -> int:
    """Bytes one system of ``n`` buses holds during a Newton iteration."""
    return (SYSTEM_BYTES_PER_N2 + (OWN_YBUS_BYTES_PER_N2 if own_ybus
                                   else 0)) * n * n


def chunk_size(n: int, own_ybus: bool, device: torch.device) -> int:
    """Systems evaluated at once: ``core.device.available_bytes`` over
    ``system_bytes``."""
    return max(1, int(available_bytes(device) // system_bytes(n, own_ybus)))


def _currents(ybus: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Ybus @ v per system: ybus (n, n) shared or (B, n, n), v (B, n)."""
    if ybus.dim() == 2:
        return (ybus @ v.transpose(0, 1)).transpose(0, 1)
    return torch.bmm(ybus, v.unsqueeze(-1)).squeeze(-1)


def _sbus(ybus: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v * torch.conj(_currents(ybus, v))


def _ds_dv(ybus: torch.Tensor, v: torch.Tensor):
    """MATPOWER dSbus_dV (polar), per system: (dS_dVa, dS_dVm), complex
    (B, n, n), as row and column scalings of Ybus:

        dS_dVm = v[:, None] * conj(Y * vnorm[None, :]) + diag(conj(i) vnorm)
        dS_dVa = -1j v[:, None] * conj(Y * v[None, :]) + diag(1j v conj(i))
    """
    i = _currents(ybus, v)
    y = ybus if ybus.dim() == 3 else ybus.unsqueeze(0)
    vnorm = v / torch.abs(v)
    ds_dvm = v[:, :, None] * torch.conj(y * vnorm[:, None, :])
    ds_dvm.diagonal(dim1=-2, dim2=-1).add_(torch.conj(i) * vnorm)
    ds_dva = (-1j * v)[:, :, None] * torch.conj(y * v[:, None, :])
    ds_dva.diagonal(dim1=-2, dim2=-1).add_(1j * v * torch.conj(i))
    return ds_dva, ds_dvm


def _contingency_ybus(gridt: dict, line_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) {0,1} line in-service masks -> (B, n, n) Ybus per case: the
    base grid's stamps of the lines in service and the 1e-6j diagonal."""
    cdtype = gridt["ybus"].dtype
    n = gridt["bus_type"].shape[0]
    b, nl = line_mask.shape
    ys = gridt["y_series"] * line_mask.to(cdtype)
    bc = (1j * gridt["b_sh"] / 2.0).to(cdtype) * line_mask
    f = gridt["f_bus"].long().expand(b, nl)
    t = gridt["t_bus"].long().expand(b, nl)
    s = torch.arange(b, device=line_mask.device)[:, None].expand(b, nl)
    ybus = torch.zeros((b, n, n), dtype=cdtype, device=line_mask.device)
    ybus.index_put_((s, f, f), ys + bc, accumulate=True)
    ybus.index_put_((s, t, t), ys + bc, accumulate=True)
    ybus.index_put_((s, f, t), -ys, accumulate=True)
    ybus.index_put_((s, t, f), -ys, accumulate=True)
    ybus.diagonal(dim1=-2, dim2=-1).add_(1e-6j)
    return ybus


def newton_powerflow(gridt: dict, *, p_extra: Optional[torch.Tensor] = None,
                     num_iters: int = 12, tol: float = 5e-4,
                     line_mask: Optional[torch.Tensor] = None) -> PFResult:
    """Solve a batch of AC powerflows.

    gridt: ``Grid.to_torch()`` dict. p_extra: optional (B, n) additional
    active injections (HVDC terms). line_mask: optional (B, L) {0,1} line
    in-service masks (contingencies); each system's Ybus is rebuilt from
    branch data. The batch B comes from whichever is given (both: equal);
    with neither, one system.
    """
    sizes = {x.shape[0] for x in (p_extra, line_mask) if x is not None}
    if len(sizes) > 1:
        raise ValueError(f"p_extra and line_mask batch sizes differ: {sizes}")
    b = sizes.pop() if sizes else 1
    n = gridt["bus_type"].shape[0]
    step = chunk_size(n, line_mask is not None, gridt["ybus"].device)
    if step >= b:
        return _newton(gridt, p_extra, line_mask, b, num_iters, tol)
    parts = [_newton(gridt,
                     None if p_extra is None else p_extra[s:s + step],
                     None if line_mask is None else line_mask[s:s + step],
                     min(step, b - s), num_iters, tol)
             for s in range(0, b, step)]
    return PFResult(*(torch.cat(field) for field in zip(*parts)))


def _newton(gridt, p_extra, line_mask, b, num_iters, tol) -> PFResult:
    bt = gridt["bus_type"]
    n = bt.shape[0]
    device = gridt["ybus"].device
    is_slack = bt == 2
    is_pv = bt == 1
    p_row = ~is_slack                             # P eqs at PV+PQ
    q_row = bt == 0                               # Q eqs at PQ
    ybus = (gridt["ybus"] if line_mask is None
            else _contingency_ybus(gridt, line_mask))

    p_spec = gridt["p_inj"] + (0.0 if p_extra is None else p_extra)
    q_spec = gridt["q_inj"]

    vm = torch.where(is_slack | is_pv, gridt["v_set"], 1.0).expand(b, n)
    va = torch.zeros((b, n), dtype=torch.float32, device=device)

    # the reduced Newton system is kept at full size with identity padding
    # (masked rows solve to zero updates)
    pr = p_row.to(torch.float32)
    qr = q_row.to(torch.float32)
    m11, m12 = pr[:, None] * pr[None, :], pr[:, None] * qr[None, :]
    m21, m22 = qr[:, None] * pr[None, :], qr[:, None] * qr[None, :]

    def mismatch(vm, va):
        v = torch.polar(vm, va)
        s = _sbus(ybus, v)
        dp = torch.where(p_row, torch.real(s) - p_spec, 0.0)
        dq = torch.where(q_row, torch.imag(s) - q_spec, 0.0)
        return dp, dq, v

    def max_err(dp, dq):
        return torch.maximum(torch.amax(torch.abs(dp), -1),
                             torch.amax(torch.abs(dq), -1))

    done = torch.zeros((b,), dtype=torch.bool, device=device)
    iters = torch.zeros((b,), dtype=torch.int32, device=device)
    for _ in range(num_iters):
        dp, dq, v = mismatch(vm, va)
        ds_dva, ds_dvm = _ds_dv(ybus, v)
        j11 = torch.real(ds_dva) * m11            # dP/dVa
        j21 = torch.imag(ds_dva) * m21            # dQ/dVa
        del ds_dva
        j12 = torch.real(ds_dvm) * m12            # dP/dVm
        j22 = torch.imag(ds_dvm) * m22            # dQ/dVm
        del ds_dvm
        # identity on masked diagonals keeps the system nonsingular
        j11.diagonal(dim1=-2, dim2=-1).add_(1.0 - pr)
        j22.diagonal(dim1=-2, dim2=-1).add_(1.0 - qr)
        jac = torch.cat([torch.cat([j11, j12], -1),
                         torch.cat([j21, j22], -1)], -2)
        del j11, j12, j21, j22
        rhs = -torch.cat([dp, dq], -1)
        dx = torch.linalg.solve_ex(jac, rhs.unsqueeze(-1)).result.squeeze(-1)
        del jac
        dva = dx[:, :n] * p_row
        dvm = dx[:, n:] * q_row

        newly_done = max_err(dp, dq) < tol
        upd = torch.where(done, 0.0, 1.0)[:, None]
        vm = vm + dvm * upd
        va = va + dva * upd
        iters = iters + (~done).to(torch.int32)
        done = done | newly_done
    dp, dq, _ = mismatch(vm, va)
    final_err = max_err(dp, dq)
    return PFResult(vm=vm, va=va, mismatch=final_err,
                    converged=final_err < tol, iters=iters)


def line_flows(gridt: dict, vm: torch.Tensor, va: torch.Tensor,
               line_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Active-power flow magnitude per line (max of both ends), p.u.:
    vm, va (B, n), line_mask optional (B, L) -> (B, L)."""
    cdtype = gridt["ybus"].dtype
    v = torch.polar(vm, va)
    f, t = gridt["f_bus"], gridt["t_bus"]
    ys = gridt["y_series"]
    bc = (1j * gridt["b_sh"] / 2.0).to(cdtype)
    if line_mask is not None:
        ys = ys * line_mask.to(cdtype)
        bc = bc * line_mask
    vf, vt = v[:, f], v[:, t]
    i_ft = (vf - vt) * ys + vf * bc
    i_tf = (vt - vf) * ys + vt * bc
    p_ft = torch.real(vf * torch.conj(i_ft))
    p_tf = torch.real(vt * torch.conj(i_tf))
    return torch.maximum(torch.abs(p_ft), torch.abs(p_tf))
