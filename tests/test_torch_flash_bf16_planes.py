"""The bf16 flash kernels' arithmetic on the CPU, backward
(``src/repro_torch/kernels/attention/csrc/flash_attention_bwd_bf16.cu``)
and forward (``flash_attention_fwd_bf16.cu``), which themselves run only
on the card.

The kernels multiply bf16 tiles on the bf16 tensor cores. Where a product
has a float32 operand (P or dS), they split that operand into three bf16
planes, each what the planes before it leave rounded toward zero (the
float32 bits with the low 16 cleared, ``split3``), and issues one bf16
product per plane into a float32 sum. Here that split is written in torch
as the kernel does it (``planes``), and checked:

* the planes add up to the value exactly, for P in [0, 1], signed dS at
  1e-3 scale and magnitudes from 2^-100 to 2^120; each plane times a bf16
  value is exact in float32;
* dq, dk, dv formed from the plane products at the tests' bf16 case hold
  against the reference's bf16 ``_bwd`` at ``ATTN_BF16_TOL``, and against
  the port's plain backward at ``bf16_grad_tol``; before the last rounding
  they are the float32 products up to summation order. ``_bwd`` is the
  backward rule of ``repro.kernels.attention.ops.flash_attention``'s custom
  VJP, called as ``jax.vjp`` calls it (its residuals are q, k, v) under one
  ``jax.jit``: it skips the Pallas forward, which it does not read, and
  the eager dispatch's one compilation an operation;
* the forward written as its kernel computes it (``_plane_fwd``: S in
  float32 from bf16 tiles, the scale after, base-2 exponentials, P's planes
  into V) at the tests' bf16 case and a GQA case with a window and a
  softcap holds against the reference's Pallas forward in interpret mode
  (one rounding step), the port's plain forward (lse at 1e-5) and the
  direct float32 P V (1e-5 before the last rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as jattn_ops
from repro_torch.kernels.attention.ref import (flash_attention_bwd_plain,
                                               flash_attention_fwd_plain)
from repro_torch.models.layers import softcap
from torch_parity import (ATTN_BF16_TOL, ATTN_CASES, attn_grad_inputs,
                          bf16_grad_tol, to_np)


def chop(x):
    """float32 ``x`` rounded toward zero to bf16: its low 16 bits cleared."""
    return (x.view(torch.int32) & -(1 << 16)).view(torch.float32)


def planes(x):
    """(lo, mid, hi) bf16 planes of float32 ``x``, small first: the kernel
    keeps the top 16 bits of x, of x - hi and of x - hi - mid."""
    hi = chop(x)
    rest = x - hi
    mid = chop(rest)
    lo = chop(rest - mid)
    return tuple(p.to(torch.bfloat16) for p in (lo, mid, hi))


def plane_einsum(eq, x, y):
    """einsum(eq, x, y) for float32 ``x`` and bf16 ``y``: one product per
    plane of ``x``, small planes first, summed in float32."""
    acc = None
    for p in planes(x):
        term = torch.einsum(eq, p.float(), y.float())
        acc = term if acc is None else acc + term
    return acc


def _draws(kind, n, seed):
    rs = np.random.default_rng(seed)
    if kind == "p":
        x = rs.random(n)
        x[:2] = (0.0, 1.0)
    elif kind == "ds":
        x = 1e-3 * rs.standard_normal(n)
    else:
        x = (rs.choice((-1.0, 1.0), n) * (1.0 + rs.random(n))
             * 2.0 ** rs.integers(-100, 121, n))
        x[:2] = (2.0 ** -100, 2.0 ** 120)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["p", "ds", "magnitudes"])
def test_three_planes_add_up_exactly(kind):
    x = _draws(kind, 1 << 16, seed=len(kind))
    lo, mid, hi = planes(x)
    whole = hi.double() + mid.double() + lo.double()
    assert torch.equal(whole, x.double()), kind
    y = _draws("magnitudes", x.numel(), seed=7).clamp(-2.0 ** 4, 2.0 ** 4)
    y = torch.where(y.abs() < 2.0 ** -4, torch.ones_like(y), y)
    y = y.to(torch.bfloat16)
    for p in (lo, mid, hi):
        assert torch.equal((p.float() * y.float()).double(),
                           p.double() * y.double()), kind


def _plane_bwd(q, k, v, out, lse, dout, *, scale, causal, window,
               attn_softcap):
    """The kernel's backward on bf16 tensors, densely: S^T and dP^T from
    the widened bf16 tiles, P and dS in float32, dV, dK, dQ from the planes
    of P and dS; D from the bf16 output. Returns the float32 gradients
    before the last rounding and the float32 products (P, dS)."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    dog = dout.reshape(b, sq, kvh, g, hd)
    dsum = (dog.float() * out.reshape(qg.shape).float()).sum(-1)
    s = softcap(torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
                * scale, attn_softcap)
    rel = torch.arange(sq)[:, None] - torch.arange(t)[None, :]
    msk = torch.ones(rel.shape, dtype=torch.bool)
    if causal:
        msk &= rel >= 0
    if window:
        msk &= rel < window
    lse = lse.float().reshape(b, sq, kvh, g).permute(0, 2, 3, 1)
    p = torch.exp(torch.where(msk, s, -torch.inf) - lse[..., None])
    dp = torch.einsum("bskgd,btkd->bkgst", dog.float(), v.float())
    ds = p * (dp - dsum.permute(0, 2, 3, 1)[..., None])
    if attn_softcap:
        ds = ds * (1.0 - (s / attn_softcap) ** 2)
    dv = plane_einsum("bkgst,bskgd->btkd", p, dout.reshape(qg.shape))
    dk = plane_einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dq = plane_einsum("bkgst,btkd->bskgd", ds, k) * scale
    return (dq.reshape(q.shape), dk, dv), (p, ds)


def test_plane_products_give_the_reference_bf16_grads():
    b, s, h, kv, hd, causal, win, cap, dtype = next(
        c for c in ATTN_CASES if c[8] == "bfloat16")
    q, k, v, do = attn_grad_inputs(b, s, h, kv, hd, seed=s)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap)
    bwd = jax.jit(jattn_ops._bwd, static_argnums=range(5))
    ref = [np.asarray(x, np.float32) for x in bwd(
        kw["scale"], causal, win, cap, 0,
        tuple(jnp.asarray(x, dtype) for x in (q, k, v)),
        jnp.asarray(do, dtype))]
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out, lse = flash_attention_fwd_plain(q, k, v, **kw)
    wide, (p, ds) = _plane_bwd(q, k, v, out, lse, do, **kw)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    direct = (torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * kw["scale"],
              torch.einsum("bkgst,bskgd->btkd", ds, q.float().reshape(
                  b, s, kv, h // kv, hd)) * kw["scale"],
              torch.einsum("bkgst,bskgd->btkd", p, do.float().reshape(
                  b, s, kv, h // kv, hd)))
    for name, w, d_, r, pl in zip(("dq", "dk", "dv"), wide, direct, ref,
                                  plain):
        # the plane products are the float32 products, up to sum order
        np.testing.assert_allclose(
            to_np(w), to_np(d_.reshape(w.shape)), rtol=1e-5,
            atol=1e-6 * float(d_.abs().max()), err_msg=name)
        got = w.to(torch.bfloat16)
        np.testing.assert_allclose(to_np(got.float()), r, **ATTN_BF16_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(to_np(got.float()), to_np(pl.float()),
                                   **bf16_grad_tol(pl), err_msg=name)


def _plane_fwd(q, k, v, *, scale, causal, window, attn_softcap):
    """The bf16 forward kernel's arithmetic
    (``csrc/flash_attention_fwd_bf16.cu``) on bf16 tensors, densely: S =
    Q K^T from the widened bf16 tiles in float32, the scale applied to S
    (and the softcap, tanh(S scale / cap)), masked scores -inf, the row max
    clamped at the reference's MIN_CLAMP in base 2, P = 2^(t - max t) with
    t = S times scale (or cap) times log2(e), O from P's three planes
    multiplied into V, small planes first. Returns (O / l before the last
    rounding, lse, P, l): lse = max(S scale) (or cap max tanh) + log(l)."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    cap = abs(attn_softcap)
    kn = np.float32(cap if cap else scale)
    f = np.float32(kn * np.float32(1.4426950408889634))
    if cap:
        s = torch.tanh(s * np.float32(scale / cap))
    rel = torch.arange(sq)[:, None] - torch.arange(t)[None, :]
    msk = torch.ones(rel.shape, dtype=torch.bool)
    if causal:
        msk &= rel >= 0
    if window:
        msk &= rel < window
    s = torch.where(msk, s, -torch.inf)
    mx = s.amax(-1, keepdim=True)
    ms = torch.clamp_min(mx * f, -0.7 * float(np.finfo(np.float32).max))
    p = torch.exp2(torch.addcmul(-ms, s, torch.full_like(s, f)))
    l = p.sum(-1, keepdim=True)
    o = plane_einsum("bkgst,btkd->bkgsd", p, v)
    l1 = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(mx == -torch.inf,
                      -0.7 * float(np.finfo(np.float32).max), mx * kn)
    lse = (lse + torch.log(l1))[..., 0].permute(0, 3, 1, 2).reshape(b, sq, h)
    out = (o / l1).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out, lse, p, l1


@pytest.mark.parametrize("case", [
    next(c for c in ATTN_CASES if c[8] == "bfloat16"),
    (1, 96, 6, 2, 64, True, 40, 50.0, "bfloat16")])
def test_plane_forward_gives_the_reference_bf16_forward(case):
    """The kernel's forward arithmetic against the reference's Pallas
    forward (interpret mode, bf16 in and out): the output within one bf16
    rounding step; against the port's plain forward: lse at 1e-5; before
    the last rounding, the plane products are the float32 products P V up
    to summation order (1e-5)."""
    from repro.kernels.attention.flash import flash_attention_fwd
    b, s, h, kv, hd, causal, win, cap, dtype = case
    q, k, v = attn_grad_inputs(b, s, h, kv, hd, seed=s)[:3]
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap)
    ref = np.asarray(flash_attention_fwd(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), **kw,
        interpret=True), np.float32)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    wide, lse, p, l = _plane_fwd(q, k, v, **kw)
    _, plain_lse = flash_attention_fwd_plain(q, k, v, **kw)
    direct = torch.einsum("bkgst,btkd->bkgsd", p, v.float()) / l
    direct = direct.permute(0, 3, 1, 2, 4).reshape(wide.shape)
    np.testing.assert_allclose(to_np(wide), to_np(direct), rtol=1e-5,
                               atol=1e-6 * float(direct.abs().max()))
    got = to_np(wide.to(torch.bfloat16).float())
    np.testing.assert_allclose(got, ref, **bf16_grad_tol(torch.from_numpy(ref)))
    np.testing.assert_allclose(to_np(lse), to_np(plain_lse), rtol=1e-5,
                               atol=1e-5)
