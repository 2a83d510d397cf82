"""Gradients of the port's flash attention on the CPU, against the JAX
reference. The port's ``kernels.attention.ops.flash_attention`` under
autograd runs ``_FlashAttention``: on CPU tensors its forward is
``flash_attention_fwd_plain`` and its backward ``flash_attention_bwd_plain``,
the backward kernel's arithmetic in torch ops. The reference's
``repro.kernels.attention.ops.flash_attention`` is differentiated with
``jax.vjp`` (Pallas in interpret mode forward, its custom VJP backward), as
tests/test_kernels.py:81 runs it. Inputs and the output gradient are
numpy draws from a seed. Tolerance: tests/test_kernels.py:96-97's
gradient tolerance, rtol 1e-3 / atol 1e-4 (``GRAD_TOL``); for the
bfloat16 case of ``ATTN_CASES`` (the draws rounded to bfloat16 on both
sides) the reference's own bfloat16 tolerance, tests/test_kernels.py:75
(``ATTN_BF16_TOL``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as jattn_ops
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import (flash_attention_blocked,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd_plain)
from torch_parity import (ATTN_BF16_TOL, ATTN_CASES, ATTN_TOL, GRAD_TOL,
                          MASKED_CASE, attn_grad_inputs, to_np)


def _port_grads(q, k, v, do, kw, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_()
               for a in (q, k, v))
    before = (attn_ops.launches, attn_ops.bwd_launches)
    out = attn_ops.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.from_numpy(do).to(dtype))
    assert (attn_ops.launches, attn_ops.bwd_launches) == before   # CPU
    assert all(g.dtype == dtype for g in (out, *grads))
    return to_np(out.float()), [to_np(g.float()) for g in grads]


@pytest.mark.parametrize("b,s,h,kv,hd,causal,win,cap,dtype", ATTN_CASES)
def test_flash_grads_match_jax_reference(b, s, h, kv, hd, causal, win, cap,
                                         dtype):
    q, k, v, do = attn_grad_inputs(b, s, h, kv, hd, seed=s)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap)
    ref_out, vjp = jax.vjp(
        lambda q, k, v: jattn_ops.flash_attention(q, k, v, **kw),
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do, dtype))
    out, grads = _port_grads(q, k, v, do, kw, getattr(torch, dtype))
    out_tol, grad_tol = ((ATTN_TOL, GRAD_TOL) if dtype == "float32"
                         else (ATTN_BF16_TOL, ATTN_BF16_TOL))
    np.testing.assert_allclose(out, np.asarray(ref_out, np.float32),
                               **out_tol)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        assert want.dtype == jnp.dtype(dtype), name
        want = np.asarray(want, np.float32)
        print(f"{dtype} {name}: {np.mean(got == want):.4f} bit-equal, max "
              f"abs difference {np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, **grad_tol, err_msg=name)


def test_bf16_grads_from_the_float32_output_match_the_reference_bits():
    """Where the port's bf16 gradients differ from the reference's. The
    port's backward reads D = rowsum(dO O) from the bf16 output the forward
    returns; the reference's custom VJP recomputes O in float32. The plain
    backward on the same bf16 q, k, v, dO, once with the bf16 out and lse
    and once with those of a float32 forward on the widened inputs: the
    second equals the reference's dq, dk, dv bit for bit in at least 0.99
    of elements, and in no smaller share than the first, so the rounded O
    is what the bf16 case above sees (it is within ATTN_BF16_TOL)."""
    b, s, h, kv, hd, causal, win, cap, dtype = next(
        c for c in ATTN_CASES if c[8] == "bfloat16")
    q, k, v, do = attn_grad_inputs(b, s, h, kv, hd, seed=s)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap)
    _, vjp = jax.vjp(
        lambda q, k, v: jattn_ops.flash_attention(q, k, v, **kw),
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    ref = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(do, dtype))]
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    shares = {}
    for label, fwd_in in (("bf16 O", (q, k, v)),
                          ("float32 O", (q.float(), k.float(), v.float()))):
        out, lse = flash_attention_fwd_plain(*fwd_in, **kw)
        got = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        shares[label] = [float(np.mean(to_np(g.float()) == r))
                         for g, r in zip(got, ref)]
    print(f"bit-equal share of dq, dk, dv against the reference: {shares}")
    for name, rounded, wide in zip(("dq", "dk", "dv"), shares["bf16 O"],
                                   shares["float32 O"]):
        assert wide >= 0.99 and wide >= rounded, f"{name}: {shares}"


# the backward's plain version against autograd through the blocked
# forward, which it must equal up to float32 summation order: GQA 4:1 and
# MQA, softcap, windows shorter and longer than a block, q_offset, keys
# not a multiple of the block; (B, Sq, T, H, KV, hd, causal, window,
# softcap, q_offset, block)
PLAIN_CASES = [
    (2, 48, 48, 8, 2, 16, True, 0, 0.0, 0, 16),
    (1, 40, 40, 4, 1, 32, True, 12, 30.0, 0, 16),
    (2, 33, 33, 6, 3, 16, False, 0, 50.0, 0, 8),
    (1, 20, 50, 4, 2, 16, True, 0, 0.0, 30, 16),
    (1, 24, 70, 4, 4, 8, True, 9, 20.0, 46, 32),
]


@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,win,cap,q_offset,block",
                         PLAIN_CASES)
def test_bwd_plain_matches_autograd_of_blocked(b, sq, t, h, kv, hd, causal,
                                               win, cap, q_offset, block):
    q, k, v, do = (torch.from_numpy(a) for a in attn_grad_inputs(
        b, sq, h, kv, hd, seed=sq + t, t=t))
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap,
              q_offset=q_offset)
    out, lse = flash_attention_fwd_plain(q, k, v, block=block, **kw)
    got = flash_attention_bwd_plain(q, k, v, out, lse, do, block=block, **kw)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    ref_out = flash_attention_blocked(qg, kg, vg, block=block, **kw)
    want = torch.autograd.grad(ref_out, (qg, kg, vg), do)
    np.testing.assert_allclose(to_np(out), to_np(ref_out), rtol=0, atol=0)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        np.testing.assert_allclose(to_np(a), to_np(w), **GRAD_TOL,
                                   err_msg=name)


def test_lse_is_the_log_sum_exp_of_the_masked_scores():
    """lse against a dense log-sum-exp of the capped, masked scores; a
    fully masked row holds the clamped max, -0.7 * FLT_MAX."""
    c = MASKED_CASE
    q, k, v = (torch.from_numpy(a) for a in attn_grad_inputs(
        c["b"], c["sq"], c["h"], c["kv"], c["hd"], seed=5, t=c["t"])[:3])
    scale = c["hd"] ** -0.5
    _, lse = flash_attention_fwd_plain(q, k, v, scale=scale, causal=True,
                                       window=c["window"], attn_softcap=30.0,
                                       q_offset=c["q_offset"], block=16)
    g = c["h"] // c["kv"]
    kr = k.repeat_interleave(g, dim=2)
    s = 30.0 * torch.tanh(torch.einsum("bshd,bthd->bhst", q, kr) * scale
                          / 30.0)
    qpos = c["q_offset"] + torch.arange(c["sq"])[:, None]
    rel = qpos - torch.arange(c["t"])[None, :]
    s = torch.where((rel >= 0) & (rel < c["window"]), s, -torch.inf)
    dense = torch.logsumexp(s, -1).permute(0, 2, 1)          # (B, Sq, H)
    first_masked = c["t"] + c["window"] - 1 - c["q_offset"]
    np.testing.assert_allclose(to_np(lse[:, :first_masked]),
                               to_np(dense[:, :first_masked]), **ATTN_TOL)
    clamp = -0.7 * torch.finfo(torch.float32).max
    assert bool((lse[:, first_masked:] == torch.tensor(clamp)).all())


def test_fully_masked_rows_get_zero_grads():
    """Rows that see no key: zero dq, and no contribution to dk and dv.
    Compared against autograd through the blocked version only (the dense
    reference averages such rows uniformly, ROADMAP)."""
    c = MASKED_CASE
    q, k, v, do = attn_grad_inputs(c["b"], c["sq"], c["h"], c["kv"],
                                   c["hd"], seed=5, t=c["t"])
    kw = dict(scale=c["hd"] ** -0.5, causal=True, window=c["window"],
              q_offset=c["q_offset"])
    _, (dq, dk, dv) = _port_grads(q, k, v, do, kw)
    qg, kg, vg = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = torch.autograd.grad(flash_attention_blocked(qg, kg, vg, **kw),
                               (qg, kg, vg), torch.from_numpy(do))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got, to_np(w), **GRAD_TOL)
    first_masked = c["t"] + c["window"] - 1 - c["q_offset"]
    assert np.all(dq[:, first_masked:] == 0.0)
    assert np.all(np.abs(dq[:, :first_masked]).sum(-1) > 0)
    # the masked rows' dO does not reach dk, dv
    do2 = do.copy()
    do2[:, first_masked:] = 123.0
    _, (dq2, dk2, dv2) = _port_grads(q, k, v, do2, kw)
    np.testing.assert_array_equal(dk2, dk)
    np.testing.assert_array_equal(dv2, dv)


def test_plain_launch_without_autograd_runs_no_function():
    q, k, v, _ = attn_grad_inputs(1, 32, 4, 2, 16, seed=1)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    out = attn_ops.flash_attention(q.requires_grad_(), k, v, scale=0.25)
    assert out.grad_fn is not None
    with torch.no_grad():
        out = attn_ops.flash_attention(q, k, v, scale=0.25)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# torch.func: vmap(grad(...)) through the wrapper folds the runs into the
# batch axis
# ---------------------------------------------------------------------------

# (runs, B, S, H, KV, hd, causal, window, softcap): tinyllama-1.1b's and
# gemma2-2b's reduced layers (window 16, softcap 50), MQA unmasked
VMAP_CASES = [(3, 2, 32, 4, 2, 32, True, 0, 0.0),
              (4, 1, 32, 4, 2, 32, True, 16, 50.0),
              (2, 2, 24, 4, 1, 16, False, 0, 30.0)]


@pytest.fixture
def opaque(monkeypatch):
    """The plain versions the wrapper runs on the CPU, made as opaque to
    torch.func as a kernel launch (they read their inputs through numpy,
    which a batched or gradient-tracking tensor refuses); returns their
    call counts."""
    calls = {"fwd": 0, "bwd": 0, "eval": 0}

    def opaque_fn(key, fn):
        def run(*tensors, **kw):
            for t in tensors:
                t.detach().numpy()
            calls[key] += 1
            return fn(*tensors, **kw)
        return run

    for key, name in (("fwd", "flash_attention_fwd_plain"),
                      ("bwd", "flash_attention_bwd_plain"),
                      ("eval", "flash_attention_plain")):
        monkeypatch.setattr(attn_ops, name,
                            opaque_fn(key, getattr(attn_ops, name)))
    return calls


def _runs(case, seed):
    r, b, s, h, kv, hd, causal, win, cap = case
    q, k, v, do = zip(*(attn_grad_inputs(b, s, h, kv, hd, seed=seed + i)
                        for i in range(r)))
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap)
    return [torch.from_numpy(np.stack(x)) for x in (q, k, v, do)], kw


def _loss(kw):
    return lambda q, k, v, do: (attn_ops.flash_attention(q, k, v, **kw)
                                * do).sum()


@pytest.mark.parametrize("case", VMAP_CASES)
def test_vmap_grad_folds_and_matches_per_run_grads(case, opaque):
    (q, k, v, do), kw = _runs(case, seed=case[2])
    before = (attn_ops.launches, attn_ops.bwd_launches)
    grads = torch.func.vmap(torch.func.grad(_loss(kw), argnums=(0, 1, 2)))(
        q, k, v, do)
    assert opaque == {"fwd": 1, "bwd": 1, "eval": 0}
    assert (attn_ops.launches, attn_ops.bwd_launches) == before    # CPU
    for r in range(case[0]):
        qr, kr, vr = (x[r].clone().requires_grad_() for x in (q, k, v))
        want = torch.autograd.grad(_loss(kw)(qr, kr, vr, do[r]),
                                   (qr, kr, vr))
        for name, got, w in zip(("dq", "dk", "dv"), grads, want):
            np.testing.assert_allclose(to_np(got[r]), to_np(w), **GRAD_TOL,
                                       err_msg=f"run {r} {name}")


def test_vmap_grad_with_unbatched_kv_and_a_moved_run_dim(opaque):
    """q's runs on dim 1, k and v shared by every run: the rule moves q's
    run dim to the front and broadcasts k and v; the gradients of the
    shared k and v come back per run."""
    case = VMAP_CASES[1]
    (q, k, v, do), kw = _runs(case, seed=9)
    k, v = k[0], v[0]
    grads = torch.func.vmap(torch.func.grad(_loss(kw), argnums=(0, 1, 2)),
                            in_dims=(1, None, None, 0))(
        q.movedim(0, 1), k, v, do)
    assert opaque == {"fwd": 1, "bwd": 1, "eval": 0}
    assert [tuple(g.shape) for g in grads] == [
        tuple(q.shape), (case[0],) + tuple(k.shape),
        (case[0],) + tuple(v.shape)]
    for r in range(case[0]):
        qr, kr, vr = (x.clone().requires_grad_() for x in (q[r], k, v))
        want = torch.autograd.grad(_loss(kw)(qr, kr, vr, do[r]),
                                   (qr, kr, vr))
        for name, got, w in zip(("dq", "dk", "dv"), grads, want):
            np.testing.assert_allclose(to_np(got[r]), to_np(w), **GRAD_TOL,
                                       err_msg=f"run {r} {name}")


def test_vmapped_evaluation_folds(opaque):
    """Without autograd a vmapped call runs the lse-free forward once."""
    (q, k, v, _), kw = _runs(VMAP_CASES[0], seed=3)
    before = attn_ops.launches
    fn = torch.func.vmap(lambda q, k, v: attn_ops.flash_attention(
        q, k, v, **kw))
    out = fn(q, k, v)
    with torch.no_grad():
        again = fn(q, k, v)
    assert opaque == {"fwd": 0, "bwd": 0, "eval": 2}
    assert attn_ops.launches == before
    np.testing.assert_array_equal(to_np(again), to_np(out))
    for r in range(q.shape[0]):
        np.testing.assert_allclose(
            to_np(out[r]), to_np(flash_attention_blocked(q[r], k[r], v[r],
                                                         **kw)),
            rtol=0, atol=0)
