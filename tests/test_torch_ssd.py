"""Parity of the port's SSD scan (``repro_torch.kernels.ssd``,
``repro_torch.models.ssm``) with the JAX reference, on the CPU. The
reference's intra-chunk kernel runs in Pallas interpret mode, as
tests/test_kernels.py runs it; the port's wrapper runs its plain version
(``ssd_intra_chunk_plain``) on CPU tensors. Tolerance 1e-4, as
tests/test_kernels.py's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd.chunk_kernel import ssd_intra_chunk as jintra
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import ssm
from torch_parity import (SSD_CASES, SSD_CHUNK256_CASES, SSD_MIN_DECAY,
                          SSD_TOL, np32, ssd_inputs, to_np)

# the reference's cases, plus an L that is not a multiple of the chunk
CASES = SSD_CASES + [(2, 100, 4, 32, 16, 32)]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _init_state(b, h, p, n, seed):
    return np32(np.random.default_rng(seed).standard_normal((b, h, p, n))
                * 0.5)


@pytest.mark.parametrize("b,l,h,p,n,q", CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(b, l, h, p, n, q, with_state):
    arrs = ssd_inputs(b, l, h, p, n, seed=l + n)
    s0 = _init_state(b, h, p, n, seed=1) if with_state else None
    jargs = [jnp.asarray(a) for a in arrs]
    js0 = None if s0 is None else jnp.asarray(s0)
    y_k, s_k = jssd_ops.ssd_chunked(*jargs, q, init_state=js0)
    y_r, s_r = jssm.ssd_chunked_ref(*jargs, q, init_state=js0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    before = ssd_ops.launches
    y, s = ssd_ops.ssd_chunked(*_torch(arrs), q, init_state=ts0)
    assert ssd_ops.launches == before             # CPU: the plain version
    y2, s2 = ssm.ssd_chunked_ref(*_torch(arrs), q, init_state=ts0)
    assert y.shape == (b, l, h, p) and s.shape == (b, h, p, n)
    # the port's kernel path and its oracle, each against the reference's
    # kernel path and its oracle
    for port in ((y, s), (y2, s2)):
        for ref in ((y_k, s_k), (y_r, s_r)):
            for got, want in zip(port, ref):
                np.testing.assert_allclose(to_np(got), np.asarray(want),
                                           **SSD_TOL)


@pytest.mark.parametrize("b,l,h,p,n,q", SSD_CASES)
def test_intra_chunk_outputs_match_jax_kernel(b, l, h, p, n, q):
    arrs = ssd_inputs(b, l, h, p, n, seed=7 * l + p)
    ref = jintra(*[jnp.asarray(a) for a in arrs], chunk=q, interpret=True)
    out = ssd_ops.ssd_intra_chunk(*_torch(arrs), chunk=q)
    names = ("y_diag", "states", "in_decay")
    shapes = ((b, l, h, p), (b, l // q, h, p, n), (b, l // q, h, q))
    for name, got, want, shape in zip(names, out, ref, shapes):
        assert tuple(got.shape) == shape, name
        np.testing.assert_allclose(to_np(got), np.asarray(want), **SSD_TOL,
                                   err_msg=name)


def _far_tile_part(x, dt, a, bm, cm, q, tile=64):
    """The part of the first chunk's y_diag that comes from key positions
    two or more 64-row tiles before the query's tile (numpy, float64)."""
    xs, dts, bs, cs = (v[0, :q].astype(np.float64) for v in (x, dt, bm, cm))
    cum = np.cumsum(dts * a[None], axis=0)                    # (q, h)
    i, j = np.arange(q)[:, None], np.arange(q)[None]
    far = (i // tile - j // tile >= 2)[..., None]
    decay = np.exp(np.where(far, cum[:, None] - cum[None], -np.inf))
    w = (cs @ bs.T)[..., None] * decay * dts[None]            # (q, q, h)
    return np.einsum("ijh,jhp->ihp", w, xs)


@pytest.mark.parametrize("b,l,h,p,n,q", SSD_CHUNK256_CASES)
def test_ssd_chunk256_in_mamba2_range_matches_jax(b, l, h, p, n, q):
    """mamba2-780m's chunk of 256 with dt and a in Mamba-2's own range:
    the far tiles of a chunk and the state carried between chunks are
    far above the tolerance, so an error there would show."""
    arrs = ssd_inputs(b, l, h, p, n, seed=l, mamba2=True)
    assert np.abs(_far_tile_part(*arrs, q)).max() > 10 * SSD_TOL["atol"]
    jargs = [jnp.asarray(v) for v in arrs]
    y_k, s_k = jssd_ops.ssd_chunked(*jargs, q)
    y, s = ssd_ops.ssd_chunked(*_torch(arrs), q)
    np.testing.assert_allclose(to_np(y), np.asarray(y_k), **SSD_TOL)
    np.testing.assert_allclose(to_np(s), np.asarray(s_k), **SSD_TOL)
    if l % q == 0:
        ref = jintra(*jargs, chunk=q, interpret=True)
        out = ssd_ops.ssd_intra_chunk(*_torch(arrs), chunk=q)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       **SSD_TOL)
        assert float(out[2][..., -1].max()) > SSD_MIN_DECAY
        # the state entering the second chunk moves its output
        y_off = to_np(y)[:, q:2 * q] - to_np(out[0])[:, q:2 * q]
        assert np.abs(y_off).max() > 10 * SSD_TOL["atol"]


def test_ssd_decode_consistent_with_chunked():
    """Sequential decode steps == the chunked scan over the same tokens, in
    the port and against the reference's decode steps."""
    b, l, h, p, n = 1, 16, 2, 8, 4
    x, dt, a, bm, cm = ssd_inputs(b, l, h, p, n, seed=2)
    y_ref, s_ref = ssm.ssd_chunked_ref(*_torch((x, dt, a, bm, cm)), chunk=8)
    state = torch.zeros((b, h, p, n))
    jstate = jnp.zeros((b, h, p, n))
    ys, jys = [], []
    for t in range(l):
        y, state = ssm.ssd_decode_step(
            state, *_torch((x[:, t], dt[:, t], a, bm[:, t], cm[:, t])))
        jy, jstate = jssm.ssd_decode_step(
            jstate, *[jnp.asarray(v) for v in
                      (x[:, t], dt[:, t], a, bm[:, t], cm[:, t])])
        ys.append(y)
        jys.append(np.asarray(jy))
    y_seq = torch.stack(ys, dim=1)
    np.testing.assert_allclose(to_np(y_seq), to_np(y_ref), **SSD_TOL)
    np.testing.assert_allclose(to_np(state), to_np(s_ref), **SSD_TOL)
    np.testing.assert_allclose(to_np(y_seq), np.stack(jys, 1), **SSD_TOL)
    np.testing.assert_allclose(to_np(state), np.asarray(jstate), **SSD_TOL)
