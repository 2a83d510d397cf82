"""Parity of the port's attention (``repro_torch.models.attention``,
``repro_torch.kernels.attention``, ``models.layers.decode_attention``)
with the JAX reference, on the CPU. The reference's flash kernel runs in
Pallas interpret mode, as tests/test_kernels.py runs it; the port's
wrapper runs its plain version on CPU tensors. Tolerances are
tests/test_kernels.py's: 3e-5 float32, 2e-2 bfloat16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as jattn_ops
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import dense_reference
from repro_torch.models import attention, layers
from torch_parity import (ATTN_BF16_TOL, ATTN_CASES, ATTN_TOL, MASKED_CASE,
                          attn_inputs, to_np)


def _both(arrs, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(x):
    return np.asarray(to_np(x.float()) if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


@pytest.mark.parametrize("b,s,h,kv,hd,causal,win,cap,dtype", ATTN_CASES)
def test_flash_attention_matches_jax_kernel(b, s, h, kv, hd, causal, win,
                                            cap, dtype):
    (jq, jk, jv), (q, k, v) = _both(attn_inputs(b, s, h, kv, hd, seed=s),
                                    dtype)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap)
    ref = jattn_ops.flash_attention(jq, jk, jv, **kw)
    before = attn_ops.launches
    out = attn_ops.flash_attention(q, k, v, **kw)
    assert attn_ops.launches == before            # CPU: the plain version
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = ATTN_BF16_TOL if dtype == "bfloat16" else ATTN_TOL
    np.testing.assert_allclose(_f32(out), _f32(ref), **tol)
    # and the port's own dense reference agrees with its blocked version
    np.testing.assert_allclose(_f32(dense_reference(q, k, v, **kw)),
                               _f32(out), **tol)


def test_fully_masked_rows_give_zeros():
    c = MASKED_CASE
    q, k, v = attn_inputs(c["b"], c["sq"], c["h"], c["kv"], c["hd"], seed=5,
                          t=c["t"])
    kw = dict(scale=c["hd"] ** -0.5, causal=True, window=c["window"],
              q_offset=c["q_offset"])
    ref = np.asarray(jattention.flash_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    out = to_np(attn_ops.flash_attention(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), **kw))
    np.testing.assert_allclose(out, ref, **ATTN_TOL)
    first_masked = c["t"] + c["window"] - 1 - c["q_offset"]     # row 15
    assert np.all(out[:, first_masked:] == 0.0)
    assert np.all(np.abs(out[:, :first_masked]).sum(-1) > 0)


JAX_IMPL = {"dense": "dense", "blocked": "flash_xla", "kernel": "pallas",
            "auto": "auto"}


@pytest.mark.parametrize("impl", sorted(JAX_IMPL))
def test_attend_matches_reference_for_each_impl(impl):
    # gemma2-like: GQA 2:1, window, softcap, q scale 1/sqrt(hd)
    q, k, v = attn_inputs(2, 48, 4, 2, 32, seed=3)
    kw = dict(scale=32 ** -0.5, causal=True, window=16, attn_softcap=50.0,
              block=16)
    ref = jattention.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            impl=JAX_IMPL[impl], **kw)
    out = attention.attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), impl=impl, **kw)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **ATTN_TOL)


def test_attend_rejects_unknown_impl():
    q, k, v = (torch.from_numpy(a) for a in attn_inputs(1, 8, 2, 1, 32))
    with pytest.raises(ValueError, match="impl"):
        attention.attend(q, k, v, scale=1.0, impl="pallas")


def test_decode_attention_on_a_ring_cache():
    """A wrapped ring cache: slot = pos % tc, unfilled slots at -1."""
    b, tc, h, kv, hd = 2, 16, 4, 2, 32
    q, k, v = attn_inputs(b, 1, h, kv, hd, seed=9, t=tc)
    for cache_pos in (np.where(np.arange(tc) < 11, np.arange(tc), -1),
                      np.roll(np.arange(24, 24 + tc), 24 % tc)):
        cp = cache_pos.astype(np.int32)
        kw = dict(kv_len=0, scale=hd ** -0.5, attn_softcap=50.0)
        ref = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v),
                                       cache_pos=jnp.asarray(cp), **kw)
        out = layers.decode_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      cache_pos=torch.from_numpy(cp), **kw)
        np.testing.assert_allclose(to_np(out), np.asarray(ref), **ATTN_TOL)
    # kv_len per batch row instead of cache positions
    lens = np.array([5, 16], np.int32)
    ref = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), kv_len=jnp.asarray(lens),
                                   scale=0.2)
    out = layers.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  kv_len=torch.from_numpy(lens), scale=0.2)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **ATTN_TOL)
