"""Variation operators: the port against ``repro.core.operators``, fed the
reference's own draws (re-derived from its keys) through ArrayUniforms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro_torch.core import operators as tops
from repro_torch.core.uniforms import ArrayUniforms, GeneratorUniforms
from repro_torch.kernels.genetic import ops as gk
from torch_parity import TOL, jax_variation_draws, np32, to_np, to_torch

KW = dict(eta_cx=15.0, prob_cx=0.9, eta_mut=20.0, prob_mut=0.7)


def _parents(p, g, seed):
    return np.random.default_rng(seed).uniform(-5.12, 5.12,
                                               (p, g)).astype(np.float32)


@pytest.mark.parametrize("p,num,tsize", [(16, 16, 2), (33, 20, 2),
                                         (64, 64, 3)])
def test_tournament_select_exact(p, num, tsize):
    rng = jax.random.PRNGKey(p + num)
    # planted ties: keys repeat, so first-index argmin decides
    key = np.random.default_rng(p).integers(0, p // 3, p).astype(np.float32)
    ref = np.asarray(jops.tournament_select(rng, jnp.asarray(key), num,
                                            tsize=tsize))
    u = np32(jax.random.uniform(rng, (num, tsize)))
    got = tops.tournament_select(ArrayUniforms([u]), to_torch(key), num,
                                 tsize=tsize)
    np.testing.assert_array_equal(to_np(got), ref)


def test_tournament_select_active_bound():
    rng = jax.random.PRNGKey(5)
    key = np.arange(32, dtype=np.float32)[::-1].copy()
    ref = np.asarray(jops.tournament_select(rng, jnp.asarray(key), 32,
                                            active=jnp.asarray(10)))
    u = np32(jax.random.uniform(rng, (32, 2)))
    got = tops.tournament_select(ArrayUniforms([u]), to_torch(key), 32,
                                 active=torch.tensor(10))
    np.testing.assert_array_equal(to_np(got), ref)
    assert to_np(got).max() < 10


def test_sbx_crossover_matches():
    rng = jax.random.PRNGKey(1)
    x = _parents(20, 7, 1)
    lo, hi = np.full(7, -5.12, np.float32), np.full(7, 5.12, np.float32)
    r1, r2 = jops.sbx_crossover(rng, x[0::2], x[1::2], eta=15.0, prob=0.9,
                                lower=lo, upper=hi)
    ka, kb, kc = jax.random.split(rng, 3)
    src = ArrayUniforms([np32(jax.random.uniform(ka, (10,))),
                         np32(jax.random.uniform(kb, (10, 7))),
                         np32(jax.random.uniform(kc, (10, 7)))])
    t = to_torch(x)
    o1, o2 = tops.sbx_crossover(src, t[0::2], t[1::2], eta=15.0, prob=0.9,
                                lower=to_torch(lo), upper=to_torch(hi))
    np.testing.assert_allclose(to_np(o1), np.asarray(r1), **TOL)
    np.testing.assert_allclose(to_np(o2), np.asarray(r2), **TOL)


def test_polynomial_mutation_matches():
    rng = jax.random.PRNGKey(2)
    x = _parents(24, 5, 2)
    ref = jops.polynomial_mutation(rng, x, eta=20.0, prob=0.7, indpb=0.5,
                                   lower=-5.12, upper=5.12)
    ka, kb, kc = jax.random.split(rng, 3)
    src = ArrayUniforms([np32(jax.random.uniform(ka, (24,))),
                         np32(jax.random.uniform(kb, (24, 5))),
                         np32(jax.random.uniform(kc, (24, 5)))])
    got = tops.polynomial_mutation(src, to_torch(x), eta=20.0, prob=0.7,
                                   indpb=0.5, lower=-5.12, upper=5.12)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("p,use_kernel", [(16, False), (17, False),
                                          (16, True), (17, True),
                                          (1, False)])
def test_variation_matches(p, use_kernel):
    """Even and odd P, unfused and fused (odd P never takes the kernel:
    the unpaired last parent is mutation-only)."""
    g = 6
    rng = jax.random.PRNGKey(p)
    x = _parents(p, g, p)
    kw = dict(KW, indpb=1.0 / g, lower=-5.12, upper=5.12)
    ref = np.asarray(jops.variation(rng, jnp.asarray(x), use_kernel=use_kernel,
                                    **kw))
    src = ArrayUniforms(jax_variation_draws(rng, p, g, fused=use_kernel))
    got = tops.variation(src, to_torch(x), use_kernel=use_kernel, **kw)
    assert src.remaining() == 0
    np.testing.assert_allclose(to_np(got), ref, **TOL)


def test_variation_tensor_hyperparameters():
    """0-d tensor hyperparameters (the meta-GA's case) give the same
    offspring as numbers."""
    x = to_torch(_parents(16, 4, 9))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    kw = dict(indpb=0.25, lower=-5.12, upper=5.12, use_kernel=True)
    a = tops.variation(gen, x, **KW, **kw)
    gen.set_state(state)
    b = tops.variation(gen, x, **{k: torch.tensor(v) for k, v in KW.items()},
                       **kw)
    np.testing.assert_array_equal(to_np(a), to_np(b))


def test_variation_batched_islands_equal_island_by_island():
    i, p, g = 3, 10, 4
    x = to_torch(np.stack([_parents(p, g, s) for s in range(i)]))
    kw = dict(KW, indpb=0.25, lower=-5.12, upper=5.12)
    for use_kernel in (True, False):
        draws = [a.numpy() for a in
                 _record(torch.Generator().manual_seed(3), x, use_kernel, kw)]
        batched = tops.variation(ArrayUniforms(draws), x,
                                 use_kernel=use_kernel, **kw)
        for k in range(i):
            one = tops.variation(ArrayUniforms([d[k] for d in draws]), x[k],
                                 use_kernel=use_kernel, **kw)
            np.testing.assert_array_equal(to_np(batched[k]), to_np(one))


def _record(gen, x, use_kernel, kw):
    """The draws a batched variation makes, recorded."""
    seen = []
    src = GeneratorUniforms(gen, "cpu")

    def rec(shape):
        seen.append(src(shape))
        return seen[-1]
    tops.variation(rec, x, use_kernel=use_kernel, **kw)
    return seen


def test_variation_kernel_path_has_no_fallback(monkeypatch):
    """With use_kernel and even P the kernel wrapper runs or raises: an
    error in it reaches the caller."""
    def boom(*a, **k):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(gk, "fused_variation", boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        tops.variation(torch.Generator().manual_seed(0),
                       to_torch(_parents(8, 3, 0)), indpb=0.3, lower=-5.12,
                       upper=5.12, use_kernel=True, **KW)
