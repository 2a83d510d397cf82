"""Broker, SPMD half: exact snake permutations and masked inverses against
``repro.core.broker`` for any N/W (N < W included), and Broker.evaluate
with a cost model."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import broker as jb
from repro.fitness import sphere as jsphere
from repro_torch.core import broker as tb
from repro_torch.fitness import sphere
from torch_parity import TOL, to_np, to_torch

SWEEP = [(n, w) for n, w in [(1, 1), (3, 8), (7, 8), (8, 8), (10, 4),
                             (16, 3), (33, 5), (64, 7), (100, 16),
                             (5, 6)]]


def _cost(n, seed, skewed):
    rs = np.random.default_rng(seed)
    c = (rs.pareto(1.5, n) if skewed else rs.integers(0, 4, n))
    return c.astype(np.float32)            # integer costs plant ties


@pytest.mark.parametrize("n,w", SWEEP)
@pytest.mark.parametrize("skewed", [False, True])
def test_permutation_and_inverse_exact(n, w, skewed):
    cost = _cost(n, n * w, skewed)
    perm_ref = np.asarray(jb.balanced_permutation(jnp.asarray(cost), w))
    perm = tb.balanced_permutation(to_torch(cost), w)
    np.testing.assert_array_equal(to_np(perm), perm_ref)
    assert perm.shape[0] == tb.padded_size(n, w) == jb.padded_size(n, w)
    inv_ref = np.asarray(jb.inverse_permutation(jnp.asarray(perm_ref), n))
    inv = tb.inverse_permutation(perm, n)
    np.testing.assert_array_equal(to_np(inv), inv_ref)
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    np.testing.assert_array_equal(
        to_np(tb.padded_take(to_torch(x), perm, n)),
        np.asarray(jb.padded_take(jnp.asarray(x), jnp.asarray(perm_ref), n)))
    # round trip: gathering through the inverse restores the order
    back = tb.padded_take(to_torch(x), perm, n)[inv]
    np.testing.assert_array_equal(to_np(back), x)


def test_inverse_of_unpadded_permutation():
    perm = np.random.default_rng(0).permutation(12)
    np.testing.assert_array_equal(
        to_np(tb.inverse_permutation(to_torch(perm))),
        np.asarray(jb.inverse_permutation(jnp.asarray(perm))))


@pytest.mark.parametrize("n,w", [(30, 4), (32, 4), (3, 8)])
def test_broker_evaluate_with_cost_model(n, w):
    genomes = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    ref = jb.Broker(jsphere, cost_fn=lambda g: 1.0 + jnp.abs(g[:, 0]) * 10.0,
                    num_workers=w)
    fit_ref, st_ref = ref.evaluate(jnp.asarray(genomes))
    port = tb.Broker(sphere, cost_fn=lambda g: 1.0 + torch.abs(g[:, 0]) * 10.0,
                     num_workers=w)
    fit, st = port.evaluate(to_torch(genomes))
    # dispatch never changes a value: exact against the port's own sphere;
    # within float32 summation order against the reference's
    np.testing.assert_array_equal(to_np(fit), to_np(sphere(to_torch(genomes))))
    np.testing.assert_allclose(to_np(fit), np.asarray(fit_ref), **TOL)
    for k in ("skew", "naive_skew", "balanced", "padded"):
        np.testing.assert_allclose(to_np(st[k]), np.asarray(st_ref[k]),
                                   rtol=1e-6, err_msg=k)


def test_broker_identity_path_and_inline_backend():
    g = to_torch(np.ones((6, 3), np.float32))
    b = tb.Broker(sphere)
    assert isinstance(b.backend, tb.InlineBackend)
    assert isinstance(b.backend, tb.DispatchBackend)
    fit, st = b.evaluate(g)
    np.testing.assert_array_equal(to_np(fit), np.full((6, 1), 3.0))
    assert float(st["skew"]) == 1.0 and float(st["balanced"]) == 0.0
    with pytest.raises(ValueError):
        tb.Broker()
