"""NSGA-II: exact integer keys, ranks and survivor order against
``repro.core.nsga2``, with planted ties and a planted all-+inf front."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import nsga2 as jn
from repro_torch.core import nsga2 as tn
from torch_parity import to_np, to_torch


def _fitness(n, o, seed, ties=True, inf_rows=0):
    rs = np.random.default_rng(seed)
    f = (rs.integers(0, max(2, n // 4), (n, o)) if ties
         else rs.normal(size=(n, o))).astype(np.float32)
    if inf_rows:
        f[rs.choice(n, inf_rows, replace=False)] = np.inf
    return f


CASES = [(o, n, seed, ties, inf_rows)
         for o in (1, 2)
         for n, seed, ties, inf_rows in [(32, 0, True, 0), (32, 1, True, 4),
                                         (32, 2, False, 0), (48, 3, False, 5),
                                         (48, 4, True, 48)]]
# the reference's keys, jitted: one compile per shape
jax_keys = jax.jit(jn.nsga2_keys)


@pytest.mark.parametrize("o,n,seed,ties,inf_rows", CASES)
def test_keys_exact(o, n, seed, ties, inf_rows):
    f = _fitness(n, o, seed, ties, inf_rows)
    r_ref, c_ref, k_ref = (np.asarray(a) for a in jax_keys(jnp.asarray(f)))
    r, c, k = (to_np(a) for a in tn.nsga2_keys(to_torch(f)))
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_allclose(c, c_ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(
        to_np(tn.domination_matrix(to_torch(f))),
        np.asarray(jn.domination_matrix(jnp.asarray(f))))


def test_all_inf_front_gives_nan_crowding_sorted_last():
    """A front whose members are all +inf has span inf-inf = NaN in both
    packages; NaN crowding sorts last among its front."""
    f = np.array([[1.0], [2.0], [np.inf], [np.inf], [np.inf], [0.5]],
                 np.float32)
    r, c, k = (to_np(a) for a in tn.nsga2_keys(to_torch(f)))
    _, c_ref, k_ref = (np.asarray(a) for a in jax_keys(jnp.asarray(f)))
    assert np.isnan(c[2:5]).all() and np.isnan(c_ref[2:5]).all()
    np.testing.assert_array_equal(k, k_ref)
    assert list(np.argsort(k, kind="stable")[-3:]) == [2, 3, 4]


@pytest.mark.parametrize("o", [1, 2])
def test_batched_islands_match_vmapped_reference(o):
    fits = np.stack([_fitness(32, o, s, ties=s % 2 == 0, inf_rows=s)
                     for s in range(4)])
    _, _, k_ref = jax.vmap(jn.nsga2_keys)(jnp.asarray(fits))
    _, _, k = tn.nsga2_keys(to_torch(fits))
    np.testing.assert_array_equal(to_np(k), np.asarray(k_ref))


@pytest.mark.parametrize("o,mu", [(1, 16), (2, 10)])
def test_survivor_order_exact(o, mu):
    n, g = 48, 5
    f = _fitness(n, o, 7 + o, ties=True, inf_rows=3)
    genomes = np.random.default_rng(o).normal(size=(n, g)).astype(np.float32)
    g_ref, f_ref = jn.survivor_select(jnp.asarray(genomes), jnp.asarray(f), mu)
    g_t, f_t = tn.survivor_select(to_torch(genomes), to_torch(f), mu)
    np.testing.assert_array_equal(to_np(g_t), np.asarray(g_ref))
    np.testing.assert_array_equal(to_np(f_t), np.asarray(f_ref))


def test_ranks_blocking_is_exact_for_any_block():
    """Host checks between blocks of iterations do not change the ranks."""
    f = to_torch(_fitness(50, 1, 11, ties=False))
    full = to_np(tn.nondominated_ranks(f, block=1000))
    for block in (1, 3, 7, 64):
        np.testing.assert_array_equal(to_np(tn.nondominated_ranks(
            f, block=block)), full)
    assert sorted(full) == list(range(50))      # one front per value
