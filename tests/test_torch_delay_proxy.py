"""``delay_proxy`` (the paper §4.1 load model) and the delay chain's plain
version against the reference (``repro.fitness.benchmarks.delay_proxy``).

The reference keeps the chain's end value internal; wrapping a fitness of
zeros exposes it as ``acc * 1e-30`` (one float32 rounding, ~6e-8
relative). Tolerances: the chain's values at rtol 1e-5 for at most 1000
steps (XLA's ``sin`` and PyTorch's round differently in the last bits, and
those differences carry through the chain); the fitness bit-equal to the
inner fitness of the same package (``acc * 1e-30`` vanishes against it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fitness import benchmarks as jbench
from repro_torch.fitness import benchmarks as tbench
from repro_torch.fitness import delay_proxy, rastrigin, sphere
from repro_torch.kernels.delay import ops
from repro_torch.kernels.delay.ref import delay_chain_ref
from torch_parity import to_np, to_torch

CHAIN_TOL = dict(rtol=1e-5, atol=0.0)


def _genomes(n, g, seed):
    return np.random.default_rng(seed).uniform(-2, 2, (n, g)).astype(
        np.float32)


def _zeros_t(x):
    return torch.zeros((x.shape[0], 1), dtype=torch.float32)


def _zeros_j(x):
    return jnp.zeros((x.shape[0], 1), jnp.float32)


def _iters_t(x):
    return (torch.abs(x[:, 0]) * 500).to(torch.int32)


def _iters_j(x):
    return (jnp.abs(x[:, 0]) * 500).astype(jnp.int32)


@pytest.mark.parametrize("iters", [0, 1, 7, 1000])
@pytest.mark.parametrize("n", [1, 33])
def test_chain_matches_reference_fixed_iters(n, iters):
    g = _genomes(n, 5, n + iters)
    acc = to_np(delay_proxy(_zeros_t, flop_iters=iters)(to_torch(g)))
    ref = np.asarray(jbench.delay_proxy(_zeros_j, flop_iters=iters)(
        jnp.asarray(g)))
    if iters == 0:                       # no chain: the inner fitness
        np.testing.assert_array_equal(acc, np.zeros((n, 1), np.float32))
    np.testing.assert_allclose(acc / 1e-30, ref / 1e-30, **CHAIN_TOL)


@pytest.mark.parametrize("n", [1, 40])
def test_chain_matches_reference_heterogeneous_iters(n):
    """iters_fn gives each lane its own count (0 to 999 here): the port's
    chain stops each lane at its count, the reference masks it."""
    g = _genomes(n, 3, 9)
    acc = to_np(delay_proxy(_zeros_t, iters_fn=_iters_t)(to_torch(g)))
    ref = np.asarray(jbench.delay_proxy(_zeros_j, iters_fn=_iters_j)(
        jnp.asarray(g)))
    np.testing.assert_allclose(acc / 1e-30, ref / 1e-30, **CHAIN_TOL)


@pytest.mark.parametrize("inner", ["sphere", "rastrigin"])
@pytest.mark.parametrize("kw", [dict(flop_iters=300),
                                dict(iters_fn=_iters_t)])
def test_fitness_bit_equal_to_inner(inner, kw):
    g = to_torch(_genomes(24, 6, 4))
    base = tbench.get_benchmark(inner)
    out = delay_proxy(base, **kw)(g)
    assert torch.equal(out, base(g))
    jbase = jbench.get_benchmark(inner)
    np.testing.assert_allclose(to_np(out), np.asarray(jbase(jnp.asarray(
        to_np(g)))), rtol=1e-6, atol=1e-5)
    # the default inner fitness is sphere
    assert torch.equal(delay_proxy(**kw)(g), sphere(g))


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    acc0 = torch.tensor([1.0, 0.5, -2.0, 3.0])
    iters = torch.tensor([0, 3, 10, -4], dtype=torch.int32)
    before = ops.launches
    out = ops.delay_chain(acc0, iters)
    assert ops.launches == before
    assert torch.equal(out, delay_chain_ref(acc0, iters))
    # a lane with no steps (0 or fewer) returns its input untouched
    assert out[0] == acc0[0] and out[3] == acc0[3]
    a = acc0[1]
    for _ in range(3):
        a = a + torch.sin(a) * 1e-6
    assert out[1] == a


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.delay_chain(torch.ones(4, device="meta"),
                        torch.ones(4, dtype=torch.int32, device="meta"))


def test_delay_proxy_through_the_engine_matches_plain_fitness():
    """A GA whose fitness is delay_proxy(rastrigin) runs the same
    generations as one on rastrigin itself."""
    from repro_torch.configs.base import GAConfig
    from repro_torch.core.engine import GAEngine
    cfg = GAConfig(num_genes=4, pop_per_island=12, num_islands=2,
                   generations_per_epoch=2, num_epochs=2, lower=-1.0,
                   upper=1.0, fused_operators=False, seed=3)
    pops = []
    for fn in (rastrigin, delay_proxy(rastrigin, flop_iters=50)):
        eng = GAEngine(cfg, fn, num_workers=4, device="cpu")
        pop, _ = eng.run(eng.init())
        pops.append(pop)
    assert torch.equal(pops[0].genomes, pops[1].genomes)
    assert torch.equal(pops[0].fitness, pops[1].fitness)
