"""Elasticity and stragglers: ``runtime.elastic.repartition_islands``,
``GAEngine.resize`` and ``runtime.straggler.backup_dispatch_eval``
against the JAX reference (``tests/test_checkpoint_fault.py``'s cases).

A shrink is exact against the reference (NSGA-II survivor selection on
integer keys with stable sorts). A grow's clones draw their mutation from
the port's own stream, so it is held to the reference's properties: the
best kept, every clone at +inf, the first copy of each island unchanged.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import GAConfig as JaxGAConfig
from repro.core.engine import GAEngine as JaxGAEngine
from repro.fitness import sphere as jsphere
from repro.runtime.elastic import repartition_islands as jax_repartition
from repro_torch.configs.base import GAConfig
from repro_torch.core.engine import GAEngine
from repro_torch.core.population import population_from_numpy
from repro_torch.fitness import rastrigin, sphere
from repro_torch.runtime import backup_dispatch_eval, repartition_islands
from torch_parity import np32, to_np, to_torch

BASE = dict(num_genes=5, pop_per_island=16, num_islands=4,
            generations_per_epoch=2, num_epochs=6, lower=-2.0, upper=2.0,
            fused_operators=False, seed=3)


def _cfg(**kw):
    return GAConfig(**dict(BASE, **kw))


def _cost(g):
    return torch.sum(torch.abs(g), -1) + 0.1


def _jax_pop(islands):
    """A reference population (evaluated), and the same in the port."""
    jcfg = JaxGAConfig(**dict(BASE, num_islands=islands))
    jpop = JaxGAEngine(jcfg, jsphere).init()
    return jcfg, jpop, population_from_numpy(
        jax.device_get(jpop._asdict()), "cpu")


@pytest.mark.parametrize("islands,new", [(4, 2), (4, 1), (6, 3)])
def test_shrink_matches_reference(islands, new):
    jcfg, jpop, pop = _jax_pop(islands)
    jsmall = jax_repartition(jcfg, jpop, new, jax.random.PRNGKey(1))
    small = repartition_islands(_cfg(num_islands=islands), pop, new,
                                np.array([0, 1], np.uint32))
    np.testing.assert_array_equal(to_np(small.genomes),
                                  np.asarray(jsmall.genomes))
    np.testing.assert_array_equal(to_np(small.fitness),
                                  np.asarray(jsmall.fitness))
    assert float(small.fitness.min()) == float(pop.fitness.min())
    assert small.rng.shape == (new, 2) and small.rng.dtype == np.uint32
    assert (small.generation, small.epoch, small.evals) == \
        (pop.generation, pop.epoch, pop.evals)


@pytest.mark.parametrize("islands,new", [(2, 4), (2, 6), (1, 3)])
def test_grow_keeps_best_and_marks_clones(islands, new):
    _, _, pop = _jax_pop(islands)
    big = repartition_islands(_cfg(num_islands=islands), pop, new,
                              np.array([0, 1], np.uint32))
    rep = new // islands
    assert big.genomes.shape == (new, 16, 5)
    assert float(big.fitness.min()) == float(pop.fitness.min())
    for k in range(new):
        src = k // rep
        if k % rep == 0:                      # the first copy is the source
            assert torch.equal(big.genomes[k], pop.genomes[src])
            assert torch.equal(big.fitness[k], pop.fitness[src])
        else:                                 # a clone: mutated, +inf
            assert bool(torch.isinf(big.fitness[k]).all())
            assert not torch.equal(big.genomes[k], pop.genomes[src])
    assert bool((big.genomes.abs() <= 2.0).all())
    assert len({tuple(r) for r in big.rng.tolist()}) == new
    again = repartition_islands(_cfg(num_islands=islands), pop, new,
                                np.array([0, 1], np.uint32))
    assert torch.equal(again.genomes, big.genomes)        # deterministic


@pytest.mark.parametrize("islands,new", [(2, 3), (4, 3)])
def test_repartition_refuses_uneven_groups(islands, new):
    _, _, pop = _jax_pop(islands)
    with pytest.raises(ValueError):
        repartition_islands(_cfg(num_islands=islands), pop, new,
                            np.array([0, 1], np.uint32))


def test_resize_rebalanced_lanes_match_fixed_lane_run():
    """Workers 8 -> 4 with the islands 4 -> 2 against 8 kept: the same
    genomes bit for bit (dispatch permutations never change fitness),
    balanced dispatch engaged throughout."""
    def run_schedule(workers_after):
        eng = GAEngine(_cfg(), sphere, cost_fn=_cost, num_workers=8,
                       device="cpu")
        pop, h1 = eng.run(eng.init(), epochs=2)
        pop = eng.resize(pop, 2, rng=np.array([0, 9], np.uint32),
                         num_workers=workers_after)
        pop, h2 = eng.run(pop, epochs=2)
        return eng, pop, h1 + h2

    eng_a, pop_a, hist_a = run_schedule(None)
    eng_b, pop_b, hist_b = run_schedule(8)
    assert eng_a.broker.num_workers == 4 and eng_b.broker.num_workers == 8
    assert eng_a.cfg.num_islands == 2 and pop_a.genomes.shape[0] == 2
    assert hist_a[-1]["best"] == hist_b[-1]["best"]
    assert torch.equal(pop_a.genomes, pop_b.genomes)
    assert all(h["balanced"] == 1.0 for h in hist_a)


def test_resize_grow_reevaluates_and_counts():
    eng = GAEngine(_cfg(num_islands=2), sphere, cost_fn=_cost, num_workers=4,
                   device="cpu")
    pop, _ = eng.run(eng.init(), epochs=1)
    evals_before = eng.evals_host
    pop = eng.resize(pop, 4)                       # the default stream
    assert pop.genomes.shape[0] == 4 and eng.broker.num_workers == 8
    assert bool(torch.isfinite(pop.fitness).all())
    assert eng.evals_host == evals_before + eng.cfg.global_pop
    np.testing.assert_array_equal(
        to_np(pop.fitness), to_np(sphere(pop.genomes.reshape(-1, 5))
                                  ).reshape(4, 16, 1))
    pop, hist = eng.run(pop, epochs=1)
    assert all(h["balanced"] == 1.0 for h in hist)
    assert bool(torch.isfinite(pop.fitness).all())


def test_resize_resets_the_cost_model_and_backend_lanes():
    class Lanes:
        """A backend with its own lane count, as the decoupled ones."""
        name, num_workers = "lanes", 4

        def __call__(self, genomes):
            return sphere(genomes)

    class Cost:
        resets = 0

        def __call__(self, g):
            return _cost(g)

        def reset(self):
            Cost.resets += 1

    backend = Lanes()
    eng = GAEngine(_cfg(), sphere, cost_fn=Cost(), backend=backend,
                   num_workers=4, device="cpu")
    pop = eng.resize(eng.init(), 2)
    assert backend.num_workers == 2 == eng.broker.num_workers
    assert Cost.resets == 1 and eng.broker.backend is backend
    assert pop.genomes.shape[0] == 2


@pytest.mark.parametrize("n,w,frac", [(64, 8, 0.25), (53, 8, 0.2),
                                      (5, 8, 0.5), (32768, 4, 0.125)])
def test_backup_dispatch_matches_direct_evaluation(n, w, frac):
    genomes = to_torch(np32(np.random.default_rng(n).uniform(-1, 1,
                                                             (n, 4))))
    fit, stats = backup_dispatch_eval(rastrigin, genomes,
                                      torch.sum(genomes, -1), num_workers=w,
                                      backup_frac=frac)
    assert torch.equal(fit, rastrigin(genomes))
    nb = max(w, int(round(n * frac / w)) * w)
    assert stats == {"duplicated": nb, "extra_frac": nb / n}


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 60), w=st.integers(1, 12),
       frac=st.floats(0.0, 0.5), seed=st.integers(0, 2**30))
def test_backup_dispatch_property_any_shape(n, w, frac, seed):
    """Over random N and W (odd N, N < W): the combined fitness equals
    direct evaluation and the duplicate batch stays lane-divisible."""
    genomes = to_torch(np32(np.random.default_rng(seed).uniform(-1, 1,
                                                                (n, 3))))
    cost = torch.sum(torch.abs(genomes), -1) + 0.05
    fit, stats = backup_dispatch_eval(sphere, genomes, cost, num_workers=w,
                                      backup_frac=frac)
    np.testing.assert_allclose(to_np(fit), to_np(sphere(genomes)),
                               rtol=1e-6)
    assert stats["duplicated"] % w == 0 and stats["duplicated"] >= w
