"""Meta-GA (``repro_torch.core.meta``), the generation step's ``hyper`` /
``pop_active`` overrides and the fused variation's per-run form, against
the JAX reference.

The inner GA is replayed from the reference's own draws. The reference's
inner GA calls the unfused operators; the port's calls the fused variation
(its plain version on the CPU), whose uniforms map one for one onto the
unfused draws: SBX's ``do_pair`` -> ``m_pair``, ``do_gene`` -> ``m_gene``,
``u`` -> ``u_cx``, then mutation's ``do_ind``, ``do_gene``, ``u`` ->
``m_ind``, ``m_genem``, ``u_mut`` (each ``< prob`` test is the same
comparison on the same number). Tolerance: a replayed generation's, as in
``tests/test_torch_island_engine.py`` (rtol 1e-5, atol 1e-5); the active
population size exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GAConfig as JaxGAConfig
from repro.core import island as jisland
from repro.core import meta as jmeta
from repro.core.broker import Broker as JaxBroker
from repro.core.population import init_population as jax_init_population
from repro.fitness import rastrigin as jrastrigin
from repro_torch.configs.base import GAConfig
from repro_torch.core import island, meta
from repro_torch.core.broker import Broker
from repro_torch.core.population import population_from_numpy
from repro_torch.core.uniforms import ArrayUniforms, GeneratorUniforms
from repro_torch.fitness import rastrigin
from repro_torch.kernels.genetic import ops
from torch_parity import (jax_generation_draws, jax_variation_draws, np32,
                          to_np, to_torch)

REPLAY_TOL = dict(rtol=1e-5, atol=1e-5)
INNER = dict(num_genes=4, lower=-5.12, upper=5.12)
# a Tab. 4 genome: pop_size, cx_prob, mut_prob, eta_mut, eta_cx
HG = [12.6, 0.85, 0.6, 18.0, 12.0]


def _inner_draws(rng, p_max, g, generations):
    """The reference inner run's draws (``repro.core.meta.make_inner_ga``)
    in the port's order: the initial genomes, then per generation the
    tournament and the variation (fused layout for even p_max)."""
    k_init, k_loop = jax.random.split(rng)
    draws = [np32(jax.random.uniform(k_init, (p_max, g)))]
    for k in jax.random.split(k_loop, generations):
        k_sel, k_var = jax.random.split(k)
        draws.append(np32(jax.random.uniform(k_sel, (p_max, 2))))
        var = jax_variation_draws(k_var, p_max, g, fused=False)
        if p_max % 2 == 0:
            do_pair, do_gene, u, do_ind, do_genem, u_mut = var
            var = [u, do_pair[:, None], do_gene, u_mut, do_ind[:, None],
                   do_genem]
        draws += var
    return draws


@pytest.mark.parametrize("p_max,pop_size,generations", [
    (16, 12.6, 10), (32, 2.0, 10), (32, 32.0, 10), (32, 12.5, 4),
    (15, 9.0, 4)])
def test_inner_ga_matches_reference(p_max, pop_size, generations):
    """p_max 16 and 32 (pop_size 2 and 32: the smallest and the full
    active size) take the fused layout; odd p_max the unfused one."""
    hg = np32([pop_size] + HG[1:])
    rng = jax.random.PRNGKey(int(pop_size * 10) + p_max)
    ref = jmeta.make_inner_ga(JaxGAConfig(**INNER), jrastrigin, p_max=p_max,
                              generations=generations)(jnp.asarray(hg), rng)
    src = ArrayUniforms(_inner_draws(rng, p_max, 4, generations))
    got = meta.make_inner_ga(GAConfig(**INNER), rastrigin, p_max=p_max,
                             generations=generations)(to_torch(hg), src)
    assert src.remaining() == 0
    assert got.shape == ()
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **REPLAY_TOL)
    p_act = jnp.clip(jnp.round(jnp.float32(pop_size)), 2, p_max)
    assert float(meta.active_size(torch.tensor(pop_size), p_max)) == \
        float(p_act)


def test_active_size_rounds_half_to_even():
    sizes = np32([1.2, 2.5, 3.5, 12.5, 13.5, 499.5, 700.0])
    got = meta.active_size(to_torch(sizes), 500)
    ref = jnp.clip(jnp.round(jnp.asarray(sizes)), 2, 500)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def _meta_fitness(**kw):
    return meta.make_meta_fitness(GAConfig(**INNER), rastrigin,
                                  **dict(dict(p_max=16, generations=5,
                                              num_seeds=2), **kw))


def test_meta_fitness_is_the_min_over_seeds_of_inner_runs():
    """2 individuals x 2 seeds in one batch: (N, 1), each the minimum of
    its two seeds' runs, each run equal to the same run made alone on
    that seed's stream."""
    hg = torch.tensor([HG, [30.0, 0.5, 0.9, 5.0, 40.0]])
    got = _meta_fitness()(hg)
    assert got.shape == (2, 1)
    inner = meta.make_inner_ga(GAConfig(**INNER), rastrigin, p_max=16,
                               generations=5)
    for n in range(2):
        alone = [float(inner(hg[n], GeneratorUniforms(gen, "cpu")))
                 for gen in meta.seed_generators(17, 2, "cpu")]
        np.testing.assert_allclose(float(got[n, 0]), min(alone),
                                   **REPLAY_TOL)


def test_meta_fitness_common_random_numbers():
    """Equal genomes get equal fitness, and a second call gives the same
    values: every individual runs seed s on the same draws, from
    base_seed alone."""
    fit = _meta_fitness()
    hg = torch.tensor([HG, HG, [40.0, 0.9, 0.1, 20.0, 15.0]])
    first = fit(hg)
    assert torch.equal(first[0], first[1])
    assert torch.equal(fit(hg), first)
    torch.manual_seed(123)                # the global stream plays no part
    assert torch.equal(fit(hg), first)
    assert not torch.equal(_meta_fitness(base_seed=18)(hg), first)


def test_meta_config_bounds_and_decode():
    assert meta.META_GENE_SPEC == jmeta.META_GENE_SPEC
    assert meta.meta_bounds() == jmeta.meta_bounds() == (
        (12.0, 0.0, 0.0, 0.01, 0.01), (500.0, 1.0, 1.0, 100.0, 100.0))
    cfg, jcfg = meta.meta_ga_config(), jmeta.meta_ga_config()
    for field in ("num_genes", "pop_per_island", "num_islands",
                  "generations_per_epoch", "num_epochs", "gene_lower",
                  "gene_upper", "mutation_prob", "mutation_eta",
                  "crossover_prob", "crossover_eta", "fused_operators",
                  "seed"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    g = np32(np.random.default_rng(0).uniform(0, 50, (3, 5)))
    got = meta.decode_meta_genome(to_torch(g))
    ref = jmeta.decode_meta_genome(jnp.asarray(g).T)
    assert list(got) == list(ref)
    for k in got:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(ref[k]))


def test_meta_ga_keeps_tab4_bounds_and_elitism():
    """The outer GA (unfused, NSGA-II) over the meta fitness: genomes
    inside Tab. 4's bounds (the initial population too), finite fitness,
    best non-increasing over epochs."""
    cfg = meta.meta_ga_config(num_epochs=3, pop_per_island=6,
                              num_islands=2)
    from repro_torch.core.engine import GAEngine
    eng = GAEngine(cfg, _meta_fitness(generations=3), device="cpu")
    pop = eng.init()
    lo, hi = (torch.tensor(b) for b in meta.meta_bounds())
    assert bool(((pop.genomes >= lo) & (pop.genomes <= hi)).all())
    pop, hist = eng.run(pop)
    bests = [h["best"] for h in hist]
    assert all(b <= a for a, b in zip(bests, bests[1:]))
    assert bool(torch.isfinite(pop.fitness).all())
    assert bool(((pop.genomes >= lo) & (pop.genomes <= hi)).all())


@pytest.mark.parametrize("fused", [True, False])
def test_generation_with_hyper_matches_reference(fused):
    """One ``make_generation_step(hyper=...)`` generation, 0-d tensor
    hyperparameters and ``pop_active`` 10 of 16, replayed from the
    reference's draws."""
    kw = dict(num_genes=6, pop_per_island=16, num_islands=2, lower=-5.12,
              upper=5.12, fused_operators=fused, seed=4)
    jcfg, cfg = JaxGAConfig(**kw), GAConfig(**kw)
    hyper = dict(eta_cx=7.5, prob_cx=0.8, eta_mut=30.0, prob_mut=0.4,
                 pop_active=10.0)
    jpop = jax_init_population(jcfg, jax.random.PRNGKey(2))
    jpop = jisland.evaluate_population(jcfg, JaxBroker(jrastrigin), jpop)
    jhyper = {k: jnp.float32(v) for k, v in hyper.items()}
    jnew, jmet = jax.jit(jisland.make_generation_step(
        jcfg, JaxBroker(jrastrigin), hyper=jhyper))(jpop, None)

    tpop = population_from_numpy(jax.device_get(jpop._asdict()), "cpu")
    src = ArrayUniforms(jax_generation_draws(jpop.rng, 16, 6, 2, fused))
    gen = island.make_generation_step(
        cfg, Broker(rastrigin), "cpu",
        hyper={k: torch.tensor(v) for k, v in hyper.items()})
    tnew, tmet = gen(tpop, src)
    assert src.remaining() == 0
    for got, ref in ((tnew.genomes, jnew.genomes),
                     (tnew.fitness, jnew.fitness),
                     (tmet["best"], jmet["best"])):
        np.testing.assert_allclose(to_np(got), np.asarray(ref),
                                   **REPLAY_TOL)


def test_per_run_plain_variation_equals_separate_calls():
    """The (R, 5) plain variation equals R separate (5,) calls bit for
    bit, and uniforms shared across a leading dim equal the same uniforms
    expanded over it."""
    rs = np.random.default_rng(5)
    r, p, g = 6, 16, 8
    parents = to_torch(np32(rs.uniform(-2, 2, (r, p, g))))
    gen = torch.Generator().manual_seed(5)
    rnd = {k: torch.rand(shape, generator=gen) for k, shape in (
        ("u_cx", (r, p // 2, g)), ("m_pair", (r, p // 2, 1)),
        ("m_gene", (r, p // 2, g)), ("u_mut", (r, p, g)),
        ("m_ind", (r, p, 1)), ("m_genem", (r, p, g)))}
    rows = to_torch(np32(np.c_[rs.uniform(1, 60, r), rs.uniform(0, 1, r),
                               rs.uniform(1, 60, r), rs.uniform(0, 1, r),
                               rs.uniform(0.1, 0.6, r)]))
    lo, hi = torch.full((g,), -2.0), torch.full((g,), 2.0)
    batched = ops.fused_variation(parents, rnd, rows, lo, hi)
    for k in range(r):
        one = ops.fused_variation(parents[k], {n: v[k] for n, v in
                                               rnd.items()}, rows[k], lo, hi)
        assert torch.equal(batched[k], one), k

    # (N, S) runs on (S, ...) uniforms, against the uniforms expanded
    runs = parents.reshape(2, 3, p, g)
    shared = {n: v[:3] for n, v in rnd.items()}
    expanded = {n: v.expand((2,) + v.shape).contiguous()
                for n, v in shared.items()}
    per_run = rows.reshape(2, 3, 5)
    assert torch.equal(ops.fused_variation(runs, shared, per_run, lo, hi),
                       ops.fused_variation(runs, expanded, per_run, lo, hi))


def test_pack_scalars_per_run_rows():
    eta = torch.tensor([[1.0, 2.0]])
    out = ops.pack_scalars(eta, torch.tensor(0.5), eta + 1,
                           torch.tensor([[0.1, 0.2]]), torch.tensor(0.25))
    assert out.shape == (1, 2, 5)
    np.testing.assert_array_equal(to_np(out[0, 1]),
                                  np32([2.0, 0.5, 3.0, 0.2, 0.25]))
    assert ops.pack_scalars(1.0, 0.5, 2.0, 0.1, 0.25).shape == (5,)
