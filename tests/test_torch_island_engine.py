"""Island model + engine: one generation and one migration per topology
replayed from the reference's draws, whole-run statistics against the
reference's, a checkpoint round trip between the two packages, and the
engine's run control."""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs.base import GAConfig as JaxGAConfig
from repro.core import island as jisland
from repro.core import nsga2 as jnsga2
from repro.core.broker import Broker as JaxBroker
from repro.core.engine import GAEngine as JaxGAEngine
from repro.core.population import init_population as jax_init_population
from repro.fitness import rastrigin as jrastrigin
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import GAConfig
from repro_torch.core import island, nsga2
from repro_torch.core.broker import Broker
from repro_torch.core.engine import GAEngine
from repro_torch.core.population import (init_population,
                                         population_from_numpy,
                                         population_to_numpy)
from repro_torch.core.uniforms import ArrayUniforms
from repro_torch.fitness import rastrigin, sphere
from torch_parity import jax_generation_draws, jax_migration_draws, to_np

BASE = dict(num_genes=8, pop_per_island=16, num_islands=4,
            generations_per_epoch=3, num_epochs=5, lower=-5.12, upper=5.12,
            mutation_prob=0.7, mutation_eta=20.0, crossover_prob=0.9,
            crossover_eta=15.0, seed=11)


def _cfgs(**kw):
    args = dict(BASE, **kw)
    return JaxGAConfig(**args), GAConfig(**args)


def _jax_pop(jcfg, seed=0):
    pop = jax_init_population(jcfg, jax.random.PRNGKey(seed))
    return jisland.evaluate_population(jcfg, JaxBroker(jrastrigin), pop)


def _port_pop(jpop):
    return population_from_numpy(jax.device_get(jpop._asdict()), "cpu")


# ---------------------------------------------------------------------------
# replayed generation and migration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("islands,pop,fused", [(2, 16, True), (3, 15, False)])
def test_generation_replay_matches_reference(islands, pop, fused):
    jcfg, cfg = _cfgs(num_islands=islands, pop_per_island=pop,
                      fused_operators=fused)
    jpop = _jax_pop(jcfg, seed=islands)
    jnew, jmet = jax.jit(jisland.make_generation_step(
        jcfg, JaxBroker(jrastrigin)))(jpop, None)

    tpop = _port_pop(jpop)
    _, _, keys = nsga2.nsga2_keys(tpop.fitness)
    _, _, jkeys = jax.vmap(jnsga2.nsga2_keys)(jpop.fitness)
    np.testing.assert_array_equal(to_np(keys), np.asarray(jkeys))

    src = ArrayUniforms(jax_generation_draws(
        jpop.rng, pop, cfg.num_genes, cfg.tournament_size, fused))
    gen = island.make_generation_step(cfg, Broker(rastrigin), "cpu")
    tnew, tmet = gen(tpop, src)
    assert src.remaining() == 0
    np.testing.assert_allclose(to_np(tnew.genomes), np.asarray(jnew.genomes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(tnew.fitness), np.asarray(jnew.fitness),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(tmet["best"]), np.asarray(jmet["best"]),
                               rtol=1e-5, atol=1e-5)
    assert tnew.generation == int(jnew.generation) == 1
    assert tnew.evals == int(jnew.evals)


@pytest.mark.parametrize("topology", ["ring", "bidirectional", "torus", "all"])
def test_migration_replay_matches_reference(topology):
    jcfg, cfg = _cfgs(migration_pattern=topology)
    jpop = _jax_pop(jcfg, seed=3)
    jnew = jisland.migrate_ring(jcfg, jpop)
    shifts = island._migration_shifts(topology, cfg.num_islands)
    assert shifts == jisland._migration_shifts(topology, cfg.num_islands)
    src = ArrayUniforms(jax_migration_draws(jpop.rng, cfg.num_migrants,
                                            len(shifts)))
    tnew = island.migrate_ring(cfg, _port_pop(jpop), src)
    assert src.remaining() == 0
    np.testing.assert_array_equal(to_np(tnew.genomes), np.asarray(jnew.genomes))
    np.testing.assert_array_equal(to_np(tnew.fitness), np.asarray(jnew.fitness))
    assert tnew.epoch == int(jnew.epoch) == 1


def test_ring_sends_best_to_next_island():
    _, cfg = _cfgs()
    pop = init_population(cfg, 0, "cpu")
    fit = torch.arange(cfg.num_islands, dtype=torch.float32)[:, None, None] \
        .repeat(1, cfg.pop_per_island, 1) + 1.0
    fit[:, 0, 0] = torch.arange(cfg.num_islands, dtype=torch.float32)
    new = island.migrate_ring(cfg, pop._replace(fitness=fit),
                              torch.Generator().manual_seed(0))
    for k in range(cfg.num_islands):
        assert float(new.fitness[(k + 1) % cfg.num_islands].min()) <= k
    assert new.genomes.shape == pop.genomes.shape and new.epoch == 1


# ---------------------------------------------------------------------------
# whole runs: statistics, run control, checkpoints
# ---------------------------------------------------------------------------

SEEDS = range(5)
RUN = dict(num_genes=8, pop_per_island=32, num_islands=4,
           generations_per_epoch=5, num_epochs=5)


def test_rastrigin_best_matches_reference_distribution():
    """Native streams differ, so whole runs compare statistically: the
    median best after 5 epochs over 5 seeds agrees within a factor 2."""
    jcfg, cfg = _cfgs(**RUN)
    jeng = JaxGAEngine(jcfg, jrastrigin)
    teng = GAEngine(cfg, rastrigin, device="cpu")
    jbest, tbest = [], []
    for s in SEEDS:
        _, jh = jeng.run(jeng.init(s), epochs=5)
        _, th = teng.run(teng.init(s), epochs=5)
        jbest.append(jh[-1]["best"])
        tbest.append(th[-1]["best"])
    jm, tm = np.median(jbest), np.median(tbest)
    assert np.isfinite(tbest).all()
    assert tm <= 2.0 * jm and jm <= 2.0 * tm, (jbest, tbest)
    # both far below a random genome's expected value (10 * G = 80)
    assert max(tm, jm) < 40.0


def test_checkpoint_round_trip_between_packages(tmp_path):
    jcfg, cfg = _cfgs(num_epochs=2)
    jeng = JaxGAEngine(jcfg, jrastrigin,
                       checkpointer=JaxCheckpointer(str(tmp_path / "jax")),
                       checkpoint_every=2)
    jpop, _ = jeng.run()
    jeng.checkpointer.wait()

    # JAX -> port: every field exact
    teng = GAEngine(cfg, rastrigin, device="cpu",
                    checkpointer=Checkpointer(str(tmp_path / "jax")))
    tpop = teng.restore()
    ref = jax.device_get(jpop._asdict())
    got = population_to_numpy(tpop)
    for k in ("genomes", "fitness", "rng"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert (tpop.epoch, tpop.generation, tpop.evals) == (
        int(ref["epoch"]), int(ref["generation"]), int(ref["evals"]))
    assert teng.evals_host == jeng.evals_host

    # port -> JAX: the port's checkpoint restores in the reference
    tck = Checkpointer(str(tmp_path / "port"), async_write=False)
    tck.save(teng._checkpoint_state(tpop), step=tpop.epoch)
    jeng2 = JaxGAEngine(jcfg, jrastrigin,
                        checkpointer=JaxCheckpointer(str(tmp_path / "port")))
    jpop2 = jeng2.restore()
    for k in ("genomes", "fitness", "rng"):
        np.testing.assert_array_equal(np.asarray(getattr(jpop2, k)),
                                      np.asarray(ref[k]), err_msg=k)
    assert int(jpop2.epoch) == tpop.epoch and jeng2.evals_host == \
        teng.evals_host
    # both continue from the restored state
    _, jh = jeng2.run(jpop2, epochs=1)
    _, th = teng.run(tpop, epochs=1)
    assert jh[0]["epoch"] == th[0]["epoch"] == 2
    assert th[0]["best"] <= float(np.min(ref["fitness"]))


def _engine(**kw):
    cfg = GAConfig(**dict(BASE, **kw.pop("cfg", {})))
    return GAEngine(cfg, kw.pop("fitness", sphere), device="cpu", **kw)


def test_elitism_best_never_worsens_and_counters():
    eng = _engine()
    gen = island.make_generation_step(eng.cfg, eng.broker, "cpu")
    pop = eng.init()
    src = torch.Generator().manual_seed(1)
    best, evals = float(pop.fitness.min()), pop.evals
    for k in range(5):
        pop, _ = gen(pop, src)
        assert float(pop.fitness.min()) <= best
        best = float(pop.fitness.min())
        assert pop.generation == k + 1
        assert pop.evals == evals + (k + 1) * eng.cfg.global_pop


def test_pipelined_run_matches_sync_run():
    sync = _engine(fitness=rastrigin)
    pop1, h1 = sync.run()
    piped = _engine(fitness=rastrigin, sync_every=2, pipeline_depth=2)
    pop2, h2 = piped.run()
    np.testing.assert_array_equal(sync.best(pop1)[0], piped.best(pop2)[0])
    assert torch.equal(pop1.genomes, pop2.genomes)
    assert [h["epoch"] for h in h2] == list(range(5))
    bests = [h["best"] for h in h2]
    assert [h["best"] for h in h1] == bests
    assert all(b <= a for a, b in zip(bests, bests[1:]))


def test_target_and_wallclock_termination():
    eng = _engine(cfg=dict(num_epochs=50))
    _, hist = eng.run(target=1.0)
    assert hist[-1]["best"] <= 1.0 and len(hist) < 50
    _, hist = _engine(cfg=dict(num_epochs=50)).run(wallclock_s=0.0)
    assert len(hist) == 1


def test_engine_checkpoint_resume(tmp_path):
    eng = _engine(checkpointer=Checkpointer(str(tmp_path)),
                  checkpoint_every=2)
    pop, _ = eng.run(epochs=4)
    eng.checkpointer.wait()
    eng2 = _engine(checkpointer=Checkpointer(str(tmp_path)),
                   checkpoint_every=2)
    pop2, hist = eng2.run(epochs=1)
    assert hist[0]["epoch"] == 4 and pop2.epoch == 5
    assert eng2.evals_host == pop2.evals == eng.evals_host + 3 * 64


def test_odd_pop_and_balanced_dispatch():
    eng = _engine(cfg=dict(pop_per_island=15), num_workers=4,
                  cost_fn=lambda g: 1.0 + g[:, 0].abs())
    pop, hist = eng.run(epochs=2)
    assert pop.genomes.shape == (4, 15, 8)
    assert hist[-1]["balanced"] == 1.0 and np.isfinite(hist[-1]["best"])


def test_engine_and_init_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GAEngine(GAConfig(**BASE), sphere)


def test_population_numpy_round_trip():
    _, cfg = _cfgs()
    pop = init_population(cfg, 5, "cpu")._replace(generation=7, epoch=2,
                                                   evals=2 ** 40)
    back = population_from_numpy(population_to_numpy(pop), "cpu")
    assert torch.equal(back.genomes, pop.genomes)
    np.testing.assert_array_equal(back.rng, pop.rng)
    assert (back.generation, back.epoch, back.evals) == (7, 2, 2 ** 40)
    assert population_to_numpy(pop)["evals"].dtype == np.int64


def test_jax_population_runs_in_port():
    """State carry-over: a JAX population continues as a port run."""
    jcfg, cfg = _cfgs()
    tpop = _port_pop(_jax_pop(jcfg))
    assert tpop.rng.dtype == np.uint32 and tpop.rng.shape == (4, 2)
    new, met = island.make_epoch_step(cfg, Broker(rastrigin), "cpu")(tpop)
    assert new.epoch == 1 and new.generation == cfg.generations_per_epoch
    assert met["best"].shape == (cfg.generations_per_epoch, cfg.num_islands)
    assert not np.array_equal(new.rng, tpop.rng)
    assert float(new.fitness.min()) <= float(tpop.fitness.min())
