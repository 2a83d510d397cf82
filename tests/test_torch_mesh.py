"""The GA and the HVDC fitness on a device mesh, on gloo process groups on
the CPU: the port's counterpart of ``tests/test_multidevice.py``.

Each world of ranks runs once (``tests/torch_mesh_worker.py``, one process
per rank, a ``file://`` store under the test's tmp dir) and every test of
it reads what rank 0 saved:

* 8 ranks: the reference's own setting (``test_multidevice.py:25-59``:
  5 genes, 8 x 8 islands, 2 generations x 3 epochs, sphere, seed 9)
  bit-identical to one rank, on 8 shards; migration issues one collective
  per shift (the counterpart of ``:102``'s CollectivePermute), ring and
  all-to-all.
* 4 ranks: 6 islands with the fused operators (blocks of 2, 2, 1, 1)
  bit-identical to one rank; one generation and one torus migration
  replayed from the reference's draws; the cost-model broker on a
  (data 2, model 2) mesh, one lane chunk per data rank; the HVDC fitness
  on that mesh with 8 contingencies, full AC and screened to 4.
* Elastic runs and the learned cost model: ``GAEngine.resize`` on 8 ranks
  (8 -> 16 -> 8 islands), on 4 (8 -> 4 -> 12, two ranks without a lane
  after the shrink) and on (data 2, model 2), bit-identical to one rank's
  resize run (population, best trace, ``evals_host``, dispatch stats); a
  resize below the data ranks refused on every rank; a ``CostEMA`` over 4
  data ranks and over (data 2, model 2) with a deterministic decoupled
  backend equal to one rank's (tables after each evaluate, permutations,
  fitness), with real host pools equal across ranks, and through a
  resize.

HVDC parity with the reference follows ``tests/test_torch_powerflow.py``:
flags exact, objectives on converged lanes at rtol 1e-4 / atol 1e-4
(unscreened; screened through one rank of the port). Against one rank of
the port the mesh is held exactly, screened or not.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GAConfig as JaxGAConfig
from repro.core import island as jisland
from repro.core.broker import Broker as JaxBroker
from repro.core.population import init_population as jax_init_population
from repro.fitness import rastrigin as jrastrigin
from repro.fitness.powerflow import HVDCDispatchFitness as JaxHVDCFitness
from repro.powerflow import grid as jg
from repro.powerflow import hvdc as jh
from repro.powerflow import newton as jn
from repro_torch.configs.base import GAConfig
from repro_torch.core import island
from repro_torch.core.broker import (Broker, CostEMA, balanced_permutation,
                                     inverse_permutation, padded_take)
from repro_torch.core.engine import GAEngine
from repro_torch.core.population import init_population, population_from_numpy
from repro_torch.core.uniforms import ArrayUniforms
from repro_torch.fitness import (HVDCDispatchFitness, hostsim, rastrigin,
                                 sphere)
from repro_torch.powerflow.grid import make_synthetic_grid
from torch_mesh_worker import (BROKER_G, BROKER_N, EIGHT, EMA_ALPHA,
                               EMA_GENS, EMA_W, HVDC_CASES, HVDC_GRID,
                               HVDC_SCREENS, MIGRATIONS, RESIZES, SIX,
                               TimedSphere, broker_cost, ema_broker,
                               ema_genomes, hvdc_parts, resize_run)
from torch_parity import jax_generation_draws, jax_migration_draws, to_np

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_worker.py")
SPAWN_TIMEOUT_S = 240
OBJ_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread in this process too, as each rank runs: these
    small batches gain nothing from more, and on a loaded machine
    oversubscribed threads slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(scenario: str, world: int, where: Path) -> dict:
    """Run ``scenario`` on ``world`` ranks and return rank 0's results."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(WORKER.parent)]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), scenario, str(r), str(world),
         str(where)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {scenario}:\n{log[-3000:]}"
    return torch.load(where / f"{scenario}.pt", weights_only=False)


def assert_same_pop(got: dict, pop):
    np.testing.assert_array_equal(got["genomes"], to_np(pop.genomes))
    np.testing.assert_array_equal(got["fitness"], to_np(pop.fitness))
    np.testing.assert_array_equal(got["rng"], pop.rng)
    assert int(got["epoch"]) == pop.epoch
    assert int(got["evals"]) == pop.evals


def assert_same_resize(got: dict, want: dict):
    """Two ``resize_run`` results: population, best trace, dispatch
    stats, ``evals_host`` and lanes bit for bit."""
    for k, v in want["pop"].items():
        np.testing.assert_array_equal(got["pop"][k], v, err_msg=k)
    assert len(got["trace"]) == len(want["trace"])
    for a, b in zip(got["trace"], want["trace"]):
        np.testing.assert_array_equal(a, b)
    assert got["stats"] == want["stats"]
    assert got["evals_host"] == want["evals_host"]
    assert got["workers"] == want["workers"]


def one_rank_run(cfg, fitness):
    eng = GAEngine(cfg, fitness, device="cpu")
    pop, hist = eng.run()
    return pop, np.stack([h["trace"] for h in hist]), eng.evals_host


# ---------------------------------------------------------------------------
# 8 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return run_ranks("eight", 8, tmp_path_factory.mktemp("eight"))


def test_eight_ranks_bit_identical_to_one(eight):
    run = eight["run"]
    assert run["islands"] == [1] * 8                  # 8 shards
    pop, trace, evals = one_rank_run(GAConfig(**EIGHT), sphere)
    assert_same_pop(run["pop"], pop)
    np.testing.assert_array_equal(run["trace"], trace)
    assert run["evals_host"] == evals == 8 * 8 * (1 + 2 * 3)
    # migration and the epoch's best trace: one gather each an epoch;
    # the returned population: genomes and fitness
    assert all(c["data"]["calls"] == 3 * 2 + 2 for c in run["counts"])
    assert eight["wallclock_epochs"] == [1] * 8


@pytest.mark.parametrize("topology", MIGRATIONS)
def test_migration_issues_one_collective_per_shift(eight, topology):
    cfg = GAConfig(**dict(EIGHT, migration_pattern=topology))
    pop = island.evaluate_population(cfg, Broker(sphere),
                                     init_population(cfg, 3, "cpu"))
    want = island.migrate_ring(cfg, pop, torch.Generator().manual_seed(5))
    got = eight[topology]
    assert got["calls"] == len(island._migration_shifts(topology, 8))
    assert_same_pop(got["pop"], want)


def test_resize_on_eight_ranks_bit_identical_to_one(eight):
    want = resize_run(*RESIZES["eight"])
    assert want["workers"] == [16, 8]
    assert all(b == 1.0 for _, b in want["stats"])
    assert_same_resize(eight["resize"], want)


# ---------------------------------------------------------------------------
# 4 ranks
# ---------------------------------------------------------------------------

def _jax_six():
    jcfg = JaxGAConfig(**SIX)
    pop = jax_init_population(jcfg, jax.random.PRNGKey(6))
    return jcfg, jisland.evaluate_population(jcfg, JaxBroker(jrastrigin), pop)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """Inputs from the reference (its population and draws) and numpy
    seeds, the four ranks' results and the reference's."""
    where = tmp_path_factory.mktemp("four")
    jcfg, jpop = _jax_six()
    cfg = GAConfig(**SIX)
    gen = jax_generation_draws(jpop.rng, cfg.pop_per_island, cfg.num_genes,
                               cfg.tournament_size, True)
    shifts = island._migration_shifts(cfg.migration_pattern,
                                      cfg.num_islands)
    mig = jax_migration_draws(jpop.rng, cfg.num_migrants, len(shifts))
    rs = np.random.default_rng(25)
    inputs = {f"state_{k}": np.asarray(v)
              for k, v in jax.device_get(jpop._asdict()).items()}
    inputs.update({f"gen_{k}": a for k, a in enumerate(gen)})
    inputs.update({f"mig_{k}": a for k, a in enumerate(mig)})
    inputs.update(n_gen=len(gen), n_mig=len(mig),
                  broker_genomes=rs.uniform(-1, 1, (BROKER_N, BROKER_G))
                  .astype(np.float32),
                  hvdc_genomes=rs.uniform(-1, 1, (8, HVDC_GRID["n_hvdc"]))
                  .astype(np.float32))
    inputs["where"] = np.array(str(where))
    np.savez(where / "inputs.npz", **inputs)
    out = run_ranks("four", 4, where)
    out["inputs"] = inputs
    out["jax"] = (jcfg, jpop, gen, mig)
    return out


def test_six_islands_on_four_ranks_bit_identical(four):
    six = four["six"]
    assert six["islands"] == [2, 2, 1, 1]
    pop, trace, evals = one_rank_run(GAConfig(**SIX), rastrigin)
    assert_same_pop(six["pop"], pop)
    np.testing.assert_array_equal(six["trace"], trace)
    assert six["evals_host"] == evals


def test_pod_and_data_axes_flattened_bit_identical(four):
    """dp = ("pod", "data") on a (2, 2, 1) mesh: one group over both axes,
    the islands in its row-major order."""
    pods = four["pods"]
    assert pods["islands"] == [2, 2, 1, 1]
    assert all(set(c) == {"pod+data"} for c in pods["counts"])
    assert_same_pop(pods["pop"], population_from_numpy(four["six"]["pop"],
                                                       "cpu"))


def test_checkpoint_on_a_mesh_resumes_bit_identical(four):
    """An epoch checkpointed on four ranks (rank 0 writes the global
    population) and resumed by a new engine on each rank: the same
    population as two epochs in one run on one rank."""
    pop, _, evals = one_rank_run(GAConfig(**SIX), rastrigin)
    assert_same_pop(four["resumed"]["pop"], pop)
    assert four["resumed"]["evals_host"] == evals


def test_generation_replay_on_four_ranks_matches_reference(four):
    jcfg, jpop, gen, _ = four["jax"]
    jnew, jmet = jax.jit(jisland.make_generation_step(
        jcfg, JaxBroker(jrastrigin)))(jpop, None)
    got = four["replay"]
    assert got["left"] == 0
    np.testing.assert_allclose(got["generation"]["genomes"],
                               np.asarray(jnew.genomes), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["generation"]["fitness"],
                               np.asarray(jnew.fitness), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["best"], np.asarray(jmet["best"]),
                               rtol=1e-5, atol=1e-5)
    assert int(got["generation"]["evals"]) == int(jnew.evals)
    # and bit for bit the same generation on one rank
    cfg = GAConfig(**SIX)
    pop = population_from_numpy(jax.device_get(jpop._asdict()), "cpu")
    one, _ = island.make_generation_step(cfg, Broker(rastrigin), "cpu")(
        pop, ArrayUniforms(gen))
    assert_same_pop(got["generation"], one)


def test_migration_replay_on_four_ranks_matches_reference(four):
    jcfg, jpop, _, mig = four["jax"]
    jnew = jax.jit(lambda p: jisland.migrate_ring(jcfg, p))(jpop)
    got = four["replay"]
    assert got["migration_calls"] == len(mig) == 2          # torus (1, 3)
    np.testing.assert_array_equal(got["migration"]["genomes"],
                                  np.asarray(jnew.genomes))
    np.testing.assert_array_equal(got["migration"]["fitness"],
                                  np.asarray(jnew.fitness))


def test_cost_model_broker_evaluates_one_chunk_per_rank(four):
    got = four["broker"]
    genomes = torch.from_numpy(four["inputs"]["broker_genomes"])
    fit, stats = Broker(sphere, broker_cost, num_workers=2).evaluate(genomes)
    # N = 21 pads to 22: each data rank (both of its model ranks)
    # evaluates one chunk of 11 lanes, once
    assert got["seen"] == [[11]] * 4
    np.testing.assert_array_equal(got["fitness"], to_np(fit))
    assert got["stats"] == {k: v.item() for k, v in stats.items()}
    assert got["stats"]["padded"] == 1 and got["stats"]["balanced"] == 1.0


@pytest.fixture(scope="module")
def jax_hvdc(four):
    """The reference's unscreened objectives and its base case's flags,
    from one jitted call (the compile dominates)."""
    genomes = jnp.asarray(four["inputs"]["hvdc_genomes"])
    fit = JaxHVDCFitness(jg.make_synthetic_grid(**HVDC_GRID),
                         contingencies=HVDC_CASES)
    gj = fit.gridj

    def flags(x):
        p_extra = jax.vmap(lambda d: jh.apply_hvdc(gj, d))(
            x * gj["hvdc_pmax"])
        return jax.vmap(lambda p: jn.newton_powerflow(
            gj, p_extra=p, num_iters=10).converged)(p_extra)

    obj, conv = jax.jit(lambda x: (fit(x), flags(x)))(genomes)
    return np.asarray(obj), np.asarray(conv)


@pytest.mark.parametrize("screen", HVDC_SCREENS)
def test_hvdc_on_a_2x2_mesh_matches_one_rank_and_reference(four, jax_hvdc,
                                                           screen):
    got = four[f"hvdc_{screen}"]
    genomes = four["inputs"]["hvdc_genomes"]
    one = HVDCDispatchFitness(make_synthetic_grid(**HVDC_GRID), device="cpu",
                              contingencies=HVDC_CASES, screen_top_k=screen)
    want = hvdc_parts(one, torch.from_numpy(genomes))
    # the case positions split over the model axis, one gather a call
    assert got["model_calls"] == 1 and want["model_calls"] == 0
    for k in ("converged", "loadings", "objective"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the broker on the mesh: each data rank solves one lane chunk, as a
    # batch of its own, so it equals one rank solving the chunks apart;
    # a batch's GEMMs round by its size, so against one batch of all
    # lanes only the ROADMAP.md rules hold
    g = torch.from_numpy(genomes)
    perm = balanced_permutation(one.cost_model()(g), 2)
    chunks = torch.cat([one(padded_take(g, part, len(g)))
                        for part in perm.chunk(2)])
    apart = chunks[inverse_permutation(perm, len(g))]
    np.testing.assert_array_equal(got["dispatched"], to_np(apart))
    fit, _ = Broker(one, one.cost_model(), num_workers=2).evaluate(g)
    conv = got["converged"]
    np.testing.assert_allclose(got["dispatched"][conv], to_np(fit)[conv],
                               **OBJ_TOL)
    # the reference (tests/test_torch_powerflow.py's rules); screened,
    # the mesh equals one rank exactly (above), and one rank's screened
    # objectives are held to the reference by
    # test_torch_powerflow.py::test_hvdc_fitness_matches_reference
    ref, jconv = jax_hvdc
    np.testing.assert_array_equal(conv, jconv)
    assert conv.any()
    if screen == 0:
        np.testing.assert_allclose(got["objective"][conv], ref[conv],
                                   **OBJ_TOL)


def test_resize_on_four_ranks_bit_identical_to_one(four):
    """8 -> 4 -> 12 islands: 4 -> 2 -> 6 lanes, so after the shrink two
    data ranks evaluate no lane; on (data 2, model 2) every rank, tp
    peers included, holds one rank's run."""
    want = resize_run(*RESIZES["four"])
    assert want["workers"] == [2, 6]
    assert_same_resize(four["resize"], want)
    assert len(four["resize22"]) == 4
    for got in four["resize22"]:
        assert_same_resize(got, want)


def test_resize_below_the_data_ranks_raises_on_every_rank(four):
    assert len(four["refused"]) == 4
    assert all(m and "2 islands cannot cover the mesh's 4 data ranks" in m
               for m in four["refused"])


@pytest.mark.parametrize("name,data_ranks", [("ema", 4), ("ema22", 2)])
def test_cost_ema_on_a_mesh_equals_one_rank(four, name, data_ranks):
    """Every rank's table after each evaluate, the fitness and the stats
    are one rank's under the same deterministic backend; the data ranks'
    lane permutations, in rank order, are one rank's, and a tp peer sees
    its data rank's."""
    backend = TimedSphere(EMA_W)
    want = ema_broker(backend, prime_fn=broker_cost if name == "ema22"
                      else None)
    ranks = four[name]
    for rank in ranks:
        assert len(rank["run"]) == EMA_GENS
        for got, exp in zip(rank["run"], want):
            np.testing.assert_array_equal(got["table"], exp["table"])
            np.testing.assert_array_equal(got["fitness"], exp["fitness"])
            assert got["stats"] == exp["stats"]
    tp = len(ranks) // data_ranks
    for k, perm in enumerate(backend.perms):
        np.testing.assert_array_equal(
            np.concatenate([r["perms"][k] for r in ranks[::tp]]), perm)
        for r, rank in enumerate(ranks):
            np.testing.assert_array_equal(rank["perms"][k],
                                          ranks[r - r % tp]["perms"][k])
    # the learned times moved the dispatch
    assert not np.array_equal(backend.perms[0], backend.perms[-1])


@pytest.mark.parametrize("name", ["ema_pool", "ema22_pool"])
def test_cost_ema_with_host_pools_agrees_across_ranks(four, name):
    """Each rank's own thread pool times its lanes; after every evaluate
    all ranks hold one table (tp peers included) and the fitness."""
    ranks = four[name]
    for k, g in enumerate(ema_genomes()):
        first = ranks[0][k]
        assert first["table"].shape == (len(g),)
        assert not np.all(first["table"] == 1.0)        # it learned
        for rank in ranks:
            np.testing.assert_array_equal(rank[k]["table"], first["table"])
            np.testing.assert_array_equal(rank[k]["fitness"],
                                          hostsim.sphere(g))
            assert rank[k]["stats"] == first["stats"]


def test_resize_with_a_cost_ema_on_a_mesh(four):
    """The shrink resets every rank's table (no clone to evaluate), the
    grow's clone evaluation learns it anew, and the run goes on as one
    rank's."""
    want = resize_run(*RESIZES["four"], cost_fn=CostEMA(alpha=EMA_ALPHA),
                      backend=TimedSphere(4))
    assert want["tables"][0] is None and want["tables"][1] is not None
    for got in four["ema_resize"]:
        assert got["tables"][0] is None
        np.testing.assert_array_equal(got["tables"][1], want["tables"][1])
        np.testing.assert_array_equal(got["final_table"],
                                      want["final_table"])
        assert_same_resize(got, want)
