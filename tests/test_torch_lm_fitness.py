"""Parity of the port's LM-training fitness (``repro_torch.fitness.lm``)
and ``ga_run --fitness lm`` with the JAX reference, on the CPU.

Both packages train the same initial parameters (the reference's, carried
over through ``models.convert``) on the same ``SyntheticTokens`` batches.
Tolerances, each with its reason:

* final losses against the reference: ``tests/test_torch_train.py``'s
  PARAM_TOL, rtol 1e-4 / atol 2e-6 (three steps of float32 training whose
  backward sums in another order);
* the vmapped fitness against one plain run per genome, and one chunk
  against two: rtol 1e-6 (the same arithmetic, batched or not).
"""
import argparse
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fitness import lm as jlm
from repro.launch import ga_run as jax_ga_run
from repro_torch.configs import get_config
from repro_torch.configs.base import GAConfig
from repro_torch.core.engine import GAEngine
from repro_torch.fitness import lm
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.launch import ga_run
from repro_torch.models.convert import params_from_numpy

PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
BATCHED_TOL = dict(rtol=1e-6, atol=0.0)
ARCHS = ["tinyllama-1.1b", "gemma2-2b", "mamba2-780m",
         "granite-moe-1b-a400m"]
SMALL = dict(steps=3, batch_size=2, seq_len=16)
# the corners the reference's system test measures against, and two draws
GENOMES = np.array([[0.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0],
                    [0.3, 0.6, 0.2, 0.8], [0.7, 0.1, 0.9, 0.4]], np.float32)


def _reference(arch):
    """(the reference's final losses (4,), its initial parameters as the
    port's state dict)."""
    fit = jlm.LMTrainFitness(arch, **SMALL)
    losses = np.asarray(jax.jit(fit)(jnp.asarray(GENOMES)))[:, 0]
    init = params_from_numpy(get_config(arch).reduced(),
                             jax.tree_util.tree_map(np.asarray, fit._init))
    return losses, init


def test_decode_matches_reference():
    rs = np.random.default_rng(0)
    genomes = np.concatenate([GENOMES, rs.random((6, 4), np.float32)])
    assert lm.LM_GENE_SPEC == jlm.LM_GENE_SPEC
    assert lm.NUM_LM_GENES == jlm.NUM_LM_GENES == 4
    batch = lm.decode_lm_genome(torch.from_numpy(genomes))
    for i, g in enumerate(genomes):
        want = jlm.decode_lm_genome(jnp.asarray(g))
        got = lm.decode_lm_genome(torch.from_numpy(g))
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-7, err_msg=name)
            assert float(batch[name][i]) == float(got[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_final_losses_match_reference(arch):
    want, init = _reference(arch)
    before = (attn_ops.launches, attn_ops.bwd_launches)
    fit = lm.LMTrainFitness(arch, device="cpu", **SMALL)
    fit.model.load_state_dict(init, strict=True)
    got = fit(torch.from_numpy(GENOMES))
    assert got.shape == (4, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, 0].numpy(), want, **PARAM_TOL)
    assert (attn_ops.launches, attn_ops.bwd_launches) == before   # CPU


@pytest.mark.parametrize("arch", ARCHS)
def test_vmapped_fitness_equals_the_per_genome_loop(arch):
    fit = lm.LMTrainFitness(arch, device="cpu", **SMALL)
    g = torch.from_numpy(GENOMES)
    np.testing.assert_allclose(fit(g).numpy(),
                               fit.per_genome_loop(g).numpy(), **BATCHED_TOL)


def test_one_chunk_equals_two(monkeypatch):
    g = torch.from_numpy(GENOMES)
    fit = lm.LMTrainFitness(device="cpu", **SMALL)
    assert fit.chunk_runs() >= 4
    one = fit(g)
    monkeypatch.setattr(lm.LMTrainFitness, "chunk_runs", lambda self: 2)
    chunks = []
    train = fit._train
    monkeypatch.setattr(fit, "_train",
                        lambda genomes: chunks.append(len(genomes))
                        or train(genomes))
    np.testing.assert_allclose(fit(g).numpy(), one.numpy(), **BATCHED_TOL)
    assert chunks == [2, 2]


def test_the_initialisation_is_drawn_on_the_cpu_from_the_seed():
    a, b = (lm.LMTrainFitness(device="cpu", seed=s, **SMALL) for s in (0, 0))
    c = lm.LMTrainFitness(device="cpu", seed=1, **SMALL)
    for name, p in a._init.items():
        assert torch.equal(p, b._init[name])
    assert not all(torch.equal(p, c._init[n]) for n, p in a._init.items())


def test_lm_hyperparameter_search():
    """The port's twin of tests/test_system.py's: the GA picks
    hyperparameters that beat the worst corner of the search space."""
    fit = lm.LMTrainFitness(device="cpu", **SMALL)
    worst = float(fit(torch.tensor([[0.0, 0.0, 1.0, 1.0]]))[0, 0])
    cfg = GAConfig(num_genes=lm.NUM_LM_GENES, pop_per_island=6,
                   num_islands=2, generations_per_epoch=2, num_epochs=2,
                   lower=0.0, upper=1.0, fused_operators=False, seed=1)
    eng = GAEngine(cfg, fit, device="cpu")
    pop, _ = eng.run()
    _, f = eng.best(pop)
    assert f[0] <= worst + 1e-3
    assert pop.evals == 12 * (1 + 2 * 2)    # init, then each generation


PARSE_ARGS = argparse.ArgumentParser.parse_args


def _parsed(main, argv, monkeypatch):
    """The namespace ``main`` parses from ``argv``, stopping there."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["args"] = PARSE_ARGS(self, args, namespace)
        raise KeyboardInterrupt

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(KeyboardInterrupt):
        main(argv)
    return seen["args"]


def test_ga_run_lm_flags_have_the_reference_defaults(monkeypatch):
    ours = _parsed(ga_run.main, ["--fitness", "lm"], monkeypatch)
    theirs = _parsed(jax_ga_run.main, ["--fitness", "lm"], monkeypatch)
    assert (ours.lm_arch, ours.lm_steps) == (theirs.lm_arch,
                                             theirs.lm_steps)
    assert (ours.lm_arch, ours.lm_steps) == ("tinyllama-1.1b", 6)


def test_ga_run_lm_on_cpu(capsys):
    pop, hist = ga_run.main(["--fitness", "lm", "--device", "cpu",
                             "--islands", "2", "--pop", "4", "--epochs",
                             "1", "--lm-steps", "2"])
    out = capsys.readouterr().out
    assert "best fitness:" in out and len(hist) == 1
    assert pop.genomes.shape == (2, 4, lm.NUM_LM_GENES)
    assert bool(((pop.genomes >= 0) & (pop.genomes <= 1)).all())
    assert bool(torch.isfinite(pop.fitness).all())


def test_ga_run_builds_the_reference_ga_config():
    args = argparse.Namespace(lm_arch="gemma2-2b", lm_steps=2, pop=4,
                              islands=2, gens_per_epoch=3, epochs=1, seed=5)
    cfg, fit, cost = ga_run.build("lm", args, torch.device("cpu"))
    assert cost is None and fit.cfg.name == "gemma2-2b-smoke"
    assert (fit.steps, fit.batch_size, fit.seq_len, fit.seed) == (2, 4, 32, 0)
    want = dict(num_genes=4, pop_per_island=4, num_islands=2,
                generations_per_epoch=3, num_epochs=1, lower=0.0, upper=1.0,
                mutation_prob=0.5, mutation_eta=20.0, crossover_prob=0.9,
                crossover_eta=15.0, fused_operators=False, seed=5)
    for key, val in want.items():
        assert getattr(cfg, key) == val, key


def test_spawned_fitness_pickles_and_matches_the_cpu_fitness():
    kw = dict(steps=2, batch_size=2, seq_len=16, seed=3)
    fit = lm.LMTrainFitness("mamba2-780m", device="cpu", **kw)
    spawned = pickle.loads(pickle.dumps(lm.SpawnedLMFitness(fit)))
    got = spawned(GENOMES)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, fit(torch.from_numpy(GENOMES))
                                  .numpy())


def test_host_fitness_adapters_for_lm():
    from repro_torch.core.hostbridge import LockedHostFitness
    fit = lm.LMTrainFitness(device="cpu", **SMALL)
    thread = ga_run.host_fitness("lm", fit, "thread")
    assert isinstance(thread, LockedHostFitness)
    assert isinstance(ga_run.host_fitness("lm", fit, "process"),
                      lm.SpawnedLMFitness)
    np.testing.assert_array_equal(thread(GENOMES),
                                  fit(torch.from_numpy(GENOMES)).numpy())
