"""Tests that need an NVIDIA GPU: the CUDA kernel against its plain
version, the wrapper's refusals, and the port's main path on the card.
They skip without a card. This file imports no JAX, so it runs on a
machine that has PyTorch for CUDA and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import GAConfig
from repro_torch.core import island, nsga2
from repro_torch.core.broker import Broker
from repro_torch.core.population import init_population
from repro_torch.core.uniforms import ArrayUniforms
from repro_torch.fitness import rastrigin
from repro_torch.kernels.genetic import ops
from repro_torch.launch import ga_run
from torch_parity import TOL, cuda_device, kernel_args, to_np  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("p,g,islands", [(16, 4, None), (130, 33, None),
                                         (256, 128, None), (1024, 128, 4)])
def test_kernel_matches_plain_version(cuda_device, p, g, islands):
    p -= p % 2
    args = kernel_args(p, g, p + g, islands=islands, device=cuda_device)
    before = ops.launches
    out = ops.fused_variation(*args)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    plain = ops.fused_variation_plain(*args)      # on the card as well
    np.testing.assert_allclose(to_np(out), to_np(plain), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    parents, rnd, scalars, lo, hi = kernel_args(16, 8, 1, device=cuda_device)
    before = ops.launches
    with pytest.raises(ValueError, match="float32"):
        ops.fused_variation(parents.double(), rnd, scalars, lo, hi)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_variation(parents.t().contiguous().t(), rnd, scalars,
                            lo, hi)
    with pytest.raises(ValueError, match="shape"):
        ops.fused_variation(parents, dict(rnd, m_ind=rnd["m_ind"][:8]),
                            scalars, lo, hi)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_variation(parents, rnd, scalars.cpu(), lo, hi)
    assert ops.launches == before


def test_generation_on_card_matches_cpu(cuda_device):
    cfg = GAConfig(num_genes=8, pop_per_island=16, num_islands=4,
                   lower=-5.12, upper=5.12, mutation_prob=0.7,
                   mutation_eta=20.0, crossover_prob=0.9, crossover_eta=15.0)
    rs = np.random.default_rng(0)
    draws = [rs.random(s, dtype=np.float32) for s in
             [(4, 16, 2), (4, 8, 8), (4, 8, 1), (4, 8, 8), (4, 16, 8),
              (4, 16, 1), (4, 16, 8)]]
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        broker = Broker(rastrigin)
        pop = island.evaluate_population(cfg, broker,
                                         init_population(cfg, 3, "cpu"))
        pop = pop._replace(genomes=pop.genomes.to(dev),
                           fitness=pop.fitness.to(dev))
        new, _ = island.make_generation_step(cfg, broker, dev)(
            pop, ArrayUniforms(draws, dev))
        out.append((new, nsga2.nsga2_keys(pop.fitness)[2]))
    (gpu, gkeys), (cpu, ckeys) = out
    assert torch.equal(gkeys.cpu(), ckeys)
    np.testing.assert_allclose(to_np(gpu.genomes), to_np(cpu.genomes),
                               rtol=1e-5, atol=1e-5)


def test_ga_run_on_card_launches_the_kernel(cuda_device, capsys):
    args = ["--fitness", "rastrigin", "--genes", "16", "--islands", "4",
            "--pop", "64", "--epochs", "2", "--gens-per-epoch", "3"]
    ops.launches = 0
    pop, hist = ga_run.main(args)
    assert ops.launches == 6
    assert pop.genomes.device.type == "cuda"
    ops.launches = 0
    pop2, _ = ga_run.main(args + ["--sync-every", "2",
                                  "--pipeline-depth", "2"])
    assert ops.launches == 6
    assert torch.equal(pop.genomes, pop2.genomes)
    assert hist[-1]["best"] <= hist[0]["best"]
    assert "best fitness:" in capsys.readouterr().out
