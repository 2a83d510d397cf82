"""Two objectives over HVDC dispatch on the port: the twin of
``tests/test_extensions.py::TestMultiObjectiveHVDC`` (the same grid,
configuration and assertions, run by ``repro_torch`` on the CPU)."""
import torch

from repro_torch.configs.base import GAConfig
from repro_torch.core import nsga2
from repro_torch.core.engine import GAEngine
from repro_torch.fitness.powerflow import HVDCDispatchFitness
from repro_torch.powerflow.grid import make_synthetic_grid


class TestMultiObjectiveHVDC:
    def test_pareto_front_flows_vs_transfer(self):
        """NSGA-II with 2 objectives: minimize total flows AND maximize
        HVDC utilization (as -transfer): the fronts must trade off."""
        grid = make_synthetic_grid(n_bus=30, n_line=55, n_gen=8, n_hvdc=3,
                                   seed=5)
        base = HVDCDispatchFitness(grid, newton_iters=8, device="cpu")

        def two_obj(genomes):
            flows = base(genomes)                        # (N, 1)
            transfer = -torch.sum(torch.abs(genomes), -1, keepdim=True)
            return torch.cat([flows, transfer], -1)

        cfg = GAConfig(num_genes=3, pop_per_island=16, num_islands=2,
                       num_objectives=2, generations_per_epoch=3,
                       num_epochs=4, lower=-1.0, upper=1.0,
                       fused_operators=False, seed=2)
        pop, _ = GAEngine(cfg, two_obj, device="cpu").run()
        fit = pop.fitness.reshape(-1, 2)
        ranks = nsga2.nondominated_ranks(fit)
        front = fit[ranks == 0]
        assert len(front) >= 3
        # a real trade-off: the front spans both objectives
        assert float(front[:, 0].max() - front[:, 0].min()) > 1e-3
        assert float(front[:, 1].max() - front[:, 1].min()) > 1e-3
