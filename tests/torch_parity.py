"""Shared helpers for the parity tests of ``repro_torch`` against the JAX
reference package (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays. JAX runs on the CPU. Where the reference draws random
numbers from a key, the helpers re-derive the same draws from the same
keys, so the port can be fed them through ``ArrayUniforms``. JAX is
imported only inside those helpers, so the tests that need a card
(``tests/test_torch_cuda.py``) run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

# tolerances of tests/test_kernels.py (genetic kernel, lines 30-31, 44-45)
TOL = dict(rtol=1e-5, atol=1e-6)
SWEEP_TOL = dict(rtol=1e-4, atol=1e-5)

UNIFORM_KEYS = ("u_cx", "m_pair", "m_gene", "u_mut", "m_ind", "m_genem")


def np32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def to_torch(x, device="cpu") -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def kernel_args(p, g, seed, islands=None, device="cpu"):
    """Parents (numpy seed), uniforms (torch seed), scalars and bounds for
    one ``ops.fused_variation`` call at the main path's hyperparameters."""
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms
    rs = np.random.default_rng(seed)
    lead = () if islands is None else (islands,)
    parents = to_torch(rs.uniform(-1, 1, lead + (p, g)).astype(np.float32),
                       device)
    gen = torch.Generator().manual_seed(seed)
    rnd = {k: v.to(device) for k, v in
           draw_uniforms(gen, p, g, "cpu", islands=islands).items()}
    scalars = ops.pack_scalars(15.0, 0.9, 20.0, 0.7, 1.0 / g, device=device)
    lo = torch.full((g,), -1.0, device=device)
    hi = torch.full((g,), 1.0, device=device)
    return parents, rnd, scalars, lo, hi


@pytest.fixture
def cuda_device():
    """The card, for tests that need one; they skip without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the reference's draws, re-derived from its keys
# ---------------------------------------------------------------------------

def jax_variation_draws(k_var, p: int, g: int, fused: bool) -> list:
    """The uniforms ``repro.core.operators.variation(k_var, parents(p, g))``
    consumes, in the port's draw order."""
    import jax
    from repro.kernels.genetic.ref import draw_uniforms
    if fused and p % 2 == 0:
        rnd = draw_uniforms(k_var, p, g)
        return [np32(rnd[k]) for k in UNIFORM_KEYS]
    k1, k2 = jax.random.split(k_var)
    n = (p - p % 2) // 2
    draws = []
    for key, rows in ((k1, n), (k2, p)):        # sbx pairs, then mutation
        ka, kb, kc = jax.random.split(key, 3)
        draws += [np32(jax.random.uniform(ka, (rows,))),
                  np32(jax.random.uniform(kb, (rows, g))),
                  np32(jax.random.uniform(kc, (rows, g)))]
    return draws


def jax_generation_draws(pop_rng, p: int, g: int, tsize: int,
                         fused: bool) -> list:
    """The uniforms one ``make_generation_step`` generation consumes, from
    the per-island keys ``pop_rng`` (I, 2), stacked over islands in the
    port's order: tournament first, then variation."""
    import jax
    per_island = []
    for key in np.asarray(pop_rng):
        step_rng = jax.random.split(key)[0]
        k_sel, k_var = jax.random.split(step_rng)
        per_island.append(
            [np32(jax.random.uniform(k_sel, (p, tsize)))]
            + jax_variation_draws(k_var, p, g, fused))
    return [np.stack(arrs) for arrs in zip(*per_island)]


def jax_migration_draws(pop_rng, m: int, num_shifts: int) -> list:
    """The (I, m) victim uniforms ``migrate_ring`` draws per shift."""
    import jax
    mig = [jax.random.split(key)[0] for key in np.asarray(pop_rng)]
    return [np.stack([np32(jax.random.uniform(jax.random.fold_in(k, s),
                                              (m,))) for k in mig])
            for s in range(num_shifts)]
