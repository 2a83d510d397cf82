"""Fused variation: the port's plain version against the reference's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and its jnp
oracle, and the wrapper's CPU and argument paths. The CUDA kernel's tests
are in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.genetic.fused_variation import fused_variation_pallas
from repro.kernels.genetic.ref import fused_variation_ref as jax_ref
from repro_torch.kernels.genetic import ops
from repro_torch.kernels.genetic.ref import (draw_uniforms,
                                             fused_variation_ref)
from torch_parity import (GA_RUN_HP, SWEEP_TOL, TABLE3_HP, TOL, UNIFORM_KEYS,
                          gene_bounds, kernel_args, to_np, to_torch)

SHAPES = [(16, 4), (64, 18), (130, 33), (256, 128)]
HP_NAMES = ("eta_cx", "prob_cx", "eta_mut", "prob_mut")
KW = dict(zip(HP_NAMES, GA_RUN_HP))


def _inputs(p, g, seed, lo=-1.0, hi=1.0):
    rs = np.random.default_rng(seed)
    parents = rs.uniform(lo, hi, (p, g)).astype(np.float32)
    p2 = p // 2
    shapes = {"u_cx": (p2, g), "m_pair": (p2, 1), "m_gene": (p2, g),
              "u_mut": (p, g), "m_ind": (p, 1), "m_genem": (p, g)}
    rnd = {k: rs.random(s, dtype=np.float32) for k, s in shapes.items()}
    return parents, rnd


def _three_ways(parents, rnd, kw, lo, hi):
    """(Pallas interpret, jnp oracle, port plain version), each (P, G);
    lo and hi are numbers or (G,) arrays."""
    p, g = parents.shape
    lo_a = np.full((g,), lo, np.float32)
    hi_a = np.full((g,), hi, np.float32)
    jrnd = {k: jnp.asarray(v) for k, v in rnd.items()}
    scalars = jnp.asarray([kw["eta_cx"], kw["prob_cx"], kw["eta_mut"],
                           kw["prob_mut"], kw["indpb"]], jnp.float32)
    o1, o2 = fused_variation_pallas(parents[0::2], parents[1::2], jrnd,
                                    scalars, lo_a, hi_a, interpret=True)
    pallas = np.stack([np.asarray(o1), np.asarray(o2)], 1).reshape(p, g)
    oracle = np.asarray(jax_ref(parents[0::2], parents[1::2], jrnd,
                                lower=lo_a, upper=hi_a, **kw))
    t = to_torch(parents)
    port = to_np(fused_variation_ref(
        t[0::2], t[1::2], {k: to_torch(v) for k, v in rnd.items()},
        lower=to_torch(lo_a), upper=to_torch(hi_a), **kw))
    return pallas, oracle, port


@pytest.mark.parametrize("p,g", SHAPES)
def test_plain_version_matches_pallas_and_oracle(p, g):
    p -= p % 2
    parents, rnd = _inputs(p, g, seed=p * 1000 + g)
    kw = dict(KW, indpb=1.0 / g)
    pallas, oracle, port = _three_ways(parents, rnd, kw, -1.0, 1.0)
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(port, oracle, **TOL)


@pytest.mark.parametrize("hp,per_gene", [("table3", False),
                                          ("ga_run", True), ("table3", True)])
@pytest.mark.parametrize("p,g", [(64, 18), (256, 128)])
def test_plain_version_table3_and_per_gene_bounds(p, g, hp, per_gene):
    """The paper's Table 3 point (its HVDC runs: eta_cx 97.5, prob_cx 1.0,
    eta_mut 34.6, prob_mut 0.7) and per-gene bounds with lo != -hi."""
    lo, hi = gene_bounds(g, seed=g) if per_gene else (-1.0, 1.0)
    parents, rnd = _inputs(p, g, seed=p + g, lo=lo, hi=hi)
    kw = dict(zip(HP_NAMES, TABLE3_HP if hp == "table3" else GA_RUN_HP),
              indpb=1.0 / g)
    pallas, oracle, port = _three_ways(parents, rnd, kw, lo, hi)
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(port, oracle, **TOL)
    assert np.all((port >= lo) & (port <= hi))


SWEEP = [tuple(np.random.default_rng(s).uniform([1, 1, 0], [80, 80, 1]))
         for s in range(8)]


@pytest.mark.parametrize("eta_cx,eta_mut,prob", SWEEP,
                         ids=[f"sweep{i}" for i in range(len(SWEEP))])
def test_plain_version_sweep(eta_cx, eta_mut, prob):
    parents, rnd = _inputs(32, 9, seed=int(eta_cx * 1e3), lo=-2.0, hi=2.0)
    kw = dict(eta_cx=eta_cx, prob_cx=prob, eta_mut=eta_mut, prob_mut=prob,
              indpb=0.4)
    pallas, oracle, port = _three_ways(parents, rnd, kw, -2.0, 2.0)
    np.testing.assert_allclose(port, pallas, **SWEEP_TOL)
    np.testing.assert_allclose(port, oracle, **SWEEP_TOL)
    assert np.all((port >= -2) & (port <= 2))


def test_draw_uniforms_keys_and_shapes():
    gen = torch.Generator().manual_seed(0)
    rnd = draw_uniforms(gen, 10, 3)
    assert tuple(rnd) == UNIFORM_KEYS
    assert {k: tuple(v.shape) for k, v in rnd.items()} == {
        "u_cx": (5, 3), "m_pair": (5, 1), "m_gene": (5, 3),
        "u_mut": (10, 3), "m_ind": (10, 1), "m_genem": (10, 3)}
    batched = draw_uniforms(gen, 10, 3, islands=4)
    assert all(v.shape[0] == 4 for v in batched.values())
    assert all(float(v.min()) >= 0 and float(v.max()) < 1
               for v in batched.values())


def test_wrapper_on_cpu_runs_plain_version_per_island():
    """The CPU path is the plain version, and a batched (I, P, G) call
    equals the islands one by one. No kernel launch is counted."""
    before = ops.launches
    parents, rnd, scalars, lo, hi = kernel_args(16, 5, 3, islands=3)
    out = ops.fused_variation(parents, rnd, scalars, lo, hi)
    assert out.shape == parents.shape
    for i in range(3):
        one = fused_variation_ref(
            parents[i, 0::2], parents[i, 1::2],
            {k: v[i] for k, v in rnd.items()}, eta_cx=15.0, prob_cx=0.9,
            eta_mut=20.0, prob_mut=0.7, indpb=1.0 / 5, lower=lo, upper=hi)
        np.testing.assert_array_equal(to_np(out[i]), to_np(one))
    assert ops.launches == before


def test_wrapper_rejects_odd_pop():
    parents, rnd, scalars, lo, hi = kernel_args(16, 5, 0)
    with pytest.raises(ValueError, match="odd"):
        ops.fused_variation(parents[:15], rnd, scalars, lo, hi)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "m_gene is torch.float64 on cpu; the kernel takes float32"),
    ("shape", r"m_ind has shape \(8, 1\), expected \(16, 1\)"),
    ("layout", "u_mut is not contiguous")])
def test_wrapper_checks_name_the_first_bad_argument(bad, match):
    """The wrapper's checks, in the order it makes them (type and device,
    shape, contiguity), name the argument the kernel does not take. They
    run before any CUDA launch, so they are tested here on CPU tensors."""
    parents, rnd, scalars, lo, hi = kernel_args(16, 8, 1)
    args = ops._expected(parents, rnd, scalars, lo, hi)
    ops._reject(args, parents.device)                 # nothing to reject
    rnd = {"dtype": dict(rnd, m_gene=rnd["m_gene"].double()),
           "shape": dict(rnd, m_ind=rnd["m_ind"][:8]),
           "layout": dict(rnd, u_mut=rnd["u_mut"].t().contiguous().t())}[bad]
    with pytest.raises(ValueError, match=match):
        ops._reject(ops._expected(parents, rnd, scalars, lo, hi),
                    parents.device)


def test_pack_scalars_keeps_tensor_hyperparameters_on_device():
    eta = torch.tensor(15.0, requires_grad=False)
    s = ops.pack_scalars(eta, 0.9, torch.tensor(20.0), 0.7, 0.25)
    assert s.dtype == torch.float32 and s.shape == (5,)
    np.testing.assert_allclose(to_np(s), [15.0, 0.9, 20.0, 0.7, 0.25],
                               rtol=1e-7)
