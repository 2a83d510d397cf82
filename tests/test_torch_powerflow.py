"""The port's powerflow substrate and HVDC fitness against the JAX
reference (``tests/test_powerflow.py``'s cases): grids bit for bit, the
batched Newton solve, line flows, the DC/LODF model and its screening,
contingency loadings with an islanding outage, the penalty, the fitness
with its cost model, and one GA generation of ``--fitness hvdc`` replayed
from the reference's draws.

Tolerances: vm and va atol 1e-4 (the solver's tolerance on the mismatch
is 5e-4 p.u., and both packages run float32 / complex64); loadings and
objectives rtol 1e-4, atol 1e-4; ``iters`` and ``converged`` exact.

Non-converging dispatches: a dispatch whose base case does not converge in
``newton_iters`` steps scores 100 x the flows of whatever iterate the last
step left. That iterate is driven by round-off (measured at n = 20 and 60:
relative differences between the packages up to 20x on such lanes, below
3e-6 on converged ones), so the tests hold the convergence flags exactly
and the objectives on converged lanes.

Islanding outages: an outage that cuts a bus loose has 1 - PTDF_l at
round-off (~1e-7), which the DC model clamps to 1e-6, so that line's LODF
column is round-off / 1e-6. Those columns, and the order among the
islanding outages in a screened list (ranked first, by those columns),
differ between any two solvers, JAX's and the port's among them. The
tests hold them as a set and everything else exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GAConfig as JaxGAConfig
from repro.core import island as jisland
from repro.core.broker import Broker as JaxBroker
from repro.core.population import init_population as jax_init_population
from repro.fitness.powerflow import HVDCDispatchFitness as JaxHVDCFitness
from repro.powerflow import contingency as jc
from repro.powerflow import dc as jdc
from repro.powerflow import grid as jg
from repro.powerflow import hvdc as jh
from repro.powerflow import newton as jn
from repro_torch.configs.base import GAConfig
from repro_torch.core import device as tdevice
from repro_torch.core import island
from repro_torch.core.broker import Broker
from repro_torch.core.population import population_from_numpy
from repro_torch.core.uniforms import ArrayUniforms
from repro_torch.fitness import HVDCDispatchFitness
from repro_torch.powerflow import contingency as tc
from repro_torch.powerflow import dc as tdc
from repro_torch.powerflow import grid as tg
from repro_torch.powerflow import hvdc as th
from repro_torch.powerflow import newton as tn
from torch_parity import jax_generation_draws, to_np

PF_TOL = dict(rtol=0, atol=1e-4)          # vm, va, ptdf, lodf
OBJ_TOL = dict(rtol=1e-4, atol=1e-4)      # loadings, objectives
SMALL = dict(n_bus=60, n_line=110, n_gen=15, n_hvdc=4, seed=1)
# the 60-bus grid's islanding lines (each cuts a degree-1 bus loose)
SMALL_BRIDGES = [4, 11, 55, 94, 107]


@pytest.fixture(scope="module")
def grids():
    """(reference Grid, port Grid, reference dict, port dict) at n = 60."""
    jgrid = jg.make_synthetic_grid(**SMALL)
    tgrid = tg.make_synthetic_grid(**SMALL)
    return jgrid, tgrid, jgrid.to_jax(), tgrid.to_torch("cpu")


def dispatches(h, pmax, seed=0):
    """(4, H) genomes in [-1, 1] (zero, alternating +-1, two uniform draws)
    and their dispatch in p.u. (float32 numpy)."""
    rs = np.random.default_rng(seed)
    genomes = np.stack([np.zeros(h), np.resize([1.0, -1.0], h),
                        rs.uniform(-1, 1, h), rs.uniform(-1, 1, h)])
    genomes = genomes.astype(np.float32)
    return genomes, genomes * np.asarray(pmax, np.float32)


def jax_p_extra(gj, dispatch):
    return jax.vmap(lambda d: jh.apply_hvdc(gj, d))(jnp.asarray(dispatch))


def jax_converged(gj, dispatch, num_iters=10):
    return np.asarray(jax.vmap(lambda p: jn.newton_powerflow(
        gj, p_extra=p, num_iters=num_iters).converged)(
            jax_p_extra(gj, dispatch)))


def assert_objectives_close(got, ref, converged):
    """Objectives (N, 1) on the lanes whose base case converged (in both
    packages, checked by the caller); the others finite."""
    got, ref = to_np(got)[:, 0], np.asarray(ref)[:, 0]
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got[converged], ref[converged], **OBJ_TOL)


def assert_pf_equal(jres, tres):
    np.testing.assert_allclose(to_np(tres.vm), np.asarray(jres.vm), **PF_TOL)
    np.testing.assert_allclose(to_np(tres.va), np.asarray(jres.va), **PF_TOL)
    np.testing.assert_array_equal(to_np(tres.iters), np.asarray(jres.iters))
    np.testing.assert_array_equal(to_np(tres.converged),
                                  np.asarray(jres.converged))
    np.testing.assert_allclose(to_np(tres.mismatch), np.asarray(jres.mismatch),
                               **PF_TOL)


# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["60-1", "20-4", "200-7", "german"])
def test_grid_matches_reference_bit_for_bit(kind):
    if kind == "german":
        jgrid, tgrid = jg.make_german_grid(0), tg.make_german_grid(0)
        assert (tgrid.n_bus, tgrid.n_line, tgrid.n_hvdc) == (2715, 5351, 18)
    else:
        n, seed = map(int, kind.split("-"))
        kw = dict(n_bus=n, n_line=int(n * 1.97), n_gen=max(4, n // 4),
                  n_hvdc=4, seed=seed)
        jgrid, tgrid = jg.make_synthetic_grid(**kw), \
            tg.make_synthetic_grid(**kw)
    fields = dataclasses.asdict(jgrid)
    for name, value in fields.items():
        got = getattr(tgrid, name)
        assert np.asarray(got).dtype == np.asarray(value).dtype, name
        np.testing.assert_array_equal(got, value, err_msg=name)
    carried = tg.grid_from_numpy(fields)
    for name, value in fields.items():
        np.testing.assert_array_equal(getattr(carried, name), value)
    gj, gt = jgrid.to_jax(), tgrid.to_torch("cpu")
    assert sorted(gj) == sorted(gt)
    for key, value in gj.items():
        assert to_np(gt[key]).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(to_np(gt[key]), np.asarray(value),
                                      err_msg=key)


def test_grid_from_numpy_names_missing_fields():
    fields = dataclasses.asdict(jg.make_synthetic_grid(**SMALL))
    del fields["rate"]
    with pytest.raises(ValueError, match="rate"):
        tg.grid_from_numpy(fields)


# ---------------------------------------------------------------------------
# HVDC injections, Newton, line flows
# ---------------------------------------------------------------------------

def test_apply_hvdc_batched(grids):
    _, _, gj, gt = grids
    _, disp = dispatches(4, np.asarray(gj["hvdc_pmax"]))
    ref = np.asarray(jax_p_extra(gj, disp))
    got = th.apply_hvdc(gt, torch.from_numpy(disp))
    np.testing.assert_allclose(to_np(got), ref, rtol=1e-6, atol=1e-6)
    # withdraw - inject = loss * transfer (net consumption)
    np.testing.assert_allclose(to_np(got.sum(-1)),
                               -th.HVDC_LOSS * disp.sum(-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        to_np(th.scale_genome_to_dispatch(gt, torch.ones(2, 4))),
        np.asarray(jh.scale_genome_to_dispatch(gj, jnp.ones((2, 4)))))


@pytest.mark.parametrize("outage", [None, 3, 11])
def test_newton_batched_matches_reference(grids, outage):
    """Three dispatches in one batch; with a line mask (line 3: meshed,
    converges; line 11: islanding, does not), one per system."""
    _, _, gj, gt = grids
    _, disp = dispatches(4, np.asarray(gj["hvdc_pmax"]))
    disp = disp[1:]
    pe_j = jax_p_extra(gj, disp)
    pe_t = th.apply_hvdc(gt, torch.from_numpy(disp))
    if outage is None:
        jres = jax.vmap(lambda p: jn.newton_powerflow(
            gj, p_extra=p, num_iters=12))(pe_j)
        tres = tn.newton_powerflow(gt, p_extra=pe_t, num_iters=12)
    else:
        mask = np.ones((3, 110), np.float32)
        mask[:, outage] = 0.0
        jres = jax.vmap(lambda p, m: jn.newton_powerflow(
            gj, p_extra=p, num_iters=12, line_mask=m))(pe_j,
                                                        jnp.asarray(mask))
        tres = tn.newton_powerflow(gt, p_extra=pe_t, num_iters=12,
                                   line_mask=torch.from_numpy(mask))
    assert tres.vm.shape == (3, 60) and tres.iters.dtype == torch.int32
    assert bool(tres.converged.all()) == (outage != 11)
    if outage == 11:
        # islanded: the reference reads NaN/inf here as well; converged
        # masks it
        np.testing.assert_array_equal(to_np(tres.converged),
                                      np.asarray(jres.converged))
        np.testing.assert_array_equal(to_np(tres.iters),
                                      np.asarray(jres.iters))
        return
    assert_pf_equal(jres, tres)


def test_newton_base_case_and_chunks(grids, monkeypatch):
    """No injections, no mask: one system; and a batch split into chunks
    of 2 gives the unchunked result."""
    _, _, gj, gt = grids
    jres = jn.newton_powerflow(gj, num_iters=12)
    tres = tn.newton_powerflow(gt, num_iters=12)
    assert tres.vm.shape == (1, 60)
    assert_pf_equal(jax.tree_util.tree_map(lambda x: x[None], jres), tres)
    _, disp = dispatches(4, np.asarray(gj["hvdc_pmax"]))
    pe = th.apply_hvdc(gt, torch.from_numpy(disp))
    whole = tn.newton_powerflow(gt, p_extra=pe, num_iters=12)
    monkeypatch.setattr(tdevice, "CPU_CHUNK_BYTES",
                        2 * tn.system_bytes(60, False))
    assert tn.chunk_size(60, False, torch.device("cpu")) == 2
    parts = tn.newton_powerflow(gt, p_extra=pe, num_iters=12)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flat_start_zero_injection():
    kw = dict(n_bus=20, n_line=35, n_gen=5, n_hvdc=2, seed=4,
              total_load_pu=0.0)
    out = []
    for mod in (jg, tg):
        g = mod.make_synthetic_grid(**kw)
        g.p_gen[:] = 0.0
        g.v_set[:] = 1.0
        g.b_sh[:] = 0.0           # no line charging: exact flat solution
        out.append(g)
    jres = jn.newton_powerflow(out[0].to_jax(), num_iters=6)
    tres = tn.newton_powerflow(out[1].to_torch("cpu"), num_iters=6)
    assert bool(tres.converged[0])
    np.testing.assert_allclose(to_np(tres.va[0]), 0.0, atol=1e-4)
    assert_pf_equal(jax.tree_util.tree_map(lambda x: x[None], jres), tres)


@pytest.mark.parametrize("outage", [None, 3])
def test_line_flows_match_reference(grids, outage):
    _, _, gj, gt = grids
    rs = np.random.default_rng(5)
    vm = rs.uniform(0.95, 1.05, (2, 60)).astype(np.float32)
    va = rs.uniform(-0.3, 0.3, (2, 60)).astype(np.float32)
    mask = None
    if outage is not None:
        mask = np.ones((2, 110), np.float32)
        mask[:, outage] = 0.0
    ref = np.stack([np.asarray(jn.line_flows(
        gj, jnp.asarray(vm[k]), jnp.asarray(va[k]),
        line_mask=None if mask is None else jnp.asarray(mask[k])))
        for k in range(2)])
    got = tn.line_flows(gt, torch.from_numpy(vm), torch.from_numpy(va),
                        line_mask=None if mask is None
                        else torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got), ref, **OBJ_TOL)
    if outage is not None:
        assert bool((got[:, outage] == 0.0).all())


def test_dispatch_changes_flows(grids):
    _, _, _, gt = grids
    inj = th.apply_hvdc(gt, torch.tensor([[0.0] * 4, [5.0, 0.0, 0.0, 0.0]]))
    res = tn.newton_powerflow(gt, p_extra=inj, num_iters=12)
    fl = tn.line_flows(gt, res.vm, res.va)
    assert float(torch.max(torch.abs(fl[0] - fl[1]))) > 1e-3


# ---------------------------------------------------------------------------
# DC model and screening
# ---------------------------------------------------------------------------

def test_dc_model_matches_reference(grids):
    _, _, gj, gt = grids
    jm, tm = jdc.build_dc_model(gj), tdc.build_dc_model(gt)
    assert int(tm.slack) == int(jm.slack)
    np.testing.assert_allclose(to_np(tm.ptdf), np.asarray(jm.ptdf), **PF_TOL)
    bridges = np.flatnonzero(np.asarray(jm.bridge_score) > 50.0)
    np.testing.assert_array_equal(bridges, SMALL_BRIDGES)
    np.testing.assert_array_equal(
        np.flatnonzero(to_np(tm.bridge_score) > 50.0), bridges)
    # meshed lines' columns and every bridge_score below the cut; the
    # islanding lines' columns are round-off / 1e-6 (module docstring)
    meshed = np.setdiff1d(np.arange(110), bridges)
    np.testing.assert_allclose(to_np(tm.lodf)[:, meshed],
                               np.asarray(jm.lodf)[:, meshed], **PF_TOL)
    np.testing.assert_allclose(to_np(tm.bridge_score)[meshed],
                               np.asarray(jm.bridge_score)[meshed],
                               **OBJ_TOL)
    np.testing.assert_array_equal(to_np(tm.lodf)[bridges, bridges], -1.0)
    flows = tdc.dc_flows(tm, gt["p_inj"][None])
    np.testing.assert_allclose(to_np(flows[0]),
                               np.asarray(jdc.dc_flows(jm, gj["p_inj"])),
                               **OBJ_TOL)


def test_dc_ac_correlation(grids):
    _, _, _, gt = grids
    f_dc = to_np(tdc.dc_flows(tdc.build_dc_model(gt), gt["p_inj"][None]))
    res = tn.newton_powerflow(gt, num_iters=12)
    f_ac = to_np(tn.line_flows(gt, res.vm, res.va))
    assert np.corrcoef(np.abs(f_dc[0]), f_ac[0])[0, 1] > 0.95


@pytest.mark.parametrize("top_k", [4, 12, 110])
def test_screen_contingencies_match_reference(grids, top_k):
    """Per genome: the islanding outages lead both lists (as a set: their
    order is round-off), and everything after them is equal, in order."""
    _, _, gj, gt = grids
    jm, tm = jdc.build_dc_model(gj), tdc.build_dc_model(gt)
    _, disp = dispatches(4, np.asarray(gj["hvdc_pmax"]))
    pe_j = jax_p_extra(gj, disp)
    ref = np.stack([np.asarray(jdc.screen_contingencies(
        jm, gj["p_inj"] + p, gj["rate"], top_k)) for p in pe_j])
    got = to_np(tdc.screen_contingencies(
        tm, gt["p_inj"] + th.apply_hvdc(gt, torch.from_numpy(disp)),
        gt["rate"], top_k))
    assert got.shape == (4, top_k) and got.dtype == np.int64
    head = min(top_k, len(SMALL_BRIDGES))
    for r, g in zip(ref, got):
        assert set(r[:head]) <= set(SMALL_BRIDGES)
        assert set(g[:head]) <= set(SMALL_BRIDGES)
        if top_k >= len(SMALL_BRIDGES):
            assert set(g[:head]) == set(r[:head]) == set(SMALL_BRIDGES)
        np.testing.assert_array_equal(g[head:], r[head:])


def test_screen_ties_keep_lower_index_first():
    """Planted ties: equal scores rank by index, as jax.lax.top_k does."""
    nl, n = 10, 4
    lodf = np.zeros((nl, nl), np.float32)
    bridge = np.ones(nl, np.float32)
    bridge[[2, 7]] = 1e6                          # two islanding ties
    ptdf = np.zeros((nl, n), np.float32)
    ptdf[[1, 4, 8], 0] = 1.0                      # three equal loadings
    rate = np.ones(nl, np.float32)
    p_inj = np.array([[1.0, 0.0, 0.0, -1.0]], np.float32)
    jm = jdc.DCModel(ptdf=jnp.asarray(ptdf), lodf=jnp.asarray(lodf),
                     f0_coeff=jnp.asarray(ptdf), slack=jnp.asarray(3),
                     bridge_score=jnp.asarray(bridge))
    tm = tdc.DCModel(ptdf=torch.from_numpy(ptdf), lodf=torch.from_numpy(lodf),
                     f0_coeff=torch.from_numpy(ptdf), slack=torch.tensor(3),
                     bridge_score=torch.from_numpy(bridge))
    ref = np.asarray(jdc.screen_contingencies(
        jm, jnp.asarray(p_inj[0]), jnp.asarray(rate), nl))
    got = to_np(tdc.screen_contingencies(tm, torch.from_numpy(p_inj),
                                         torch.from_numpy(rate), nl))[0]
    np.testing.assert_array_equal(ref, [2, 7, 0, 1, 3, 4, 5, 6, 8, 9])
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# contingencies and the penalty
# ---------------------------------------------------------------------------

def test_contingency_loadings_match_reference(grids):
    """Two genomes x four outages, one of them islanding (line 11 cuts bus
    36 loose): that case reads 10.0 on every line and does not raise."""
    _, _, gj, gt = grids
    _, disp = dispatches(4, np.asarray(gj["hvdc_pmax"]))
    disp = disp[2:]
    cases = np.array([3, 11, 40, 77])
    pe_j = jax_p_extra(gj, disp)
    ref = np.stack([np.asarray(jc.contingency_loadings(
        gj, jnp.asarray(cases), p_extra=p, num_iters=10)) for p in pe_j])
    got = tc.contingency_loadings(
        gt, torch.from_numpy(cases),
        p_extra=th.apply_hvdc(gt, torch.from_numpy(disp)), num_iters=10)
    assert got.shape == (2, 4, 110)
    np.testing.assert_allclose(to_np(got), ref, **OBJ_TOL)
    assert bool((got[:, 1] == 10.0).all())
    assert bool((got[:, [0, 2, 3]] < 10.0).all())
    # per-genome case lists, no injections: one genome per row
    per = tc.contingency_loadings(gt, torch.tensor([[3, 11], [40, 77]]))
    np.testing.assert_allclose(
        to_np(per), np.stack([np.asarray(jc.contingency_loadings(
            gj, jnp.asarray(c), num_iters=10)) for c in ([3, 11], [40, 77])]),
        **OBJ_TOL)


def test_select_contingency_lines_same_picks(grids):
    jgrid, tgrid, _, _ = grids
    for num, seed in ((8, 0), (20, 3), (500, 1)):
        np.testing.assert_array_equal(
            tc.select_contingency_lines(tgrid, num, seed),
            jc.select_contingency_lines(jgrid, num, seed))


def test_penalized_objective():
    """Paper eq. (3): +10% per critical, +1% per near-critical case,
    batched over genomes."""
    loadings = np.array([[[0.5, 1.2], [0.97, 0.5], [0.5, 0.5]],
                         [[0.5, 0.5], [0.96, 0.95], [1.01, 2.0]]],
                        np.float32)
    base = np.array([100.0, 50.0], np.float32)
    got = to_np(tc.penalized_objective(torch.from_numpy(base),
                                       torch.from_numpy(loadings)))
    np.testing.assert_allclose(got, [111.0, 55.5], rtol=1e-6)
    ref = [float(jc.penalized_objective(jnp.asarray(b), jnp.asarray(l)))
           for b, l in zip(base, loadings)]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# the fitness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("contingencies,screen", [(0, 0), (8, 0), (8, 4)])
def test_hvdc_fitness_matches_reference(grids, contingencies, screen):
    jgrid, tgrid, _, _ = grids
    kw = dict(contingencies=contingencies, screen_top_k=screen,
              newton_iters=10)
    jfit = JaxHVDCFitness(jgrid, **kw)
    tfit = HVDCDispatchFitness(tgrid, device="cpu", **kw)
    assert tfit.num_genes == jfit.num_genes == 4
    genomes, disp = dispatches(4, np.asarray(jgrid.hvdc_pmax))
    ref = np.asarray(jax.jit(jfit)(jnp.asarray(genomes)))
    got = tfit(torch.from_numpy(genomes))
    assert got.shape == (4, 1) and bool(torch.isfinite(got).all())
    conv = to_np(tn.newton_powerflow(
        tfit.gridt, p_extra=th.apply_hvdc(tfit.gridt, torch.from_numpy(disp)),
        num_iters=10).converged)
    np.testing.assert_array_equal(conv, jax_converged(jfit.gridj, disp))
    assert conv[0] and conv[2:].all()
    assert_objectives_close(got, ref, conv)
    if contingencies == 0:
        assert float(got[0, 0]) < float(got[2, 0])   # zero beats a draw


def test_cost_model_matches_reference(grids):
    jgrid, tgrid, _, _ = grids
    jcost = JaxHVDCFitness(jgrid, newton_iters=8).cost_model()
    tcost = HVDCDispatchFitness(tgrid, newton_iters=8,
                                device="cpu").cost_model()
    genomes, _ = dispatches(4, np.asarray(jgrid.hvdc_pmax), seed=3)
    got = tcost(torch.from_numpy(genomes))
    np.testing.assert_allclose(to_np(got),
                               np.asarray(jcost(jnp.asarray(genomes))),
                               rtol=1e-6)
    assert float(got[1]) > float(got[0])


def test_hvdc_generation_replay_matches_reference(grids):
    """One generation of ga_run --fitness hvdc (the 60-bus grid, Table 3,
    fused operators, cost model over 4 lanes with 3 x 6 % 4 != 0 padded)
    from the reference's pre-drawn uniforms. Survivor selection must be
    decided by converged objectives alone (module docstring): each island
    holds at least P converged individuals among parents and offspring,
    which the test checks."""
    jgrid, tgrid, gj, _ = grids
    jfit = JaxHVDCFitness(jgrid)
    tfit = HVDCDispatchFitness(tgrid, device="cpu")
    i, p, g = 3, 6, 4
    args = dict(num_genes=g, pop_per_island=p, num_islands=i,
                generations_per_epoch=1, num_epochs=1, lower=-1.0,
                upper=1.0, mutation_prob=0.7, mutation_eta=34.6,
                crossover_prob=1.0, crossover_eta=97.5, seed=2)
    jcfg, cfg = JaxGAConfig(**args), GAConfig(**args)
    jbroker = JaxBroker(jfit, jfit.cost_model(), num_workers=4)
    jpop = jax_init_population(jcfg, jax.random.PRNGKey(2))
    jpop = jisland.evaluate_population(jcfg, jbroker, jpop)
    jnew, jmet = jax.jit(jisland.make_generation_step(jcfg, jbroker))(
        jpop, None)

    def converged(genomes):
        disp = to_np(genomes).reshape(-1, g) * np.asarray(jgrid.hvdc_pmax,
                                                          np.float32)
        return jax_converged(gj, disp)

    tpop = population_from_numpy(jax.device_get(jpop._asdict()), "cpu")
    conv0 = converged(tpop.genomes)
    assert_objectives_close(tfit(tpop.genomes.reshape(-1, g)),
                            np.asarray(jpop.fitness).reshape(-1, 1), conv0)
    src = ArrayUniforms(jax_generation_draws(jpop.rng, p, g,
                                             cfg.tournament_size, True))
    gen = island.make_generation_step(
        cfg, Broker(tfit, tfit.cost_model(), num_workers=4), "cpu")
    tnew, tmet = gen(tpop, src)
    assert src.remaining() == 0
    np.testing.assert_allclose(to_np(tnew.genomes), np.asarray(jnew.genomes),
                               rtol=1e-5, atol=1e-5)
    conv1 = converged(tnew.genomes)
    assert conv1.all(), "survivors include a non-converged individual"
    assert_objectives_close(tnew.fitness.reshape(-1, 1),
                            np.asarray(jnew.fitness).reshape(-1, 1), conv1)
    np.testing.assert_allclose(to_np(tmet["skew"]), np.asarray(jmet["skew"]),
                               rtol=1e-6)
    assert float(tmet["balanced"]) == 1.0
