"""Parity of the port's MoE functions (``repro_torch.models.moe``) with
the JAX reference's (``repro.models.moe``) on the CPU: the router's top-k
(indices exact, ties to the lower index; weights and aux at 1e-5), the
dense oracle, the sorted capacity dispatch (which tokens a full expert
drops, exactly), capacity and padded expert counts, and padded experts
(60 -> 64) that never win. Inputs and weights are made with numpy from a
seed and handed to both."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import moe as TM

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")


def _cfgs(arch, **change):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **change)
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _weights(cfg, seed, e=None):
    """Router, expert and (qwen) shared-expert weights at fan-in scale."""
    rs = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.moe_d_ff
    e = e or cfg.num_experts

    def w(shape, fan_in):
        return (rs.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    p = {"router": w((d, e), d), "wi": w((e, d, f), d),
         "wg": w((e, d, f), d), "wo": w((e, f, d), f)}
    if cfg.num_shared_experts:
        sf = cfg.shared_d_ff
        p.update(swi=w((d, sf), d), swg=w((d, sf), d), swo=w((sf, d), sf),
                 sgate=w((d, 1), d))
    return p


def _tokens(cfg, b, s, seed, skew=0):
    """(B, S, D) float32; with ``skew`` the first ``skew`` tokens of each
    row are one repeated token, so they all pick the same experts."""
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    x[:, :skew] = x[0, 0]
    return x


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    p = _weights(cfg, 0)
    x = _tokens(cfg, 3, 17, 1)
    jp, jx, tp, tx = _both(p, x)
    ji, jw, jaux = JM.router_topk(jcfg, jp["router"], jx)
    ti, tw, taux = TM.router_topk(cfg, tp["router"], tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert tw.dtype == tx.dtype and taux.dtype == torch.float32


def test_router_topk_ties_take_the_lower_index():
    """Columns 1, 3, 5 of the router are equal, so experts 1, 3, 5 tie for
    every token; top-2 over them takes 1 then 3, as ``lax.top_k`` does."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    p = _weights(cfg, 2)
    r = p["router"]
    r[:, [3, 5]] = r[:, [1, 1]]
    # x >= 0, so x . r_1 >= -x . |r_1| > -4 x . |r_1|: the tie leads
    r[:, [0, 2, 4, 6, 7]] = -4.0 * np.abs(r[:, [1]])
    x = np.abs(_tokens(cfg, 2, 9, 3))
    jp, jx, tp, tx = _both(p, x)
    ji = np.asarray(JM.router_topk(jcfg, jp["router"], jx)[0])
    ti = TM.router_topk(cfg, tp["router"], tx)[0].numpy()
    assert (ji == [1, 3]).all()
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, jx, tp, tx = _both(_weights(cfg, 4), _tokens(cfg, 2, 13, 5))
    jout, jaux = JM.moe_dense(jcfg, jp, jx)
    tout, taux = TM.moe_dense(cfg, tp, tx)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("groups", [1, 4, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sorted_drops_what_the_reference_drops(arch, groups):
    """Capacity factor 1.0 on skewed tokens (20 of each 24 identical): the
    busiest experts overflow, and the port drops exactly the reference's
    (token, choice) pairs, in 1, 4 or 3 groups (48, 12 or 16 tokens a
    group)."""
    jcfg, cfg = _cfgs(arch)
    p = _weights(cfg, 6)
    x = _tokens(cfg, 2, 24, 7, skew=20)
    jp, jx, tp, tx = _both(p, x)
    jout, jaux = JM.moe_sorted(jcfg, jp, jx, num_groups=groups,
                               capacity_factor=1.0)
    tout, taux = TM.moe_sorted(cfg, tp, tx, num_groups=groups,
                               capacity_factor=1.0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # the dispatch itself, group by group
    k, t = cfg.experts_per_token, 48 // groups
    cap = TM.capacity(cfg, t, 1.0)
    assert cap == JM.capacity(jcfg, t, 1.0)
    idx = np.array(JM.router_topk(jcfg, jp["router"], jx)[0]).reshape(
        groups, t, k)
    xf = x.reshape(groups, t, -1)
    dropped = 0
    for gi in range(groups):
        jb, js, jk = JM._dispatch_one_group(
            jcfg, jnp.asarray(xf[gi]), jnp.asarray(idx[gi]), cap,
            cfg.num_experts)
        tb, ts, tk = TM._dispatch_one_group(
            cfg, torch.from_numpy(xf[gi]), torch.from_numpy(idx[gi]).long(),
            cap, cfg.num_experts)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        # real slots hold one token each, bit for bit; the drop bin sums
        np.testing.assert_array_equal(tb[:-1].numpy(), np.asarray(jb)[:-1])
        dropped += int((~tk).sum())
    assert dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sorted_without_drops_equals_dense(arch):
    jcfg, cfg = _cfgs(arch)
    _, _, tp, tx = _both(_weights(cfg, 8), _tokens(cfg, 2, 16, 9))
    factor = cfg.num_experts / cfg.experts_per_token      # capacity = T
    dense, daux = TM.moe_dense(cfg, tp, tx)
    out, aux = TM.moe_sorted(cfg, tp, tx, capacity_factor=factor)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)
    assert float(aux) == float(daux)


def test_capacity_and_padded_experts_match_reference():
    for arch in ARCHS:
        for cfg_fn in (lambda a: a, lambda a: a.reduced()):
            jcfg, cfg = cfg_fn(jax_config(arch)), cfg_fn(get_config(arch))
            assert TM.padded_experts(cfg) == JM.padded_experts(jcfg)
            assert TM.padded_experts(cfg, 8) == JM.padded_experts(jcfg, 8)
            for tokens in (1, 2, 7, 12, 100, 8192):
                for factor in (1.0, 1.25, 2.0):
                    assert (TM.capacity(cfg, tokens, factor)
                            == JM.capacity(jcfg, tokens, factor))
    assert TM.padded_experts(get_config("qwen2-moe-a2.7b")) == 64


@pytest.mark.parametrize("impl", ["dense", "sorted"])
def test_padded_experts_never_win(impl):
    """qwen's 60 experts padded to 64: the router and expert weights have
    64 columns, the 4 padded ones are masked out of the softmax (their
    router columns made large, so they would win unmasked)."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b", num_experts=60, experts_per_token=4)
    e_pad = TM.padded_experts(cfg)
    assert e_pad == 64
    p = _weights(cfg, 10, e=e_pad)
    p["router"][:, 60:] = 5.0
    x = np.abs(_tokens(cfg, 2, 16, 11))
    jp, jx, tp, tx = _both(p, x)
    idx = TM.router_topk(cfg, tp["router"], tx)[0]
    assert int(idx.max()) < 60
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(JM.router_topk(jcfg, jp["router"], jx)[0]))
    if impl == "dense":
        jout, jaux = JM.moe_dense(jcfg, jp, jx)
        tout, taux = TM.moe_dense(cfg, tp, tx)
    else:
        jout, jaux = JM.moe_sorted(jcfg, jp, jx, capacity_factor=1.0)
        tout, taux = TM.moe_sorted(cfg, tp, tx, capacity_factor=1.0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
