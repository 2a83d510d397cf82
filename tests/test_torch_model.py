"""Parity of the port's ``Model`` (``repro_torch.models``) with the JAX
reference on reduced configs, on the CPU. The reference's parameters go
through numpy into the port (``models.convert.params_from_numpy``); the
same tokens go through both. Compared: full-sequence logits, prefill's
last logits and every cache leaf (``cache_to_numpy``), and 4 decode steps
fed the same tokens — past the sliding window on gemma2 (s = 40 > 16).
Tolerances of tests/test_models_smoke.py: 2e-4, 3e-4 through the ring
cache. Each case runs twice: with the plain paths, and with the kernel
paths (JAX: Pallas in interpret mode; the port: its kernels' plain
versions on CPU tensors)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.convert import cache_to_numpy, params_from_numpy
from repro_torch.models.model import Model
from torch_parity import MODEL_TOL, RING_TOL, to_np

S, DECODE, MAX_CACHE = 40, 4, 64
VARIANTS = {
    # variant: (JAX Model switches, port Model switches)
    "plain": (dict(), dict(attn_impl="auto", use_ssd_kernel=False)),
    "kernel": (dict(attn_impl="pallas", use_ssd_kernel=True),
               dict(attn_impl="kernel", use_ssd_kernel=True)),
}


def _pair(arch, variant):
    jkw, tkw = VARIANTS[variant]
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = JaxModel(jcfg, max_seq=96, **jkw)
    params = jm.init_params(jax.random.PRNGKey(0))
    m = Model(cfg, device="cpu", max_seq=96, **tkw)
    m.load_state_dict(params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jm, params, m


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", list_archs())
def test_model_matches_reference(arch, variant):
    jm, params, m = _pair(arch, variant)
    cfg = m.cfg
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S + DECODE)).astype(np.int32)
    tt = torch.from_numpy(toks)
    jfull, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    jlast, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                               max_cache_len=MAX_CACHE)
    before = (attn_ops.launches, ssd_ops.launches)
    with torch.inference_mode():
        full, aux = m.forward({"tokens": tt})
        last, cache = m.prefill({"tokens": tt[:, :S]}, MAX_CACHE)
    assert (attn_ops.launches, ssd_ops.launches) == before   # CPU: plain
    assert full.shape == (2, S + DECODE, cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(to_np(full), np.asarray(jfull), **MODEL_TOL)
    np.testing.assert_allclose(to_np(last), np.asarray(jlast), **MODEL_TOL)

    ours = cache_to_numpy(cache)
    theirs = jax.tree_util.tree_map(np.asarray, jcache)
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(theirs))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **MODEL_TOL)

    for i in range(DECODE):
        pos = S + i
        jdec, jcache = jm.decode_step(params, jcache,
                                      jnp.asarray(toks[:, pos:pos + 1]),
                                      jnp.int32(pos))
        with torch.inference_mode():
            dec, cache = m.decode_step(cache, tt[:, pos:pos + 1], pos)
        np.testing.assert_allclose(to_np(dec), np.asarray(jdec), **RING_TOL)
        np.testing.assert_allclose(to_np(dec[:, 0]), to_np(full[:, pos]),
                                   **RING_TOL)


def test_gemma2_ring_cache_wraps_past_the_window():
    cfg = get_config("gemma2-2b").reduced()
    assert cfg.sliding_window == 16 and S > cfg.sliding_window
    m = Model(cfg, device="cpu", max_seq=96)
    cache = m.init_cache(2, MAX_CACHE)
    local, glob = cache["sub0"][0]["attn"], cache["sub1"][0]["attn"]
    assert local["k"].shape[1] == 16 and glob["k"].shape[1] == MAX_CACHE
    m.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, S), dtype=torch.int32)
    with torch.inference_mode():
        _, cache = m.prefill({"tokens": toks}, MAX_CACHE)
    cp = to_np(cache["sub0"][0]["attn"]["cache_pos"])
    assert sorted(cp) == list(range(S - 16, S))
    assert all(p % 16 == slot for slot, p in enumerate(cp))


def test_init_params_is_seeded_and_finite():
    cfg = get_config("mamba2-780m").reduced()
    a = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x).all()), name
    dt_bias = a.layers[0].ssm.dt_bias
    dt = torch.nn.functional.softplus(dt_bias)
    assert bool(((dt > 0.99e-3) & (dt < 1.01e-1)).all())
    n = sum(p.numel() for p in a.parameters())
    pad = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    assert abs(n - pad - cfg.total_params()) / cfg.total_params() < 0.02


@pytest.mark.parametrize("change", [
    dict(family="moe", num_experts=4, experts_per_token=2),
    dict(family="hybrid", attn_every=2),
    dict(family="vlm", frontend="vision_patches"),
    dict(family="audio", is_encoder_decoder=True, pos_embedding="learned"),
])
def test_families_not_ported_raise(change):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              **change)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Model(cfg, device="cpu")


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_config("tinyllama-1.1b").reduced())
