"""Parity of the port's ``Model`` (``repro_torch.models``) with the JAX
reference on reduced configs, on the CPU. The reference's parameters go
through numpy into the port (``models.convert.params_from_numpy``); the
same tokens go through both. Compared: full-sequence logits, prefill's
last logits and every cache leaf (``cache_to_numpy``), and 4 decode steps
fed the same tokens — past the sliding window on gemma2 (s = 40 > 16).
Tolerances of tests/test_models_smoke.py: 2e-4, 3e-4 through the ring
cache. Each case runs twice: with the plain paths, and with the kernel
paths (JAX: Pallas in interpret mode; the port: its kernels' plain
versions on CPU tensors); the MoE archs once more with the sorted
capacity dispatch forced, at a capacity factor that drops tokens. Decode
at one position per lane is held against decode lane by lane. The VLM
and audio archs get the reference's smoke-test frontends (8 patches,
``encoder_seq`` frames), so their caches hold the patch prefix and the
cross-attention's ``xk`` / ``xv``, and decoding starts after the
prefix."""
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
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import MODEL_TOL, RING_TOL, frontend_embeds, to_np

S, DECODE, MAX_CACHE = 40, 4, 64
VARIANTS = {
    # variant: (JAX Model switches, port Model switches)
    "plain": (dict(), dict(attn_impl="auto", use_ssd_kernel=False)),
    "kernel": (dict(attn_impl="pallas", use_ssd_kernel=True),
               dict(attn_impl="kernel", use_ssd_kernel=True)),
}


MOE_ARCHS = [a for a in list_archs() if get_config(a).num_experts]
# sorted dispatch at a capacity factor of 1.0: 88 tokens over 8 experts, 2
# choices each, leave 24 slots an expert, and the busiest ones overflow
SORTED = (dict(moe_impl="sorted", moe_capacity_factor=1.0),
          dict(moe_impl="sorted", moe_capacity_factor=1.0))


def _pair(arch, variant, kw=None):
    jkw, tkw = VARIANTS[variant] if kw is None else kw
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
    _check_against_reference(*_pair(arch, variant))


@pytest.mark.parametrize("arch,pad", [(a, False) for a in MOE_ARCHS]
                         + [("qwen2-moe-a2.7b", True)])
def test_moe_sorted_matches_reference(arch, pad):
    """The sorted dispatch at capacity factor 1.0, and on qwen with the
    experts padded to a multiple of 16 (8 -> 16 reduced), the padded
    experts' weights carried across with the rest."""
    kw = dict(SORTED[0], pad_experts=pad)
    jm, params, m = _pair(arch, None, (kw, kw))
    moe = next(layer.moe for layer in m.layers if layer.moe is not None)
    assert m.moe_impl == "sorted" and moe.impl == "sorted"
    assert moe.wi.shape[0] == (16 if pad else 8)
    # the full sequence drops tokens at this capacity, a decode step none:
    # decode matches the reference's decode, not the full logits
    _check_against_reference(jm, params, m, decode_is_full=False)


def _check_against_reference(jm, params, m, decode_is_full=True):
    cfg = m.cfg
    rs = np.random.default_rng(1)
    toks = rs.integers(0, cfg.vocab_size, (2, S + DECODE)).astype(np.int32)
    fe = frontend_embeds(cfg, 2, rs)
    off = 8 if cfg.frontend == "vision_patches" else 0
    tt = torch.from_numpy(toks)
    jfe = {k: jnp.asarray(v) for k, v in fe.items()}
    tfe = {k: torch.from_numpy(v) for k, v in fe.items()}
    jfull, jaux = jm.forward(params, {"tokens": jnp.asarray(toks), **jfe})
    jlast, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S]),
                                        **jfe}, max_cache_len=MAX_CACHE)
    before = (attn_ops.launches, ssd_ops.launches)
    with torch.inference_mode():
        full, aux = m.forward({"tokens": tt, **tfe})
        last, cache = m.prefill({"tokens": tt[:, :S], **tfe}, MAX_CACHE)
    assert (attn_ops.launches, ssd_ops.launches) == before   # CPU: plain
    assert full.shape == (2, off + S + DECODE, cfg.padded_vocab)
    assert (float(jaux) == 0.0) == (not cfg.num_experts)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL)
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
                                      jnp.int32(off + pos))
        with torch.inference_mode():
            dec, cache = m.decode_step(cache, tt[:, pos:pos + 1], off + pos)
        np.testing.assert_allclose(to_np(dec), np.asarray(jdec), **RING_TOL)
        if decode_is_full:
            np.testing.assert_allclose(to_np(dec[:, 0]),
                                       to_np(full[:, off + pos]), **RING_TOL)


def test_registry_matches_reference():
    """The port registers all ten of the reference's archs, each config
    field for field equal to the reference's, at full size and
    reduced."""
    from repro.configs import list_archs as jax_archs
    assert list_archs() == jax_archs() and len(list_archs()) == 10
    for arch in list_archs():
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jax_config(arch)))
        assert (dataclasses.asdict(get_config(arch).reduced())
                == dataclasses.asdict(jax_config(arch).reduced()))


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


def _cat_lanes(caches):
    """One cache of B lanes from B caches of one lane each (prefills of
    different lengths): k/v and SSM states concatenated on the batch axis,
    ``cache_pos`` stacked to (B, T_cache)."""
    def cat(items):
        if isinstance(items[0], dict):
            return {k: cat([it[k] for it in items]) for k in items[0]}
        if isinstance(items[0], list):
            return [cat(list(per)) for per in zip(*items)]
        if items[0].ndim == 1:                          # cache_pos
            return torch.stack(items)
        return torch.cat(items)
    return cat(caches)


class _HostReads(TorchDispatchMode):
    """Counts reads of a tensor's value into Python (``.item()``,
    ``int(t)``, ``bool(t)``: ``aten._local_scalar_dense``), each a device
    sync on the GPU."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", list_archs())
def test_decode_with_lane_positions_equals_lane_by_lane(arch):
    """Three lanes prefilled at B = 1 to different lengths (one past
    gemma2's reduced window of 16; each with its own VLM patches or
    whisper frames), then 4 decode steps with a (3,) position tensor: each
    lane's logits and cache (whisper's cross cache included) equal its own
    decode at an int position; the tensor form reads no position back to
    the host."""
    cfg = get_config(arch).reduced()
    m = Model(cfg, device="cpu", max_seq=96, moe_impl="sorted"
              if cfg.num_experts else "auto")
    m.init_params(torch.Generator().manual_seed(5))
    rs = np.random.default_rng(6)
    off = 8 if cfg.frontend == "vision_patches" else 0
    lens = (9, 37, 22)
    prompts = [{"tokens": torch.from_numpy(rs.integers(0, cfg.vocab_size,
                                                       (1, n))),
                **{k: torch.from_numpy(v)
                   for k, v in frontend_embeds(cfg, 1, rs).items()}}
               for n in lens]
    steps = torch.from_numpy(rs.integers(0, cfg.vocab_size, (3, DECODE)))
    lens = tuple(off + n for n in lens)
    with torch.inference_mode():
        lanes = [m.prefill(p, MAX_CACHE)[1] for p in prompts]
        pool = _cat_lanes([m.prefill(p, MAX_CACHE)[1] for p in prompts])
        pos = torch.tensor(lens)
        for i in range(DECODE):
            with _HostReads() as mode:
                dec, pool = m.decode_step(pool, steps[:, i:i + 1], pos + i)
            assert mode.reads == 0
            for b in range(3):
                one, lanes[b] = m.decode_step(
                    lanes[b], steps[b:b + 1, i:i + 1], lens[b] + i)
                np.testing.assert_allclose(to_np(dec[b]), to_np(one[0]),
                                           **MODEL_TOL)
    ours = cache_to_numpy(pool)
    for b in range(3):
        lane = cache_to_numpy(lanes[b])
        for s in lane:
            for kind, leaves in lane[s].items():
                for leaf, val in leaves.items():
                    got = ours[s][kind][leaf][:, b]
                    if leaf == "cache_pos":
                        np.testing.assert_array_equal(got, val)
                    else:
                        np.testing.assert_allclose(got, val[:, 0],
                                                   **MODEL_TOL)


def test_moe_impl_choice_and_padded_experts():
    """"auto" takes the sorted dispatch above 8 experts (the reference's
    rule); ``pad_experts`` widens the router and expert weights to a
    multiple of 16 while the config keeps its count."""
    cfg = get_config("qwen2-moe-a2.7b")
    small = cfg.reduced()
    assert Model(small, device="cpu").moe_impl == "dense"
    assert Model(dataclasses.replace(small, num_experts=9),
                 device="cpu").moe_impl == "sorted"
    m = Model(dataclasses.replace(small, num_experts=12), device="cpu",
              pad_experts=True)
    moe = m.layers[0].moe
    assert moe.router.shape == (small.d_model, 16)
    assert moe.router.dtype == torch.float32
    assert moe.wi.shape[0] == moe.wg.shape[0] == moe.wo.shape[0] == 16
    with pytest.raises(ValueError, match="moe_impl"):
        Model(small, device="cpu", moe_impl="grouped")


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_config("tinyllama-1.1b").reduced())
