"""The port's continuous batcher (``repro_torch.serve.batching``) on the
CPU: against per-request ``generate`` (the reference's
``tests/test_extensions.py::TestContinuousBatching``, ported), against
the reference's batcher on the same converted weights (tokens exactly,
the lane pool's caches at RING_TOL), and a lane reused after a long
request against a fresh batcher. Prompts are drawn with numpy from a
seed."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import Model as JaxModel
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro.serve.batching import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models.convert import cache_to_numpy, params_from_numpy
from repro_torch.models.model import Model
from repro_torch.models.moe import capacity
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.train.serve_step import generate
from torch_parity import RING_TOL

MAX_CACHE = 64


def _requests(cls, vocab, lens, new, seed=0):
    rs = np.random.default_rng(seed)
    prompts = [rs.integers(0, vocab, size=n).astype(np.int32) for n in lens]
    return [cls(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]


def test_matches_plain_generation():
    """Four requests through two slots (an oversubscribed queue) give each
    request's per-request greedy ``generate`` tokens."""
    cfg = get_config("tinyllama-1.1b").reduced()
    m = Model(cfg, device="cpu", max_seq=96)
    m.init_params(torch.Generator().manual_seed(0))
    b = ContinuousBatcher(m, slots=2, max_cache_len=MAX_CACHE)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=8 + i).astype(np.int32),
                    max_new_tokens=4) for i in range(4)]
    for r in reqs:
        b.submit(r)
    done = b.run()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    for req in done:
        ref = generate(m, {"tokens": torch.from_numpy(req.prompt[None])},
                       steps=4, max_cache_len=MAX_CACHE)
        assert req.out == ref[0].tolist()


def _pair(arch, **kw):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jm = JaxModel(jcfg, max_seq=96, **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    m = Model(cfg, device="cpu", max_seq=96, **kw)
    m.load_state_dict(params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jm, params, m


# arch: (Model switches, slots, prompt lengths, max_new_tokens). gemma2's
# reduced window is 16: prompts of 40 and 30 wrap its local ring caches.
# granite-moe with sorted dispatch: 12 lanes, ten of them one prompt, so
# each tick ten identical tokens pick the same experts; one dispatch group
# over the 12 lanes (capacity 8) would drop two of them, the reference's
# per-lane steps never drop one
CASES = {
    "gemma2-2b": (dict(), 2, (40, 9, 30, 12, 9), (5, 7, 3, 6, 4)),
    "mamba2-780m": (dict(), 2, (20, 9, 33, 9), (6, 4, 5, 3)),
    "granite-moe-1b-a400m": (dict(moe_impl="sorted"), 12,
                             (11,) * 10 + (7, 19, 7, 25),
                             (4, 6, 3, 5, 4, 6, 3, 5, 4, 6, 5, 3, 6, 4)),
}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_tokens_equal_the_reference_batcher(arch):
    kw, slots, lens, new = CASES[arch]
    jm, params, m = _pair(arch, **kw)
    cfg = m.cfg
    ours = _requests(Request, cfg.vocab_size, lens, new)
    theirs = _requests(JaxRequest, cfg.vocab_size, lens, new)
    if arch == "granite-moe-1b-a400m":
        for r in (ours, theirs):
            for req in r[1:10]:
                req.prompt = r[0].prompt
        assert capacity(cfg, slots) < 10
    b = ContinuousBatcher(m, slots=slots, max_cache_len=MAX_CACHE)
    jb = JaxBatcher(jm, params, slots=slots, max_cache_len=MAX_CACHE)
    for r, jr in zip(ours, theirs):
        b.submit(r)
        jb.submit(jr)
    done = {r.uid: r.out for r in b.run()}
    jdone = {r.uid: r.out for r in jb.run()}
    assert done == jdone
    assert all(len(done[i]) == n for i, n in enumerate(new))
    # the lane pools after the same ticks: the reference stacks one cache
    # per lane, (slots, periods, 1, ...); the port's is (periods, slots,
    # ...) through cache_to_numpy
    pool = cache_to_numpy(b.cache)
    for s, kinds in pool.items():
        for kind, leaves in kinds.items():
            for leaf, val in leaves.items():
                ref = np.asarray(jb.cache[s][kind][leaf])
                ref = np.swapaxes(ref, 0, 1)
                if leaf == "cache_pos":
                    np.testing.assert_array_equal(val, ref)
                else:
                    np.testing.assert_allclose(val, ref[:, :, 0], **RING_TOL)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m",
                                  "granite-moe-1b-a400m"])
def test_reused_lane_equals_a_fresh_batcher(arch):
    """One slot: a long request (past gemma2's window), then a short one in
    the same lane. The short one's tokens, and the lane's whole cache
    after it, equal a fresh batcher's that served it alone: admission
    overwrites every entry the long request left."""
    cfg = get_config(arch).reduced()
    m = Model(cfg, device="cpu", max_seq=96)
    m.init_params(torch.Generator().manual_seed(1))
    long, short = _requests(Request, cfg.vocab_size, (50, 6), (8, 6),
                            seed=2)
    fresh_short = Request(uid=1, prompt=short.prompt, max_new_tokens=6)
    reused = ContinuousBatcher(m, slots=1, max_cache_len=MAX_CACHE)
    reused.submit(long)
    reused.submit(short)
    reused.run()
    fresh = ContinuousBatcher(m, slots=1, max_cache_len=MAX_CACHE)
    fresh.submit(fresh_short)
    fresh.run()
    assert short.out == fresh_short.out
    # the same ticks since the short request's admission
    assert int(reused.pos[0]) == int(fresh.pos[0])
    a, b = cache_to_numpy(reused.cache), cache_to_numpy(fresh.cache)
    for s in a:
        for kind in a[s]:
            for leaf in a[s][kind]:
                np.testing.assert_allclose(a[s][kind][leaf],
                                           b[s][kind][leaf], **RING_TOL)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-large-v3"])
def test_frontend_archs_are_refused(arch):
    """Requests carry token prompts only, so an arch with a frontend is
    refused at construction (the reference's batcher passes no
    ``frontend_embeds`` and fails at its first prefill)."""
    m = Model(get_config(arch).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="token prompts only"):
        ContinuousBatcher(m, slots=2, max_cache_len=MAX_CACHE)
