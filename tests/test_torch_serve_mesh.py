"""Serving over a device mesh (``Model.prefill`` / ``decode_step`` under
``make_serve_ctx``, ``train.serve_step``'s greedy and sampled tokens,
``launch.serve.serve(mesh=)``) on gloo process groups on the CPU: the
port's counterpart of the reference's sharded serving, which GSPMD gives
the numbers of one device.

Two worlds of ranks run once each (``tests/torch_serve_mesh_worker.py``,
one process per rank, one intra-op thread, a ``file://`` store under the
test's tmp dir), every scenario of the world in one spawn, while this
process runs the same scenarios on one rank and through the reference:

* 4 ranks on (data 2, model 2), reduced widths: gemma2-2b with a prompt
  past its ring window; tinyllama-1.1b with a vocab across both tp blocks,
  one kv head, 3 heads, a cache whose slots do not split, fsdp over data,
  and temperature sampling; granite-moe through the sorted dispatch;
  whisper-large-v3 (the cross cache); mamba2-780m (the SSM cache split
  over tp); llava-next-34b (a patch prefix); jamba at batch 1 (the batch
  below the data size: the attention cache's slots over data and model);
  ``serve(mesh=)``; the continuous batcher refused.
* 8 ranks on (pod 2, data 2, model 2): gemma2-2b and jamba at batch 1.

Each scenario: greedy (or sampled) tokens equal to one rank's; prefill
and decode logits within ``MODEL_TOL`` / ``RING_TOL`` of one rank's and
of the reference's unsharded ``prefill`` / ``decode_step`` fed the same
tokens from the same parameters (one jitted reference call a scenario);
every rank's cache leaves within ``MODEL_TOL`` of its block of the
one-rank cache, cut by the reference's ``cache_specs`` on an
``AbstractMesh`` of the world's shape.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.models import sharding as jsh
from repro.models.model import Model as JaxModel
from repro_torch.models.convert import cache_to_numpy, params_to_numpy
from repro_torch.models.model import Model
from torch_parity import MODEL_TOL, RING_TOL
from torch_serve_mesh_worker import (SCENARIOS, WORLD_SCENARIOS, config,
                                     inputs, run)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_serve_mesh_worker.py")
SPAWN_TIMEOUT_S = 240
MESHES = {4: ((2, 2), ("data", "model")),
          8: ((2, 2, 2), ("pod", "data", "model"))}
# a route is held where one rank's top-k margin is at least this
ROUTE_MARGIN = 1e-5
CASES = [(w, n) for w, names in WORLD_SCENARIOS.items() for n in names]
# the scenarios held against the reference: one a config (fsdp and
# odd_slots serve tinyllama's own config; the sampled tokens have no
# greedy reference)
REFERENCE = [n for n in SCENARIOS if n not in ("fsdp", "sample")]


def spawn(world: int, where: Path) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(WORKER.parent)]))
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(world), str(r), str(where)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def collect(world: int, where: Path, procs: list) -> dict:
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log[-3000:]}"
    return torch.load(where / f"{world}.pt", weights_only=False)


def reference(name: str, tokens: np.ndarray) -> dict:
    """The reference's unsharded prefill and decode steps fed ``tokens``
    (one rank's), from the port's seed-0 parameters: the logits (B, 1 +
    steps, V) and the last cache, one jitted call."""
    sc = SCENARIOS[name]
    cfg = config(sc)
    model = Model(cfg, device="cpu", max_seq=sc.cache, **dict(sc.model_kw))
    model.init_params(torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
        cfg, dict(model.named_parameters())))
    jcfg = dataclasses.replace(jax_config(sc.arch).reduced(),
                               **dict(sc.cfg_kw))
    jm = JaxModel(jcfg, max_seq=sc.cache, **dict(sc.model_kw))
    data = inputs(sc)
    off = 8 if cfg.frontend == "vision_patches" else 0

    @jax.jit
    def steps(params, batch, toks):
        last, cache = jm.prefill(params, batch, max_cache_len=sc.cache)
        out = [last[:, -1]]
        for i in range(sc.steps):
            logits, cache = jm.decode_step(
                params, cache, toks[:, i:i + 1],
                jnp.int32(off + sc.prompt + i))
            out.append(logits[:, -1])
        return jnp.stack(out, 1), cache

    logits, cache = steps(params, {k: jnp.asarray(v) for k, v in
                                   data.items()}, jnp.asarray(tokens))
    return {"logits": np.asarray(logits),
            "cache": jax.tree_util.tree_map(np.asarray, cache)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results, with one rank's runs and the reference's,
    computed here while the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        where = {w: tmp_path_factory.mktemp(f"w{w}") for w in MESHES}
        procs = {w: spawn(w, where[w]) for w in MESHES}
        try:
            one = {name: run(name) for name in SCENARIOS}
            ref = {name: reference(name, one[name]["tokens"][:, :-1])
                   for name in REFERENCE}
        except BaseException:
            for ps in procs.values():
                for p in ps:
                    p.kill()
                    p.wait()
            raise
        got = {w: collect(w, where[w], procs[w]) for w in MESHES}
    finally:
        torch.set_num_threads(n)
    return {"got": got, "one": one, "ref": ref}


@pytest.mark.parametrize("world,name", CASES)
def test_tokens_and_logits_equal_one_rank(worlds, world, name):
    got, one = worlds["got"][world][name], worlds["one"][name]
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    np.testing.assert_allclose(got["logits"][:, :1], one["logits"][:, :1],
                               **MODEL_TOL)
    np.testing.assert_allclose(got["logits"][:, 1:], one["logits"][:, 1:],
                               **RING_TOL)


@pytest.mark.parametrize("world,name", [c for c in CASES
                                        if c[1] in REFERENCE])
def test_logits_match_the_reference(worlds, world, name):
    """The mesh's logits against the reference's unsharded prefill and
    decode steps (its tokens are one rank's, the previous test holds)."""
    got, ref = worlds["got"][world][name], worlds["ref"][name]
    np.testing.assert_allclose(got["logits"][:, :1], ref["logits"][:, :1],
                               **MODEL_TOL)
    np.testing.assert_allclose(got["logits"][:, 1:], ref["logits"][:, 1:],
                               **RING_TOL)


def block(x: np.ndarray, spec, coord: dict, sizes: dict) -> np.ndarray:
    """The block of ``x`` a rank at ``coord`` holds under ``spec`` (a
    reference PartitionSpec; blocks in row-major order over a dim's
    axes)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        c, k = 0, 1
        for a in axes:
            c, k = c * sizes[a] + coord[a], k * sizes[a]
        n = x.shape[d] // k
        x = np.take(x, np.arange(c * n, (c + 1) * n), axis=d)
    return x


@pytest.mark.parametrize("world,name", CASES)
def test_cache_blocks_are_the_reference_cache_specs_cut(worlds, world,
                                                        name):
    """Every rank's cache after the last step is its block of the one-rank
    cache under the reference's ``cache_specs`` (make_serve_ctx on an
    AbstractMesh of the world's shape): k / v with every kv head and the
    rank's block of the slots, ``cache_pos`` whole, whisper's xk / xv and
    the Mamba-2 state / conv as the specs say."""
    sc = SCENARIOS[name]
    shape, names = MESHES[world]
    jctx = jsh.make_serve_ctx(AbstractMesh(shape, names),
                              global_batch=sc.batch, big_model=sc.big_model)
    jm = JaxModel(dataclasses.replace(jax_config(sc.arch).reduced(),
                                      **dict(sc.cfg_kw)), max_seq=sc.cache)
    specs = jsh.cache_specs(jm.cache_shapes(sc.batch, sc.cache), jctx)
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    whole = jax.tree_util.tree_leaves(
        cache_to_numpy(worlds["one"][name]["cache"]))
    split = 0
    for coord, cache in worlds["got"][world][name]["caches"]:
        at = dict(zip(names, coord))
        mine = jax.tree_util.tree_leaves(cache_to_numpy(cache))
        assert len(mine) == len(whole) == len(flat_specs)
        for a, w, spec in zip(mine, whole, flat_specs):
            want = block(w, spec, at, dict(zip(names, shape)))
            assert a.shape == want.shape, (spec, a.shape, want.shape)
            np.testing.assert_allclose(a, want, **MODEL_TOL)
            split += a.shape != w.shape
    assert split     # some leaf is a block, not the whole cache


def _ops(got, axis):
    return got["counts"].get(axis, {}).get("ops", {})


@pytest.mark.parametrize("world", sorted(MESHES))
def test_decode_combines_partial_softmax_over_the_slots(worlds, world):
    """Reduced gemma2's 4 attention layers (ring and global caches, both
    split over "model") each take one max and one sum over "model" a
    decode step; jamba at batch 1 combines its attention layer over data
    and model together."""
    sc = SCENARIOS["gemma2"]
    layers = config(sc).num_layers
    model = _ops(worlds["got"][world]["gemma2"], "model")
    # the combine's max a layer a step (greedy takes one gather a step)
    assert model["all_reduce_max"] == sc.steps * layers
    assert "all_reduce_min" not in model
    jamba = _ops(worlds["got"][world]["jamba"], "data+model")
    steps = SCENARIOS["jamba"].steps
    assert jamba == {"all_reduce_max": steps, "all_reduce_sum": steps}


def test_slots_that_do_not_split_exchange_no_softmax(worlds):
    """25 slots over tp 2: each rank holds every slot and attends its own
    heads; no max is taken over "model"."""
    ops = _ops(worlds["got"][4]["odd_slots"], "model")
    assert ops and "all_reduce_max" not in ops


def test_moe_routes_exact_where_the_margin_holds(worlds):
    """Every tp rank routes its tokens alike; against one rank, routes are
    exact wherever one rank's top-k margin is at least ROUTE_MARGIN."""
    for name in ("moe", "jamba"):
        got, one = worlds["got"][4][name], worlds["one"][name]
        assert len(got["routes"]) == len(one["routes"]) > 0
        held = 0
        for (a, _), (b, margin) in zip(got["routes"], one["routes"]):
            keep = margin >= ROUTE_MARGIN
            assert not ((a != b).any(-1) & keep).any(), name
            held += int(keep.sum())
        assert held > 0


def test_serve_entry_on_a_mesh(worlds):
    """``serve(mesh=)``: each rank returns its rows (the data ranks'
    blocks in order, tp peers alike), together one rank's ``serve``; only
    rank 0 logs."""
    from repro_torch.launch.serve import serve
    got = worlds["got"][4]["serve"]
    one = serve("gemma2-2b", batch=4, prompt_len=20, gen=5, device="cpu",
                log_fn=lambda *_: None).numpy()
    toks = got["tokens"]          # ranks (data, model) in row-major order
    np.testing.assert_array_equal(toks[0], toks[1])
    np.testing.assert_array_equal(toks[2], toks[3])
    np.testing.assert_array_equal(np.concatenate([toks[0], toks[2]]), one)
    assert len(got["log"][0]) == 1 and not any(got["log"][1:])


def test_continuous_batcher_refuses_a_mesh(worlds):
    assert "ROADMAP.md" in worlds["got"][4]["batcher_refused"]
