"""The port's sharding rules (``repro_torch.models.sharding``) against the
reference's on both production meshes: the reference's on
``jax.sharding.AbstractMesh``, the port's on a ``DeviceMesh`` of a fake
process group of 256 or 512 ranks (``launch.mesh.make_production_mesh``).

Parameters: every leaf of all ten archs at published widths, the port's
``Model`` built on the ``meta`` device, the reference's from
``param_shapes()``, leaves matched through ``models/convert.py``'s names
(a layer leaf's spec is the reference's stacked leaf's without its
leading period None). Caches likewise, from ``init_cache`` on ``meta``
and ``cache_shapes``. The context factories' fields are compared as they
are.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jax_get_config
from repro.models import sharding as jsh
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import convert
from repro_torch.models import sharding as tsh
from repro_torch.models.model import Model

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
CTX_FIELDS = ("dp", "tp", "fsdp", "seq", "shard_cache_seq", "seq_parallel")
# decode caches: a batch below the data size (long-context: the sequence
# dim over data and model) and one above it
CACHE_RUNS = ((4, 8192), (64, 4096))


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """(reference AbstractMesh, port DeviceMesh) of one production mesh."""
    shape, names = MESHES[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield (AbstractMesh(shape, names),
               make_production_mesh(multi_pod=request.param == "multi_pod",
                                    device="cpu"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def models():
    """{arch: (port Model on meta, reference Model)}."""
    return {a: (Model(get_config(a), device="meta"),
                JaxModel(jax_get_config(a))) for a in list_archs()}


def ctxs(jmesh, tmesh):
    """(reference, port) context pairs: training, and serving a big model
    at a batch above the data size (fsdp over dp, no seq sharding)."""
    return [(jsh.make_train_ctx(jmesh), tsh.make_train_ctx(tmesh)),
            (jsh.make_serve_ctx(jmesh, global_batch=64, big_model=True),
             tsh.make_serve_ctx(tmesh, global_batch=64, big_model=True))]


def assert_same_ctx(jctx, tctx):
    for f in CTX_FIELDS:
        assert getattr(tctx, f) == getattr(jctx, f), f
    assert (tctx.dp_size, tctx.tp_size, tctx.dp_spec) == \
        (jctx.dp_size, jctx.tp_size, jctx.dp_spec)


def flat(tree) -> dict:
    """{dotted path: leaf} of a tree (a PartitionSpec is a leaf)."""
    return {".".join(jsh._key_name(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def flat_specs(tree) -> dict:
    """{dotted path: spec tuple} of a spec tree."""
    return {k: tuple(v) for k, v in flat(tree).items()}


def port_specs(tree: dict, prefix: str = "") -> dict:
    """{dotted path: spec} of the port's nested dicts of spec tuples."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(port_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def reference_name(cfg, name: str) -> tuple:
    """(reference dotted name, stacked) of a port parameter name."""
    head, _, rest = name.partition(".")
    stacks = {port: ref for ref, port in convert._STACKS}
    if head not in stacks:
        return name, False
    layer, leaf = rest.split(".", 1)
    per = convert._periods(cfg, stacks[head])[1]
    return f"{stacks[head]}.sub{int(layer) % per}.{leaf}", True


def test_train_ctx_matches_reference(meshes):
    jmesh, tmesh = meshes
    for seq_parallel in (True, False):
        assert_same_ctx(jsh.make_train_ctx(jmesh, seq_parallel=seq_parallel),
                        tsh.make_train_ctx(tmesh, seq_parallel=seq_parallel))
    assert tsh.make_train_ctx(None) == tsh.ShardingCtx()


@pytest.mark.parametrize("batch", [1, 8, 16, 64])
@pytest.mark.parametrize("big_model", [False, True])
def test_serve_ctx_matches_reference(meshes, batch, big_model):
    jmesh, tmesh = meshes
    jctx = jsh.make_serve_ctx(jmesh, global_batch=batch, big_model=big_model)
    tctx = tsh.make_serve_ctx(tmesh, global_batch=batch, big_model=big_model)
    assert_same_ctx(jctx, tctx)
    assert tctx.shard_cache_seq == (batch < tctx.axes_size(
        ("pod", "data") if "pod" in tmesh.mesh_dim_names else "data"))


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(meshes, models, arch):
    model, jmodel = models[arch]
    cfg = get_config(arch)
    shapes = jmodel.param_shapes()
    ref_shapes = {k: tuple(v.shape) for k, v in flat(shapes).items()}
    params = dict(model.named_parameters())
    for jctx, tctx in ctxs(*meshes):
        ref = flat_specs(jsh.param_specs(shapes, jctx))
        got = tsh.param_specs(model, tctx)
        assert got.keys() == params.keys()
        seen = set()
        for name, spec in got.items():
            rname, stacked = reference_name(cfg, name)
            seen.add(rname)
            want_shape = ref_shapes[rname][1:] if stacked else \
                ref_shapes[rname]
            assert tuple(params[name].shape) == want_shape, name
            assert spec == (ref[rname][1:] if stacked else ref[rname]), name
        assert seen == ref.keys()


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(meshes, models, arch):
    model, jmodel = models[arch]
    jmesh, tmesh = meshes
    for batch, length in CACHE_RUNS:
        jctx = jsh.make_serve_ctx(jmesh, global_batch=batch)
        tctx = tsh.make_serve_ctx(tmesh, global_batch=batch)
        ref = flat_specs(jsh.cache_specs(
            jmodel.cache_shapes(batch, length), jctx))
        got = tsh.cache_specs(model.init_cache(batch, length), tctx)
        n = 0
        for sub, layers in got.items():
            for layer in layers:
                for path, spec in port_specs(layer).items():
                    assert spec == ref[f"{sub}.{path}"][1:], (sub, path)
                    n += 1
        assert n == len(ref) * (len(next(iter(got.values()))))


def test_placements_and_blocks(meshes):
    _, tmesh = meshes
    ctx = tsh.make_train_ctx(tmesh)
    dp = ("pod", "data") if "pod" in tmesh.mesh_dim_names else ("data",)
    want = [Shard(0)] * len(dp) + [Shard(1)]
    assert ctx.named(ctx.dp_spec, "model") == want
    assert ctx.named(None, None) == [Replicate()] * len(want)
    shardings = tsh.param_shardings({"embed.tokens": (32000, 2048)}, ctx)
    assert shardings["embed.tokens"] == [Shard(1)] * len(dp) + [Shard(0)]
    assert tsh.param_shardings({}, tsh.ShardingCtx()) is None
    # blocks: torch.tensor_split's, this rank (0) first
    assert ctx.sizes(6, "model") == [1] * 6 + [0] * 10
    assert ctx.sizes(70, "model") == [5] * 6 + [4] * 10
    assert ctx.rows(70, "model") == (0, 5)
    x = torch.arange(70.0).reshape(70, 1)
    torch.testing.assert_close(ctx.cs(x, "model"),
                               torch.tensor_split(x, 16)[0])


def test_meshes_need_the_group_size(meshes):
    _, tmesh = meshes
    world = dist.get_world_size()
    multi = "pod" in tmesh.mesh_dim_names
    assert tmesh.mesh_dim_names == MESHES["multi_pod" if multi else "pod"][1]
    with pytest.raises(RuntimeError, match=f"needs 8 ranks.*has {world}"):
        make_local_mesh(4, 2, device="cpu")
    with pytest.raises(RuntimeError, match=f"needs {512 if not multi else 256}"
                       f" ranks.*has {world}"):
        make_production_mesh(multi_pod=not multi, device="cpu")


@pytest.mark.parametrize("cards,local,world,env,want", [
    (8, None, 256, "8", ("nccl", 3)),      # 32 nodes, one rank per card
    (8, 8, 512, None, ("nccl", 3)),        # told the node's ranks
    (8, None, 8, None, ("nccl", 3)),       # one node, no launcher
    (1, None, 4, None, ("gloo", 0)),       # four ranks share one card
    (8, None, 32, "16", ("gloo", 3)),      # two ranks per card
])
def test_init_distributed_backend_per_node(monkeypatch, cards, local, world,
                                           env, want):
    """NCCL when each node's ranks have a card each, gloo when they share
    one, whatever the world size; rank 11 takes card 11 % cards."""
    from repro_torch.launch import mesh
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend))
    if env is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", env)
    dev = mesh.init_distributed(11, world, "file:///unused",
                                local_world_size=local)
    assert (seen["backend"], dev.index) == want
