"""The port's dry-run shape contract against the reference's: the shape
cells (``configs.SHAPES``, ``shape_applicable``) and the stand-ins of
``launch/specs.py`` (``input_specs``, ``train_specs``) for every arch x
shape, shapes and dtypes. The reference's stand-ins are
``ShapeDtypeStruct``s from ``eval_shape``, the port's ``meta`` tensors;
neither allocates. The port keeps one parameter and cache entry per layer
where the reference stacks layers over periods, so the port's per-layer
entries are stacked (``stacked``) before they are compared. Twins of
tests/test_extensions.py::TestInputSpecs and
tests/test_dryrun_units.py::TestShapeContract."""
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.configs import list_archs as j_archs
from repro.configs import shape_applicable as j_applicable
from repro.launch import specs as jspecs
from repro.models.model import Model as JModel
from repro.models.sharding import ShardingCtx as JCtx
from repro_torch.configs import (SHAPES, get_config, get_shape, list_archs,
                                 shape_applicable)
from repro_torch.launch import specs
from repro_torch.models.model import Model
from repro_torch.models.sharding import ShardingCtx

ARCHS = list_archs()
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
# the reference's per-layer stacks, and the port's module lists
_STACKS = {"layers": ("stack", lambda cfg: cfg.scan_period),
           "enc_layers": ("enc_stack", lambda cfg: 1)}


def _sig(x):
    """(shape, dtype name) of a stand-in of either package."""
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def stacked(cfg, params) -> dict:
    """{reference leaf name: (shape, dtype)} of the port's per-layer
    parameter stand-ins, layer leaves stacked over periods as the
    reference's tree holds them; every layer of a stack slot must agree."""
    out, slots = {}, {}
    for name, t in params.items():
        head, _, rest = name.partition(".")
        if head not in _STACKS:
            out[name] = _sig(t)
            continue
        ref_head, per = _STACKS[head]
        layer, leaf = rest.split(".", 1)
        slots.setdefault(f"{ref_head}.sub{int(layer) % per(cfg)}.{leaf}",
                         []).append(_sig(t))
    for key, sigs in slots.items():
        assert len(set(sigs)) == 1, key
        out[key] = ((len(sigs),) + sigs[0][0], sigs[0][1])
    return out


def test_shape_cells_and_contract_match_reference():
    assert set(SHAPES) == set(J_SHAPES) and ARCHS == j_archs()
    for name, shp in SHAPES.items():
        ref = J_SHAPES[name]
        assert get_shape(name) == shp
        assert (shp.name, shp.seq_len, shp.global_batch, shp.kind,
                shp.is_train) == (ref.name, ref.seq_len, ref.global_batch,
                                  ref.kind, ref.is_train)
    for arch, name in CELLS:
        got = shape_applicable(get_config(arch), SHAPES[name])
        assert got == j_applicable(j_config(arch), J_SHAPES[name]), \
            (arch, name)
    # the reference's own contract (TestShapeContract)
    runs = {a for a in ARCHS
            if shape_applicable(get_config(a), SHAPES["long_500k"])[0]}
    assert runs == {"mamba2-780m", "jamba-1.5-large-398b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Every shape of ``arch``: batch stand-ins equal; decode caches equal
    once the port's per-layer caches are stacked over periods."""
    for name in SHAPES:
        got, want = specs.input_specs(arch, name), jspecs.input_specs(arch,
                                                                      name)
        assert set(got) == set(want), name
        if "batch" in got:
            assert {k: _sig(v) for k, v in got["batch"].items()} == \
                {k: _sig(v) for k, v in want["batch"].items()}, name
            assert all(v.is_meta for v in got["batch"].values())
            continue
        assert _sig(got["tokens"]) == _sig(want["tokens"])
        assert _sig(got["pos"]) == _sig(want["pos"])
        port = {}
        for sub, layers in got["cache"].items():
            for layer in layers:
                for leaf, t in _leaves(layer):
                    assert t.is_meta
                    port.setdefault(f"{sub}.{leaf}", []).append(_sig(t))
        ref = dict(_leaves(want["cache"]))
        assert set(port) == set(ref), name
        for key, sigs in port.items():
            assert len(set(sigs)) == 1, key
            shape, dtype = sigs[0]
            assert ((len(sigs),) + shape, dtype) == _sig(ref[key]), \
                (name, key)


def test_input_specs_known_cells():
    """tests/test_extensions.py::TestInputSpecs on the port's layout."""
    s = specs.input_specs("tinyllama-1.1b", "train_4k")
    assert tuple(s["batch"]["tokens"].shape) == (256, 4097)
    s = specs.input_specs("llava-next-34b", "prefill_32k")
    assert tuple(s["batch"]["tokens"].shape) == (32, 32768 - 576)
    assert tuple(s["batch"]["frontend_embeds"].shape) == (32, 576, 7168)
    s = specs.input_specs("gemma2-2b", "decode_32k")
    assert tuple(s["tokens"].shape) == (128, 1)
    # gemma2 local layers allocate window-sized ring caches
    assert s["cache"]["sub0"][0]["attn"]["k"].shape[1] == 4096
    assert s["cache"]["sub1"][0]["attn"]["k"].shape[1] == 32768


@pytest.mark.parametrize("arch", ARCHS)
def test_train_specs_match_reference(arch):
    """The train_4k cell's state as the dry run builds it (bf16 compute,
    remat, bf16 moments above 20e9 parameters): parameters, both moments
    and the step equal the reference's; the port's "rng" is a 0-d int64
    seed where the reference's is a (2,) uint32 key."""
    cfg, jcfg = get_config(arch), j_config(arch)
    moment = "bfloat16" if cfg.total_params() > 20e9 else "float32"
    assert moment == ("bfloat16" if jcfg.total_params() > 20e9
                      else "float32")
    model = Model(cfg, device="meta", compute_dtype="bfloat16", remat=True,
                  max_seq=SHAPES["train_4k"].seq_len)
    got, sh = specs.train_specs(model, moment)
    want, _ = jspecs.train_specs(JModel(
        jcfg, JCtx(), compute_dtype="bfloat16", remat=True,
        max_seq=J_SHAPES["train_4k"].seq_len), moment)
    ref = {k: _sig(v) for k, v in _leaves(want["params"])}
    assert stacked(cfg, got["params"]) == ref
    for m in ("m", "v"):
        assert stacked(cfg, got["opt"][m]) == {
            k: (shape, moment) for k, (shape, _) in ref.items()}
        assert {_sig(v)[1] for _, v in _leaves(want["opt"][m])} == {moment}
    assert _sig(got["opt"]["step"]) == _sig(want["opt"]["step"])
    assert _sig(got["rng"]) == ((), "int64")
    assert _sig(want["rng"]) == ((2,), "uint32")
    assert all(t.is_meta for _, t in _leaves(got))
    # no mesh: no placements, as the reference's unsharded context
    assert sh == {"params": None, "opt": {"m": None, "v": None,
                                          "step": None}, "rng": None}


class _Mesh:
    """A mesh as ``ShardingCtx`` reads it: axis names and sizes."""
    mesh_dim_names = ("data", "model")
    shape = (4, 2)


def test_batch_placements_split_the_batch_over_data():
    from torch.distributed.tensor import Replicate, Shard
    ctx = ShardingCtx(mesh=_Mesh(), dp=("data",), tp="model",
                      fsdp=("data",))
    cfg = get_config("whisper-large-v3")
    batch, sh = specs.batch_specs(cfg, SHAPES["train_4k"], ctx, train=True)
    assert sh["tokens"] == [Shard(0), Replicate()]
    assert sh["frontend_embeds"] == [Shard(0), Replicate()]
    assert tuple(batch["frontend_embeds"].shape) == (256, cfg.encoder_seq,
                                                     cfg.d_model)
    assert batch["frontend_embeds"].dtype == torch.bfloat16
