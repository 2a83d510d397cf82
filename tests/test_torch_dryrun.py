"""The port's fake-mesh dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``): the shallow configs, the collective
counts under the reference's op names, one shallow cell of each kind on
the 16 x 16 production mesh (a fake process group of 256 ranks, one step
under ``FakeTensorMode``), and the decode cells' argument bytes against
the bytes a device holds under the reference's ``param_specs`` /
``cache_specs`` on an ``AbstractMesh`` of the same shape.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import dryrun as jdry
from repro.models import sharding as jsh
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, list_archs
from repro_torch.core import collectives
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.sharding import make_flat_groups, make_train_ctx

# one shallow cell of each kind: (arch, shape)
CELLS = [("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
         ("tinyllama-1.1b", "decode_32k"),
         ("jamba-1.5-large-398b", "long_500k")]
POD = ((16, 16), ("data", "model"))
SHAPES_KIND = {k: v.kind for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_shallow_cfg_matches_reference(arch):
    for periods in (1, 2):
        got = dryrun._shallow_cfg(get_config(arch), periods)
        want = jdry._shallow_cfg(jax_config(arch), periods)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_variants_are_the_references():
    assert dryrun.VARIANTS == jdry.VARIANTS
    assert dryrun.MICROBATCHES == jdry.MICROBATCHES


def test_collective_counts_of_known_calls():
    """One call of each kind on the fake 16 x 16 mesh, under the
    reference's names: the gathered buffer of an all-gather, the block a
    reduce-scatter leaves, the tensor of an all-reduce."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        make_flat_groups(mesh)
        ctx = make_train_ctx(mesh)
        collectives.reset_counts()
        ctx.gather(torch.zeros(4, 8), 64, "model")            # 16 x 128 B
        collectives.reduce_scatter(torch.zeros(32, 3), [2] * 16,
                                   ctx.group("data"), "data")  # 384 B in
        ctx.all_reduce(torch.zeros(5), ("data", "model"), "max")
        ctx.all_reduce(torch.zeros(2, dtype=torch.int64), "model")
        stats = dryrun.collective_stats(
            collectives.counts, lambda a: ctx.axes_size(a.split("+")))
    assert stats == {
        "bytes_all-gather": 16 * 4 * 8 * 4, "count_all-gather": 1,
        "bytes_reduce-scatter": 2 * 3 * 4, "count_reduce-scatter": 1,
        "bytes_all-reduce": 5 * 4 + 2 * 8, "count_all-reduce": 2,
        "bytes_all-to-all": 0, "count_all-to-all": 0,
        "bytes_collective-permute": 0, "count_collective-permute": 0,
        "coll_bytes": 2048 + 24 + 36}


@pytest.fixture(scope="module")
def records():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {cell: dryrun.run_cell(*cell, periods=1, verbose=False)
                for cell in CELLS}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_shallow_cells_run_on_the_fake_mesh(records, arch, shape):
    rec = records[(arch, shape)]
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "16x16", 256)
    mem = rec["mem"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["output_bytes"] > 0 and rec["cost"]["flops"] > 0
    # the whole counts: the corrected keys are the counts
    assert rec["flops_corrected"] == rec["cost"]["flops"]
    for key in dryrun._DEPTH_KEYS:
        assert rec[f"{key}_corrected"] == rec[key]
    assert rec["count_all-gather"] > 0 and rec["coll_bytes"] > 0
    assert rec["total_params"] >= rec["active_params"] > 0
    if SHAPES_KIND[shape] == "train":
        # sequence-parallel activations over the 16 model ranks
        assert rec["seq_parallel"] is True and rec["microbatches"] == 1
        assert rec["count_reduce-scatter"] > 0
    json.dumps(rec)


def test_microbatched_train_cell_holds_less(records):
    """The ``mb2`` variant: the train step's two microbatches each run the
    model (MemTracker's module stats start afresh each forward), the same
    FLOPs, and a lower peak than one microbatch."""
    one = records[("tinyllama-1.1b", "train_4k")]
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", periods=1,
                          variant="mb2", verbose=False)
    assert (rec["status"], rec["microbatches"]) == ("ok", 2)
    assert rec["cost"]["flops"] == one["cost"]["flops"]
    assert rec["mem"]["peak_bytes"] < one["mem"]["peak_bytes"]


def test_no_seqpar_train_cell_holds_more(records):
    """The ``no_seqpar`` variant, every model rank holding the whole hidden
    state: the same FLOPs as the baseline, a higher peak, and the
    activations summed over model by all-reduce where the baseline
    all-gathers and reduce-scatters them along the sequence."""
    one = records[("tinyllama-1.1b", "train_4k")]
    model_bytes = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for variant in ("baseline", "no_seqpar"):
            rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", periods=1,
                                  variant=variant, verbose=False)
            model_bytes[variant] = dict(
                collectives.counts["model"]["op_bytes"])
    finally:
        torch.set_num_threads(n)
    assert (rec["status"], rec["seq_parallel"]) == ("ok", False)
    assert "same_as" not in rec
    assert rec["cost"]["flops"] == one["cost"]["flops"]
    assert rec["mem"]["peak_bytes"] > one["mem"]["peak_bytes"]
    sp, whole = model_bytes["baseline"], model_bytes["no_seqpar"]
    assert whole["all_reduce_sum"] > 100 * sp["all_reduce_sum"]
    for op in ("all_gather", "reduce_scatter"):
        assert sp[op] > 100 * whole.get(op, 0), op


def reference_argument_bytes(arch: str, shape_name: str) -> int:
    """The bytes a device holds of the decode cell's arguments (parameters,
    cache, tokens, the 0-d int32 pos) under the reference's specs on an
    AbstractMesh of the 16 x 16 mesh's shape, each leaf's bytes over the
    ranks of the axes its spec splits it over."""
    cfg = jdry._shallow_cfg(jax_config(arch), 1)
    shape = JSHAPES[shape_name]
    sizes = dict(zip(POD[1], POD[0]))
    ctx = jsh.make_serve_ctx(AbstractMesh(*POD),
                             global_batch=shape.global_batch,
                             big_model=cfg.total_params() > 20e9)
    model = JaxModel(cfg, ctx, compute_dtype="bfloat16",
                     max_seq=shape.seq_len + 8)

    def device_bytes(leaves, specs):
        total = 0
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
        for leaf, spec in zip(jax.tree_util.tree_leaves(leaves),
                              jax.tree_util.tree_leaves(
                                  specs, is_leaf=is_spec)):
            split = 1
            for e in spec:
                for a in ((e,) if isinstance(e, str) else e or ()):
                    split *= sizes[a]
            total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // split
        return total

    params = model.param_shapes()
    cache = model.cache_shapes(shape.global_batch, shape.seq_len,
                               dtype=model.compute_dtype)
    dp = ctx.dp_spec
    tokens = shape.global_batch * 4 // (
        np.prod([sizes[a] for a in ((dp,) if isinstance(dp, str)
                                    else dp or ())]))
    return (device_bytes(params, jsh.param_specs(params, ctx))
            + device_bytes(cache, jsh.cache_specs(cache, ctx))
            + int(tokens) + 4)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if SHAPES_KIND[c[1]] == "decode"])
def test_decode_argument_bytes_are_the_reference_specs(records, arch, shape):
    assert records[(arch, shape)]["mem"]["argument_bytes"] == \
        reference_argument_bytes(arch, shape)


def test_cli_writes_a_record_a_cell(tmp_path):
    """The reference's CLI: a cell the shape contract skips is written with
    its reason; the exit code counts failures."""
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k",
                        "--mesh", "both", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("16x16", "skip"), ("2x16x16", "skip")]
    assert recs[0]["reason"] == jdry.run_cell(
        "tinyllama-1.1b", "long_500k", verbose=False)["reason"]
