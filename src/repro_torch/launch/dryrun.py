"""Multi-pod dry run on a fake mesh: build every (architecture x input
shape) cell on the production meshes and report what one device of it
holds and does (the port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 256 or 512 XLA host
devices. The port has no compiler to ask, so this process plays rank 0
of a ``fake`` process group of 256 or 512 ranks (collectives return at
once, moving nothing), builds the cell's ``DeviceMesh``
(``launch.mesh.make_production_mesh``) and runs one step of the cell
under ``FakeTensorMode``: every tensor has a shape and a dtype and no
storage, so no memory is allocated and no kernel or card is reached. Each
cell is built as the reference builds it (``_lower_one``): train under
``make_train_ctx`` with bf16 compute, the plain blocked attention (the
reference's ``"flash_xla"``), remat, ``MICROBATCHES`` and bf16 moments
above 20e9 parameters; prefill and decode under ``make_serve_ctx``, every
rank holding its ``cache_specs`` block of the cache.

Per cell (``run_cell``) a record with the reference's keys, a device:

  * ``mem.{argument,output,temp,peak}_bytes``: the step's inputs (this
    rank's parameter, moment, batch and cache blocks), its outputs, and
    from ``torch.distributed._tools.mem_tracker.MemTracker`` the peak of
    all it holds during the step (temp = peak - arguments);
  * ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count;
    ``cost.bytes_accessed`` is None (nothing here counts it);
  * ``bytes_<op>`` / ``count_<op>`` / ``coll_bytes`` under the reference's
    five op names, from ``core.collectives.counts``: an all-gather's
    gathered buffer, a reduce-scatter's block of its input, an
    all-reduce's tensor, as the partitioned HLO's result shapes give them.
    The port has no all-to-all and no collective-permute: their counts
    are 0.

The port runs every layer in Python, so its counts are whole: there is no
scan body counted once and no depth probe (``--no-depth-probe`` is not
taken), and each ``*_corrected`` key equals its count. A train record's
``seq_parallel`` is its context's: true where the mesh's model axis holds
more than one rank (``make_train_ctx``'s default: the hidden state carried
as each rank's sequence block between sub-layers, moved by all-gather and
reduce-scatter over model); the ``no_seqpar`` variant runs the same cell
with the hidden state whole on every model rank, summed by all-reduce.

Usage (no GPU needed; one cell at a time, the fake group made per mesh):
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch tinyllama-1.1b --shape all --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES, get_config, list_archs,
                                 shape_applicable)
from repro_torch.core import collectives
from repro_torch.data.pipeline import place
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import batch_specs, decode_specs
from repro_torch.models.model import Model
from repro_torch.models.sharding import (cache_blocks, make_flat_groups,
                                         make_serve_ctx, make_train_ctx)
from repro_torch.train.optimizer import init_opt_state, optimizer_for_arch
from repro_torch.train.train_step import make_train_step

# Per-arch gradient-accumulation defaults for train_4k (the reference's).
MICROBATCHES = {
    "jamba-1.5-large-398b": 8,
    "llava-next-34b": 4,
    "granite-8b": 2,
}

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")
# core.collectives' kinds under the reference's op names
_OPS = {"all_gather": "all-gather", "all_reduce_sum": "all-reduce",
        "all_reduce_max": "all-reduce", "all_reduce_min": "all-reduce",
        "reduce_scatter": "reduce-scatter"}

# Hillclimb variants (the reference's): model / step / ctx keywords
VARIANTS = {
    "baseline":    {},
    "mb1":         {"microbatches": 1},
    "mb2":         {"microbatches": 2},
    "pad_experts": {"model": {"pad_experts": True}},
    "moe_dense":   {"model": {"moe_impl": "dense"}},
    "moe_dense_pad": {"model": {"moe_impl": "dense", "pad_experts": True}},
    "remat_dots":  {"model": {"remat_policy": "dots"}},
    "cap1":        {"model": {"moe_capacity_factor": 1.0}},
    "pad_cap1":    {"model": {"pad_experts": True,
                              "moe_capacity_factor": 1.0}},
    "no_seqpar":   {"ctx": {"seq_parallel": False}},
    "compress_pod": {"step": {"compress_pod_reduce": True}},
    "grad_rs":     {"step": {"shard_grads": True}},
    "grad_rs_mb2": {"step": {"shard_grads": True}, "microbatches": 2},
}

_DEPTH_KEYS = ("coll_bytes",) + tuple(
    f"bytes_{op}" for op in COLL_OPS) + tuple(
    f"count_{op}" for op in COLL_OPS)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def collective_stats(counts: dict, axis_size) -> dict:
    """A device's collective bytes and calls by the reference's op names
    from ``core.collectives.counts`` (``axis_size(axis)``: the ranks of a
    counted axis, "+"-joined for several): the gathered buffer of an
    all-gather, the tensor of an all-reduce, the block of a
    reduce-scatter (its input over the ranks), as the partitioned HLO's
    result shapes count them."""
    per_op = {op: 0 for op in COLL_OPS}
    count = {op: 0 for op in COLL_OPS}
    for axis, c in counts.items():
        for kind, nbytes in c["op_bytes"].items():
            op = _OPS[kind]
            if kind == "reduce_scatter":
                nbytes //= axis_size(axis)
            per_op[op] += nbytes
            count[op] += c["ops"][kind]
    out = {f"bytes_{k}": v for k, v in per_op.items()}
    out.update({f"count_{k}": v for k, v in count.items()})
    out["coll_bytes"] = sum(per_op.values())
    return out


def _blocks(tree):
    """A tensor of its own (fake under the dry run's mode) on the CPU for
    every ``meta`` block of ``tree``: a block cut from a whole stand-in is
    a view, which would hold the whole storage."""
    if isinstance(tree, dict):
        return {k: _blocks(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_blocks(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype)


def _run_and_report(fn, model, args: list, label: str, ctx,
                    verbose: bool, train: bool = False) -> dict:
    """Run ``fn()`` once under the counters (with autograd where ``train``):
    the record's mem, cost and collective keys."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    arg_bytes = _nbytes(args) + sum(
        p.numel() * p.element_size() for p in model.parameters())
    mt = MemTracker()
    # MemTracker hooks every parameter's gradient: a serving cell's
    # parameters are made to want one and its step runs under no_grad
    if not train:
        model.requires_grad_(True)
    mt.track_external(model, *_tensors(args))
    # it also refuses a module called again in a second forward (a train
    # step's microbatches): each forward starts with fresh module stats,
    # the device's peak kept
    forward = model.forward

    def fresh_forward(*a, **kw):
        mt.reset_mod_stats()
        return forward(*a, **kw)

    model.forward = fresh_forward
    collectives.reset_counts()
    t0 = time.monotonic()
    try:
        with mt, FlopCounterMode(display=False) as flops, \
                torch.set_grad_enabled(train):
            out = fn()
    finally:
        del model.forward
    rec = {"run_s": round(time.monotonic() - t0, 2)}
    peak = max((snap.get("Total", 0) for snap in
                mt.get_tracker_snapshot("peak").values()), default=0)
    rec["mem"] = {"argument_bytes": arg_bytes,
                  "output_bytes": _nbytes(out),
                  "temp_bytes": max(peak - arg_bytes, 0),
                  "peak_bytes": max(peak, arg_bytes)}
    rec["cost"] = {"flops": flops.get_total_flops(), "bytes_accessed": None}
    rec.update(collective_stats(collectives.counts,
                                lambda a: ctx.axes_size(a.split("+"))))
    if verbose:
        mem = rec["mem"]
        print(f"  [{label}] run {rec['run_s']}s | flops/dev "
              f"{rec['cost']['flops']} | arg+tmp bytes "
              f"{mem['argument_bytes']}+{mem['temp_bytes']} | coll/dev "
              f"{rec['coll_bytes']}", flush=True)
    return rec


def _lower_one(cfg, shape, mesh, *, microbatches, label, verbose,
               variant="baseline"):
    """Build and run one cell for one config under the fake mode; returns
    the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    big = cfg.total_params() > 20e9
    vkw = VARIANTS[variant]
    model_kw = dict(vkw.get("model", {}))
    step_kw = dict(vkw.get("step", {}))
    ctx_kw = dict(vkw.get("ctx", {}))
    if "microbatches" in vkw:
        microbatches = vkw["microbatches"]
    moment_dtype = "bfloat16" if big else "float32"

    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            ctx = make_train_ctx(mesh, **ctx_kw)
            model = Model(cfg, device="cpu", ctx=ctx,
                          compute_dtype="bfloat16", attn_impl="blocked",
                          remat=True, max_seq=shape.seq_len, **model_kw)
            mb = microbatches or MICROBATCHES.get(cfg.name, 1)
            step = make_train_step(model, optimizer_for_arch(
                cfg.name, moment_dtype=moment_dtype), microbatches=mb,
                **step_kw)
            model.requires_grad_(True)
            params = dict(model.named_parameters())
            state = {"params": params,
                     "opt": init_opt_state(params, moment_dtype),
                     "rng": torch.zeros((), dtype=torch.int64)}
            batch = _blocks(place(batch_specs(cfg, shape, ctx, train=True)[0],
                                  ctx, "meta", mb))
            rec = _run_and_report(lambda: step(state, batch), model,
                                  [state["opt"], state["rng"], batch],
                                  f"{label} train mb={mb}", ctx, verbose,
                                  train=True)
            rec["microbatches"] = mb
            rec["seq_parallel"] = ctx.seq_split
        else:
            ctx = make_serve_ctx(mesh, global_batch=shape.global_batch,
                                 big_model=big)
            if shape.kind == "prefill":
                model = Model(cfg, device="cpu", ctx=ctx,
                              compute_dtype="bfloat16", attn_impl="blocked",
                              max_seq=shape.seq_len, **model_kw)
                batch = _blocks(place(batch_specs(cfg, shape, ctx,
                                                  train=False)[0],
                                      ctx, "meta"))
                rec = _run_and_report(
                    lambda: model.prefill(batch, shape.seq_len), model,
                    [batch], f"{label} prefill", ctx, verbose)
            else:
                model = Model(cfg, device="cpu", ctx=ctx,
                              compute_dtype="bfloat16",
                              max_seq=shape.seq_len + 8, **model_kw)
                cache, _, tokens, _, _ = decode_specs(cfg, shape, model)
                cache = _blocks(cache_blocks(cache, ctx))
                tokens = _blocks(place({"t": tokens}, ctx, "meta"))["t"]
                # the reference's pos is a 0-d int32 argument
                pos = torch.zeros((), dtype=torch.int32)
                rec = _run_and_report(
                    lambda: model.decode_step(cache, tokens,
                                              shape.seq_len - 1),
                    model, [cache, tokens, pos], f"{label} decode", ctx,
                    verbose)
    return rec


def _shallow_cfg(cfg, periods: int):
    enc = 0
    if cfg.encoder_layers:
        enc = max(1, cfg.encoder_layers // cfg.num_periods) * periods
    return dataclasses.replace(cfg, name=cfg.name,
                               num_layers=cfg.scan_period * periods,
                               encoder_layers=enc)


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks, this process rank 0, for
    the block: made and destroyed here where none exists, used as it is
    where one of that size does."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(
                f"the dry run needs a process group of {size} ranks; this "
                f"process has one of {dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             microbatches: Optional[int] = None,
             variant: str = "baseline", periods: Optional[int] = None,
             verbose: bool = True) -> dict:
    """The record of one cell. ``periods``: the model cut to that many
    periods (``_shallow_cfg``; default its published depth)."""
    cfg = get_config(arch)
    if periods is not None:
        cfg = _shallow_cfg(cfg, periods)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        if verbose:
            print(f"  [SKIP] {arch} x {shape_name}: {reason}", flush=True)
        return {**base, "status": "skip", "reason": reason}

    label = f"{arch} x {shape_name} x {mesh_name}"
    label += "" if variant == "baseline" else f" [{variant}]"
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        make_flat_groups(mesh)
        rec = _lower_one(cfg, shape, mesh, microbatches=microbatches,
                         label=label, verbose=verbose, variant=variant)
    # every layer ran: the counts are whole, no depth probe corrects them
    rec["flops_corrected"] = rec["cost"]["flops"]
    for key in _DEPTH_KEYS:
        rec[f"{key}_corrected"] = rec[key]
    rec.update(base)
    rec["variant"] = variant
    rec["status"] = "ok"
    rec["chips"] = 512 if multi_pod else 256
    rec["total_params"] = cfg.total_params()
    rec["active_params"] = cfg.active_params()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(VARIANTS))
    ap.add_argument("--out", default="experiments/dryrun.jsonl")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    try:
                        rec = run_cell(arch, shape, multi_pod=mp,
                                       microbatches=args.microbatches,
                                       variant=args.variant)
                    except Exception as e:                 # noqa: BLE001
                        n_fail += 1
                        rec = {"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if mp else "16x16",
                               "status": "fail", "error": str(e)[:500]}
                        print(f"  [FAIL] {arch} x {shape}: "
                              f"{str(e)[:200]}", flush=True)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    print(f"done; failures={n_fail}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
