"""One rank of the port's mesh-training tests
(``tests/test_torch_train_mesh.py``), and the runs those tests hold it
against.

Every rank of a gloo process group on the CPU runs every scenario of its
world; rank 0 saves what the tests compare (``<dir>/<world>.pt``). The
runs start from the port's own initialisation (seed 0, each rank drawing
what one rank draws and keeping its blocks) on tokens drawn with numpy
here, so the tests rebuild the same inputs with one rank's functions of
this module (``run``, ``train_run``, ``loss_case``). This module imports
the port only, never JAX.

    python tests/torch_train_mesh_worker.py WORLD RANK DIR
"""
import contextlib
import copy
import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import collectives
from repro_torch.data.pipeline import place
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.model import Block, Model
from repro_torch.models.sharding import (ShardingCtx, gather_params,
                                         make_train_ctx)
from repro_torch.train import compress
from repro_torch.train.loss import lm_loss
from repro_torch.train.optimizer import optimizer_for_arch
from repro_torch.train.train_step import (init_train_state,
                                          make_compute_grads,
                                          make_train_step)

STEPS, BATCH, SEQ, LR = 3, 4, 32, 1e-3
OPT = dict(lr=LR, warmup_steps=2, total_steps=10)
MOE_ARCH = "granite-moe-1b-a400m"
# the reference test's compressed run: 8 x 33 tokens, 3 steps
POD_BATCH = 8
CKPT_STEPS, CKPT_EVERY = 4, 2
# a vocab whose valid columns reach both tp blocks of the padded 2048
TIE_VOCAB = 1500
TIE_COLS = (100, 1200)
# llava's patches in front of the SEQ tokens: 37 rows, blocks of 19 and 18
# over tp 2, the first holding the patches and 14 tokens
PATCHES = 5


# the other ways a sub-layer splits over tp 2, one step each: kv heads
# that do not split (each rank reads the whole k / v), heads that do not
# split (attention whole on every tp rank), experts that do not split
# (every expert's d_ff split), and the shared expert split with the routed
SPLITS = {
    "mqa": ("tinyllama-1.1b", dict(num_kv_heads=1), {}),
    "odd_heads": ("tinyllama-1.1b", dict(num_heads=3, num_kv_heads=1), {}),
    "moe_dff": (MOE_ARCH, dict(num_experts=3), dict(moe_impl="sorted")),
    "shared_expert": ("qwen2-moe-a2.7b", {}, dict(moe_impl="sorted")),
}


def tokens(cfg, step: int, batch: int = BATCH) -> np.ndarray:
    return np.random.default_rng((1, step)).integers(
        0, cfg.vocab_size, (batch, SEQ + 1)).astype(np.int32)


def frontend(cfg, step: int, rows: int, batch: int = BATCH) -> np.ndarray:
    """A frontend's (batch, rows, d) embeddings, scaled by 0.02 as
    ``data.pipeline`` draws them."""
    return (np.random.default_rng((2, step)).standard_normal(
        (batch, rows, cfg.d_model)) * 0.02).astype(np.float32)


def uneven_mask(batch: int = BATCH) -> np.ndarray:
    """A loss mask that keeps 1 in 8 tokens of the first half of the batch
    (the first data rank's rows) and 7 in 8 of the second."""
    rs = np.random.default_rng(7)
    keep = np.where(np.arange(batch)[:, None] < batch // 2, 0.125, 0.875)
    return (rs.random((batch, SEQ)) < keep).astype(np.float32)


def whole(tree: dict, model) -> dict:
    """Whole tensors from this rank's blocks, as numpy (every rank)."""
    return {n: t.float().numpy() for n, t in
            gather_params(tree, model.layouts, model.ctx).items()}


@contextlib.contextmanager
def recorded_hidden():
    """The shape of the hidden state every layer returns under it, in call
    order."""
    seen = []
    forward = Block.forward

    def record(self, *args, **kw):
        out = forward(self, *args, **kw)
        seen.append(tuple(out[0].shape))
        return out

    Block.forward = record
    try:
        yield seen
    finally:
        Block.forward = forward


@contextlib.contextmanager
def recorded_routes():
    """The expert choices of every router call under it, in call order."""
    seen = []
    router = MOE.router_topk

    def record(*args, **kw):
        out = router(*args, **kw)
        seen.append(out[0].detach().clone())
        return out

    MOE.router_topk = record
    try:
        yield seen
    finally:
        MOE.router_topk = router


def run(arch: str, ctx: ShardingCtx, *, steps: int = STEPS,
        batch: int = BATCH, mask=None, step_kw=None, every_grad=False,
        cfg_kw=None, patches: int = 0, **model_kw) -> dict:
    """``steps`` train steps of reduced ``arch`` (its fields replaced by
    ``cfg_kw``) over ``ctx`` (one rank without a mesh): the first step's
    gradients (every step's with ``every_grad``) and routes, every step's
    metrics, the last parameters, the "rng" seed and the collectives of
    the steps, all whole. A frontend arch gets its embeddings: whisper's
    ``encoder_seq`` frames, a VLM's ``patches``."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **(cfg_kw or {}))
    model = Model(cfg, device="cpu", max_seq=SEQ + 8, attn_impl="kernel",
                  ctx=ctx, **model_kw)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, optimizer_for_arch(arch, **OPT),
                           **(step_kw or {}))
    out = {"metrics": [], "grads": []}
    for i in range(steps):
        data = {"tokens": tokens(cfg, i, batch)}
        if cfg.frontend != "none":
            data["frontend_embeds"] = frontend(
                cfg, i, patches or cfg.encoder_seq, batch)
        if mask is not None:
            data["loss_mask"] = mask
        b = place(data, ctx, "cpu")
        if i == 0 or every_grad:
            with recorded_routes() as routes:
                grads, _ = make_compute_grads(model)(state["params"], b)
            out["grads"].append(whole(grads, model))
            if i == 0:
                out["routes"] = [ctx.gather(r, batch, ctx.dp).numpy()
                                 for r in routes]
        if i == 0:
            collectives.reset_counts()
        state, met = step(state, b)
        out["metrics"].append({k: float(v) for k, v in met.items()})
    # a copy of its own: the gathers below count into the live dicts
    out["counts"] = copy.deepcopy(collectives.counts)
    out["params"] = whole(state["params"], model)
    out["block_numel"] = sum(p.numel() for p in state["params"].values())
    out["rng"] = int(state["rng"])
    return out


def train_run(ctx_mesh, where: Path, steps: int = CKPT_STEPS) -> dict:
    """``launch.train.train`` of reduced tinyllama with a checkpoint every
    CKPT_EVERY steps in ``where`` (its per-step losses and grad norms and
    the last parameters, whole)."""
    stats = {}
    state, _ = train_cli.train(
        "tinyllama-1.1b", steps=steps, batch=BATCH, seq=SEQ, device="cpu",
        ckpt_dir=str(where), ckpt_every=CKPT_EVERY, mesh=ctx_mesh,
        log_fn=lambda s: stats.setdefault("log", []).append(s),
        stats=stats)
    ctx = make_train_ctx(ctx_mesh) if ctx_mesh is not None else \
        ShardingCtx()
    layouts = {n: p._layout for n, p in state["params"].items()
               if hasattr(p, "_layout")}
    params = gather_params(state["params"], layouts, ctx)
    return {"loss": stats["loss"], "grad_norm": stats["grad_norm"],
            "log": stats.get("log", []),
            "params": {n: t.numpy() for n, t in params.items()}}


def loss_case(ctx: ShardingCtx) -> dict:
    """``lm_loss`` on logits drawn here (this rank's rows over dp and
    columns over tp), with ties across the tp blocks and an uneven mask:
    loss, tokens, accuracy and the logits' gradient, whole."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              vocab_size=TIE_VOCAB)
    rs = np.random.default_rng(11)
    vp = cfg.padded_vocab
    logits = rs.standard_normal((BATCH, SEQ, vp)).astype(np.float32)
    labels = rs.integers(0, cfg.vocab_size, (BATCH, SEQ))
    a, b = TIE_COLS
    for row in range(BATCH):
        logits[row, :6, [a, b]] = 50.0       # tied across the blocks
        labels[row, :3] = a                  # argmax is the first: a hit
        labels[row, 3:6] = b                 # a miss
    logits[:, 6, vp - 1] = 80.0              # a padded column: masked
    x = torch.from_numpy(logits)
    if ctx.mesh is not None:
        x = ctx.cs(x, ctx.dp_spec, None, ctx.tp)
    x.requires_grad_(True)
    lab = place({"l": labels}, ctx, "cpu")["l"]
    mask = place({"m": uneven_mask()}, ctx, "cpu")["m"]
    loss, met = lm_loss(cfg, x, lab, mask, ctx)
    loss.backward()
    grad = x.grad
    if ctx.mesh is not None:
        grad = ctx.gather(ctx.gather(grad, BATCH, ctx.dp), vp, ctx.tp, 2)
    return {"loss": float(met["loss"]), "tokens": float(met["tokens"]),
            "accuracy": float(met["accuracy"]), "grad": grad.numpy()}


def gathered(value) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def four(where: Path) -> dict:
    mesh = make_local_mesh(2, 2, device="cpu")
    ctx = make_train_ctx(mesh)
    out = {"tinyllama": run("tinyllama-1.1b", ctx, every_grad=True),
           "uneven_mask": run("tinyllama-1.1b", ctx, steps=1,
                              mask=uneven_mask()),
           "shard_grads": run("tinyllama-1.1b", ctx, steps=2,
                              step_kw=dict(shard_grads=True)),
           "moe": run(MOE_ARCH, ctx, steps=2, moe_impl="sorted"),
           "moe_dense": run(MOE_ARCH, ctx, steps=1, moe_impl="dense"),
           "mamba2": run("mamba2-780m", ctx, steps=2),
           **{name: run(arch, ctx, steps=1, cfg_kw=kw, **model_kw)
              for name, (arch, kw, model_kw) in SPLITS.items()},
           "loss": loss_case(ctx),
           # the same mesh with the hidden state whole on every tp rank
           "no_seq_parallel": run("tinyllama-1.1b", make_train_ctx(
               mesh, seq_parallel=False), steps=1)}
    # cross-attention and learned positions; a sequence of patches and
    # tokens that splits unevenly over tp; the hidden state each layer
    # returns on every rank
    for name, arch, kw in (("whisper", "whisper-large-v3", {}),
                           ("llava_uneven", "llava-next-34b",
                            dict(patches=PATCHES))):
        with recorded_hidden() as shapes:
            out[name] = run(arch, ctx, steps=1, **kw)
        out[name]["hidden"] = gathered(shapes[0])
    # a checkpointed run, resumed from its step-2 checkpoint
    ckpt = where / "ckpt"
    out["ckpt_straight"] = train_run(mesh, ckpt)
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt / f"step_{CKPT_STEPS:010d}")
    dist.barrier()
    out["ckpt_resumed"] = train_run(mesh, ckpt)
    # place: this rank's rows of each global microbatch; a batch that does
    # not split over the data ranks is refused
    rows = place({"t": np.arange(8)}, ctx, "cpu", microbatches=2)["t"]
    out["place_rows"] = gathered(rows.tolist())
    try:
        place({"t": np.arange(3)}, ctx, "cpu")
    except ValueError as err:
        out["place_refused"] = str(err)
    return out


def eight(where: Path) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    # the reference test's compressed setting: pure dp across pods
    pods = ShardingCtx(mesh=mesh, dp=("pod", "data"), tp="model",
                       fsdp=("data",))
    out = {"train_ctx": run("tinyllama-1.1b", make_train_ctx(mesh),
                            steps=2, batch=POD_BATCH)}
    for comp in (False, True):
        out[f"pods_{comp}"] = run("tinyllama-1.1b", pods, batch=POD_BATCH,
                                  step_kw=dict(compress_pod_reduce=comp))
    # the compressed mean of known leaves against one rank's formula
    rank = dist.get_rank()
    leaves = {"a": torch.arange(12.0).reshape(3, 4) * (1 + rank % 4),
              "b": torch.linspace(-1, 1, 7) * (rank // 4 + 1)}
    collectives.reset_counts()
    out["psum"] = gathered({k: v.numpy() for k, v in
                            compress.compressed_psum_tree(
                                leaves, "pod", 5, pods).items()})
    out["psum_leaves"] = gathered({k: v.numpy() for k, v in leaves.items()})
    out["psum_counts"] = {k: dict(v) for k, v in collectives.counts.items()}
    # parameters blocked over the pod axis cannot take the compressed mean
    model = Model(get_config("tinyllama-1.1b").reduced(), device="cpu",
                  ctx=make_train_ctx(mesh))
    try:
        make_train_step(model, optimizer_for_arch("tinyllama-1.1b"),
                        compress_pod_reduce=True)
    except ValueError as err:
        out["pods_refused"] = str(err)
    return out


WORLDS = {4: four, 8: eight}


def main(argv) -> None:
    world, rank, where = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    init_distributed(rank, world, f"file://{where / 'store'}", device="cpu")
    try:
        out = WORLDS[world](where)
        if rank == 0:
            torch.save(out, where / f"{world}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
