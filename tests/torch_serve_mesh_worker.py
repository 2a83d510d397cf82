"""One rank of the port's mesh-serving tests
(``tests/test_torch_serve_mesh.py``), and the runs those tests hold it
against.

Every rank of a gloo process group on the CPU runs every scenario of its
world; rank 0 saves what the tests compare (``<dir>/<world>.pt``). A
scenario prefills a batch of prompts and decodes greedily (or samples)
from the port's own initialisation (seed 0, each rank drawing what one
rank draws and keeping its blocks) under ``make_serve_ctx``; the tests
rebuild the same inputs and the one-rank run with this module's ``run``.
This module imports the port only, never JAX.

    python tests/torch_serve_mesh_worker.py WORLD RANK DIR
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import collectives
from repro_torch.data.pipeline import place
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.model import Model
from repro_torch.models.sharding import ShardingCtx, make_serve_ctx
from repro_torch.serve.batching import ContinuousBatcher
from repro_torch.train.serve_step import (make_decode_step,
                                          make_prefill_step)
from repro_torch.train.train_step import frontend_len

# a vocab whose real columns reach both tp blocks of the padded 2048
WIDE_VOCAB = 1500


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One serving run: reduced ``arch`` with ``cfg_kw`` replaced, a
    (batch, prompt) prompt, ``steps`` decode steps, ``cache`` slots."""
    arch: str
    batch: int = 4
    prompt: int = 16
    steps: int = 4
    cache: int = 24
    cfg_kw: tuple = ()
    model_kw: tuple = ()
    big_model: bool = False
    temperature: float = 0.0


SCENARIOS = {
    # the prompt wraps gemma2's 16-slot ring (local layers), and both its
    # ring and its 32-slot global caches split their slots over tp
    "gemma2": Scenario("gemma2-2b", prompt=24, cache=32),
    # argmax across the two vocab blocks
    "tinyllama": Scenario("tinyllama-1.1b",
                          cfg_kw=(("vocab_size", WIDE_VOCAB),)),
    # one kv head (every rank reads it whole), 3 heads (attention whole on
    # every tp rank): every rank's cache holds all kv heads
    "mqa": Scenario("tinyllama-1.1b", cfg_kw=(("num_kv_heads", 1),)),
    "odd_heads": Scenario("tinyllama-1.1b", cfg_kw=(("num_heads", 3),
                                                    ("num_kv_heads", 1))),
    # 25 slots do not split over tp 2: the cache's sequence is replicated
    "odd_slots": Scenario("tinyllama-1.1b", cache=25),
    # fsdp over the data axis as well (the serve context above 20e9
    # parameters)
    "fsdp": Scenario("tinyllama-1.1b", big_model=True),
    # temperature sampling: every rank draws one rank's tokens
    "sample": Scenario("tinyllama-1.1b", temperature=1.0,
                       cfg_kw=(("vocab_size", WIDE_VOCAB),)),
    # the production dispatch, dropless (capacity E/k: every token's
    # choices fit), experts split over tp
    "moe": Scenario("granite-moe-1b-a400m",
                    model_kw=(("moe_impl", "sorted"),
                              ("moe_capacity_factor", 4.0))),
    "whisper": Scenario("whisper-large-v3"),
    "mamba2": Scenario("mamba2-780m"),
    # a patch prefix counted in the positions
    "llava": Scenario("llava-next-34b", cache=32),
    # batch 1 below the data size: the batch replicated, the attention
    # cache's slots over data and model
    "jamba": Scenario("jamba-1.5-large-398b", batch=1,
                      model_kw=(("moe_impl", "sorted"),
                                ("moe_capacity_factor", 4.0))),
}
WORLD_SCENARIOS = {4: tuple(SCENARIOS), 8: ("gemma2", "jamba")}


def config(sc: Scenario):
    return dataclasses.replace(get_config(sc.arch).reduced(),
                               **dict(sc.cfg_kw))


def inputs(sc: Scenario) -> dict:
    """The prompts (numpy, seeded) and, where the arch has a frontend, its
    embeddings (8 VLM patches, ``encoder_seq`` whisper frames, N(0, 0.02)),
    as the reference's smoke tests shape them."""
    cfg = config(sc)
    rs = np.random.default_rng(5)
    out = {"tokens": rs.integers(0, cfg.vocab_size, (sc.batch, sc.prompt)
                                 ).astype(np.int32)}
    n = (8 if cfg.frontend == "vision_patches"
         else cfg.encoder_seq if cfg.is_encoder_decoder else 0)
    if n:
        out["frontend_embeds"] = (rs.standard_normal(
            (sc.batch, n, cfg.d_model)) * 0.02).astype(np.float32)
    return out


@contextlib.contextmanager
def recorded_routes():
    """The expert choices and top-k margins of every router call under
    it, in call order."""
    seen = []
    router = MOE.router_topk

    def record(cfg, w, x, ctx=None):
        out = router(cfg, w, x, ctx)
        probs = torch.softmax(x.float() @ w.float(), -1)
        top = probs.topk(cfg.experts_per_token + 1, -1).values
        seen.append((out[0].clone(), (top[..., -2] - top[..., -1]).clone()))
        return out

    MOE.router_topk = record
    try:
        yield seen
    finally:
        MOE.router_topk = router


def whole_rows(x, ctx, n):
    """``x`` (this rank's rows over dp) gathered whole over dp."""
    return ctx.gather(x, n, ctx.live(ctx.dp), 0) if ctx.live(ctx.dp) else x


def run(name: str, mesh=None) -> dict:
    """Scenario ``name`` over ``mesh`` (one rank without one): the whole
    batch's tokens, prefill and decode logits (B, steps, V), the routes
    (whole over dp), the collective counts and, as this rank holds them,
    the cache leaves after the last step and the model's parameters
    (whole, from seed 0)."""
    sc = SCENARIOS[name]
    cfg = config(sc)
    ctx = (ShardingCtx() if mesh is None else
           make_serve_ctx(mesh, global_batch=sc.batch,
                          big_model=sc.big_model))
    model = Model(cfg, device="cpu", max_seq=sc.cache, attn_impl="kernel",
                  use_ssd_kernel=True, ctx=ctx, **dict(sc.model_kw))
    model.init_params(torch.Generator().manual_seed(0))
    batch = place(inputs(sc), ctx, "cpu")
    prefill = make_prefill_step(model, sc.cache)
    decode = make_decode_step(model, temperature=sc.temperature)
    gen = torch.Generator().manual_seed(1)
    collectives.reset_counts()
    with recorded_routes() as routes:
        tok, logits, cache = prefill(batch)
        out_logits, out_tok = [logits[:, -1]], [tok[:, None]]
        cur, pos = tok[:, None], sc.prompt + frontend_len(cfg, batch)
        for i in range(sc.steps):
            cur, logits, cache = decode(cache, cur, pos + i, gen)
            out_logits.append(logits[:, -1])
            out_tok.append(cur)
    counts = {k: dict(v, ops=dict(v["ops"]))
              for k, v in collectives.counts.items()}
    logits = torch.stack(out_logits, 1)
    if model.logits_block() is not None:
        logits = ctx.gather(logits, cfg.padded_vocab, ctx.tp, 2)
    return {
        "tokens": whole_rows(torch.cat(out_tok, 1), ctx, sc.batch).numpy(),
        "logits": whole_rows(logits, ctx, sc.batch).numpy(),
        "routes": [(whole_rows(r, ctx, sc.batch).numpy(),
                    whole_rows(m, ctx, sc.batch).numpy())
                   for r, m in routes],
        "counts": counts,
        "cache": _numpy(cache),
        "coord": ([] if mesh is None else
                  [int(c) for c in mesh.get_coordinate()]),
    }


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy().copy()


def gathered(value) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def four(mesh) -> dict:
    out = {}
    for name in WORLD_SCENARIOS[4]:
        got = run(name, mesh)
        got["caches"] = gathered((got.pop("coord"), got.pop("cache")))
        out[name] = got
    # serve(mesh=) (rank 0 logs; each rank returns its rows)
    log = []
    toks = serve_cli.serve("gemma2-2b", batch=4, prompt_len=20, gen=5,
                           device="cpu", mesh=mesh, log_fn=log.append)
    out["serve"] = {"tokens": gathered(toks.numpy()), "log": gathered(log)}
    # the continuous batcher stays on one rank
    try:
        ContinuousBatcher(Model(get_config("gemma2-2b").reduced(),
                                device="cpu", ctx=make_serve_ctx(
                                    mesh, global_batch=4)))
    except NotImplementedError as err:
        out["batcher_refused"] = str(err)
    return out


def eight(mesh) -> dict:
    out = {}
    for name in WORLD_SCENARIOS[8]:
        got = run(name, mesh)
        got["caches"] = gathered((got.pop("coord"), got.pop("cache")))
        out[name] = got
    return out


def main(argv) -> None:
    world, rank, where = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    init_distributed(rank, world, f"file://{where / 'store'}", device="cpu")
    try:
        if world == 4:
            out = four(make_local_mesh(2, 2, device="cpu"))
        else:
            from torch.distributed.device_mesh import init_device_mesh
            out = eight(init_device_mesh(
                "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model")))
        if rank == 0:
            torch.save(out, where / f"{world}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
