"""Training entry point: LM training on synthetic data (port of
``repro/launch/train.py``).

Runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it fails. Parameters are random, drawn on the
device from a seeded ``torch.Generator``; data is ``SyntheticTokens``
(bigram chains). Attention runs the flash kernels (``--attn-impl
kernel``, the default and the only value taken on the GPU: the forward
kernel and, through autograd, the backward kernel; on the CPU their plain
versions, or with ``dense`` / ``blocked`` / ``auto`` the plain attention
of ``models/attention.py``, as the port's ``serve``). ``--full`` runs the
architecture at its published widths. The SSM family (mamba2) trains
through the plain chunked scan on either device, as the reference does
(``Model(use_ssd_kernel=False)``): the SSD kernel has no backward, and its
wrapper refuses CUDA inputs that need a gradient.

Checkpoints (``--ckpt-dir``) hold the reference's state keys and layout
(``params``, ``opt/{m,v,step}``, parameters stacked over periods), and a
run resumes from the latest one.

Over a device mesh (``train(mesh=...)``, no CLI flag, as the reference's):
one process per rank, each joined by ``launch.mesh.init_distributed`` and
passing its own device and the same mesh; the model, parameters and AdamW
moments are each rank's blocks (``make_train_ctx(mesh)``: fsdp over the
data axes, tensor parallelism over "model"), each rank trains on its block
of every batch (``data.pipeline.place``), only rank 0 logs and writes the
checkpoint (gathered whole, the one-rank format), and on resume every rank
takes its blocks of it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --full --steps 8 --batch 4 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      --full --steps 8 --batch 2 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 20 --batch 4 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, list_archs
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticTokens, place
from repro_torch.models.attention import IMPLS
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model
from repro_torch.models.sharding import (ShardingCtx, gather_params,
                                         make_train_ctx, take_blocks)
from repro_torch.train.optimizer import optimizer_for_arch
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          train_rng)


def _to_checkpoint(cfg, state, model: Model) -> dict:
    """The train state as the reference's checkpoint tree (numpy has no
    bfloat16: moments are written as float32); over a mesh gathered whole
    from every rank's blocks (every rank must call it)."""
    opt = state["opt"]

    def tree(leaves):
        whole = gather_params(leaves, model.layouts, model.ctx)
        return params_to_numpy(cfg, {n: t.float() for n, t in whole.items()})
    return {"params": tree(state["params"]),
            "opt": {"m": tree(opt["m"]), "v": tree(opt["v"]),
                    "step": opt["step"]}}


def _from_checkpoint(cfg, model: Model, restored, moment_dtype,
                     seed: int) -> dict:
    def blocks(tree):
        return take_blocks(params_from_numpy(cfg, tree), model.layouts,
                           model.ctx)

    model.load_state_dict(blocks(restored["params"]), strict=True)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    md = getattr(torch, moment_dtype)
    opt = {key: {n: t.to(device=params[n].device, dtype=md)
                 for n, t in blocks(restored["opt"][key]).items()}
           for key in ("m", "v")}
    step = int(restored["opt"]["step"])
    opt["step"] = torch.as_tensor(step, dtype=torch.int32,
                                  device=model.device)
    return {"params": params, "opt": opt,
            "rng": train_rng(seed, step).to(model.device)}


def train(arch: str = "tinyllama-1.1b", *, reduced: bool = True,
          steps: int = 200, batch: int = 8, seq: int = 128,
          lr: float = 1e-3, microbatches: int = 1,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          resume: bool = True, mesh=None, log_every: int = 10,
          seed: int = 0, device="cuda", attn_impl: str = "kernel",
          log_fn=print, stats: Optional[dict] = None):
    """Train ``steps`` steps; returns (state, history of the logged
    steps). ``mesh``: train over it, this process one of its ranks, on
    ``device`` (its own card, from ``launch.mesh.init_distributed``).
    ``stats``, where given, receives every
    step's ``loss``, ``grad_norm``, ``lr`` and MoE load-balance ``aux`` (0
    without MoE layers; lists of floats, read once after the loop),
    ``step_ms`` (each step's wall time, the device synchronised at its
    end; the first includes the kernels' build and warm-up) and, on the
    GPU, ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over the
    run)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if torch.device(device).type == "cuda" and attn_impl != "kernel":
        raise ValueError(
            f"attn_impl={attn_impl!r} would run plain attention on the GPU; "
            f"training on the GPU takes attn_impl='kernel' (the flash "
            f"kernels), the others run on the CPU only")
    dev = resolve_device(device)
    ctx = make_train_ctx(mesh) if mesh is not None else ShardingCtx()
    if mesh is not None and dist.get_rank() != 0:
        log_fn = _quiet
    model = Model(cfg, device=dev, attn_impl=attn_impl,
                  use_ssd_kernel=False, max_seq=seq + 8, ctx=ctx)
    opt_cfg = optimizer_for_arch(arch, lr=lr,
                                 warmup_steps=max(steps // 20, 5),
                                 total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches)
    data = SyntheticTokens(cfg, batch, seq, seed=seed, mode="bigram",
                           frontend_seq=16 if cfg.frontend == "vision_patches"
                           else 0)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None

    state, start = None, 0
    if ckpt and resume:
        restored = ckpt.restore()
        if restored is not None:
            state = _from_checkpoint(cfg, model, restored,
                                     opt_cfg.moment_dtype, seed)
            start = int(state["opt"]["step"])
            log_fn(f"resumed from step {start}")
    if state is None:
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed),
            opt_cfg.moment_dtype)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history, step_ms, per_step = [], [], []
    t0 = time.monotonic()
    for i in range(start, steps):
        b = place(data.batch(i), ctx, dev, microbatches)
        ts = time.perf_counter()
        state, metrics = step_fn(state, b)
        if stats is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - ts) * 1e3)
            per_step.append({k: metrics[k] for k in
                             ("loss", "grad_norm", "lr", "aux")})
        if (i + 1) % log_every == 0 or i == steps - 1:
            rec = {"step": i + 1, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "tok_per_s": (i + 1 - start) * batch * seq
                   / (time.monotonic() - t0)}
            history.append(rec)
            log_fn(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                   f"gnorm {rec['grad_norm']:.2f} lr {rec['lr']:.2e} "
                   f"tok/s {rec['tok_per_s']:.0f}")
        if ckpt and (i + 1) % ckpt_every == 0:
            _save(ckpt, _to_checkpoint(cfg, state, model), i + 1, mesh)
    if ckpt:
        _save(ckpt, _to_checkpoint(cfg, state, model), steps, mesh)
        ckpt.wait()
    if stats is not None:
        for key in ("loss", "grad_norm", "lr", "aux"):
            stats[key] = [float(m[key]) for m in per_step]
        stats["step_ms"] = step_ms
        if dev.type == "cuda":
            stats["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return state, history


def _quiet(*_):
    pass


def _save(ckpt, tree, step, mesh):
    """Save ``tree`` at ``step`` (asynchronously); over a mesh rank 0
    writes it and every rank waits for the write, so a later restore on
    any rank finds it."""
    if mesh is None:
        ckpt.save(tree, step=step)
        return
    if dist.get_rank() == 0:
        ckpt.save(tree, step=step)
        ckpt.wait()
    dist.barrier()


def main(argv=None, stats=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published widths (default: the reduced "
                         "smoke-test config)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the GPU (default; fails without one) or "
                         "the CPU")
    ap.add_argument("--attn-impl", default="kernel", choices=IMPLS,
                    help="attention: the flash kernels (default; the only "
                         "value on the GPU), or on the CPU the dense / "
                         "blocked / auto plain versions")
    args = ap.parse_args(argv)
    return train(args.arch, reduced=args.reduced, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                 device=args.device, attn_impl=args.attn_impl, stats=stats)


if __name__ == "__main__":
    main()
