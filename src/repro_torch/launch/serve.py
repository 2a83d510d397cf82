"""Serving entry point: batched prefill + decode with a KV / SSM cache
(port of ``repro/launch/serve.py``).

Runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it fails. Parameters are random, drawn on the
device from a seeded ``torch.Generator``: nothing is downloaded. By
default the port runs its kernels: ``--attn-impl kernel`` (the flash
attention kernel) and ``--ssd-kernel`` (the SSD intra-chunk kernel); on
the CPU those are their plain versions. ``--no-reduced`` runs the
architecture at its published widths (the reference's ``--reduced`` flag
cannot be turned off). ``--arch`` takes every registered architecture:
the dense (gemma2-2b, granite-8b, minicpm-2b, tinyllama-1.1b), MoE
(granite-moe-1b-a400m, qwen2-moe-a2.7b; the sorted capacity dispatch
above 8 experts), SSM (mamba2-780m), hybrid (jamba-1.5-large-398b),
VLM (llava-next-34b) and audio (whisper-large-v3) families. The batch
carries the frontend's embeddings from ``SyntheticTokens``: under
``--reduced`` 8 patches for the VLM, as the reference's ``serve`` gives it,
and ``encoder_seq`` frames for whisper; under ``--no-reduced`` the
pipeline's own defaults, 576 patches and 1500 frames. The cache holds a
VLM's patches too. The weights are made in place on the device, in the
config's ``param_dtype`` (qwen2-moe-a2.7b at its published widths: 53.3
GiB of float32; llava-next-34b 64.1 GiB of bfloat16; jamba-1.5-large-398b
at its 72 layers does not fit one card), and computed in float32.

Over a device mesh (``serve(mesh=...)``, no CLI flag, as ``train``'s): one
process per rank, each joined by ``launch.mesh.init_distributed`` and
passing its own device and the same mesh; the model is built under
``make_serve_ctx(mesh, global_batch=batch, big_model=...)`` (batch over
the data axes, parameters over "model", and fsdp over the data axes above
20e9 parameters, as the dry run), each rank prefills and decodes its
block of the prompts with its ``cache_specs`` block of the cache, only
rank 0 logs, and each rank returns its block of the tokens.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --no-reduced --batch 4 --prompt-len 4500 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-1b-a400m --no-reduced --batch 4 \
      --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch whisper-large-v3 --no-reduced --batch 8 --prompt-len 128 \
      --gen 64
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ModelConfig, get_config, list_archs
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticTokens, place
from repro_torch.models.attention import IMPLS
from repro_torch.models.model import Model
from repro_torch.models.sharding import ShardingCtx, make_serve_ctx
from repro_torch.train.serve_step import generate
from repro_torch.train.train_step import frontend_len


def serve(arch: str | ModelConfig = "gemma2-2b", *, reduced: bool = True,
          batch: int = 4, prompt_len: int = 32, gen: int = 16,
          temperature: float = 0.0, seed: int = 0, device="cuda",
          attn_impl: str = "kernel", use_ssd_kernel: bool = True,
          mesh=None, log_fn=print, stats=None):
    """Generate ``gen`` tokens for a (batch, prompt_len) synthetic prompt.
    ``arch`` is a registered arch or a ``ModelConfig`` (a config cut to
    fit a card). Returns the (batch, gen) tokens. ``mesh``: serve over
    it, this process one of its ranks, on ``device`` (its own card, from
    ``launch.mesh.init_distributed``); the tokens are then this rank's
    rows. ``stats``, where given, receives the
    wall seconds, ``logits_finite`` and, on the GPU, ``prefill_ms`` and
    ``decode_ms_per_token`` (CUDA events) and ``peak_bytes``
    (``torch.cuda.max_memory_allocated`` from the model's construction to
    the last token)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the allocator keeps statistics once CUDA is up (a rank's first
        # call may come before any other)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    ctx = ShardingCtx()
    if mesh is not None:
        ctx = make_serve_ctx(mesh, global_batch=batch,
                             big_model=cfg.total_params() > 20e9)
        if dist.get_rank() != 0:
            log_fn = _quiet
    vlm = cfg.frontend == "vision_patches"
    data = SyntheticTokens(cfg, batch, prompt_len, seed=seed, mode="bigram",
                           frontend_seq=8 if vlm and reduced else 0)
    b = place(data.batch(0), ctx, dev)
    b["tokens"] = b["tokens"][:, :prompt_len]
    # the cache holds a VLM's patches before the prompt
    max_cache = frontend_len(cfg, b) + prompt_len + gen + 64
    model = Model(cfg, device=dev, attn_impl=attn_impl,
                  use_ssd_kernel=use_ssd_kernel, max_seq=max_cache, ctx=ctx)
    model.init_params(torch.Generator(device=dev).manual_seed(seed))
    timings = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    out = generate(model, b, steps=gen, max_cache_len=max_cache,
                   temperature=temperature,
                   generator=torch.Generator(device=dev).manual_seed(seed),
                   timings=timings)
    out = out.cpu()
    dt = time.monotonic() - t0
    log_fn(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
           f"({out.numel() / dt:.1f} tok/s)")
    if "prefill_ms" in timings:
        log_fn(f"prefill {timings['prefill_ms']:.3f} ms, decode "
               f"{timings['decode_ms_per_token']:.3f} ms/token "
               f"(CUDA events, {torch.cuda.get_device_name(dev)})")
    if stats is not None:
        stats.update(timings, seconds=dt)
        if dev.type == "cuda":
            stats["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _quiet(*_):
    pass


def main(argv=None, stats=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced smoke-test config (default) or, with "
                         "--no-reduced, the published widths")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the GPU (default; fails without one) or "
                         "the CPU")
    ap.add_argument("--attn-impl", default="kernel", choices=IMPLS,
                    help="attention for full sequences: the flash kernel "
                         "(default), or the dense / blocked / auto plain "
                         "versions")
    ap.add_argument("--ssd-kernel", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the SSD intra-chunk kernel (default) or the plain "
                         "chunked scan")
    args = ap.parse_args(argv)
    return serve(args.arch, reduced=args.reduced, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen,
                 temperature=args.temperature, seed=args.seed,
                 device=args.device, attn_impl=args.attn_impl,
                 use_ssd_kernel=args.ssd_kernel, stats=stats)


if __name__ == "__main__":
    main()
