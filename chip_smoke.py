#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right and runs its main
paths on the card.

    python3 chip_smoke.py            # from the root of a checkout

Six main paths: the GA loop (``repro_torch.launch.ga_run``), LM
serving (``repro_torch.launch.serve``: prefill + decode), LM training
(``repro_torch.launch.train``: tinyllama-1.1b at its published widths,
flash attention forward and backward kernels), the paper's HVDC
dispatch (``ga_run --fitness hvdc``: batched AC Newton power flow on the
German-size grid) and the paper's decoupled simulation backend
(``ga_run --dispatch-backend host-thread|host-process``: fitness on a
host pool, the learned cost model) with its §4.1 overhead study (rho,
``delay_proxy`` through the delay chain kernel), and the paper's central
message broker (``ga_run --dispatch-backend mq|mq-mock|mq-net|slurm-mock|
k8s-mock``: the port's queue runtime and workers). Phases, in order; any
failure exits non-zero:

1. card:   the GPU's name and power limit, as nvidia-smi reports them;
2. build:  every CUDA kernel of the port (fused variation, flash attention
           forward and backward, SSD intra-chunk, delay chain), compiled
           from this
           checkout's sources for
           sm_90a (one nvcc per source, all started together); ptxas's
           entry, register and spill lines of every compiled kernel;
3. check:  each kernel against its plain PyTorch version on the card: the
           fused variation at the reference's test shapes, a
           hyperparameter sweep, the GA main path's shape (ga_run's and
           the paper's Table 3 hyperparameters) and its template edges
           (float4 and scalar-load templates, unaligned parents,
           per-gene bounds, all and no pair-genes crossing), and one
           generation on the card against the same generation on the CPU;
           flash attention at tests/test_kernels.py's cases, a q_offset
           case with fully masked rows and gemma2-2b's layer shapes
           (float32 3e-5, bfloat16 2e-2); the SSD kernel and the whole
           chunked scan at the reference's cases and mamba2-780m's shapes
           (1e-4); the fused variation at the HVDC runs' shapes (2, 16 and
           8, 18); the HVDC fitness on the card against the same code on
           the CPU (LAPACK's LU) for four genomes at the tests' 60-bus grid
           (8 contingencies, full AC and screened to 4 and 12) and at the
           German grid's base case (vm, va 1e-4; iters and converged exact; the
           screened lists exact past their islanding head; objectives
           1e-4 on converged lanes), an
           islanding outage that reads 10.0 without raising, and TF32 off;
           the flash backward kernel (autograd through the wrapper) against
           its plain version (dq, dk, dv at 1e-3 / 1e-4) at the tests'
           float32 cases (the bf16 one must be refused), the fully masked
           rows (zero dq), tinyllama-1.1b's layer shape at batch 1 and 4
           (at batch 4 two more calls, and one in one-key-tile chunks,
           must give the same bits) and gemma2-2b's (1, 4500, 8, 4, 256)
           with softcap 50, window 4096 and global; tinyllama-1.1b's
           layer at (1, 16384) within the scratch budget, bit-equal to one
           launch with none and its peak memory under the budget plus its
           outputs; one train step of reduced tinyllama-1.1b and
           gemma2-2b on the card against the CPU; the delay chain kernel
           against its plain version (rtol 1e-6) at N = 1, 33, 32768
           lanes with 0, 1, 1000 and [0, 20000] steps and at (32768,
           20000), delay_proxy(sphere) bit-equal to sphere; the host pool
           on a main-shape population on the card, bit-equal to
           fitness.hostsim.rastrigin in row order (identity, padded
           balanced dispatch, CostEMA); the broker's padded dispatch
           (cost model, 4 lanes) through each queue backend (slurm-mock,
           k8s-mock, mq on threads and on subprocesses, self-contained
           mq-net) on card genomes of (29, 5) and (32768, 128), bit-equal
           to hostsim.sphere / hostsim.rastrigin, padding and balance as
           the broker reports them, and the spawned workers' command
           lines naming the port's modules;
4. main:   ``python -m repro_torch.launch.ga_run --fitness rastrigin`` at
           I=32 islands x P=1024 individuals x G=128 genes, 5 generations x
           3 epochs, then again with --sync-every 2 --pipeline-depth 2,
           which must give the bit-identical best genome; then
           ``python -m repro_torch.launch.serve --no-reduced`` on gemma2-2b
           (batch 4, prompt 4500 > its 4096 window, 32 tokens) and
           mamba2-780m (batch 4, prompt 4000, 32 tokens): random weights
           from a seed, every logit finite, the flash kernel launched 26
           times (one per layer) in gemma2's prefill and the SSD kernel 48
           times in mamba2's; ``python -m repro_torch.launch.train
           --arch tinyllama-1.1b --full --steps 8 --batch 4 --seq 2048``:
           random weights from a seed, bigram data, exactly 22 x 8 flash
           forward and 22 x 8 backward launches, every loss and grad norm
           finite, the last loss below the first; ``ga_run --fitness hvdc
           --grid-size 2715 --hvdc-lines 18 --islands 2 --gens-per-epoch 2
           --epochs 2 --num-workers 4``, horizontal (--pop 16) and
           vertical (--pop 8 --contingencies 8: full AC on 8 outages per
           genome), each
           launching the fused variation exactly 4 times, with finite
           fitness and genomes in [-1, 1]; ``ga_run --fitness rastrigin``
           at the main shape under --dispatch-backend host-thread,
           host-process and host-thread --sync-every 2 --pipeline-depth 2
           (4 workers; 15 launches each, a ``dispatch stats: retries=0``
           line, fitness bit-equal to hostsim.rastrigin, the same best
           genome in all three) and ``ga_run --fitness hvdc`` on the
           German-size grid under host-thread --cost-ema (one epoch of 2
           generations: 2 launches, retries=0, CostEMA updates > 0);
           ``ga_run --fitness rastrigin`` at the main shape under
           --dispatch-backend mq --mq-fleet local, mq-mock (with
           --cost-ema --metrics-dir --events-log), mq-net, slurm-mock and
           k8s-mock (4 workers; 15 launches each, retries=0, fitness
           bit-equal to hostsim.rastrigin, the best genome bit-identical
           to host-thread's; the broker's tasks/, claimed/ and runs/
           empty after, the spool pruned to --keep-jobs; the mq-mock
           run's chambga.prom parsed, its
           dispatch_chunk_duration_seconds count equal to the chunks
           dispatched). Every run has the launch counts zeroed just
           before it and read just after;
5. times:  with CUDA events, medians of repeats: each kernel beside its
           bound and its plain version. The fused variation at the main
           shape at three points (no crossover or mutation, so no powf
           runs; ga_run's; Table 3's), both templates, Table 3 at the
           HVDC gene count G = 18, and the host µs per wrapper call. The flash and
           SSD kernels run their products as 3xTF32 on the tensor cores:
           their bound is at the TF32 rate (three products per float32
           product), and the share of the float32 SIMT bound is printed
           beside it. Flash is also timed
           like for like beside PyTorch's scaled_dot_product_attention
           (causal, global, softcap 0, the same tensors; the fastest
           backend that computes that function in float32), a yardstick
           the port never calls. Then one GA generation phase by phase,
           GA epochs, and prefill ms, decode ms/token and tokens/s of each
           served model; the training run's step ms (median of steps 2-8),
           tokens/s and peak device memory, the flash backward (its
           wrapper's row sum and its two kernels) at tinyllama-1.1b's training
           shape and gemma2-2b's beside its bound (10 hd FLOP per visible
           pair and head), its plain version and, at tinyllama's, the
           backward of SDPA's fastest float32 backend, and the forward
           with and without its lse output, in turns; one HVDC generation
           phase by phase, the batched
           LU (torch.linalg.solve_ex at (B, 5430, 5430), B = 1 and 16)
           beside its float32 bound, one Newton solve per system and its
           LU share, evaluations/s and power-flow solves/s of each HVDC
           run's population, the share of LU work on converged lanes, and
           each HVDC run's peak device memory; rho (paper eq. 1,
           T_eval / T_epoch, as benchmarks/efficiency.py measures it) at
           Fig. 4's six (workers, iters) points and at the main shape
           (20k steps, 4 workers; the delay kernel's launches there
           counted from zero); the delay kernel at (32768, 20000) beside
           its operations bound and the latency floor of its dependent
           chain, read from its SASS; one main-shape generation phase by
           phase under inline, host-thread and host-process, the host
           backends' fitness split into device->host copy, host
           evaluation and host->device copy; CostEMA's first vs learned
           dispatch (n 64, w 8, delay_sphere); one main-shape generation
           under each queue backend phase by phase, its fitness split
           into device->host, enqueue or spool write, wait, collect and
           host->device; one task's round trip over the file and the
           socket broker (median of 30); an mq dispatch with the metrics
           bus off and on;
6. trace:  one prefill and 8 decode steps of each served model, and one
           train step of the training path, under torch.profiler: the
           device's idle share and the kernels' share of each window and
           the largest device entries, read from the trace; in the train
           step each flash kernel's ms per launch (a flash kernel missing
           from FLASH_SYMBOLS fails the run);
7. the ``{"kernels": [...]}`` line (five kernels), the card line, and last
   the result line ``{"ok": true, "device": {...}}``.

Without a GPU, or outside a checkout, it exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package ``repro``.
"""
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN = dict(islands=32, pop=1024, genes=128, gens_per_epoch=5, epochs=3)
MAIN_ARGS = ["--fitness", "rastrigin", "--genes", str(MAIN["genes"]),
             "--islands", str(MAIN["islands"]), "--pop", str(MAIN["pop"]),
             "--gens-per-epoch", str(MAIN["gens_per_epoch"]),
             "--epochs", str(MAIN["epochs"]), "--device", "cuda"]
# main-path hyperparameters (launch/ga_run.py::build), and the paper's
# Table 3 point, which its HVDC runs use (repro/launch/ga_run.py:222-223)
HP = dict(eta_cx=15.0, prob_cx=0.9, eta_mut=20.0, prob_mut=0.7)
TABLE3 = dict(eta_cx=97.5, prob_cx=1.0, eta_mut=34.6, prob_mut=0.7)
BOUND = 5.12
# tolerances of tests/test_kernels.py for the genetic kernel
TOL, SWEEP_TOL = (1e-5, 1e-6), (1e-4, 1e-5)
TEST_SHAPES = [(16, 4), (64, 18), (130, 33), (256, 128)]
# the fused variation's templates and edges, each held against the plain
# version at TOL: (rows, genes, kernel_args options, floats per load of the
# template the launcher must pick: 4 where G % 4 == 0 and every stream is
# 16-byte aligned, else 1)
VARIATION_EDGES = [
    (2048, 4, {}, 4), (2048, 33, {}, 1), (2048, 128, {}, 4),
    (2048, 128, dict(unaligned=True), 1), (2048, 4, dict(unaligned=True), 1),
    (2048, 128, dict(hp=TABLE3), 4), (2048, 33, dict(hp=TABLE3), 1),
    (2048, 18, dict(hp=TABLE3), 1),
    (2048, 128, dict(per_gene=True), 4), (2048, 33, dict(per_gene=True), 1),
    (2048, 128, dict(cross="all", hp=dict(HP, indpb=0.4)), 4),
    (2048, 33, dict(cross="all", hp=dict(HP, indpb=0.4)), 1),
    (2048, 128, dict(cross="none", hp=dict(HP, indpb=0.4)), 4)]
# the kernel timed at (I, P) of the main shape at three points: no
# crossover and no mutation (no powf runs: the layout's memory floor),
# ga_run's point and Table 3's; the first two again with unaligned
# parents, which take the scalar-load template; and Table 3 at G = 18,
# the HVDC genome (repro/powerflow/grid.py: n_hvdc), which takes the
# scalar-load template too (name: (genes, hyperparameters, kernel_args
# options))
NO_POWF = dict(HP, prob_cx=0.0, prob_mut=0.0)
HVDC_GENES = 18
VARIATION_POINTS = {"no_powf": (MAIN["genes"], NO_POWF, {}),
                    "ga_run": (MAIN["genes"], HP, {}),
                    "table3": (MAIN["genes"], TABLE3, {}),
                    "no_powf_scalar": (MAIN["genes"], NO_POWF,
                                       dict(unaligned=True)),
                    "ga_run_scalar": (MAIN["genes"], HP,
                                      dict(unaligned=True)),
                    "table3_g18": (HVDC_GENES, TABLE3, {})}
# HVDC dispatch path (``ga_run --fitness hvdc``): the tests' 60-bus grid
# and its islanding line 11 (it cuts bus 36, of degree 1, loose); the
# German-size runs (--grid-size 2715 builds 2715 buses, 5348 lines, 18
# HVDC lines; population and depth are the cuts), horizontal and vertical
# (full AC on 8 outages per genome)
HVDC_SMALL = dict(n_bus=60, n_line=110, n_gen=15, n_hvdc=4, seed=1)
HVDC_BRIDGE = 11
HVDC_TOL, HVDC_PF_ATOL = (1e-4, 1e-4), 1e-4
HVDC_BUSES, HVDC_EPOCHS = 2715, 2
HVDC_GENS = 2 * HVDC_EPOCHS          # generations per epoch x epochs
HVDC_ARGS = ["--fitness", "hvdc", "--grid-size", str(HVDC_BUSES),
             "--hvdc-lines", str(HVDC_GENES), "--islands", "2",
             "--gens-per-epoch", str(HVDC_GENS // HVDC_EPOCHS),
             "--epochs", str(HVDC_EPOCHS), "--num-workers", "4",
             "--device", "cuda"]
HVDC_RUNS = {"horizontal": ["--pop", "16"],
             "vertical": ["--pop", "8", "--contingencies", "8"]}
HVDC_SOLVE_BATCHES = (1, 16)
# the decoupled host backend: the GA main path under host-thread,
# host-process and host-thread pipelined (fitness.hostsim's numpy
# rastrigin on HOST_WORKERS workers; the three must give the same best
# genome), and HVDC on the German-size grid under host-thread with the
# learned cost model (one epoch of two generations); the host pool's
# padded dispatch check runs over HOST_PAD_WORKERS (32768 % 6 != 0)
HOST_WORKERS, HOST_PAD_WORKERS = 4, 6
HOST_ARGS = ["--num-workers", str(HOST_WORKERS)]
HOST_RUNS = {
    "host-thread": ["--dispatch-backend", "host-thread"] + HOST_ARGS,
    "host-process": ["--dispatch-backend", "host-process"] + HOST_ARGS,
    "host-thread pipelined": ["--dispatch-backend", "host-thread"] + HOST_ARGS
    + ["--sync-every", "2", "--pipeline-depth", "2"]}
HVDC_HOST_GENS = 2
HVDC_HOST_ARGS = ["--fitness", "hvdc", "--grid-size", str(HVDC_BUSES),
                  "--hvdc-lines", str(HVDC_GENES), "--islands", "2",
                  "--pop", "16", "--gens-per-epoch", str(HVDC_HOST_GENS),
                  "--epochs", "1", "--dispatch-backend", "host-thread",
                  "--cost-ema", "--device", "cuda"] + HOST_ARGS
# the §4.1 delay chain kernel: checked at N lanes x fixed counts, and at
# counts drawn in [0, DELAY_HETERO_MAX]; timed at DELAY_MAIN (lanes,
# steps), the main shape's population at Fig. 4's 20k steps. A step is
# sinf, a multiply and an add: 3 float32 operations, sinf counted as one
# (as kernel 1's powf); the latency floor charges each dependent SASS
# instruction of a step DEP_CYCLES, the fixed latency of Hopper's
# arithmetic pipes
DELAY_NS, DELAY_ITERS, DELAY_HETERO_MAX = (1, 33, 32768), (0, 1, 1000), 20000
DELAY_MAIN = (MAIN["islands"] * MAIN["pop"], 20000)
DELAY_RTOL = 1e-6
DELAY_OPS_PER_STEP, DEP_CYCLES = 3, 4
# rho (paper eq. 1) as benchmarks/efficiency.py measures it: Fig. 4's
# (workers, iters) at the reference's GA, and the main shape at 20k steps
# over 4 workers (the main path's GA, 2 epochs of 5 generations)
FIG4_POINTS = [(1, 20000), (4, 20000), (16, 20000), (16, 100000),
               (16, 400000), (64, 20000)]
FIG4_GA = dict(islands=4, pop=32, genes=4, generations=3, epochs=2,
               fused=False)
RHO_MAIN, RHO_MAIN_EPOCHS = (4, 20000), 2
# the learned cost model's first vs learned dispatch
# (benchmarks/broker_overhead.py:150-180)
EMA_DISPATCH = dict(n=64, w=8, slow_s=0.002, genes=6)
# the paper's central message broker: the queue backends. check: the
# broker's padded dispatch over QUEUE_WORKERS on card genomes of
# QUEUE_CHECK_SHAPES (rows, genes, hostsim simulator) through each of
# QUEUE_KINDS; main: ga_run rastrigin at the main shape under each of
# QUEUE_RUNS (the same depth as HOST_RUNS, so its best genome is held
# bit for bit against host-thread's), QUEUE_METRICS_RUN with the metrics
# bus on; times: one main-shape generation per kind, and the transport
# round trip (enqueue -> claim -> lease -> publish -> fetched, median of
# QUEUE_LATENCY_REPS, as benchmarks/broker_overhead.py's
# *_result_latency rows) of the file and socket brokers
QUEUE_WORKERS = 4
QUEUE_KINDS = ("slurm-mock", "k8s-mock", "mq thread", "mq subprocess",
               "mq-net")
QUEUE_CHECK_SHAPES = ((29, 5, "sphere"),
                      (MAIN["islands"] * MAIN["pop"], MAIN["genes"],
                       "rastrigin"))
QUEUE_RUNS = {
    "mq --mq-fleet local": ["--dispatch-backend", "mq", "--mq-fleet",
                            "local"],
    "mq-mock": ["--dispatch-backend", "mq-mock"],
    "mq-net": ["--dispatch-backend", "mq-net"],
    "slurm-mock": ["--dispatch-backend", "slurm-mock"],
    "k8s-mock": ["--dispatch-backend", "k8s-mock"]}
QUEUE_METRICS_RUN = "mq-mock"
QUEUE_LATENCY_REPS, QUEUE_METRICS_REPS = 30, 5
# host time of a wrapper call: mean over this many calls, one sync at the
# end, at the main shape and at a small one where the device keeps up
HOST_CALLS = 1000
HOST_SMALL = (1, 16, 4)
# the busy-wait (GPU clock cycles, ~2 ms) that device_ms queues its calls
# behind
SLEEP_CYCLES = 1 << 22

# Peak rates from NVIDIA's data sheets (dense, at the full 700 W limit):
# memory bytes/s, float32 operations/s outside the tensor cores, and TF32
# tensor-core operations/s.
PEAKS = {"H200": (4.8e12, 67e12, 495e12), "H100": (3.35e12, 67e12, 495e12)}
# the flash and SSD kernels issue each float32 product as three TF32
# tensor-core products (3xTF32, src/repro_torch/kernels/csrc/mma_tf32.cuh)
TF32_PRODUCTS = 3
# LM serving path: (arch, prompt length, kernel launches of its run, one
# prefill: gemma2-2b's 26 attention layers, mamba2-780m's 48 SSD layers)
SERVE_RUNS = [("gemma2-2b", 4500, {"flash_attention": 26}),
              ("mamba2-780m", 4000, {"ssd_chunk": 48})]
SERVE_BATCH, SERVE_GEN = 4, 32
# decode steps in each traced decode window; the device symbols of the
# port's kernels, as they appear in a trace: the flash forward, then the
# backward's two kernels (flash_attention_bwd.cu: dk, dv and dq partials;
# the partials' sum)
TRACE_DECODE = 8
FLASH_SYMBOLS = ("flash_fwd_kernel", "flash_bwd_kernel",
                 "flash_bwd_dq_reduce_kernel")
KERNEL_SYMBOLS = ("fused_variation_kernel", *FLASH_SYMBOLS,
                  "ssd_chunk_kernel", "delay_chain_kernel")
# tests/test_kernels.py:53-61: (B, S, H, KV, hd, causal, window, softcap,
# dtype); then gemma2-2b's layer shapes on the serving path (batch 4,
# prompt 4500): its windowed and its global layers
ATTN_CASES = [
    (2, 256, 8, 4, 64, True, 0, 0.0, "float32"),
    (1, 200, 4, 4, 32, True, 50, 0.0, "float32"),
    (2, 128, 8, 2, 64, False, 0, 30.0, "float32"),
    (1, 384, 6, 2, 128, True, 100, 50.0, "float32"),
    (1, 256, 8, 8, 64, True, 0, 0.0, "bfloat16"),
    (1, 160, 4, 1, 256, True, 0, 0.0, "float32"),
]
ATTN_MAIN = [(4, 4500, 8, 4, 256, True, 4096, 50.0, "float32"),
             (4, 4500, 8, 4, 256, True, 0, 50.0, "float32")]
ATTN_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2e-2, 2e-2)}
# queries at 64..95 against keys 0..63, window 16: rows >= 15 see no key
ATTN_MASKED = dict(case=(1, 32, 4, 2, 64, True, 16, 0.0, "float32"), t=64,
                   q_offset=64, first_masked=15)
# tests/test_kernels.py:103-108: (B, L, H, P, N, chunk); then mamba2-780m's
# shape (L = 4096 whole chunks, and the serving path's 4000, padded)
SSD_CASES = [(2, 128, 4, 32, 16, 32), (1, 256, 8, 64, 128, 64),
             (2, 96, 2, 32, 64, 32), (1, 64, 4, 128, 128, 64)]
SSD_MAIN = (4, 4096, 48, 64, 128, 256)
SSD_SERVE_L = 4000
SSD_TOL = (1e-4, 1e-4)
# with Mamba-2's dt and a, some head's chunk decay exp(cum_Q) must exceed
# this, so the far tiles and the inter-chunk recurrence carry weight
SSD_MIN_DECAY = 1e-4

# LM training path: ``launch.train --arch tinyllama-1.1b --full`` for 8
# steps of batch 4 x sequence 2048, TinyLlama's training context; each
# step launches the flash forward and backward kernels once per layer
TRAIN_ARCH, TRAIN_LAYERS = "tinyllama-1.1b", 22
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--full", "--steps", str(TRAIN_STEPS),
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--device", "cuda"]
# the backward kernel's checks beyond ATTN_CASES (its bf16 case must
# raise): tinyllama-1.1b's layer shape at batch 1 and at the training
# path's batch 4; gemma2-2b's layer shapes with S > its 4096 window, so
# the window binds, windowed and global, softcap 50; the fully masked
# rows of ATTN_MASKED. (B, S, H, KV, hd, causal, window, softcap, dtype)
BWD_TINYLLAMA = (TRAIN_BATCH, TRAIN_SEQ, 32, 4, 64, True, 0, 0.0, "float32")
BWD_MAIN = [(1, TRAIN_SEQ, 32, 4, 64, True, 0, 0.0, "float32"),
            BWD_TINYLLAMA,
            (1, 4500, 8, 4, 256, True, 4096, 50.0, "float32"),
            (1, 4500, 8, 4, 256, True, 0, 50.0, "float32")]
# tinyllama-1.1b's layer at one sequence of 16384: every key tile's dq
# partials at once would take 17,179,869,184 bytes of scratch
BWD_LONG = (1, 16384, 32, 4, 64, True, 0, 0.0, "float32")
# a scratch budget that every shape's dq partials fit
NO_BUDGET = 1 << 62
# gradients: tests/test_kernels.py:96-97's tolerance (rtol, atol)
GRAD_TOL = (1e-3, 1e-4)
# the backward needs five products of 2 hd FLOP per visible (query, key)
# pair and query head: Q K^T, dO V^T, P^T dO, dS^T Q, dS K
BWD_PRODUCTS = 5

# float32 operations of the fused variation, counted from the source with
# each powf as ONE operation (a lower bound): per gene pair always (mask
# compares and selects), per gene pair where crossover applies, and per
# child gene where mutation applies
OPS_PAIR_GENE, OPS_CROSSOVER, OPS_MUTATION = 8, 46, 18


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(*parts):
    print(*parts, flush=True)


def peaks(card):
    """(bytes/s, float32 op/s, TF32 op/s) of the card named in ``card``."""
    return next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])


def cuda_ms(fn, repeats=10, inner=5):
    """Median over ``repeats`` of the mean time of ``inner`` back-to-back
    calls, with CUDA events (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def once_ms(fn):
    """Device ms of one call of ``fn``, with CUDA events and no warm-up
    (for calls that take seconds and were warmed by an earlier run)."""
    import torch
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def device_ms(fn, launches=20, repeats=10):
    """Median over ``repeats`` of the device ms per call of ``launches``
    back-to-back calls of ``fn``, with CUDA events, for kernels that take
    less time than the host takes to call them: the calls are queued
    behind a busy-wait kernel (``torch.cuda._sleep``), so the device runs
    them with no host gap in between. Where the host took longer to queue
    them than the wait lasted, the wait is doubled and the repeat made
    again."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles, times = SLEEP_CYCLES, []
    while len(times) < repeats:
        gate, start, stop = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        gate.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        stop.synchronize()
        if host_ms < gate.elapsed_time(start):
            times.append(start.elapsed_time(stop) / launches)
        elif cycles >= SLEEP_CYCLES << 10:
            fail(f"the host took {host_ms:.3f} ms to queue {launches} calls, "
                 f"longer than a wait of {cycles} cycles")
        else:
            cycles *= 2
    return statistics.median(times)


def close(a, b, rtol, atol):
    """(all close, max abs error) of two tensors, NaN-aware."""
    import torch
    err = (a - b).abs()
    both_nan = torch.isnan(a) & torch.isnan(b)
    ok = (err <= atol + rtol * b.abs()) | both_nan
    return bool(ok.all()), float(torch.where(both_nan, 0.0, err).max())


def kernel_args(rows, genes, seed, hp, bound, device, islands=None,
                unaligned=False, per_gene=False, cross=None):
    """Parents (rows, genes) — or (islands, rows, genes), as the main path
    calls the wrapper — uniforms, scalars and bounds for one launch. ``hp``
    holds the hyperparameters; its indpb defaults to 1/genes. Options:
    ``unaligned`` parents (a contiguous view at element offset 1 of a
    larger buffer), ``per_gene`` bounds with lo != -hi inside [-bound,
    bound], ``cross`` "all" or "none" to force every pair-gene's crossover
    mask on or off."""
    import torch
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lead = () if islands is None else (islands,)
    parents = (torch.rand(lead + (rows, genes), generator=gen, device=device)
               * 2 - 1) * bound
    lo = torch.full((genes,), -bound, device=device)
    hi = torch.full((genes,), bound, device=device)
    if per_gene:
        lo = -bound * torch.rand(genes, generator=gen, device=device)
        hi = lo + (bound - lo) * (0.2 + 0.8 * torch.rand(
            genes, generator=gen, device=device))
        parents = lo + (hi - lo) * (parents + bound) / (2 * bound)
    if unaligned:
        buf = torch.empty(parents.numel() + 1, device=device)
        parents = buf[1:].view(parents.shape).copy_(parents)
    rnd = draw_uniforms(gen, rows, genes, device, islands=islands)
    if cross == "all":
        rnd["m_pair"].zero_()
        rnd["m_gene"].zero_()
    elif cross == "none":
        rnd["m_gene"].fill_(0.75)
    scalars = ops.pack_scalars(hp["eta_cx"], hp["prob_cx"], hp["eta_mut"],
                               hp["prob_mut"], hp.get("indpb", 1.0 / genes),
                               device=device)
    return parents, rnd, scalars, lo, hi


def check_kernel(rows, genes, seed, hp, bound, tol, device, islands=None,
                 **options):
    from repro_torch.kernels.genetic import ops
    args = kernel_args(rows, genes, seed, hp, bound, device, islands,
                       **options)
    out = ops.fused_variation(*args)
    ref = ops.fused_variation_plain(*args)
    ok, err = close(out, ref, *tol)
    lo, hi = args[3:]
    inside = bool(((out >= lo) & (out <= hi)).all())
    if not (ok and inside):
        fail(f"fused_variation kernel disagrees with its plain version at "
             f"({rows}, {genes}) hp={hp} {options}: max abs err {err}, "
             f"within bounds {inside}")
    return err


def phase_check(device):
    """Kernel against its plain version; a generation on the card against
    the same generation on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import GAConfig
    from repro_torch.core import island, nsga2
    from repro_torch.core.broker import Broker
    from repro_torch.core.population import init_population
    from repro_torch.core.uniforms import ArrayUniforms
    from repro_torch.fitness import rastrigin
    from repro_torch.kernels.genetic import fused_variation
    for p, g in TEST_SHAPES:
        err = check_kernel(p - p % 2, g, p + g, dict(HP, indpb=1.0 / g), 1.0,
                           TOL, device)
        say(f"check: kernel ({p - p % 2}, {g}) max abs err {err:.3g}")
    rs = np.random.default_rng(0)
    for k in range(10):
        eta_cx, eta_mut, prob = rs.uniform([1, 1, 0], [80, 80, 1])
        hp = dict(eta_cx=eta_cx, prob_cx=prob, eta_mut=eta_mut,
                  prob_mut=prob, indpb=0.4)
        check_kernel(32, 9, 100 + k, hp, 2.0, SWEEP_TOL, device)
        check_kernel(MAIN["pop"], MAIN["genes"], 200 + k, hp, BOUND,
                     SWEEP_TOL, device, MAIN["islands"])
    say("check: kernel hyperparameter sweep (10 points, two shapes) ok")
    main_err = check_kernel(MAIN["pop"], MAIN["genes"], 7,
                            dict(HP, indpb=1.0 / MAIN["genes"]), BOUND, TOL,
                            device, MAIN["islands"])
    say(f"check: kernel main-path shape ({MAIN['islands']}, {MAIN['pop']}, "
        f"{MAIN['genes']}) max abs err {main_err:.3g}")
    err = check_kernel(MAIN["pop"], MAIN["genes"], 8, TABLE3, BOUND, TOL,
                       device, MAIN["islands"])
    say(f"check: kernel main-path shape, Table 3 point {TABLE3}: max abs "
        f"err {err:.3g}")
    for k, (rows, genes, options, vec) in enumerate(VARIATION_EDGES):
        options = dict(options)
        hp = options.pop("hp", HP)
        args = kernel_args(rows, genes, 300 + k, hp, BOUND, device,
                           **options)
        got = fused_variation.template(*args[:2], *args[3:],
                                       torch.empty_like(args[0]))
        if got != (vec, 32):
            fail(f"fused_variation at ({rows}, {genes}) {options}: template "
                 f"{got}, expected ({vec}, 32)")
        err = check_kernel(rows, genes, 300 + k, hp, BOUND, TOL, device,
                           **options)
        say(f"check: kernel edge ({rows}, {genes}) hp={hp} {options}: "
            f"template {vec} float(s) per load, 32-bit index, max abs err "
            f"{err:.3g}")

    # one generation, card vs CPU, from the same pre-drawn uniforms
    cfg = GAConfig(num_genes=8, pop_per_island=16, num_islands=4,
                   lower=-BOUND, upper=BOUND, mutation_prob=0.7,
                   mutation_eta=20.0, crossover_prob=0.9, crossover_eta=15.0)
    draws = [rs.random(s, dtype=np.float32) for s in
             [(4, 16, 2), (4, 8, 8), (4, 8, 1), (4, 8, 8), (4, 16, 8),
              (4, 16, 1), (4, 16, 8)]]
    out = []
    for dev in (device, torch.device("cpu")):
        broker = Broker(rastrigin)
        pop = island.evaluate_population(cfg, broker,
                                         init_population(cfg, 3, "cpu"))
        pop = pop._replace(genomes=pop.genomes.to(dev),
                           fitness=pop.fitness.to(dev))
        gen = island.make_generation_step(cfg, broker, dev)
        new, _ = gen(pop, ArrayUniforms(draws, dev))
        out.append((new, nsga2.nsga2_keys(pop.fitness)[2]))
    (gpu, gkeys), (cpu, ckeys) = out
    if not torch.equal(gkeys.cpu(), ckeys):
        fail("NSGA-II keys on the card differ from the CPU's")
    ok, err = close(gpu.genomes.cpu(), cpu.genomes, 1e-5, 1e-5)
    if not ok:
        fail(f"a generation on the card differs from the CPU's: {err}")
    say(f"check: one generation card vs CPU, keys exact, genomes max abs "
        f"err {err:.3g}")
    return main_err


def phase_main():
    import torch
    from repro_torch.core.population import best_of
    from repro_torch.fitness import rastrigin
    from repro_torch.kernels.genetic import ops
    from repro_torch.launch import ga_run
    expect = MAIN["gens_per_epoch"] * MAIN["epochs"]
    runs = []
    for extra in ([], ["--sync-every", "2", "--pipeline-depth", "2"]):
        ops.launches = 0
        t0 = time.perf_counter()
        pop, hist = ga_run.main(MAIN_ARGS + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launches
        say(f"main: ga_run {' '.join(extra) or '(defaults)'}: {seconds:.3f} s "
            f"wall, fused_variation launches {launches}")
        if launches != expect:
            fail(f"fused_variation launched {launches} times in the main "
                 f"path, expected {expect}")
        bests = [h["best"] for h in hist]
        if len(bests) != MAIN["epochs"] or not all(map(math.isfinite, bests)):
            fail(f"epoch bests {bests}")
        if any(b > a for a, b in zip(bests, bests[1:])):
            fail(f"global best worsened across epochs: {bests}")
        shape = (MAIN["islands"], MAIN["pop"], MAIN["genes"])
        if tuple(pop.genomes.shape) != shape or \
                not bool(torch.isfinite(pop.fitness).all()):
            fail("population shape or fitness not finite")
        if not bool((pop.genomes.abs() <= BOUND).all()):
            fail("genomes outside the bounds")
        refit = rastrigin(pop.genomes.reshape(-1, MAIN["genes"]))
        ok, err = close(refit.reshape(pop.fitness.shape), pop.fitness,
                        1e-5, 1e-3)
        if not ok:
            fail(f"stored fitness disagrees with the genomes' ({err})")
        g, f = best_of(pop)
        runs.append((g.clone(), float(f[0]), launches, seconds, pop))
    if not torch.equal(runs[0][0], runs[1][0]):
        fail("--sync-every 2 --pipeline-depth 2 changed the best genome")
    say(f"main: best fitness {runs[0][1]!r}, bit-identical best genome "
        f"under pipelining")
    return runs[0][2], runs[0][4]


def variation_bound(args, card):
    """(bound ms, "bytes" or "operations") of one fused variation launch
    on ``args``: every input read once and the offspring written once at
    the memory rate, or the float32 operations these inputs need (OPS_*,
    each powf one operation) at the float32 rate, whichever is longer."""
    parents, rnd, scalars, _, _ = args
    g = parents.shape[-1]
    rows = parents.numel() // g
    mem_rate, f32_rate, _ = peaks(card)
    nbytes = 4 * (rows * g * 4 + (rows // 2) * g * 2 + rows // 2 + rows
                  + 2 * g + 5)
    prob_cx, prob_mut, indpb = (float(scalars[k]) for k in (1, 3, 4))
    n_cx = int(((rnd["m_pair"] < prob_cx) & (rnd["m_gene"] < 0.5)).sum())
    n_mut = int(((rnd["m_ind"] < prob_mut) & (rnd["m_genem"] < indpb)).sum())
    nops = (OPS_PAIR_GENE * (rows // 2) * g + OPS_CROSSOVER * n_cx
            + OPS_MUTATION * n_mut)
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
    say(f"times: fused_variation bound: {nbytes} bytes at {mem_rate:.3g} "
        f"B/s = {bytes_ms:.5f} ms; {nops} ops ({n_cx} crossing pair-genes, "
        f"{n_mut} mutating genes) at {f32_rate:.3g} op/s = {ops_ms:.5f} ms")
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def host_us(fn):
    """Mean host microseconds per call of ``fn`` over HOST_CALLS calls
    after a warm-up call, with one synchronize at the end, outside the
    clock."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def variation_times(device, card):
    """The fused variation kernel at (I, P) of the main shape, called
    through ``ops.fused_variation`` only, so this also runs on an older
    tree of the port: its device time (``device_ms``) at each
    VARIATION_POINTS point (the same parents and uniforms at one G)
    beside its bound, and the host µs per wrapper call at the main shape
    and at HOST_SMALL. Returns ({point: (ms, bound ms, bound_by, args)},
    {shape: host µs})."""
    from repro_torch.kernels.genetic import ops
    i, p = MAIN["islands"], MAIN["pop"]
    points = {}
    for name, (g, hp, options) in VARIATION_POINTS.items():
        args = kernel_args(p, g, 11, hp, BOUND, device, i, **options)
        ms = device_ms(lambda: ops.fused_variation(*args))
        bound_ms, bound_by = variation_bound(args, card)
        points[name] = (ms, bound_ms, bound_by, args)
        say(f"times: fused_variation ({i}, {p}, {g}) at {name} {hp} "
            f"{options}: kernel {ms:.5f} ms, {bound_ms / ms:.3f} of the "
            f"bound ({bound_ms:.5f} ms, {bound_by})")
    host = {}
    for shape in ((i, p, MAIN["genes"]), HOST_SMALL):
        args = kernel_args(shape[1], shape[2], 12, HP, BOUND, device,
                           shape[0])
        host[shape] = host_us(lambda: ops.fused_variation(*args))
        say(f"times: fused_variation host µs per wrapper call at {shape}: "
            f"{host[shape]:.3f} (mean over {HOST_CALLS} calls, one sync at "
            f"the end)")
    del args
    say("times: " + json.dumps({
        "card": card, "variation_ms": {k: v[0] for k, v in points.items()},
        "variation_bound_share": {k: v[1] / v[0] for k, v in points.items()},
        "variation_host_us": {str(k): v for k, v in host.items()}}))
    return points, host


def generation_phases(pop, broker, scalars, bound, device,
                      migrate_cfg=None):
    """One generation on ``pop``, phase by phase (CUDA events, median of 3
    single calls): NSGA-II keys, tournament with the parent gather, the
    variation's uniform draws, one fused variation wrapper call (genes in
    [-bound, bound], hyperparameters ``scalars``), the fitness through
    ``broker``, survivor selection; and one migration when
    ``migrate_cfg`` is given. Returns {phase: ms}."""
    import torch
    from repro_torch.core import island, nsga2, operators
    from repro_torch.core.uniforms import GeneratorUniforms
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms
    i, p, g = pop.genomes.shape
    lo = torch.full((g,), -bound, device=device)
    hi = torch.full((g,), bound, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rand = GeneratorUniforms(gen, device)
    state = {}

    def keys():
        state["keys"] = nsga2.nsga2_keys(pop.fitness)[2].to(torch.float32)

    def tournament():
        idx = operators.tournament_select(rand, state["keys"], p)
        state["parents"] = torch.gather(
            pop.genomes, 1, idx.unsqueeze(-1).expand(i, p, g))

    def draws():
        state["rnd"] = draw_uniforms(rand, p, g, device, islands=i)

    def variation():
        state["off"] = ops.fused_variation(state["parents"], state["rnd"],
                                           scalars, lo, hi)

    def fitness():
        state["fit"] = broker.evaluate(state["off"].reshape(i * p, g))[0]

    def survivors():
        nsga2.survivor_select(
            torch.cat([pop.genomes, state["off"]], 1),
            torch.cat([pop.fitness, state["fit"].reshape(i, p, -1)], 1), p)

    steps = [("nsga2_keys", keys), ("tournament", tournament),
             ("uniform_draws", draws), ("variation_kernel", variation),
             ("fitness", fitness), ("survivor_select", survivors)]
    if migrate_cfg is not None:
        steps.append(("migration",
                      lambda: island.migrate_ring(migrate_cfg, pop, rand)))
    return {name: cuda_ms(fn, repeats=3, inner=1) for name, fn in steps}


def phase_times(pop, main_err, launches, device, card):
    import torch
    from repro_torch.configs.base import GAConfig
    from repro_torch.core.broker import Broker
    from repro_torch.core.engine import GAEngine
    from repro_torch.fitness import rastrigin
    from repro_torch.kernels.genetic import ops

    i, p, g = pop.genomes.shape
    rows = i * p
    points, _ = variation_times(device, card)
    kernel_ms, bound_ms, bound_by, args = points["ga_run"]
    plain_ms = cuda_ms(lambda: ops.fused_variation_plain(*args), repeats=5,
                       inner=2)
    say(f"times: fused_variation ({i}, {p}, {g}), ga_run's point: kernel "
        f"{kernel_ms:.5f} ms, plain version {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / kernel_ms:.3f} of the "
        f"bound")

    # one generation, phase by phase, on the main path's population
    cfg = GAConfig(num_genes=g, pop_per_island=p, num_islands=i,
                   lower=-BOUND, upper=BOUND, mutation_prob=0.7,
                   mutation_eta=20.0, crossover_prob=0.9, crossover_eta=15.0)
    phases = generation_phases(pop, Broker(rastrigin), args[2], BOUND,
                               device, migrate_cfg=cfg)
    gen_ms = sum(v for k, v in phases.items() if k != "migration")
    say("times: one generation at (I, P, G) = "
        f"({i}, {p}, {g}), ms per phase: "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
        + f"; generation total {gen_ms:.4f}")

    # whole epochs through the engine
    eng = GAEngine(cfg, rastrigin, device=device)
    epop = eng.init(1)
    epop, _ = eng.run(epop, epochs=1)                     # warm-up
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    n_epochs = 2
    start.record()
    epop, _ = eng.run(epop, epochs=n_epochs)
    stop.record()
    stop.synchronize()
    epoch_s = start.elapsed_time(stop) / 1e3 / n_epochs
    gens_s = cfg.generations_per_epoch / epoch_s
    evals_s = cfg.generations_per_epoch * rows / epoch_s
    say(f"times: epoch {epoch_s:.4f} s ({cfg.generations_per_epoch} "
        f"generations + migration), {gens_s:.4f} generations/s, "
        f"{evals_s:.1f} evaluations/s")
    say("times: " + json.dumps({
        "card": card, "phase_ms": phases, "generation_ms": gen_ms,
        "epoch_s": epoch_s, "generations_per_s": gens_s,
        "evaluations_per_s": evals_s}))
    return {"name": "fused_variation", "route": "cuda",
            "source": "src/repro_torch/kernels/genetic/csrc/fused_variation.cu",
            "replaces": "src/repro/kernels/genetic/fused_variation.py:126",
            "launches": launches, "max_abs_err": main_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# ---------------------------------------------------------------------------
# HVDC dispatch path: batched AC Newton power flow through ga_run
# ---------------------------------------------------------------------------

def hvdc_genomes(h, seed):
    """(4, H) float32 genomes in [-1, 1]: zero dispatch, alternating +-1,
    two uniform draws (numpy seed)."""
    import numpy as np
    import torch
    rs = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [np.zeros(h), np.resize([1.0, -1.0], h), rs.uniform(-1, 1, h),
         rs.uniform(-1, 1, h)]).astype(np.float32))


def hvdc_eval(grid, device, genomes, **fitness_kw):
    """On ``device``: the base-case Newton result of ``genomes``, their
    objectives, the screened outage lists (or None) and the islanding
    mask of the DC model (or None), all moved to the CPU."""
    from repro_torch.fitness.powerflow import HVDCDispatchFitness
    from repro_torch.powerflow.dc import screen_contingencies
    from repro_torch.powerflow.hvdc import apply_hvdc, scale_genome_to_dispatch
    from repro_torch.powerflow.newton import newton_powerflow
    fit = HVDCDispatchFitness(grid, device=device, **fitness_kw)
    gridt, genomes = fit.gridt, genomes.to(device)
    pe = apply_hvdc(gridt, scale_genome_to_dispatch(gridt, genomes))
    res = newton_powerflow(gridt, p_extra=pe, num_iters=fit.newton_iters)
    obj = fit(genomes)
    cases = islanding = None
    if fit.dc_model is not None:
        cases = screen_contingencies(fit.dc_model, gridt["p_inj"] + pe,
                                     gridt["rate"], fit.screen_top_k).cpu()
        islanding = (fit.dc_model.bridge_score > 50.0).cpu()
    return (res._replace(**{k: v.cpu() for k, v in res._asdict().items()}),
            obj.cpu(), cases, islanding)


def check_hvdc(grid, label, device, **fitness_kw):
    """HVDCDispatchFitness on the card against the same code on the CPU
    (LAPACK's LU) for hvdc_genomes: vm and va atol HVDC_PF_ATOL, iters and
    converged exact, objectives at HVDC_TOL on the lanes whose base case
    converged (a non-converged lane scores 100 x a round-off-driven
    iterate), screened lists equal past their head of islanding outages
    (which of those lead, in which order, is round-off: each islanding
    line's LODF column is round-off / 1e-6)."""
    import torch
    genomes = hvdc_genomes(grid.n_hvdc, seed=5)
    card = hvdc_eval(grid, device, genomes, **fitness_kw)
    cpu = hvdc_eval(grid, torch.device("cpu"), genomes, **fitness_kw)
    (cres, cobj, ccases, cisl), (res, obj, cases, isl) = card, cpu
    errs = {}
    for field in ("vm", "va"):
        ok, errs[field] = close(getattr(cres, field), getattr(res, field),
                                0.0, HVDC_PF_ATOL)
        if not ok:
            fail(f"HVDC {label}: {field} on the card differs from the CPU's "
                 f"by {errs[field]}")
    if not (torch.equal(cres.iters, res.iters)
            and torch.equal(cres.converged, res.converged)):
        fail(f"HVDC {label}: iters/converged {cres.iters.tolist()} "
             f"{cres.converged.tolist()} on the card, {res.iters.tolist()} "
             f"{res.converged.tolist()} on the CPU")
    conv = res.converged
    if not bool(torch.isfinite(cobj).all()):
        fail(f"HVDC {label}: objectives {cobj.tolist()} not finite")
    ok, errs["objective"] = close(cobj[conv], obj[conv], *HVDC_TOL)
    if not ok:
        fail(f"HVDC {label}: objectives {cobj.tolist()} on the card, "
             f"{obj.tolist()} on the CPU")
    if cases is not None:
        if not torch.equal(cisl, isl):
            fail(f"HVDC {label}: islanding lines differ card vs CPU")
        head = min(cases.shape[1], int(isl.sum()))
        for a, b in zip(ccases.tolist(), cases.tolist()):
            if not (all(isl[k] for k in a[:head] + b[:head])
                    and a[head:] == b[head:]):
                fail(f"HVDC {label}: screened {a} on the card, {b} on the "
                     f"CPU")
    say(f"check: HVDC {label}: {int(conv.sum())} of {len(conv)} base cases "
        f"converged (iters {res.iters.tolist()}), vm max abs err "
        f"{errs['vm']:.3g}, va {errs['va']:.3g}, objectives "
        f"{errs['objective']:.3g}"
        + ("" if cases is None else
           f", screened lists {ccases.tolist()} (islanding head {head})"))


def phase_check_hvdc(device):
    """The fused variation at the HVDC runs' shapes; the HVDC fitness on
    the card against the CPU at the tests' 60-bus grid (8 contingencies,
    full AC and screened to 4 and 12) and at the German grid's base case;
    an islanding outage reads 10.0 without raising."""
    import torch
    from repro_torch.powerflow.contingency import contingency_loadings
    from repro_torch.powerflow.grid import (make_german_grid,
                                            make_synthetic_grid)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is set: TF32 in the "
             "complex GEMMs would eat into the Newton tolerance")
    for p in (16, 8):                 # the HVDC runs' (I, P, G) shapes
        err = check_kernel(p, HVDC_GENES, 400 + p,
                           dict(TABLE3, indpb=1.0 / HVDC_GENES), 1.0, TOL,
                           device, islands=2)
        say(f"check: kernel HVDC main-path shape (2, {p}, {HVDC_GENES}), "
            f"Table 3: max abs err {err:.3g}")
    small = make_synthetic_grid(**HVDC_SMALL)
    check_hvdc(small, "60-bus, 8 contingencies", device, contingencies=8)
    for k in (4, 12):                 # inside and past the islanding head
        check_hvdc(small, f"60-bus, 8 contingencies screened to {k}", device,
                   contingencies=8, screen_top_k=k)
    german = make_german_grid(0)
    check_hvdc(german, f"German grid ({german.n_bus} buses, {german.n_line} "
               f"lines, {german.n_hvdc} HVDC), base case", device)
    load = contingency_loadings(small.to_torch(device),
                                torch.tensor([HVDC_BRIDGE, 3], device=device))
    torch.cuda.synchronize()
    if not (bool((load[0, 0] == 10.0).all())
            and bool((load[0, 1] < 10.0).all())):
        fail(f"HVDC: the islanding outage of line {HVDC_BRIDGE} reads "
             f"{load[0, 0].max().item()}, line 3's {load[0, 1].max().item()}")
    say(f"check: HVDC islanding outage (line {HVDC_BRIDGE}, a degree-1 bus "
        f"cut loose) reads 10.0 on every line without raising")


def phase_main_hvdc():
    """``ga_run --fitness hvdc`` on the German-size grid, horizontal and
    vertical, each with the fused variation's count zeroed just before and
    read just after: exactly HVDC_GENS launches (the initial evaluation
    launches none), finite fitness, genomes in [-1, 1]."""
    import torch
    from repro_torch.kernels.genetic import ops
    from repro_torch.launch import ga_run
    runs = {}
    for name, extra in HVDC_RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.launches = 0
        t0 = time.perf_counter()
        pop, hist = ga_run.main(HVDC_ARGS + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches
        peak = torch.cuda.max_memory_allocated()
        i, p, g = pop.genomes.shape
        evals = i * p * (1 + HVDC_GENS)
        contingencies = int(extra[extra.index("--contingencies") + 1]) \
            if "--contingencies" in extra else 0
        say(f"main: ga_run hvdc {name} {' '.join(extra)}: {wall:.3f} s wall "
            f"(set-up included), fused_variation launches {launches}, "
            f"{evals} evaluations, peak memory {peak} B")
        if launches != HVDC_GENS:
            fail(f"fused_variation launched {launches} times in ga_run hvdc "
                 f"{name}, expected {HVDC_GENS}")
        if g != HVDC_GENES or len(hist) != HVDC_EPOCHS or \
                not bool(torch.isfinite(pop.fitness).all()) or \
                not all(math.isfinite(h["best"]) for h in hist):
            fail(f"ga_run hvdc {name}: genes {g}, {len(hist)} epochs, "
                 f"fitness finite {bool(torch.isfinite(pop.fitness).all())}")
        if not bool((pop.genomes.abs() <= 1.0).all()):
            fail(f"ga_run hvdc {name}: genomes outside [-1, 1]")
        if any(h["balanced"] != 1.0 for h in hist):
            fail(f"ga_run hvdc {name}: balanced dispatch did not engage")
        runs[name] = dict(pop=pop, launches=launches, wall_s=wall,
                          evaluations=evals, contingencies=contingencies,
                          peak_bytes=peak, best=hist[-1]["best"],
                          skew=[h["skew"] for h in hist])
    return runs


def finished_share(iters, num_iters):
    """Share of a static schedule's LU work spent on lanes already done."""
    return 1.0 - float(iters.float().mean()) / num_iters


def phase_times_hvdc(runs, device, card):
    """HVDC times on the card (CUDA events): one generation phase by phase
    at the horizontal run's shape; the batched LU (torch.linalg.solve_ex)
    at (B, 2n, 2n) beside its float32 bound, under each linear-algebra
    library PyTorch can prefer; one Newton solve per system and its LU
    share; the fitness of each run's population: evaluations/s and
    power-flow solves/s; the share of LU work on lanes already
    converged."""
    import argparse
    import torch
    from repro_torch.core.broker import Broker
    from repro_torch.kernels.genetic import ops
    from repro_torch.launch import ga_run
    from repro_torch.powerflow.contingency import select_contingency_lines
    from repro_torch.powerflow.hvdc import apply_hvdc, scale_genome_to_dispatch
    from repro_torch.powerflow.newton import newton_powerflow
    out = {"card": card}
    fits = {}
    for name, extra in HVDC_RUNS.items():
        pop = runs[name]["pop"]
        i, p, g = pop.genomes.shape
        ns = argparse.Namespace(
            grid_size=HVDC_BUSES, hvdc_lines=HVDC_GENES, pop=p, islands=i,
            gens_per_epoch=HVDC_GENS // HVDC_EPOCHS, epochs=HVDC_EPOCHS,
            seed=0, contingencies=runs[name]["contingencies"],
            screen_top_k=0)
        cfg, fit, cost = ga_run.build("hvdc", ns, device)
        fits[name] = (cfg, fit, cost, pop)
    cfg, fit, cost, pop = fits["horizontal"]
    i, p, g = pop.genomes.shape
    scalars = ops.pack_scalars(cfg.crossover_eta, cfg.crossover_prob,
                               cfg.mutation_eta, cfg.mutation_prob, cfg.indpb,
                               device=device)
    phases = generation_phases(pop, Broker(fit, cost, num_workers=4),
                               scalars, 1.0, device)
    gen_ms = sum(phases.values())
    say(f"times: one HVDC generation at (I, P, G) = ({i}, {p}, {g}), "
        f"{HVDC_BUSES} buses, ms per phase: "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
        + f"; generation total {gen_ms:.4f}")
    out.update(phase_ms=phases, generation_ms=gen_ms)

    # the batched LU at the Jacobian's shape, on diagonally dominant
    # matrices, beside its bound: 2/3 (2n)^3 FLOP per system at the float32
    # rate, or its bytes (the matrix read, the solution written); under
    # PyTorch's default choice of library (what the port runs) and under
    # each library it can be told to prefer
    m = 2 * HVDC_BUSES
    mem_rate, f32_rate, _ = peaks(card)
    solve = {}
    default_lib = torch.backends.cuda.preferred_linalg_library()
    for b in HVDC_SOLVE_BATCHES:
        gen = torch.Generator(device=device).manual_seed(b)
        a = torch.rand((b, m, m), generator=gen, device=device)
        a.diagonal(dim1=-2, dim2=-1).add_(m)
        rhs = torch.rand((b, m, 1), generator=gen, device=device)
        flops = b * 2 / 3 * m ** 3
        nbytes = 4 * b * (m * m + 2 * m)
        ops_ms, bytes_ms = flops / f32_rate * 1e3, nbytes / mem_rate * 1e3
        row = dict(bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        for lib in ("default", "cusolver", "magma"):
            try:
                torch.backends.cuda.preferred_linalg_library(lib)
                ms = cuda_ms(lambda: torch.linalg.solve_ex(a, rhs),
                             repeats=3, inner=1)
            except RuntimeError as err:
                say(f"times: solve_ex with {lib} preferred: refused "
                    f"({str(err).splitlines()[0][:120]})")
                continue
            finally:
                torch.backends.cuda.preferred_linalg_library(default_lib)
            row[lib] = ms
            say(f"times: torch.linalg.solve_ex at ({b}, {m}, {m}) float32, "
                f"{lib} library: {ms:.4f} ms, {ms / b:.4f} ms per system; "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
                f"{flops:.4g} FLOP at {f32_rate:.3g} op/s, {nbytes} B at "
                f"{mem_rate:.3g} B/s), {row['bound_ms'] / ms:.3f} of it")
        row.update(ms=row["default"], ms_per_system=row["default"] / b)
        solve[b] = row
        del a, rhs
    out["solve_ex"] = solve

    # one Newton solve per system (base case, newton_iters iterations); the
    # B = 16 solve's iterations give the base case's share of LU work on
    # lanes already converged
    gridt = fit.gridt
    newton = {}
    for b in HVDC_SOLVE_BATCHES:
        genomes = pop.genomes.reshape(-1, g)[:b]
        pe = apply_hvdc(gridt, scale_genome_to_dispatch(gridt, genomes))
        res = {}

        def solve_once(pe=pe, res=res):
            res["r"] = newton_powerflow(gridt, p_extra=pe,
                                        num_iters=fit.newton_iters)
        ms = cuda_ms(solve_once, repeats=1, inner=1)
        lu = fit.newton_iters * solve[b]["ms"] / ms
        iters = res["r"].iters
        newton[b] = dict(ms=ms, ms_per_system=ms / b, lu_share=lu,
                         iters=iters.tolist(),
                         finished_lane_lu_share=finished_share(
                             iters, fit.newton_iters))
        say(f"times: newton_powerflow at B = {b} ({fit.newton_iters} "
            f"iterations): {ms:.4f} ms, {ms / b:.4f} ms per system; LU "
            f"share {lu:.3f} ({fit.newton_iters} x solve_ex); iters "
            f"{iters.tolist()}, LU work on converged lanes "
            f"{newton[b]['finished_lane_lu_share']:.4f}")
    out["newton"] = newton

    # each run's whole-population fitness, one call timed after the runs
    # warmed it: evaluations/s, power-flow solves/s
    for name, (cfg, fit, cost, pop) in fits.items():
        flat = pop.genomes.reshape(-1, g)
        broker = Broker(fit, cost, num_workers=4)
        ms = once_ms(lambda: broker.evaluate(flat))
        c = runs[name]["contingencies"]
        evals_s = flat.shape[0] / ms * 1e3
        row = dict(fitness_ms=ms, evaluations_per_s=evals_s,
                   powerflow_solves_per_s=evals_s * (1 + c),
                   peak_bytes=runs[name]["peak_bytes"],
                   run_wall_s=runs[name]["wall_s"],
                   run_evaluations_per_s=runs[name]["evaluations"]
                   / runs[name]["wall_s"])
        if c:
            # the contingency cases of the first two genomes: their share
            # of LU work on lanes already converged
            gridt = fit.gridt
            pe = apply_hvdc(gridt, scale_genome_to_dispatch(gridt, flat[:2]))
            lines = torch.as_tensor(
                select_contingency_lines(fit.grid, c, 0), device=device)
            mask = torch.ones((2 * c, fit.grid.n_line), device=device)
            mask[torch.arange(2 * c, device=device), lines.repeat(2)] = 0.0
            iters = newton_powerflow(
                gridt, p_extra=pe.repeat_interleave(c, 0),
                num_iters=fit.newton_iters, line_mask=mask).iters
            row.update(case_iters=iters.tolist(),
                       case_finished_lane_lu_share=finished_share(
                           iters, fit.newton_iters))
        out[name] = row
        say(f"times: HVDC {name} fitness of {flat.shape[0]} genomes x "
            f"{1 + c} power flows: {ms:.3f} ms, {evals_s:.3f} "
            f"evaluations/s, {row['powerflow_solves_per_s']:.3f} power-flow "
            f"solves/s; run: {row['run_evaluations_per_s']:.3f} "
            f"evaluations/s over {runs[name]['wall_s']:.3f} s wall (set-up "
            f"included), peak memory {runs[name]['peak_bytes']} B"
            + (f"; contingency cases' iters {row['case_iters']}, LU work on "
               f"converged lanes {row['case_finished_lane_lu_share']:.4f}"
               if c else ""))
    say("times: hvdc " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Decoupled host backend (ga_run --dispatch-backend host-*) and the §4.1
# delay chain kernel
# ---------------------------------------------------------------------------

def delay_inputs(n, iters, device, seed):
    """(acc0, iters) on ``device``: start values as delay_proxy seeds them
    (1 + a genome sum x 1e-6) and int32 counts, all ``iters`` or, for
    "hetero", drawn in [0, DELAY_HETERO_MAX] (numpy seed)."""
    import numpy as np
    import torch
    rs = np.random.default_rng(seed)
    acc0 = torch.tensor(1.0 + rs.uniform(-64, 64, n) * 1e-6,
                        dtype=torch.float32, device=device)
    counts = (rs.integers(0, DELAY_HETERO_MAX + 1, n) if iters == "hetero"
              else np.full(n, iters))
    return acc0, torch.tensor(counts, dtype=torch.int32, device=device)


def check_delay(n, iters, device):
    """The delay kernel against its plain version at rtol DELAY_RTOL; a
    lane with no steps must come back untouched. Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.delay import ops
    from repro_torch.kernels.delay.ref import delay_chain_ref
    acc0, counts = delay_inputs(n, iters, device, seed=n)
    out = ops.delay_chain(acc0, counts)
    ref = delay_chain_ref(acc0, counts)
    ok, err = close(out, ref, DELAY_RTOL, 0.0)
    idle = counts <= 0
    if not ok or not torch.equal(out[idle], acc0[idle]):
        fail(f"delay_chain kernel disagrees with its plain version at N={n}, "
             f"iters {iters}: max abs err {err}")
    return err


def host_eval_checks(device):
    """One host-pool evaluation of a main-shape population on the card,
    bit-equal in row order to fitness.hostsim.rastrigin on the genomes
    copied to the host: identity dispatch over HOST_WORKERS, padded
    balanced dispatch (N % HOST_PAD_WORKERS != 0) under a static cost
    model, and under CostEMA (two rounds: cold, then learned)."""
    import torch
    from repro_torch.core.broker import Broker, CostEMA, HostPoolBackend
    from repro_torch.fitness import hostsim
    n, g = MAIN["islands"] * MAIN["pop"], MAIN["genes"]
    gen = torch.Generator(device=device).manual_seed(5)
    genomes = (torch.rand((n, g), generator=gen, device=device) * 2 - 1) \
        * BOUND
    expect = hostsim.rastrigin(genomes.cpu().numpy())
    ema = CostEMA()
    cases = [("identity", None, HOST_WORKERS),
             ("padded, static cost", lambda x: torch.sum(torch.abs(x), -1),
              HOST_PAD_WORKERS),
             ("padded, CostEMA", ema, HOST_PAD_WORKERS)]
    for name, cost_fn, w in cases:
        with HostPoolBackend(hostsim.rastrigin, num_workers=w) as backend:
            broker = Broker(cost_fn=cost_fn, num_workers=w, backend=backend)
            for _ in range(2 if cost_fn is ema else 1):
                fit, stats = broker.evaluate(genomes)
                if fit.device != genomes.device or \
                        not (fit.cpu().numpy() == expect).all():
                    fail(f"host pool ({name}, {w} workers) on ({n}, {g}) "
                         f"genomes on the card: fitness on {fit.device} not "
                         f"bit-equal to hostsim.rastrigin in row order")
        say(f"check: host pool, ({n}, {g}) genomes on the card, {name}, {w} "
            f"workers (padded {int(stats['padded'])}): fitness bit-equal to "
            f"hostsim.rastrigin in row order")
    if ema.updates != 2:
        fail(f"CostEMA took {ema.updates} updates in two rounds, expected 2")


def phase_check_host(device):
    """The delay chain kernel against its plain version (DELAY_NS x
    DELAY_ITERS, and heterogeneous counts); delay_proxy(sphere) bit-equal
    to sphere; the host pool on main-shape genomes on the card. Returns
    the kernel's max abs error at the timed shape (DELAY_MAIN)."""
    import torch
    from repro_torch.fitness import delay_proxy, sphere
    from repro_torch.kernels.delay import ops
    for n in DELAY_NS:
        for iters in DELAY_ITERS + ("hetero",):
            err = check_delay(n, iters, device)
            say(f"check: delay_chain N={n} iters {iters}: max abs err "
                f"{err:.3g} (rtol {DELAY_RTOL})")
    main_err = check_delay(*DELAY_MAIN, device)
    say(f"check: delay_chain {DELAY_MAIN}: max abs err {main_err:.3g}")
    gen = torch.Generator(device=device).manual_seed(3)
    genomes = torch.rand((MAIN["islands"] * MAIN["pop"], MAIN["genes"]),
                         generator=gen, device=device) * 2 - 1
    before = ops.launches
    out = delay_proxy(sphere, flop_iters=DELAY_MAIN[1])(genomes)
    if ops.launches != before + 1 or not torch.equal(out, sphere(genomes)):
        fail("delay_proxy(sphere) did not launch the delay kernel once, or "
             "is not bit-equal to sphere")
    say(f"check: delay_proxy(sphere, flop_iters={DELAY_MAIN[1]}) on "
        f"{tuple(genomes.shape)}: bit-equal to sphere, one kernel launch")
    host_eval_checks(device)
    return main_err


def run_captured(argv):
    """``ga_run.main(argv)`` with its standard output captured and echoed
    line by line. Returns (pop, hist, printed lines)."""
    import io
    from repro_torch.launch import ga_run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pop, hist = ga_run.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        say(f"main:   | {line}")
    return pop, hist, lines


def check_dispatch_line(lines, label):
    stats = [ln for ln in lines if ln.startswith("dispatch stats: ")]
    if stats != ["dispatch stats: retries=0"]:
        fail(f"{label}: dispatch stats line(s) {stats}, expected "
             f"'dispatch stats: retries=0'")


def phase_main_host():
    """``ga_run --fitness rastrigin`` at the main shape under host-thread,
    host-process and host-thread pipelined, and ``ga_run --fitness hvdc``
    on the German-size grid under host-thread with --cost-ema; each with
    the launch counts zeroed just before and read just after. Returns
    {run: {launches, wall_s, best genome, ...}}."""
    import torch
    from unittest import mock
    from repro_torch.core import broker as broker_mod
    from repro_torch.fitness import hostsim
    from repro_torch.kernels.delay import ops as delay_ops
    from repro_torch.kernels.genetic import ops
    expect = MAIN["gens_per_epoch"] * MAIN["epochs"]
    runs = {}
    for name, extra in HOST_RUNS.items():
        ops.launches = delay_ops.launches = 0
        t0 = time.perf_counter()
        pop, hist, lines = run_captured(MAIN_ARGS + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches
        say(f"main: ga_run rastrigin {' '.join(extra)}: {wall:.3f} s wall, "
            f"fused_variation launches {launches}, delay_chain launches "
            f"{delay_ops.launches}")
        if launches != expect:
            fail(f"fused_variation launched {launches} times in ga_run "
                 f"{name}, expected {expect}")
        check_dispatch_line(lines, f"ga_run {name}")
        g = pop.genomes.reshape(-1, MAIN["genes"])
        fit = pop.fitness.reshape(-1, 1)
        if not bool(torch.isfinite(fit).all()) or \
                not all(math.isfinite(h["best"]) for h in hist):
            fail(f"ga_run {name}: fitness not finite")
        if not (fit.cpu().numpy() == hostsim.rastrigin(g.cpu().numpy())).all():
            fail(f"ga_run {name}: stored fitness is not hostsim.rastrigin of "
                 f"the genomes bit for bit")
        best = g[int(torch.argmin(fit[:, 0]))].clone()
        runs[name] = dict(launches=launches, wall_s=wall, best=best,
                          best_fitness=hist[-1]["best"])
    names = list(HOST_RUNS)
    for other in names[1:]:
        if not torch.equal(runs[names[0]]["best"], runs[other]["best"]):
            fail(f"ga_run {other} changed the best genome of {names[0]}")
    say(f"main: best fitness {runs[names[0]]['best_fitness']!r}, "
        f"bit-identical best genome under {', '.join(names)}")

    # HVDC on the host pool, the learned cost model primed by the static
    # one; the CostEMA the run makes is recorded to read its updates
    made = []
    init = broker_mod.CostEMA.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    torch.cuda.empty_cache()
    ops.launches = delay_ops.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(broker_mod.CostEMA, "__init__", recording_init):
        pop, hist, lines = run_captured(HVDC_HOST_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches
    updates = [e.updates for e in made]
    say(f"main: ga_run hvdc host-thread --cost-ema: {wall:.3f} s wall (set-up "
        f"included), fused_variation launches {launches}, CostEMA updates "
        f"{updates}")
    if launches != HVDC_HOST_GENS:
        fail(f"fused_variation launched {launches} times in ga_run hvdc "
             f"host-thread, expected {HVDC_HOST_GENS}")
    check_dispatch_line(lines, "ga_run hvdc host-thread")
    if len(updates) != 1 or updates[0] <= 0:
        fail(f"ga_run hvdc --cost-ema: CostEMA updates {updates}")
    if not bool(torch.isfinite(pop.fitness).all()) or \
            not bool((pop.genomes.abs() <= 1.0).all()):
        fail("ga_run hvdc host-thread: fitness not finite or genomes outside "
             "[-1, 1]")
    runs["hvdc host-thread --cost-ema"] = dict(
        launches=launches, wall_s=wall, ema_updates=updates[0],
        skew=[h["skew"] for h in hist], best_fitness=hist[-1]["best"])
    return runs


def sass_chain(sass):
    """The dependent chain of one step of the delay kernel's loop, read
    from its SASS (``cuobjdump -sass``): (chain length in instructions,
    instructions executed per step). The loop is the body of the
    outermost backward branch. The executed path is sinf's fast path
    (|a| < 105615, every value the chain takes): a forward branch whose
    skipped range holds a backward branch (the slow path's reduction
    loop) is taken, every other instruction runs. The chain is the longest
    run of instructions on that path each reading a register (R or P) the
    one before wrote, ending in a register the loop carries to the next
    step."""
    import re
    inst = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?(P\d|PT)\s+)?([A-Z][A-Z0-9_.]*)"
                      r"([^;]*);")
    rows = [(int(m.group(1), 16), m.group(3), m.group(4), m.group(5))
            for m in inst.finditer(sass)]
    branches = [(addr, int(t.group(1), 16)) for addr, _, op, rest in rows
                if op == "BRA" and (t := re.search(r"0x([0-9a-f]+)", rest))]
    back = [(a, t) for a, t in branches if t < a]
    if not back:
        fail("delay_chain SASS: no loop (backward branch) found")
    end, start = max(back, key=lambda b: b[0] - b[1])
    skip = [(a, t) for a, t in branches if start <= a < t <= end
            and any(a < b < t and bt < b for b, bt in back)]
    path = [r for r in rows if start <= r[0] <= end
            and not any(a < r[0] < t for a, t in skip)
            and r[2] not in ("BRA", "BSSY", "BSYNC")]
    reg = re.compile(r"^!?(R\d+|P\d)(\.reuse)?$")
    depth, read_first, written = {}, set(), set()
    for _, guard, op, rest in path:
        args = [a.strip() for a in rest.split(",")]
        ndest = 1
        if op.split(".")[0] in ("ISETP", "FSETP", "DSETP") or (
                len(args) > 1 and args[0].startswith("P")
                and args[1].startswith("R")) or (
                len(args) > 1 and args[1].startswith("P")
                and op.startswith("IADD3")):
            ndest = 2
        srcs = [reg.match(a).group(1) for a in args[ndest:] if reg.match(a)]
        if guard:
            srcs.append(guard)
        read_first.update(r for r in srcs if r not in written)
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        for a in args[:ndest]:
            if reg.match(a):
                depth[reg.match(a).group(1)] = d
                written.add(reg.match(a).group(1))
    carried = read_first & written
    return max(depth[r] for r in carried), len(path)


def sass_loop(card):
    """``sass_chain`` of the delay kernel's library, as built."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    return sass_chain(subprocess.run(
        [str(tool), "-sass", str(_build.library_path("delay_chain"))],
        capture_output=True, text=True, check=True, timeout=120).stdout)


def delay_times(device, card, launches, main_err):
    """The delay kernel at DELAY_MAIN by device_ms beside its bounds: the
    operations (sinf, multiply, add a step; sinf one operation, as powf is
    for the fused variation) at the float32 SIMT rate, the bytes at the
    memory rate, and the dependent chain's latency floor (iters x the
    step's chain of dependent SASS instructions x DEP_CYCLES, at the card's
    highest SM clock); its plain version, one call. Returns the
    kernels-line entry."""
    from repro_torch.kernels.delay import ops
    from repro_torch.kernels.delay.ref import delay_chain_ref
    n, iters = DELAY_MAIN
    acc0, counts = delay_inputs(n, iters, device, seed=1)
    ms = device_ms(lambda: ops.delay_chain(acc0, counts), launches=5,
                   repeats=5)
    plain_ms = once_ms(lambda: delay_chain_ref(acc0, counts))
    mem_rate, f32_rate, _ = peaks(card)
    nops = DELAY_OPS_PER_STEP * n * iters
    nbytes = 12 * n
    ops_ms, bytes_ms = nops / f32_rate * 1e3, nbytes / mem_rate * 1e3
    chain, path = sass_loop(card)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    floor_ms = iters * chain * DEP_CYCLES / (mhz * 1e6) * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    cycles = ms * 1e-3 * mhz * 1e6 / iters
    say(f"times: delay_chain SASS: {path} instructions a step on sinf's fast "
        f"path, a dependent chain of {chain}")
    say(f"times: delay_chain ({n} lanes, {iters} steps): kernel {ms:.5f} ms "
        f"({cycles:.1f} cycles a step at {mhz:.0f} MHz); bound "
        f"{bound_ms:.5f} ms ({nops} ops at {f32_rate:.3g} op/s; {nbytes} B "
        f"at {mem_rate:.3g} B/s: {bytes_ms:.6f} ms), {bound_ms / ms:.4f} of "
        f"it; latency floor {floor_ms:.5f} ms ({iters} x {chain} x "
        f"{DEP_CYCLES} cycles), {floor_ms / ms:.3f} of it; plain version "
        f"{plain_ms:.3f} ms")
    return {"name": "delay_chain", "route": "cuda",
            "source": "src/repro_torch/kernels/delay/csrc/delay_chain.cu",
            "replaces": "src/repro/fitness/benchmarks.py:76",
            "launches": launches, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "latency_floor_ms": floor_ms,
            "sass_chain": chain, "sass_step_instructions": path,
            "sm_clock_mhz": mhz}


def measure_rho(device, *, workers, iters, islands, pop, genes,
                generations, epochs, fused, hp=None):
    """Paper eq. 1, as ``benchmarks/efficiency.py:30-87`` measures it:
    rho = T_eval / T_epoch. T_eval: ``epochs`` x ``generations`` broker
    evaluations of the full population under delay_proxy(sphere,
    flop_iters=iters), each fed by the last through a data dependency;
    T_epoch: the same epochs of the full GA (selection, variation,
    survivors, dispatch, migration and the same evaluations). Both after a
    warm-up, host clock around work that ends in a synchronize. Returns
    (rho, T_eval s, T_epoch s)."""
    import torch
    from repro_torch.configs.base import GAConfig
    from repro_torch.core.broker import Broker
    from repro_torch.core.island import evaluate_population, make_epoch_step
    from repro_torch.core.population import init_population
    from repro_torch.fitness import delay_proxy, sphere
    hp = hp or {}
    cfg = GAConfig(num_genes=genes, pop_per_island=pop, num_islands=islands,
                   generations_per_epoch=generations, num_epochs=epochs,
                   lower=-1.0, upper=1.0, fused_operators=fused, seed=0,
                   **hp)
    broker = Broker(delay_proxy(sphere, flop_iters=iters),
                    num_workers=workers)
    epoch = make_epoch_step(cfg, broker, device)
    flat = cfg.global_pop

    def eval_epoch(genomes):
        c = genomes
        for _ in range(generations):
            f, _ = broker.evaluate(c.reshape(flat, genes))
            c = c + 0.0 * f.reshape(islands, pop, -1)[..., :1] * 0.0
        return c

    p = evaluate_population(cfg, broker, init_population(cfg, 0, device))
    epoch(p)
    eval_epoch(p.genomes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        out = eval_epoch(p.genomes)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    del out
    p2 = p
    t0 = time.perf_counter()
    for _ in range(epochs):
        p2, _ = epoch(p2)
    torch.cuda.synchronize()
    t_epoch = time.perf_counter() - t0
    return t_eval / t_epoch, t_eval, t_epoch


def rho_times(device, card):
    """rho at Fig. 4's (workers, iters) points at the reference's GA, and
    at the main shape with the main path's GA; the delay kernel's launches
    over the main-shape measurement (counted from zero, which must equal
    the evaluations it ran). Returns (rows, main-shape launches, launches
    over the Fig. 4 points)."""
    from repro_torch.kernels.delay import ops
    rows = []
    ops.launches = 0
    for workers, iters in FIG4_POINTS:
        rho, t_eval, t_epoch = measure_rho(device, workers=workers,
                                           iters=iters, **FIG4_GA)
        rows.append(dict(point="fig4", workers=workers, iters=iters, rho=rho,
                         t_eval_s=t_eval, t_epoch_s=t_epoch))
        say(f"times: rho fig4 workers={workers} iters={iters}: {rho:.6f} "
            f"(T_eval {t_eval:.6f} s, T_epoch {t_epoch:.6f} s; GA "
            f"{FIG4_GA})")
    fig4_launches = ops.launches
    workers, iters = RHO_MAIN
    ops.launches = 0
    rho, t_eval, t_epoch = measure_rho(
        device, workers=workers, iters=iters, islands=MAIN["islands"],
        pop=MAIN["pop"], genes=MAIN["genes"],
        generations=MAIN["gens_per_epoch"], epochs=RHO_MAIN_EPOCHS,
        fused=True, hp=dict(mutation_prob=HP["prob_mut"],
                            mutation_eta=HP["eta_mut"],
                            crossover_prob=HP["prob_cx"],
                            crossover_eta=HP["eta_cx"]))
    launches = ops.launches
    gens = MAIN["gens_per_epoch"]
    expect = 1 + 2 * gens + 2 * RHO_MAIN_EPOCHS * gens
    say(f"times: rho main shape ({MAIN['islands']}, {MAIN['pop']}, "
        f"{MAIN['genes']}) workers={workers} iters={iters}: {rho:.6f} "
        f"(T_eval {t_eval:.6f} s, T_epoch {t_epoch:.6f} s over "
        f"{RHO_MAIN_EPOCHS} epochs of {gens} generations); delay_chain "
        f"launches {launches}")
    if launches != expect:
        fail(f"delay_chain launched {launches} times over the main-shape rho "
             f"measurement, expected {expect}")
    rows.append(dict(point="main", workers=workers, iters=iters, rho=rho,
                     t_eval_s=t_eval, t_epoch_s=t_epoch))
    say("times: rho " + json.dumps({"card": card, "rows": rows}))
    return rows, launches, fig4_launches


def host_generation_times(pop, device, card):
    """One main-shape generation phase by phase under inline, host-thread
    and host-process (generation_phases, CUDA events), and for the host
    backends the fitness split into its device->host copy, host
    evaluation and host->device copy (cuda_ms, median of 3)."""
    import torch
    from repro_torch.core.broker import Broker, HostPoolBackend
    from repro_torch.fitness import hostsim, rastrigin
    from repro_torch.kernels.genetic import ops
    i, p, g = pop.genomes.shape
    scalars = ops.pack_scalars(HP["eta_cx"], HP["prob_cx"], HP["eta_mut"],
                               HP["prob_mut"], 1.0 / g, device=device)
    offspring = pop.genomes.reshape(i * p, g).contiguous()
    out = {"card": card}
    for name in ("inline", "host-thread", "host-process"):
        with contextlib.ExitStack() as stack:
            if name == "inline":
                broker = Broker(rastrigin)
            else:
                backend = stack.enter_context(HostPoolBackend(
                    hostsim.rastrigin, num_workers=HOST_WORKERS,
                    executor=name.split("-")[1]))
                broker = Broker(num_workers=HOST_WORKERS, backend=backend)
            phases = generation_phases(pop, broker, scalars, BOUND, device)
            row = dict(phase_ms=phases,
                       generation_ms=sum(phases.values()))
            if name != "inline":
                state = {}
                for key, fn in (
                        ("d2h_ms", lambda: state.update(
                            host=offspring.cpu().numpy())),
                        ("host_eval_ms", lambda: state.update(
                            fit=backend._host_eval(state["host"]))),
                        ("h2d_ms", lambda: torch.from_numpy(
                            state["fit"]).to(device))):
                    row[key] = cuda_ms(fn, repeats=3, inner=1)
        out[name] = row
        say(f"times: one generation at ({i}, {p}, {g}) under {name}, ms per "
            f"phase: " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
            + f"; total {row['generation_ms']:.4f}"
            + ("" if name == "inline" else
               f"; fitness split: device->host {row['d2h_ms']:.4f}, host "
               f"evaluation {row['host_eval_ms']:.4f}, host->device "
               f"{row['h2d_ms']:.4f}"))
    return out


def ema_dispatch_times(device, card):
    """The learned cost model's first vs learned dispatch, set up as
    ``benchmarks/broker_overhead.py:150-180``: N genomes whose hot rows are
    exactly one lane of the uniform balanced assignment, delay_sphere
    sleeping slow_s a hot row, a host thread pool of W; round 1 after a
    reset (unlearned; once_ms), then one warm round and the mean of 3
    (learned; cuda_ms). ms per evaluate, and the skew vs naive skew the
    broker reports."""
    import functools
    import numpy as np
    import torch
    from repro_torch.core.broker import (Broker, CostEMA, HostPoolBackend,
                                         balanced_permutation)
    from repro_torch.fitness import hostsim
    n, w, slow_s, genes = (EMA_DISPATCH[k] for k in ("n", "w", "slow_s",
                                                     "genes"))
    perm0 = balanced_permutation(torch.ones(n), w).numpy()
    hot = np.zeros(n, bool)
    hot[perm0[:n // w]] = True
    het = np.random.default_rng(0).uniform(-1, 1, (n, genes)).astype(
        np.float32)
    het[:, 0] = np.where(hot, 1.0, -1.0)
    fast = het.copy()
    fast[:, 0] = -1.0
    het_g, fast_g = (torch.tensor(a, device=device) for a in (het, fast))
    ema = CostEMA(alpha=0.6)
    fn = functools.partial(hostsim.delay_sphere, slow_s=slow_s)
    with HostPoolBackend(fn, num_workers=w) as backend:
        broker = Broker(cost_fn=ema, num_workers=w, backend=backend)
        broker.evaluate(fast_g)
        ema.reset()
        res = {}
        first_ms = once_ms(lambda: res.update(r1=broker.evaluate(het_g)))
        learned_ms = cuda_ms(lambda: res.update(r=broker.evaluate(het_g)),
                             repeats=1, inner=3)
    rows = {}
    for name, ms, key in (("first", first_ms, "r1"),
                          ("learned", learned_ms, "r")):
        stats = res[key][1]
        rows[name] = dict(ms_per_evaluate=ms, skew=float(stats["skew"]),
                          naive_skew=float(stats["naive_skew"]))
        say(f"times: CostEMA {name} dispatch (n {n}, w {w}, delay_sphere "
            f"slow_s {slow_s}): {ms:.3f} ms per evaluate, skew "
            f"{rows[name]['skew']:.4f} vs naive skew "
            f"{rows[name]['naive_skew']:.4f}")
    return {"card": card, **rows}


def phase_times_host(pop, device, card, host_runs, delay_err):
    """Times of this path: rho (Fig. 4 and the main shape), the delay
    kernel beside its bounds, one generation per dispatch backend, the
    CostEMA's first vs learned dispatch. Returns the delay kernel's
    kernels-line entry."""
    rows, launches, fig4_launches = rho_times(device, card)
    entry = delay_times(device, card, launches, delay_err)
    entry["launches_by_path"] = {"rho main shape": launches,
                                 "rho fig4 points": fig4_launches}
    gens = host_generation_times(pop, device, card)
    ema = ema_dispatch_times(device, card)
    say("times: host " + json.dumps({
        "card": card, "rho": rows, "generation": gens, "cost_ema": ema,
        "runs_wall_s": {k: v["wall_s"] for k, v in host_runs.items()},
        "delay_chain": {k: v for k, v in entry.items()
                        if k not in ("source", "replaces")}}))
    return entry


# ---------------------------------------------------------------------------
# The paper's central message broker: the queue backends
# ---------------------------------------------------------------------------

def queue_backend(kind, simulator, root):
    """One queue backend of ``kind`` over QUEUE_WORKERS workers, its
    fitness the ``fitness.hostsim`` simulator named, resolved by the
    workers from its import spec; spool and broker directories under
    ``root``. Built as ``ga_run`` builds them (slurm-mock spawns a numpy
    subprocess per chunk, k8s-mock runs threads behind an in-process
    kubectl, mq-net boots its own server)."""
    from repro_torch.runtime import batchq, mq, netbroker
    common = dict(fn_spec=f"repro_torch.fitness.hostsim:{simulator}",
                  num_workers=QUEUE_WORKERS, chunk_timeout_s=300.0)
    if kind in ("slurm-mock", "k8s-mock"):
        scheduler = (batchq.LocalMockScheduler() if kind == "slurm-mock"
                     else batchq.KubernetesScheduler(
                         runner=batchq.MockKubectl()))
        return batchq.SlurmArrayBackend(
            scheduler=scheduler, spool_dir=str(Path(root) / "spool"),
            **common)
    if kind.startswith("mq "):
        pool = mq.LocalWorkerPool(QUEUE_WORKERS, kind.split()[1])
        return mq.QueueBackend(mq_dir=str(Path(root) / "mq"),
                               worker_pool=pool, **common)
    return netbroker.SocketQueueBackend(
        worker_pool=netbroker.NetWorkerPool(QUEUE_WORKERS, "thread"),
        **common)


def worker_commands(kind, backend):
    """The command lines of a kind's spawned workers: the pool's members
    (read back from /proc) or the mock scheduler's per-chunk
    subprocesses; [] for kinds whose workers are threads."""
    if kind == "mq subprocess":
        return [Path(f"/proc/{m.pid}/cmdline").read_bytes()
                .replace(b"\0", b" ").decode()
                for m in backend.worker_pool._members]
    if kind == "slurm-mock":
        return [" ".join(task.args)
                for task in backend.scheduler._tasks.values()
                if hasattr(task, "args")]
    return []


def phase_check_queue(device):
    """The broker's padded cost-balanced dispatch through each queue
    backend, on card genomes: fitness on the card, bit-equal in row order
    to the hostsim simulator of the genomes copied to the host, padding
    padded_size(n, W) - n, balanced 1; the spawned workers are the
    port's."""
    import tempfile
    import torch
    from repro_torch.core.broker import Broker, padded_size
    from repro_torch.fitness import hostsim
    gen = torch.Generator(device=device).manual_seed(11)
    for kind in QUEUE_KINDS:
        for n, g, simulator in QUEUE_CHECK_SHAPES:
            genomes = (torch.rand((n, g), generator=gen, device=device)
                       * 2 - 1) * BOUND
            expect = getattr(hostsim, simulator)(genomes.cpu().numpy())
            with tempfile.TemporaryDirectory() as root, \
                    queue_backend(kind, simulator, root) as backend:
                broker = Broker(
                    cost_fn=lambda x: torch.sum(torch.abs(x), -1) + 0.1,
                    num_workers=QUEUE_WORKERS, backend=backend)
                fit, stats = broker.evaluate(genomes)
                commands = worker_commands(kind, backend)
            if fit.device != genomes.device or \
                    not (fit.cpu().numpy() == expect).all():
                fail(f"{kind} on ({n}, {g}) genomes on the card: fitness on "
                     f"{fit.device} not bit-equal to hostsim.{simulator}")
            pad = padded_size(n, QUEUE_WORKERS) - n
            if int(stats["padded"]) != pad or float(stats["balanced"]) != 1:
                fail(f"{kind} on ({n}, {g}): padded {int(stats['padded'])} "
                     f"(expected {pad}), balanced {float(stats['balanced'])}")
            worker = {"mq subprocess": "repro_torch.runtime.mq",
                      "slurm-mock": "repro_torch.runtime.batchq"}.get(kind)
            if worker is not None and (
                    not commands
                    or not all(f"-m {worker} --worker" in c
                               for c in commands)):
                fail(f"{kind}: spawned workers {commands} are not "
                     f"python -m {worker} --worker")
            say(f"check: {kind}, ({n}, {g}) genomes on the card, padded "
                f"{pad}, balanced: fitness bit-equal to hostsim.{simulator}"
                + (f"; {len(commands)} spawned worker(s) ran -m {worker}"
                   if worker else ""))


def queue_dirs_clean(name, root, listing=None):
    """After a queue run: the broker's tasks/, claimed/ and runs/ empty (the
    file broker's directory, or the socket server's listing taken before
    it stopped), or no more than the kept job directories left in the
    spool and no *.tmp anywhere."""
    root = Path(root)
    if listing is not None:
        left = {d: listing[d] for d in ("tasks", "claimed", "runs")}
    elif (root / "mq").is_dir():
        left = {d: sorted(p.name for p in (root / "mq" / d).iterdir())
                for d in ("tasks", "claimed", "runs")}
    else:
        jobs = sorted(p.name for p in (root / "spool").glob("job_*"))
        left = {"job dirs past --keep-jobs": jobs[:-4] if len(jobs) > 4
                else []}
    left["tmp"] = sorted(str(p) for p in root.rglob("*.tmp"))
    if any(left.values()):
        fail(f"ga_run {name}: left behind {left}")


def phase_main_queue(host_runs):
    """``ga_run --fitness rastrigin`` at the main shape under each queue
    backend (QUEUE_RUNS; QUEUE_METRICS_RUN also with --cost-ema,
    --metrics-dir and --events-log), each with the launch counts zeroed
    just before and read just after: one fused variation launch a
    generation, the stored fitness hostsim.rastrigin of the genomes bit
    for bit, the best genome bit-identical to host-thread's, the broker
    clean after. Returns {run: {launches, wall_s, ...}}."""
    import tempfile
    import torch
    from unittest import mock
    from repro_torch.fitness import hostsim
    from repro_torch.kernels.genetic import ops
    from repro_torch.obs import parse_prometheus_text
    from repro_torch.runtime import netbroker
    expect = MAIN["gens_per_epoch"] * MAIN["epochs"]
    evaluations = expect + 1                 # the initial population too
    runs = {}
    for name, extra in QUEUE_RUNS.items():
        with tempfile.TemporaryDirectory() as root:
            argv = MAIN_ARGS + HOST_ARGS + extra
            if name.startswith("mq") and name != "mq-net":
                argv += ["--mq-dir", str(Path(root) / "mq")]
            elif name != "mq-net":
                argv += ["--spool-dir", str(Path(root) / "spool")]
            metrics = name == QUEUE_METRICS_RUN
            if metrics:
                argv += ["--cost-ema", "--metrics-dir",
                         str(Path(root) / "metrics"), "--events-log",
                         str(Path(root) / "events.jsonl")]
            listing = {}
            teardown = netbroker.SocketQueueBackend._t_teardown

            def listed_teardown(self, remove_dir):
                listing.update(self.client.listdir())
                teardown(self, remove_dir)

            ops.launches = 0
            t0 = time.perf_counter()
            with mock.patch.object(netbroker.SocketQueueBackend,
                                   "_t_teardown", listed_teardown):
                pop, hist, lines = run_captured(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launches
            say(f"main: ga_run rastrigin {' '.join(extra)}"
                f"{' --cost-ema --metrics-dir --events-log' if metrics else ''}"
                f": {wall:.3f} s wall, fused_variation launches {launches}")
            if launches != expect:
                fail(f"fused_variation launched {launches} times in ga_run "
                     f"{name}, expected {expect}")
            stats = [ln for ln in lines if ln.startswith("dispatch stats: ")]
            if len(stats) != 1 or "retries=0" not in stats[0].split():
                fail(f"ga_run {name}: dispatch stats {stats}")
            g = pop.genomes.reshape(-1, MAIN["genes"])
            fit = pop.fitness.reshape(-1, 1)
            if not (fit.cpu().numpy()
                    == hostsim.rastrigin(g.cpu().numpy())).all():
                fail(f"ga_run {name}: stored fitness is not "
                     f"hostsim.rastrigin of the genomes bit for bit")
            best = g[int(torch.argmin(fit[:, 0]))]
            if not torch.equal(best, host_runs["host-thread"]["best"]):
                fail(f"ga_run {name}: best genome differs from host-thread's")
            queue_dirs_clean(name, root,
                             listing if name == "mq-net" else None)
            row = dict(launches=launches, wall_s=wall,
                       best_fitness=hist[-1]["best"], stats=stats[0])
            if metrics:
                prom = parse_prometheus_text(
                    (Path(root) / "metrics" / "chambga.prom").read_text())
                total = {}
                for (key, _labels), v in prom.items():
                    total[key] = total.get(key, 0.0) + v
                chunks = total.get("mq_chunks_enqueued_total")
                durations = total.get("dispatch_chunk_duration_seconds_count")
                if total.get("mq_jobs_total") != evaluations or \
                        chunks != evaluations * QUEUE_WORKERS or \
                        durations != chunks or \
                        total.get("cost_ema_updates_total") != chunks:
                    fail(f"ga_run {name}: chambga.prom jobs "
                         f"{total.get('mq_jobs_total')}, chunks {chunks}, "
                         f"dispatch_chunk_duration_seconds count "
                         f"{durations}, cost_ema updates "
                         f"{total.get('cost_ema_updates_total')} (expected "
                         f"{evaluations} jobs of {QUEUE_WORKERS} chunks)")
                events = (Path(root) / "events.jsonl").read_text().splitlines()
                row.update(prom_chunks=chunks, events=len(events),
                           chunk_seconds=total.get(
                               "dispatch_chunk_duration_seconds_sum"))
                say(f"main: ga_run {name} metrics: chambga.prom parses, "
                    f"{int(chunks)} chunks dispatched = "
                    f"dispatch_chunk_duration_seconds count = CostEMA "
                    f"updates; {len(events)} events")
        runs[name] = row
    say(f"main: best genome under {', '.join(QUEUE_RUNS)} bit-identical to "
        f"host-thread's; stored fitness hostsim.rastrigin bit for bit; "
        f"brokers clean")
    return runs


def queue_generation_phases(backend, host_genomes):
    """One ``_host_eval`` of the host genomes, split by the host clock
    into the enqueue or spool write (task publication and, for the batch
    backends, the scheduler submission), the collect (concatenation and
    scatter of the chunk results) and the wait for results (the rest).
    Counts only the calling thread's publications: thread workers publish
    their results through the same functions. Returns ms per phase."""
    import threading
    from unittest import mock
    from repro_torch.runtime import batchq, mq
    me = threading.get_ident()
    spent = {"enqueue": 0.0, "collect": 0.0}

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            if threading.get_ident() != me:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapped

    module = batchq if isinstance(backend, batchq.SlurmArrayBackend) else mq
    with contextlib.ExitStack() as stack:
        for fn_name in ("collect_chunk_results", "scatter_chunk_results"):
            stack.enter_context(mock.patch.object(
                module, fn_name, timed(getattr(module, fn_name), "collect")))
        if module is batchq:
            stack.enter_context(mock.patch.object(
                batchq, "atomic_savez", timed(batchq.atomic_savez,
                                              "enqueue")))
            stack.enter_context(mock.patch.object(
                backend.scheduler, "submit",
                timed(backend.scheduler.submit, "enqueue")))
        else:
            stack.enter_context(mock.patch.object(
                backend, "_t_enqueue", timed(backend._t_enqueue,
                                             "enqueue")))
        t0 = time.perf_counter()
        backend._host_eval(host_genomes)
        total = time.perf_counter() - t0
    return {"enqueue_ms": spent["enqueue"] * 1e3,
            "wait_ms": (total - spent["enqueue"] - spent["collect"]) * 1e3,
            "collect_ms": spent["collect"] * 1e3, "host_eval_ms": total * 1e3}


def queue_generation_times(pop, device, card):
    """One main-shape generation under each queue backend, phase by phase
    (generation_phases, CUDA events, median of 3), and its fitness split
    into device->host copy, enqueue or spool write, wait for results,
    collect and host->device copy (median of 3)."""
    import tempfile
    import torch
    from repro_torch.core.broker import Broker
    from repro_torch.kernels.genetic import ops
    i, p, g = pop.genomes.shape
    scalars = ops.pack_scalars(HP["eta_cx"], HP["prob_cx"], HP["eta_mut"],
                               HP["prob_mut"], 1.0 / g, device=device)
    offspring = pop.genomes.reshape(i * p, g).contiguous()
    state = {"host": offspring.cpu().numpy()}
    out = {"card": card}
    for kind in QUEUE_KINDS:
        with tempfile.TemporaryDirectory() as root, \
                queue_backend(kind, "rastrigin", root) as backend:
            broker = Broker(num_workers=QUEUE_WORKERS, backend=backend)
            phases = generation_phases(pop, broker, scalars, BOUND, device)
            row = dict(phase_ms=phases, generation_ms=sum(phases.values()))
            row["d2h_ms"] = cuda_ms(lambda: state.update(
                host=offspring.cpu().numpy()), repeats=3, inner=1)
            split = [queue_generation_phases(backend, state["host"])
                     for _ in range(3)]
            for key in split[0]:
                row[key] = statistics.median(s[key] for s in split)
            fit = backend._host_eval(state["host"])
            row["h2d_ms"] = cuda_ms(lambda: torch.from_numpy(fit).to(device),
                                    repeats=3, inner=1)
        out[kind] = row
        say(f"times: one generation at ({i}, {p}, {g}) under {kind}, ms per "
            f"phase: " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
            + f"; total {row['generation_ms']:.4f}; fitness split: "
            f"device->host {row['d2h_ms']:.4f}, enqueue {row['enqueue_ms']:.4f}"
            f" ({offspring.numel() * 4} B in {QUEUE_WORKERS} chunks), wait "
            f"{row['wait_ms']:.4f}, collect {row['collect_ms']:.4f}, "
            f"host->device {row['h2d_ms']:.4f}")
    return out


def transport_latency(card):
    """One task's round trip, enqueue -> claim -> lease -> publish ->
    fetched, median of QUEUE_LATENCY_REPS, over the file broker (the
    protocol functions on a directory) and the socket broker (the same
    steps as frames to a BrokerServer), as
    ``benchmarks/broker_overhead.py``'s ``*_result_latency`` rows (8 x 4
    genomes)."""
    import os
    import tempfile
    import numpy as np
    from repro_torch.fitness import hostsim
    from repro_torch.runtime import mq
    from repro_torch.runtime.fsatomic import atomic_savez
    from repro_torch.runtime.netbroker import BrokerClient, BrokerServer
    g = np.random.default_rng(7).uniform(-1, 1, (8, 4)).astype(np.float32)
    fit = hostsim.sphere(g)
    spec = "repro_torch.fitness.hostsim:sphere"
    lats = {"file": [], "socket": []}
    with tempfile.TemporaryDirectory() as d:
        mq.make_broker_dirs(d)
        mq.register_run(d, "a", fn_spec=spec)
        for i in range(QUEUE_LATENCY_REPS):
            name = mq.task_name("a", 1, i, 0, 0)
            t0 = time.perf_counter()
            atomic_savez(os.path.join(d, mq.TASKS_DIR, name), genomes=g)
            got = mq.claim_next(d)
            mq.write_lease(d, got)
            mq.publish_result(d, got, fit, 0.01)
            with np.load(mq.mq_result_path(d, got)) as z:
                z["fitness"]
            lats["file"].append(time.perf_counter() - t0)
            mq.release_claim(d, got)
            os.remove(mq.mq_result_path(d, got))
    with BrokerServer() as server, BrokerClient(server.addr) as client:
        client.register_run("a", fn_spec=spec)
        for i in range(QUEUE_LATENCY_REPS):
            name = mq.task_name("a", 1, i, 0, 0)
            t0 = time.perf_counter()
            client.enqueue(name, g)
            reply, _ = client.claim()
            got = reply["name"]
            client.lease(got)
            client.result(got, fit, 0.01)
            if client.result_fetch(got) is None:
                fail("socket broker: a published result was not fetched")
            lats["socket"].append(time.perf_counter() - t0)
            client.release(got)
    row = {k: statistics.median(v) * 1e6 for k, v in lats.items()}
    say(f"times: transport round trip (enqueue -> claim -> lease -> publish "
        f"-> fetched, median of {QUEUE_LATENCY_REPS}, µs): file broker "
        f"{row['file']:.1f}, socket broker {row['socket']:.1f}")
    return {"card": card, "us": row}


def metrics_cost(pop, card):
    """One main-shape dispatch through the mq thread pool with the metrics
    bus off and on (a MetricsRegistry and a JSONL event log), ms per
    ``_host_eval``, median of QUEUE_METRICS_REPS after one warm-up, in
    turns off, on, on, off."""
    import tempfile
    from repro_torch.obs import EventLog, MetricsRegistry
    from repro_torch.runtime import metrics as runtime_metrics
    genomes = pop.genomes.reshape(-1, MAIN["genes"]).cpu().numpy()
    times = {"off": [], "on": []}
    with tempfile.TemporaryDirectory() as root, \
            queue_backend("mq thread", "rastrigin", root) as backend:
        backend._host_eval(genomes)
        for turn in ("off", "on", "on", "off"):
            log = None
            if turn == "on":
                log = EventLog(str(Path(root) / "events.jsonl"))
                runtime_metrics.set_registry(MetricsRegistry(events=log))
            try:
                for _ in range(QUEUE_METRICS_REPS):
                    t0 = time.perf_counter()
                    backend._host_eval(genomes)
                    times[turn].append((time.perf_counter() - t0) * 1e3)
            finally:
                runtime_metrics.set_registry(None)
                if log is not None:
                    log.close()
    row = {k: statistics.median(v) for k, v in times.items()}
    say(f"times: mq thread dispatch of ({len(genomes)}, {MAIN['genes']}) "
        f"genomes, metrics bus off {row['off']:.4f} ms, on {row['on']:.4f} "
        f"ms (median of {2 * QUEUE_METRICS_REPS} each, in turns)")
    return {"card": card, "ms": row}


def phase_times_queue(pop, device, card, queue_runs):
    say("times: queue " + json.dumps({
        "card": card,
        "generation": queue_generation_times(pop, device, card),
        "transport": transport_latency(card),
        "metrics": metrics_cost(pop, card),
        "runs_wall_s": {k: v["wall_s"] for k, v in queue_runs.items()}}))


# ---------------------------------------------------------------------------
# LM serving path: flash attention and SSD kernels, prefill + decode
# ---------------------------------------------------------------------------

def attn_tensors(case, device, seed, t=None):
    import torch
    b, s, h, kv, hd = case[:5]
    dtype = getattr(torch, case[8])
    t = s if t is None else t
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


def attn_kwargs(case, q_offset=0):
    hd, causal, window, cap = case[4:8]
    return dict(scale=hd ** -0.5, causal=causal, window=window,
                attn_softcap=cap, q_offset=q_offset)


def check_flash(case, device, seed, t=None, q_offset=0):
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    q, k, v = attn_tensors(case, device, seed, t)
    kw = attn_kwargs(case, q_offset)
    out = attn_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = attn_ops.flash_attention_plain(q, k, v, **kw)
    ok, err = close(out.float(), ref.float(), *ATTN_TOL[case[8]])
    if not ok or out.dtype != q.dtype:
        fail(f"flash attention kernel disagrees with its plain version at "
             f"{case} q_offset={q_offset}: max abs err {err}")
    return err, out


def ssd_tensors(b, l, h, p, n, device, seed, mamba2=False):
    """x, dt, a, B, C. By default drawn as tests/test_kernels.py draws them
    (dt = softplus(z), a = -exp(0.3 z): ~-0.8 per step, so a 256-step
    chunk decays to 0 in float32); with ``mamba2``, in the range of
    Mamba-2's own initialisation (dt log-uniform in [1e-3, 1e-1],
    a = -U(1, 16), one head per 1/H stratum of the range so the slowest
    heads are always drawn), where the decay across a chunk and between
    chunks stays above 0 on the heads of small |a|."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)
    x = rnd(b, l, h, p) * 0.5
    if mamba2:
        dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1), b, l, h))
        a = -(1.0 + 15.0 * (torch.arange(h, device=device)
                            + uniform(0.0, 1.0, h)) / h)
    else:
        dt = torch.nn.functional.softplus(rnd(b, l, h))
        a = -torch.exp(rnd(h) * 0.3)
    return x, dt, a, rnd(b, l, n) * 0.3, rnd(b, l, n) * 0.3


def check_ssd(case, device, seed, intra=True, mamba2=False):
    import torch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import (ssd_chunked_ref,
                                             ssd_intra_chunk_plain)
    b, l, h, p, n, q = case
    args = ssd_tensors(b, l, h, p, n, device, seed, mamba2)
    err = 0.0
    if intra:
        out = ssd_ops.ssd_intra_chunk(*args, chunk=q)
        torch.cuda.synchronize()
        ref = ssd_intra_chunk_plain(*args, chunk=q)
        for name, a, r in zip(("y_diag", "states", "in_decay"), out, ref):
            ok, e = close(a, r, *SSD_TOL)
            if not ok:
                fail(f"SSD kernel's {name} disagrees with its plain version "
                     f"at {case}: max abs err {e}")
            err = max(err, e)
        if mamba2:
            # the chunk's decay exp(cum_Q) carries the state between chunks
            decay = float(out[2][..., -1].max())
            if not decay > SSD_MIN_DECAY:
                fail(f"SSD inputs at {case}: the largest chunk decay is "
                     f"{decay}, not above {SSD_MIN_DECAY}")
            say(f"check: SSD {case}, Mamba-2's range: largest chunk decay "
                f"{decay:.4g}")
    y, s = ssd_ops.ssd_chunked(*args, q)
    y_ref, s_ref = ssd_chunked_ref(*args, q)
    for name, a, r in (("y", y, y_ref), ("final state", s, s_ref)):
        ok, e = close(a, r, *SSD_TOL)
        if not ok:
            fail(f"ssd_chunked's {name} disagrees with ssd_chunked_ref at "
                 f"{case}: max abs err {e}")
        err = max(err, e)
    return err


def phase_check_lm(device):
    """Flash attention and SSD kernels against their plain versions."""
    for i, case in enumerate(ATTN_CASES):
        err, _ = check_flash(case, device, seed=i)
        say(f"check: flash attention {case}: max abs err {err:.3g}")
    m = ATTN_MASKED
    err, out = check_flash(m["case"], device, seed=7, t=m["t"],
                           q_offset=m["q_offset"])
    if not bool((out[:, m["first_masked"]:] == 0).all()):
        fail("flash attention: fully masked rows are not zero")
    say(f"check: flash attention q_offset {m['q_offset']} (rows "
        f">= {m['first_masked']} fully masked, zeros): max abs err {err:.3g}")
    flash_err = 0.0
    for i, case in enumerate(ATTN_MAIN):
        err, _ = check_flash(case, device, seed=100 + i)
        flash_err = max(flash_err, err)
        say(f"check: flash attention main-path shape {case}: max abs err "
            f"{err:.3g}")
    for i, case in enumerate(SSD_CASES):
        err = check_ssd(case, device, seed=i)
        say(f"check: SSD {case}: max abs err {err:.3g}")
    ssd_err = 0.0
    padded = SSD_MAIN[:1] + (SSD_SERVE_L,) + SSD_MAIN[2:]
    for mamba2 in (False, True):
        draws = "Mamba-2's range" if mamba2 else "the tests' draws"
        err = check_ssd(SSD_MAIN, device, seed=200, mamba2=mamba2)
        ssd_err = max(ssd_err, err)
        say(f"check: SSD main-path shape {SSD_MAIN}, {draws}: max abs err "
            f"{err:.3g}")
        err = check_ssd(padded, device, seed=201, intra=False, mamba2=mamba2)
        say(f"check: ssd_chunked at the serving path's {padded} (padded to "
            f"whole chunks), {draws}: max abs err {err:.3g}")
    return flash_err, ssd_err


def serve_args(arch, prompt):
    return ["--arch", arch, "--no-reduced", "--device", "cuda",
            "--batch", str(SERVE_BATCH), "--prompt-len", str(prompt),
            "--gen", str(SERVE_GEN)]


def phase_serve():
    """The serving path at published widths, one run per model, with the
    kernels' launch counts zeroed just before and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve
    launches = {}
    for arch, prompt, expect in SERVE_RUNS:
        attn_ops.launches = ssd_ops.launches = 0
        stats = {}
        t0 = time.perf_counter()
        out = serve.main(serve_args(arch, prompt), stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"flash_attention": attn_ops.launches,
               "ssd_chunk": ssd_ops.launches}
        want = dict({"flash_attention": 0, "ssd_chunk": 0}, **expect)
        say(f"main: serve {arch} --no-reduced batch {SERVE_BATCH} prompt "
            f"{prompt} gen {SERVE_GEN}: {wall:.3f} s wall (set-up "
            f"included), launches {got}")
        if got != want:
            fail(f"serve {arch}: kernel launches {got}, expected {want}")
        if not stats.get("logits_finite"):
            fail(f"serve {arch}: a logit is not finite")
        vocab = get_config(arch).vocab_size
        if tuple(out.shape) != (SERVE_BATCH, SERVE_GEN) or \
                int(out.min()) < 0 or int(out.max()) >= vocab:
            fail(f"serve {arch}: tokens of shape {tuple(out.shape)} in "
                 f"[{int(out.min())}, {int(out.max())}]")
        launches.update(expect)
        torch.cuda.empty_cache()
    return launches


def tensor_bound(flops, nbytes, card):
    """The least time of a kernel whose float32 products run as 3xTF32 on
    the tensor cores: the larger of its bytes over the memory rate and
    3 x its FLOP over the TF32 rate. Also the bound at the float32 rate
    outside the tensor cores, for comparison with SIMT designs."""
    mem_rate, f32_rate, tf32_rate = peaks(card)
    bytes_ms = nbytes / mem_rate * 1e3
    tc_ms = TF32_PRODUCTS * flops / tf32_rate * 1e3
    simt_ms = flops / f32_rate * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(bytes_ms, tc_ms),
            "bound_by": "bytes" if bytes_ms >= tc_ms else "operations",
            "simt_bound_ms": max(bytes_ms, simt_ms), "rates": (
                f"{flops} FLOP x {TF32_PRODUCTS} at {tf32_rate:.3g} TF32 "
                f"op/s, or at {f32_rate:.3g} float32 op/s; {nbytes} bytes "
                f"at {mem_rate:.3g} B/s")}


def flash_bound(case, card):
    """float32 multiply-adds over the visible (query, key) pairs (2 hd for
    Q K^T, 2 hd for P V, per query head), and q, k, v, out each moved
    once (``tensor_bound``)."""
    b, s, h, kv, hd, causal, window = case[:7]
    pairs = 0
    for pos in range(s):
        vis = pos + 1 if causal else s
        pairs += min(vis, window) if window else vis
    itemsize = 2 if case[8] == "bfloat16" else 4
    return tensor_bound(4 * hd * b * h * pairs,
                        itemsize * (2 * b * s * h * hd + 2 * b * s * kv * hd),
                        card)


def ssd_bound(case, card):
    """The products the function needs, over the Q(Q+1)/2 pairs i >= j of
    the causal form: C B^T once per chunk (B and C are shared by the heads,
    n_groups = 1), Q(Q+1)P for W X and 2QPN for the state per (chunk,
    head); inputs and outputs moved once (``tensor_bound``)."""
    b, l, h, p, n, q = case
    nc = l // q
    flops = b * nc * (q * (q + 1) * n + h * (q * (q + 1) * p + 2 * q * p * n))
    nbytes = 4 * (b * l * h * p + b * l * h + h + 2 * b * l * n
                  + b * l * h * p + b * nc * h * p * n + b * nc * h * q)
    return tensor_bound(flops, nbytes, card)


def say_kernel_time(label, ms, plain, bnd):
    plain = "" if plain is None else f", plain version {plain:.4f} ms"
    say(f"times: {label}: kernel {ms:.4f} ms{plain}, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; "
        f"{bnd['rates']}): {bnd['bound_ms'] / ms:.3f} of the 3xTF32 bound, "
        f"{bnd['simt_bound_ms'] / ms:.3f} of the float32 SIMT bound "
        f"({bnd['simt_bound_ms']:.4f} ms)")


def sdpa_yardstick(q, k, v, scale, out):
    """The fastest backend of F.scaled_dot_product_attention that computes
    this float32 GQA case (causal, no softcap, no window) on the kernel's
    own tensors, in SDPA's (B, H, S, hd) layout: (ms, backend). The flash
    backend refuses float32. MATH takes the KV heads as they are
    (enable_gqa); EFFICIENT_ATTENTION and CUDNN_ATTENTION refuse
    enable_gqa, so they get K and V with each KV head repeated for its G
    query heads (what enable_gqa means), built before the timed calls.
    Each backend's output is held against the kernel's ``out``. The port
    never calls SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    g = qt.shape[1] // kt.shape[1]
    ke, ve = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    tries = [(SDPBackend.EFFICIENT_ATTENTION, ke, ve, False),
             (SDPBackend.CUDNN_ATTENTION, ke, ve, False),
             (SDPBackend.MATH, kt, vt, True)]
    best = None
    for backend, kb, vb, gqa in tries:
        def call(backend=backend, kb=kb, vb=vb, gqa=gqa):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kb, vb, is_causal=True, enable_gqa=gqa, scale=scale)
        try:
            with warnings.catch_warnings():   # the refusal's reasons
                warnings.simplefilter("ignore")
                got = call()
        except RuntimeError as err:
            say(f"times: scaled_dot_product_attention {backend.name}: "
                f"refused ({str(err).splitlines()[0][:120]})")
            continue
        err = float((got.transpose(1, 2) - out).abs().max())
        del got
        ms = cuda_ms(call, repeats=5, inner=3)
        say(f"times: scaled_dot_product_attention {backend.name}"
            f"{'' if gqa else ' (K, V repeated to H heads)'}: {ms:.4f} ms, "
            f"max abs difference from the kernel {err:.3g}")
        if best is None or ms < best[0]:
            best = (ms, backend.name)
    if best is None:
        fail("no scaled_dot_product_attention backend takes the case")
    return best


def phase_times_lm(device, card, launches, flash_err, ssd_err):
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain
    from repro_torch.launch import serve

    rows = []
    for i, case in enumerate(ATTN_MAIN):
        q, k, v = attn_tensors(case, device, seed=300 + i)
        kw = attn_kwargs(case)
        ms = cuda_ms(lambda: attn_ops.flash_attention(q, k, v, **kw),
                     repeats=5, inner=3)
        plain = cuda_ms(lambda: attn_ops.flash_attention_plain(q, k, v, **kw),
                        repeats=3, inner=1)
        bnd = flash_bound(case, card)
        rows.append((ms, plain, bnd))
        say_kernel_time(f"flash attention {case}", ms, plain, bnd)
    # yardstick, like for like: the kernel and PyTorch's
    # scaled_dot_product_attention on the same tensors at the one case SDPA
    # computes (causal, global, softcap 0)
    like = ATTN_MAIN[1][:7] + (0.0, ATTN_MAIN[1][8])
    q, k, v = attn_tensors(like, device, seed=310)
    kw = attn_kwargs(like)
    like_ms = cuda_ms(lambda: attn_ops.flash_attention(q, k, v, **kw),
                      repeats=5, inner=3)
    sdpa_ms, backend = sdpa_yardstick(q, k, v, kw["scale"],
                                      attn_ops.flash_attention(q, k, v, **kw))
    say(f"times: like for like at {like}: flash kernel {like_ms:.4f} ms, "
        f"scaled_dot_product_attention ({backend}, the fastest backend that "
        f"computes it in float32) {sdpa_ms:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()

    args = ssd_tensors(*SSD_MAIN[:5], device, seed=320, mamba2=True)
    chunk = SSD_MAIN[5]
    ssd_ms = cuda_ms(lambda: ssd_ops.ssd_intra_chunk(*args, chunk=chunk),
                     repeats=5, inner=3)
    ssd_plain = cuda_ms(lambda: ssd_intra_chunk_plain(*args, chunk=chunk),
                        repeats=3, inner=1)
    sbnd = ssd_bound(SSD_MAIN, card)
    say_kernel_time(f"SSD intra-chunk {SSD_MAIN}", ssd_ms, ssd_plain, sbnd)
    del args

    served = {}
    for arch, prompt, _ in SERVE_RUNS:
        stats = {}
        serve.main(serve_args(arch, prompt), stats=stats)
        torch.cuda.empty_cache()
        tok_s = SERVE_BATCH * SERVE_GEN / stats["seconds"]
        served[arch] = dict(stats, tokens_per_s=tok_s)
        say(f"times: serve {arch} (second run): prefill "
            f"{stats['prefill_ms']:.3f} ms, decode "
            f"{stats['decode_ms_per_token']:.4f} ms/token, {tok_s:.2f} "
            f"tokens/s over {stats['seconds']:.3f} s")
    flash_ms = [r[0] for r in rows]
    # gemma2-2b's prefill runs half its flash launches windowed, half global
    share = {
        "gemma2-2b flash": launches["flash_attention"] / 2 * sum(flash_ms)
        / served["gemma2-2b"]["prefill_ms"],
        "mamba2-780m ssd": launches["ssd_chunk"] * ssd_ms
        / served["mamba2-780m"]["prefill_ms"]}
    say("times: kernels' share of prefill (kernel ms x launches / prefill "
        "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in share.items()))
    say("times: " + json.dumps({
        "card": card, "serve": served, "prefill_share": share,
        "flash_ms": {"window": flash_ms[0], "global": flash_ms[1],
                     "like_for_like": like_ms},
        "sdpa_ms": sdpa_ms, "sdpa_backend": backend, "ssd_ms": ssd_ms,
        "bound_share": {
            "flash": [r[2]["bound_ms"] / r[0] for r in rows],
            "flash_simt": [r[2]["simt_bound_ms"] / r[0] for r in rows],
            "ssd": sbnd["bound_ms"] / ssd_ms,
            "ssd_simt": sbnd["simt_bound_ms"] / ssd_ms}}))

    def mean(values):
        return sum(values) / len(values)
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/attention/flash.py:119",
         "launches": launches["flash_attention"], "max_abs_err": flash_err,
         "ms": mean(flash_ms), "plain_ms": mean([r[1] for r in rows]),
         "bound_ms": mean([r[2]["bound_ms"] for r in rows]),
         "bound_by": rows[0][2]["bound_by"], "library_ms": sdpa_ms,
         "library_case_ms": like_ms, "library_backend": backend},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd/chunk_kernel.py:101",
         "launches": launches["ssd_chunk"], "max_abs_err": ssd_err,
         "ms": ssd_ms, "plain_ms": ssd_plain, "bound_ms": sbnd["bound_ms"],
         "bound_by": sbnd["bound_by"], "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# LM training path: flash attention backward, launch.train on tinyllama
# ---------------------------------------------------------------------------

def grad_tensors(case, device, seed, t=None):
    """q, k, v (``attn_tensors``) and an output gradient dO."""
    import torch
    q, k, v = attn_tensors(case, device, seed, t)
    gen = torch.Generator(device=device).manual_seed(seed + 1000)
    return q, k, v, torch.randn(q.shape, generator=gen, device=device)


def check_flash_bwd(case, device, seed, t=None, q_offset=0):
    """Autograd through the wrapper ``ops.flash_attention`` (forward kernel
    with its lse, backward kernel) against the plain forward and backward
    (``flash_attention_fwd_plain``, ``flash_attention_bwd_plain``) on the
    same q, k, v, dO. The wrapper's output and the forward kernel's lse
    (``flash_attention_fwd_cuda(with_lse=True)``, what the backward reads)
    are held at ATTN_TOL, the gradients at GRAD_TOL: (max abs error of dq,
    dk, dv, (out max abs error, lse max relative error), (dq, dk, dv))."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.flash import flash_attention_fwd_cuda
    from repro_torch.kernels.attention.ref import (flash_attention_bwd_plain,
                                                   flash_attention_fwd_plain)
    q, k, v, do = grad_tensors(case, device, seed, t)
    kw = attn_kwargs(case, q_offset)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = attn_ops.flash_attention(qg, kg, vg, **kw)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    _, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    p_out, p_lse = flash_attention_fwd_plain(q, k, v, **kw)
    ok_out, out_err = close(out.detach(), p_out, *ATTN_TOL[case[8]])
    ok_lse, _ = close(lse, p_lse, *ATTN_TOL["float32"])
    lse_err = float(((lse - p_lse).abs() / p_lse.abs().clamp_min(1.0)).max())
    if not (ok_out and ok_lse):
        fail(f"flash attention forward kernel's output or lse (training "
             f"path) disagrees with its plain version at {case} "
             f"q_offset={q_offset}: out max abs err {out_err}, lse max rel "
             f"err {lse_err}")
    ref = flash_attention_bwd_plain(q, k, v, p_out, p_lse, do, **kw)
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
        ok, e = close(a, b, *GRAD_TOL)
        if not ok or a.dtype != torch.float32:
            fail(f"flash attention backward kernel's {name} disagrees with "
                 f"its plain version at {case} q_offset={q_offset}: max abs "
                 f"err {e}")
        err = max(err, e)
    return err, (out_err, lse_err), grads


@contextlib.contextmanager
def scratch_budget(nbytes):
    """The flash backward's scratch budget (``flash.BWD_SCRATCH_BYTES``)
    set to ``nbytes`` inside the block: 0 runs its key tiles in chunks of
    one, NO_BUDGET all in one launch."""
    from repro_torch.kernels.attention import flash
    default = flash.BWD_SCRATCH_BYTES
    flash.BWD_SCRATCH_BYTES = nbytes
    try:
        yield
    finally:
        flash.BWD_SCRATCH_BYTES = default


def check_bwd_deterministic(case, device, seed, grads):
    """Two more backward calls through the wrapper on the tensors that gave
    ``grads`` (``check_flash_bwd``, same seed), and one call of the kernel
    with no scratch budget (its key tiles in chunks of one): dq, dk, dv
    must equal ``grads`` bit for bit, or fail."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.flash import (flash_attention_bwd_cuda,
                                                     flash_attention_fwd_cuda)
    q, k, v, do = grad_tensors(case, device, seed)
    kw = attn_kwargs(case)
    for call in (1, 2):
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = attn_ops.flash_attention(qg, kg, vg, **kw)
        again = torch.autograd.grad(out, (qg, kg, vg), do)
        same = [bool(torch.equal(a, b)) for a, b in zip(again, grads)]
        if not all(same):
            fail(f"flash attention backward is not deterministic at {case}: "
                 f"call {call + 1} equals call 1 bit for bit in (dq, dk, dv) "
                 f"{same}")
    out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    with scratch_budget(0):
        chunked = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    same = [bool(torch.equal(a, b)) for a, b in zip(chunked, grads)]
    if not all(same):
        fail(f"flash attention backward in one-key-tile chunks differs from "
             f"one launch at {case}: bit-equal (dq, dk, dv) {same}")
    say(f"check: flash attention backward {case}: three calls, and a call "
        f"in one-key-tile chunks, give the same dq, dk, dv bit for bit")


def check_bwd_long(device):
    """The backward at BWD_LONG within the default scratch budget (key
    tiles in chunks) and with no budget (one launch of every key tile):
    the same bits, finite; each call's device ms and its peak device memory
    beyond its inputs. Fails if the budgeted call's peak passes the budget
    plus its outputs and D."""
    import torch
    from repro_torch.kernels.attention import flash
    case = BWD_LONG
    q, k, v, do = grad_tensors(case, device, seed=600)
    kw = attn_kwargs(case)
    out, lse = flash.flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    runs = {}
    for name, budget in (("budget", flash.BWD_SCRATCH_BYTES),
                         ("one launch", NO_BUDGET)):
        with scratch_budget(budget):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            grads = flash.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                   **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - base
            ms = cuda_ms(lambda: flash.flash_attention_bwd_cuda(
                q, k, v, out, lse, do, **kw), repeats=3, inner=1)
        runs[name] = (grads, peak, ms)
        torch.cuda.empty_cache()
    (g0, peak0, _), (g1, _, _) = runs["budget"], runs["one launch"]
    same = [bool(torch.equal(a, b)) for a, b in zip(g0, g1)]
    finite = all(bool(torch.isfinite(a).all()) for a in g0)
    outputs = 4 * (2 * q.numel() + 2 * k.numel() + lse.numel())
    if not (all(same) and finite):
        fail(f"flash attention backward at {case}: within the scratch budget "
             f"bit-equal to one launch {same}, finite {finite}")
    if peak0 > flash.BWD_SCRATCH_BYTES + outputs:
        fail(f"flash attention backward at {case} took {peak0} B beyond its "
             f"inputs, past the budget {flash.BWD_SCRATCH_BYTES} B + outputs "
             f"{outputs} B")
    say(f"check: flash attention backward {case}: within the "
        f"{flash.BWD_SCRATCH_BYTES} B scratch budget bit-equal to one launch "
        f"and finite; " + "; ".join(
            f"{name} {ms:.4f} ms, peak {peak} B beyond the inputs"
            for name, (_, peak, ms) in runs.items()))
    del runs, g0, g1, q, k, v, do, out, lse
    torch.cuda.empty_cache()


def fwd_errs(fwd):
    return (f"forward with lse: out max abs err {fwd[0]:.3g}, lse max rel "
            f"err {fwd[1]:.3g}")


def train_step_card_vs_cpu(arch, device):
    """One train step of reduced ``arch`` on the card (the flash kernels,
    forward and backward) against the same step on the CPU (their plain
    versions), from the same parameters and tokens
    (``train_step.reduced_train_step``): (loss rel err, grad norm rel err,
    max over leaves of max |dg| / max |g|)."""
    from repro_torch.train.train_step import reduced_train_step
    (ggpu, mgpu, _), (gcpu, mcpu, _) = (
        reduced_train_step(arch, dev, seq=128) for dev in (device, "cpu"))
    loss_err = abs(mgpu["loss"] - mcpu["loss"]) / abs(mcpu["loss"])
    norm_err = abs(mgpu["grad_norm"] - mcpu["grad_norm"]) / mcpu["grad_norm"]
    grad_err = max(float((ggpu[n] - g).abs().max() / g.abs().max())
                   for n, g in gcpu.items())
    if not (loss_err < 1e-4 and norm_err < 1e-4 and grad_err < GRAD_TOL[0]):
        fail(f"a train step of reduced {arch} on the card differs from the "
             f"CPU's: loss {loss_err}, grad norm {norm_err}, grads "
             f"{grad_err} (relative)")
    return loss_err, norm_err, grad_err


def phase_check_train(device):
    """The backward kernel against its plain version, its bits over calls
    and chunkings, its memory at a long sequence, and one train step on the
    card against the CPU. Returns the largest error at the training path's
    shape."""
    import torch
    for i, case in enumerate(ATTN_CASES):
        if case[8] != "float32":
            q, k, v = (x.requires_grad_() for x in
                       attn_tensors(case, device, seed=i))
            try:
                from repro_torch.kernels.attention import ops as attn_ops
                attn_ops.flash_attention(q, k, v, **attn_kwargs(case))
            except ValueError as err:
                say(f"check: flash attention backward {case}: refused as "
                    f"expected ({err})")
                continue
            fail(f"flash attention under autograd took {case[8]}; the "
                 f"backward kernel is float32 only")
        err, fwd, _ = check_flash_bwd(case, device, seed=i)
        say(f"check: flash attention backward {case}: max abs err "
            f"{err:.3g}; {fwd_errs(fwd)}")
    m = ATTN_MASKED
    err, fwd, (dq, dk, dv) = check_flash_bwd(
        m["case"], device, seed=7, t=m["t"], q_offset=m["q_offset"])
    if not bool((dq[:, m["first_masked"]:] == 0).all()):
        fail("flash attention backward: fully masked rows have a nonzero dq")
    say(f"check: flash attention backward q_offset {m['q_offset']} (rows "
        f">= {m['first_masked']} fully masked, zero dq): max abs err "
        f"{err:.3g}; {fwd_errs(fwd)}")
    main_err = 0.0
    for i, case in enumerate(BWD_MAIN):
        err, fwd, grads = check_flash_bwd(case, device, seed=400 + i)
        if case == BWD_TINYLLAMA:
            main_err = err
            check_bwd_deterministic(case, device, seed=400 + i, grads=grads)
        say(f"check: flash attention backward {case}: max abs err "
            f"{err:.3g}; {fwd_errs(fwd)}")
        del grads
        torch.cuda.empty_cache()
    check_bwd_long(device)
    for arch in ("tinyllama-1.1b", "gemma2-2b"):
        errs = train_step_card_vs_cpu(arch, device)
        say(f"check: one train step of reduced {arch}, card vs CPU: loss "
            f"{errs[0]:.3g}, grad norm {errs[1]:.3g} (relative), grads "
            f"{errs[2]:.3g} of each leaf's largest")
    return main_err


def phase_train():
    """``launch.train --arch tinyllama-1.1b --full`` for TRAIN_STEPS steps,
    with every kernel's launch count zeroed just before and read just
    after. Returns (flash forward launches, backward launches, stats)."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import train
    attn_ops.launches = attn_ops.bwd_launches = 0
    ssd_ops.launches = ops.launches = 0
    stats = {}
    t0 = time.perf_counter()
    train.main(TRAIN_ARGS, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (attn_ops.launches, attn_ops.bwd_launches, ssd_ops.launches,
           ops.launches)
    expect = TRAIN_LAYERS * TRAIN_STEPS
    say(f"main: train {' '.join(TRAIN_ARGS)}: {wall:.3f} s wall (set-up "
        f"included), flash forward / backward launches {got[0]} / {got[1]}, "
        f"ssd {got[2]}, fused variation {got[3]}")
    if got != (expect, expect, 0, 0):
        fail(f"train: kernel launches {got}, expected ({expect}, {expect}, "
             f"0, 0)")
    losses, norms = stats["loss"], stats["grad_norm"]
    if len(losses) != TRAIN_STEPS or not all(
            map(math.isfinite, losses + norms)):
        fail(f"train: losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        fail(f"train: the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    say(f"main: train losses {losses}; grad norms {norms}; peak device "
        f"memory {stats['peak_bytes']} B")
    torch.cuda.empty_cache()
    return got[0], got[1], stats


def flash_bwd_bound(case, card):
    """BWD_PRODUCTS x 2 hd FLOP per visible (query, key) pair and query
    head; q, k, v, out, dO and lse read once, dq, dk, dv written once
    (``tensor_bound``)."""
    b, s, h, kv, hd = case[:5]
    # flash_bound counts 2 products (4 hd FLOP) per pair and head
    flops = flash_bound(case, card)["flops"] * BWD_PRODUCTS // 2
    nbytes = 4 * (3 * b * s * h * hd + 2 * b * s * kv * hd + b * s * h
                  + b * s * h * hd + 2 * b * s * kv * hd)
    return tensor_bound(flops, nbytes, card)


def sdpa_bwd_yardstick(q, k, v, do, scale, dq):
    """Autograd backward through the fastest backend of
    F.scaled_dot_product_attention that computes this float32 GQA case
    (causal, no softcap, no window) on the same tensors, in SDPA's
    (B, H, S, hd) layout, K and V repeated to H heads for the backends
    that refuse enable_gqa (MATH takes GQA as it is). Only the backward is
    timed (``torch.autograd.grad`` on a kept graph). Each backend's dq is
    held against the kernel's. (ms, backend). The port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    dot = do.transpose(1, 2).contiguous()
    tries = [(SDPBackend.EFFICIENT_ATTENTION, False),
             (SDPBackend.CUDNN_ATTENTION, False), (SDPBackend.MATH, True)]
    best = None
    for backend, gqa in tries:
        qt = q.detach().transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (x.detach().transpose(1, 2).contiguous() for x in (k, v))
        if not gqa:
            kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
        kt, vt = kt.requires_grad_(), vt.requires_grad_()
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")     # the refusal's reasons
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=gqa, scale=scale)
                got = torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
        except RuntimeError as err:
            say(f"times: scaled_dot_product_attention backward "
                f"{backend.name}: refused ({str(err).splitlines()[0][:120]})")
            continue
        err = float((got[0].transpose(1, 2) - dq).abs().max())
        del got

        def call(out=out, qt=qt, kt=kt, vt=vt):
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        ms = cuda_ms(call, repeats=5, inner=3)
        say(f"times: scaled_dot_product_attention backward {backend.name}"
            f"{'' if gqa else ' (K, V repeated to H heads)'}: {ms:.4f} ms, "
            f"max abs difference of dq from the kernel's {err:.3g}")
        del out, call
        torch.cuda.empty_cache()
        if best is None or ms < best[0]:
            best = (ms, backend.name)
    if best is None:
        fail("no scaled_dot_product_attention backend takes the backward")
    return best


def phase_times_train(device, card, fwd_launches, bwd_launches, bwd_err,
                      stats):
    """Training times: step ms and tokens/s of the main run; the backward
    kernel at tinyllama-1.1b's training shape and gemma2-2b's shapes
    beside its bound, its plain version and, at tinyllama's (causal,
    softcap 0), SDPA's backward; the forward with and without its lse
    output, in turns, and at tinyllama's shape beside its bound and SDPA's
    forward. Returns (the forward's numbers at tinyllama's shape, the
    backward's kernels entry)."""
    import torch
    from repro_torch.kernels.attention.flash import (flash_attention_bwd_cuda,
                                                     flash_attention_fwd_cuda)
    from repro_torch.kernels.attention.ref import (flash_attention_bwd_plain,
                                                   flash_attention_fwd_plain)
    steady = stats["step_ms"][1:]
    step_ms = statistics.median(steady)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    say(f"times: train {TRAIN_ARCH} --full batch {TRAIN_BATCH} seq "
        f"{TRAIN_SEQ}: step {step_ms:.3f} ms (median of steps 2-"
        f"{TRAIN_STEPS}; step 1 {stats['step_ms'][0]:.3f} ms with set-up), "
        f"{tok_s:.1f} tokens/s, peak device memory {stats['peak_bytes']} B")
    rows = {}
    for i, case in enumerate([BWD_TINYLLAMA] + BWD_MAIN[2:]):
        q, k, v, do = grad_tensors(case, device, seed=500 + i)
        kw = attn_kwargs(case)
        out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
        ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                      **kw),
                     repeats=5, inner=3)
        plain = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, lse,
                                                          do, **kw),
                        repeats=3, inner=1)
        bnd = flash_bwd_bound(case, card)
        say_kernel_time(f"flash attention backward {case}", ms, plain, bnd)
        # every key tile in one launch, with no scratch budget
        with scratch_budget(NO_BUDGET):
            one_ms = cuda_ms(lambda: flash_attention_bwd_cuda(
                q, k, v, out, lse, do, **kw), repeats=5, inner=3)
        say(f"times: flash attention backward {case}: {ms:.4f} ms within "
            f"the scratch budget, {one_ms:.4f} ms in one launch with none")
        torch.cuda.empty_cache()
        # the forward with and without its lse output, in turns
        fwd = {False: [], True: []}
        for with_lse in (False, True, True, False):
            fwd[with_lse].append(cuda_ms(
                lambda: flash_attention_fwd_cuda(q, k, v, with_lse=with_lse,
                                                 **kw), repeats=5, inner=3))
        fwd = {k_: statistics.mean(v_) for k_, v_ in fwd.items()}
        say(f"times: flash attention forward {case}: {fwd[False]:.4f} ms "
            f"without the lse output, {fwd[True]:.4f} ms with it (each the "
            f"mean of two turns)")
        rows[case] = dict(ms=ms, plain_ms=plain, bound=bnd,
                          one_launch_ms=one_ms, fwd_ms=fwd[False],
                          fwd_lse_ms=fwd[True])
        if case == BWD_TINYLLAMA:
            dq = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)[0]
            sdpa_ms, backend = sdpa_bwd_yardstick(q, k, v, do, kw["scale"],
                                                  dq)
            say(f"times: like for like at {case}: backward kernel "
                f"{ms:.4f} ms, scaled_dot_product_attention's backward "
                f"({backend}, the fastest backend that computes it in "
                f"float32) {sdpa_ms:.4f} ms")
            del dq
            # the forward at the training shape: its bound, and SDPA's
            # forward like for like (causal, global, softcap 0)
            fbnd = flash_bound(case, card)
            sdpa_fwd_ms, fwd_backend = sdpa_yardstick(q, k, v, kw["scale"],
                                                      out)
            say_kernel_time(f"flash attention forward with lse {case}",
                            fwd[True], None, fbnd)
            say(f"times: like for like at {case}: forward kernel "
                f"{fwd[False]:.4f} ms ({fwd[True]:.4f} with lse), "
                f"scaled_dot_product_attention ({fwd_backend}) "
                f"{sdpa_fwd_ms:.4f} ms")
            rows[case].update(fwd_bound=fbnd["bound_ms"],
                              sdpa_fwd_ms=sdpa_fwd_ms)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    main = rows[BWD_TINYLLAMA]
    share = bwd_launches / TRAIN_STEPS * main["ms"] / step_ms
    fshare = fwd_launches / TRAIN_STEPS * main["fwd_lse_ms"] / step_ms
    say(f"times: kernels' share of a train step (kernel ms x launches per "
        f"step / step ms): flash backward {share:.4f}, flash forward "
        f"{fshare:.4f}")
    say("times: " + json.dumps({
        "card": card, "train_step_ms": step_ms,
        "train_step_ms_all": stats["step_ms"], "train_tokens_per_s": tok_s,
        "train_peak_bytes": stats["peak_bytes"], "losses": stats["loss"],
        "bwd_step_share": share, "fwd_step_share": fshare,
        "sdpa_bwd_ms": sdpa_ms, "sdpa_bwd_backend": backend,
        "flash_bwd": {str(c): {k_: (v_ if k_ != "bound" else
                                    v_["bound_ms"]) for k_, v_ in r.items()}
                      for c, r in rows.items()}}))
    # the forward's numbers at the training shape, for its kernels entry
    fwd_train = {"shape": list(BWD_TINYLLAMA[:8]), "ms": main["fwd_lse_ms"],
                 "bound_ms": main["fwd_bound"],
                 "library_ms": main["sdpa_fwd_ms"],
                 "ms_without_lse": main["fwd_ms"]}
    return fwd_train, {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/"
                      "flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/attention/ops.py:37",
            "launches": bwd_launches, "max_abs_err": bwd_err,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound"]["bound_ms"],
            "bound_by": main["bound"]["bound_by"], "library_ms": sdpa_ms,
            "library_backend": backend,
            "shape": list(BWD_TINYLLAMA[:8])}


def profiled(fn):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity), then
    synchronise. Returns (window ms from the first to the last traced
    event, device busy ms = the union of the device's kernel, copy and
    set intervals, {device event name: summed ms}); busy is None where the
    trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CUDA)
    if not device:
        return span, None, {}
    busy, by_name = 0.0, {}
    cur_start, cur_end = device[0][:2]
    for start, end, name in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return span, busy / 1e3, by_name


def phase_trace(device, card):
    """One prefill and TRACE_DECODE decode steps of each served model (the
    serving path's steps, kernels on, published widths) under
    torch.profiler, after a warm-up: the device's idle share over each
    window and the port's kernels' share of it, read from the trace. Each
    window's host time without the profiler is taken first, before any
    window is traced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    windows, keep = [], []
    for arch, prompt, _ in SERVE_RUNS:
        cfg = get_config(arch)
        max_cache = prompt + SERVE_GEN + 64
        model = Model(cfg, device=device, attn_impl="kernel",
                      use_ssd_kernel=True, max_seq=max_cache)
        model.init_params(torch.Generator(device=device).manual_seed(0))
        data = SyntheticTokens(cfg, SERVE_BATCH, prompt, seed=0,
                               mode="bigram")
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(0).items()}
        batch["tokens"] = batch["tokens"][:, :prompt]
        prefill = make_prefill_step(model, max_cache)
        decode = make_decode_step(model)
        state = {}
        keep.append((model, state))

        def run_prefill(prefill=prefill, batch=batch, state=state):
            state["tok"], _, state["cache"] = prefill(batch)

        def run_decode(decode=decode, prompt=prompt, state=state):
            tok, cache = state["tok"][:, None], state["cache"]
            for i in range(TRACE_DECODE):
                tok, _, cache = decode(cache, tok, prompt + i)
        windows += [(f"{arch} prefill", run_prefill),
                    (f"{arch} decode", run_decode)]

    out = {}
    for name, fn in windows:
        fn()                                                # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = {"host_ms": (time.perf_counter() - t0) * 1e3}
    for name, fn in windows:
        span, busy, by_name = profiled(fn)
        ours = sum(v for k, v in by_name.items()
                   if any(n in k for n in KERNEL_SYMBOLS))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        row = out[name]
        row.update(traced_ms=span, device_busy_ms=busy,
                   idle_share=None if busy is None else 1 - busy / span,
                   kernels_ms=ours, kernels_share=ours / span,
                   top_device_ms={k[:90]: v for k, v in top})
        if busy is None:
            say(f"trace: {name}: the profiler recorded no device activity; "
                f"idle share not measured")
            continue
        steps = f" ({TRACE_DECODE} steps)" if name.endswith("decode") else ""
        say(f"trace: {name}{steps}: host {row['host_ms']:.3f} ms "
            f"unprofiled, {span:.3f} ms traced; device busy {busy:.3f} ms, "
            f"idle share {row['idle_share']:.4f} of the traced window, "
            f"{1 - busy / row['host_ms']:.4f} of the unprofiled one; port "
            f"kernels {ours:.3f} ms = {row['kernels_share']:.4f} of the "
            f"traced window")
    del keep, windows
    torch.cuda.empty_cache()
    say("trace: " + json.dumps({"card": card, "windows": out}))
    return out


def phase_trace_train(device, card):
    """One train step of the training path (tinyllama-1.1b, published
    widths, batch TRAIN_BATCH x TRAIN_SEQ, kernels on) under
    torch.profiler, after a warm-up step and one unprofiled step: the
    device's idle share, the flash kernels' share and the largest device
    entries, read from the trace."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import optimizer_for_arch
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg, device=device, attn_impl="kernel",
                  max_seq=TRAIN_SEQ + 8)
    state = {"s": init_train_state(
        model, torch.Generator(device=device).manual_seed(0))}
    step = make_train_step(model, optimizer_for_arch(
        TRAIN_ARCH, lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS))
    data = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(0).items()}

    def run():
        state["s"], _ = step(state["s"], batch)

    run()                                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    span, busy, by_name = profiled(run)
    flash = {k: sum(v for name, v in by_name.items() if k in name)
             for k in FLASH_SYMBOLS}
    unlisted = [name for name in by_name if "flash" in name
                and not any(k in name for k in FLASH_SYMBOLS)]
    if unlisted or (busy is not None and not all(flash.values())):
        fail(f"train trace: flash kernels {unlisted} are not in "
             f"FLASH_SYMBOLS, or a listed one did not run: {flash}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"host_ms": host_ms, "traced_ms": span, "device_busy_ms": busy,
           "idle_share": None if busy is None else 1 - busy / span,
           "flash_ms": flash, "flash_share": sum(flash.values()) / span,
           "top_device_ms": {k[:90]: v for k, v in top}}
    del state, model
    torch.cuda.empty_cache()
    if busy is None:
        say("trace: train step: the profiler recorded no device activity; "
            "idle share not measured")
    else:
        say(f"trace: {TRAIN_ARCH} train step (batch {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}): host {host_ms:.3f} ms unprofiled, {span:.3f} ms "
            f"traced; device busy {busy:.3f} ms, idle share "
            f"{row['idle_share']:.4f} of the traced window, "
            f"{1 - busy / host_ms:.4f} of the unprofiled one; flash "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in flash.items())
            + f" = {row['flash_share']:.4f} of the traced window")
        say("trace: per launch (" + str(TRAIN_LAYERS) + " a step): "
            + ", ".join(f"{k} {v / TRAIN_LAYERS:.4f} ms"
                        for k, v in flash.items()))
    say("trace: " + json.dumps({"card": card, "train_step": row}))
    return row


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no src/repro_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    logs = _build.build()
    say(f"build: {len(logs)} kernel(s) compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                say(f"build: {name}: {line.strip()}")

    main_err = phase_check(device)
    flash_err, ssd_err = phase_check_lm(device)
    bwd_err = phase_check_train(device)
    phase_check_hvdc(device)
    delay_err = phase_check_host(device)
    phase_check_queue(device)
    launches, pop = phase_main()
    lm_launches = phase_serve()
    train_fwd, train_bwd, train_stats = phase_train()
    hvdc_runs = phase_main_hvdc()
    host_runs = phase_main_host()
    queue_runs = phase_main_queue(host_runs)
    kernels = [phase_times(pop, main_err, launches, device, card)]
    kernels[0]["launches_by_path"] = dict(
        {"ga_run rastrigin": launches},
        **{f"ga_run rastrigin {k}": v["launches"]
           for k, v in host_runs.items() if not k.startswith("hvdc")},
        **{f"ga_run rastrigin {k}": v["launches"]
           for k, v in queue_runs.items()},
        **{f"ga_run hvdc {k}": v["launches"] for k, v in hvdc_runs.items()},
        **{f"ga_run {k}": v["launches"] for k, v in host_runs.items()
           if k.startswith("hvdc")})
    kernels += phase_times_lm(device, card, lm_launches, flash_err, ssd_err)
    kernels[1]["launches_by_path"] = {
        "serve gemma2-2b prefill": lm_launches["flash_attention"],
        f"train {TRAIN_ARCH} ({TRAIN_STEPS} steps)": train_fwd}
    fwd_train, bwd_entry = phase_times_train(device, card, train_fwd,
                                             train_bwd, bwd_err, train_stats)
    kernels[1]["train_shape"] = fwd_train
    kernels.append(bwd_entry)
    phase_times_hvdc(hvdc_runs, device, card)
    del hvdc_runs
    kernels.append(phase_times_host(pop, device, card, host_runs, delay_err))
    phase_times_queue(pop, device, card, queue_runs)
    phase_trace(device, card)
    phase_trace_train(device, card)
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
