#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right and runs its main
paths on the card.

    python3 chip_smoke.py            # from the root of a checkout

Main paths: the GA loop (``repro_torch.launch.ga_run``), LM
serving (``repro_torch.launch.serve``: prefill + decode), LM training
(``repro_torch.launch.train``: tinyllama-1.1b at its published widths,
flash attention forward and backward kernels), the paper's HVDC
dispatch (``ga_run --fitness hvdc``: batched AC Newton power flow on the
German-size grid) and the paper's decoupled simulation backend
(``ga_run --dispatch-backend host-thread|host-process``: fitness on a
host pool, the learned cost model) with its §4.1 overhead study (rho,
``delay_proxy`` through the delay chain kernel), and the paper's central
message broker (``ga_run --dispatch-backend mq|mq-mock|mq-net|slurm-mock|
k8s-mock``: the port's queue runtime and workers), and the paper's
hierarchical meta-GA (``GAEngine(meta_ga_config(), make_meta_fitness(...))``:
the inner GAs batched over individuals x seeds through the fused
variation kernel with one hyperparameter row per run) with the elastic
``GAEngine.resize`` and speculative backup dispatch, and the LM
hyperparameter search (``ga_run --fitness lm``: every genome's training
run batched through ``torch.func``, the flash kernels folding the runs
into their batch axis) with mamba2-780m training on the card, and LM
serving of the dense (granite-8b, minicpm-2b) and MoE
(granite-moe-1b-a400m, qwen2-moe-a2.7b) families at published widths
with the continuous batcher (``repro_torch.serve.batching``: lanes at
their own decode positions), and LM serving of the audio
(whisper-large-v3: encoder, cross-attention, learned positions), VLM
(llava-next-34b: a patch prefix, bfloat16 parameters) and hybrid
(jamba-1.5-large-398b: Mamba-2 and attention interleaved, MoE on every
other layer; one period, expert width cut) families, and LM training of
the MoE (granite-moe-1b-a400m, with and without the reference's
activation recomputation, ``Model(remat=True)``), audio
(whisper-large-v3) and VLM (llava-next-34b, cut in depth, bfloat16
parameters) families at published widths, and the GA and the HVDC
fitness on a device mesh (``GAEngine(ctx=)`` over
``repro_torch.launch.mesh``: islands over the data axis, contingency cases
over the model axis, cost-balanced dispatch across ranks), and LM
training over a device mesh (``launch.train.train(mesh=)``: parameters
and moments as each rank's fsdp / tensor-parallel blocks, the int8
compressed pod reduce), and bf16 training at the dry run's train_4k cell
(tinyllama-1.1b and gemma2-2b, remat, the flash forward and backward in
bf16, each its own kernel on the bf16 tensor cores). Phases, in
order; any failure exits non-zero:

1. card:   the GPU's name and power limit, as nvidia-smi reports them;
2. build:  every CUDA kernel of the port (fused variation, flash attention
           forward and backward, float32 and bf16 each, SSD intra-chunk,
           delay chain), compiled
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
           (float32 3e-5, bfloat16 one rounding step: rtol 2^-7, atol
           2^-12 of the largest magnitude); the SSD kernel and the whole
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
           float32 cases (the bf16 one below, in bf16), the fully masked
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
           lines naming the port's modules; the fused variation with one
           hyperparameter row per run, bit-equal to its plain version at
           the meta shape (96 x 5 runs, P 500, G 128) and at G = 6, with
           the uniforms shared across individuals and per run; runs of
           equal rows, and R = 1, bit-equal to the (5,) form; one
           full-size meta-fitness call through the kernel bit-equal to
           the same call on the plain variation (20 launches); and
           backup_dispatch_eval(rastrigin) on (32768, 128) card genomes
           over 4 workers, bit-equal to direct evaluation; the flash
           wrapper under vmap(grad) over 8 runs at reduced tinyllama-1.1b's
           and gemma2-2b's layer shapes (window 16 and global, softcap
           50): one forward and one backward launch a call, each run's
           gradients against a separate call's (1e-3 / 1e-4); the LM
           fitness for 8 genomes (corners included) on the card against
           the CPU (1e-4 / 2e-6), against one plain run per genome and in
           two chunks (1e-5), for each of the three archs; one reduced
           mamba2-780m train step on the card against the CPU; flash
           attention at the new archs' layer shapes (hd 64 and 128, MHA
           and GQA); one MoE layer of each MoE arch at its published
           widths, moe_sorted with room for every token against
           moe_dense (2e-4) and the router's experts equal to the CPU's;
           each new arch at its published widths cut to 2 layers, prefill
           on the card (flash kernel) against the CPU (2e-4); flash
           attention at the audio, VLM and hybrid families' layer shapes
           (whisper's encoder at T = 1500, its cross-attention with
           Sq = 128 != T = 1500 and its decoder; llava's GQA 7:1; jamba's
           GQA 8:1) and the SSD kernel at jamba's (P, N, chunk) = (128,
           128, 256), both draws, the chunk decay above 1e-4; and each of
           the three at its published widths (jamba cut as in main), one
           prefill of 1 x 256 tokens (whisper's 1500 frames, llava's 576
           patches) through the kernels against the plain paths on the
           same model: last logits and every cache leaf at 2e-4, flash /
           SSD launched once a layer, then not at all; the flash
           backward at the trained families' layer shapes (whisper's
           encoder at T = 1500, non-causal; its decoder; its
           cross-attention, 448 queries against 1500 keys, no mask;
           llava's GQA 7:1 at hd 128; granite-moe's 16:8 at 4 x 2048 and
           4 x 4096) against its plain version at 1e-3 / 1e-4;
           granite-moe-1b-a400m at its published widths, one gradient
           evaluation of 4 x 2048 with remat=True against remat=False
           (the router's experts equal exactly, the backward's recomputed
           ones included; gradients at 1e-3 of each leaf's largest; flash
           forward launched twice a layer under remat); one train step
           of reduced whisper, llava, jamba and granite-moe (sorted
           dispatch, with and without remat) on the card against the
           CPU, with the routers' smallest top-k margin; the flash
           backward kernel in bf16 (``check_flash_bwd``, as in float32:
           autograd through the wrapper, one launch each way, against
           the plain backward on the forward kernel's out and lse),
           within one bf16 rounding step (rtol 2^-7,
           atol 2^-12 of each gradient's largest magnitude), with the
           share of bit-equal elements, at the tests' bf16 case,
           tinyllama-1.1b's train_4k layer (4, 4096, 32, 4, 64), gemma2-2b's
           (1, 4500, 8, 4, 256) windowed and global with softcap 50 and
           the trained families' shapes; at tinyllama's and gemma2's
           global shape three more calls bit-equal (the bf16 backward,
           flash_attention_bwd_bf16.cu, keeps no scratch and takes no
           budget, so the one with none runs the same path); at each of
           those shapes, at the fully masked rows' case in bf16 (those
           rows zero) and at hd 32 with a window and softcap 30, the bf16
           forward (flash_attention_fwd_bf16.cu) with its lse against the
           plain forward: the output at one rounding step, with its share
           of bit-equal elements, lse at 1e-5 relative plus 1e-5, and two
           calls bit-equal;
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
           --grid-size 2715 --hvdc-lines 18 --islands 2 --num-workers 4``,
           horizontal (--pop 16 --gens-per-epoch 2 --epochs 1) and
           vertical (--pop 8 --contingencies 4 --gens-per-epoch 1
           --epochs 1: full AC on 4 outages per genome), each launching
           the fused variation exactly once a generation (2 times and
           once), with finite
           fitness and genomes in [-1, 1]; ``ga_run --fitness rastrigin``
           at the main shape under --dispatch-backend host-thread,
           host-process and host-thread --sync-every 2 --pipeline-depth 2
           (4 workers; 15 launches each, a ``dispatch stats: retries=0``
           line, fitness bit-equal to hostsim.rastrigin, the same best
           genome in all three) and ``ga_run --fitness hvdc`` on the
           German-size grid under host-thread --cost-ema (2 islands of 8,
           one epoch of 1 generation: 1 launch, retries=0, CostEMA
           updates > 0);
           ``ga_run --fitness rastrigin`` at the main shape under
           --dispatch-backend mq --mq-fleet local, mq-mock (with
           --cost-ema --metrics-dir --events-log), mq-net and k8s-mock,
           and slurm-mock cut to one epoch (4 workers; 15 launches each,
           5 for slurm-mock, retries=0, fitness bit-equal to
           hostsim.rastrigin, the best genome bit-identical to
           host-thread's, slurm-mock's best fitness bit-equal to
           host-thread's after its first epoch; the broker's tasks/,
           claimed/ and runs/ empty after, the spool pruned to --keep-jobs; the mq-mock
           run's chambga.prom parsed, its
           dispatch_chunk_duration_seconds count equal to the chunks
           dispatched); the meta-GA at Fig. 6's setup (3 islands x 32,
           4 epochs; 5 seeds x 20 inner generations at p_max 500,
           rastrigin G 128) through ``GAEngine``: 180 launches, finite
           fitness, genomes inside Tab. 4's bounds, a non-increasing
           best, each gene's per-epoch mean, std, min and max; the GA
           main shape resized 32 -> 16 -> 32 islands between epochs
           (cost-balanced over 8 lanes rescaled with the islands): the
           best kept through the shrink, the clones re-evaluated, 15
           launches, bit-identical to a run that keeps 8 lanes;
           ``ga_run --fitness lm`` at the reference's defaults (4 islands
           x 32, 5 generations an epoch, 6 steps) for 2 epochs on
           tinyllama-1.1b, gemma2-2b and mamba2-780m, and on
           tinyllama-1.1b under host-thread: flash forward and backward
           launches exactly attention layers x 6 x fitness calls (none on
           mamba2, and no SSD or fused variation launch), finite losses,
           the best no worse than the corner [0, 0, 1, 1] + 1e-3;
           ``python -m repro_torch.launch.train --arch mamba2-780m --full
           --steps 24 --batch 2 --seq 1024`` through the plain chunked scan:
           no kernel launch, finite losses, the last below the first, its
           peak memory; ``python -m repro_torch.launch.serve --no-reduced``
           on granite-moe-1b-a400m (batch 4, prompt 4096, 32 tokens),
           qwen2-moe-a2.7b (batch 4, prompt 2048, 32 tokens; 57.3 GB of
           float32 weights made on the card), granite-8b and minicpm-2b
           (batch 4, prompt 2048, 16 tokens): flash launched once per layer
           (24, 24, 36, 40), finite logits, prefill ms, decode ms/token,
           tokens/s, peak memory; the ContinuousBatcher on gemma2-2b at
           published widths (4 lanes, max_cache_len 4608, 12 requests with
           prompts spread over 256-4500, past the 4096 window, and 8-32 new
           tokens): 26 x 12 flash launches, ticks, tokens/s, admission
           prefill and tick ms, then each request against its own batch-1
           decoding on the card (tokens equal, logits at 2e-4, up to the
           first step whose top-2 margin is below 1e-3);
           ``python -m repro_torch.launch.serve --no-reduced`` on
           whisper-large-v3 (32 encoder + 32 decoder layers, batch 8,
           1500 frames, prompt 128, 64 tokens: flash 96 a prefill, 32
           each encoder, causal, cross) and llava-next-34b (all 60
           layers, 68.8 GB of bfloat16 weights, float32 compute; batch 2,
           576 patches + prompt 1024, 16 tokens: flash 60), and
           ``launch.serve.serve`` on jamba-1.5-large-398b cut to one
           published period of 8 layers with moe_d_ff 24576 -> 6144
           (every other width published, 16 experts top-2, sorted
           dispatch; batch 2, prompt 2048, 16 tokens: SSD 7 and flash 1
           a prefill): finite logits, tokens in the vocabulary, prefill
           ms, decode ms/token, tokens/s, peak memory; ``python -m
           repro_torch.launch.train --arch granite-moe-1b-a400m --full
           --steps 8 --batch 4 --seq 2048`` (24 x 8 flash forward and
           backward launches), granite-moe through ``make_train_step(
           Model(..., remat=True))`` for 3 steps of 4 x 4096 (48 x 3
           forward, 24 x 3 backward), ``launch.train --arch
           whisper-large-v3 --full --steps 8 --batch 4 --seq 448`` on 1500
           frames (96 x 8 each) and llava-next-34b cut to 4 layers,
           bfloat16 parameters, 4 steps of 2 x (576 patches + 1024
           tokens) (16 each; every bf16 parameter keeps its dtype through
           AdamW and moves): finite losses and grad norms, step ms,
           tokens/s, peak memory; ``ga_run --fitness lm --epochs 0`` on
           reduced whisper, llava and jamba, one fitness call of 16
           genomes each against the same call on the CPU (1e-4 / 2e-6).
           ``GAEngine(ctx=)`` at the GA cell's shape (32, 1024, 128), 2
           epochs, right after the first ga_run: unsharded, then on a
           one-rank NCCL mesh (``launch.mesh.init_distributed``,
           ``make_local_mesh(1, 1)``; population and best trace bit-equal,
           10 launches each, nothing staged through the host), then
           ``ga_run --fitness hvdc``'s German-size grid (2715 buses, 18
           lines) on that mesh, pop 8, 4 contingencies, one generation
           with the cost model over 4 lanes (1 launch; the survivors'
           fitness bit-equal to the unsharded fitness through the same
           dispatch), then 4 processes of ``mesh_rank`` on one gloo group
           sharing the card (8 islands each, bit-equal to the one-rank
           run; per rank the epoch s, a migration's ms, the collectives'
           calls and bytes, all staged through the host, and 10
           launches); each of these runs (unsharded, one-rank NCCL, every
           gloo rank) then goes on through ``GAEngine.resize`` 32 -> 16 ->
           32 islands, an epoch after each resize, cost dispatch over 8
           lanes rescaled with the islands (bit-equal to the unsharded
           run, the best kept through the shrink, no +inf after the grow,
           10 more launches a rank; each resize's ms, collectives and
           staged bytes), and the gloo ranks run the learned cost model's
           first vs learned dispatch (CostEMA, each rank's own host
           pool; every rank's table and permutation equal after each
           evaluate; skew vs naive skew, ms per evaluate a rank); then
           ``launch.train.train(mesh=)`` (mesh train:)
           of tinyllama-1.1b at its published widths, all 22 layers, 2
           steps: (a) at 4 x 2048 on a one-rank NCCL mesh, losses, grad
           norms and parameters bit-equal to the unsharded train; on 4
           gloo ranks sharing the card on (data 2, model 2) at 4 x 512,
           rank 0 first running one rank's baselines: (b) losses and grad
           norms at rtol 2e-5 of one rank, the gathered parameters at
           tests/test_torch_train.py's PARAM_TOL on its held elements, and
           (c) granite-moe-1b-a400m (16 experts a tp rank) 1 step, its
           routes exactly one rank's with num_groups=2, loss and aux at
           rtol 2e-5; (d) 2 gloo ranks on (pod 2, data 1, model 1)
           with compress_pod_reduce=True, the last loss within 5% of the
           exact run's and int8 on the pod axis; per rank the step ms,
           collectives a step (every call on gloo staged and counted),
           peak memory, block bytes and flash launches (layers x steps);
           (b)'s parameters gathered for its check are the embedding's,
           the final norm's and those of layers 0 and 21; then
           ``launch.serve.serve(mesh=)`` (mesh serve:) of gemma2-2b at its published widths, all 26
           layers, greedy: (a) 4 x 4500 prompts, 8 tokens on a one-rank
           NCCL mesh, tokens and every step's logits bit-equal to the
           unsharded serve; (b) 4 x 1024 prompts, 16 tokens on 4 gloo
           ranks sharing the card on (data 2, model 2), every rank's
           tokens its rows of one rank's (run in this process) and its
           logits (its rows and vocab block) within 2e-4; per rank the
           prefill ms and decode ms/token (CUDA events), the collectives
           of the prefill and of a decode step by axis, flash launches
           (26 a prefill: 13 windowed and 13 global layers over the
           rank's 4 heads), peak memory and its cache block's bytes
           beside the one-rank cache's;
           the dry run's train_4k cell trained in bf16 through the
           library's entry points (``Model(compute_dtype="bfloat16",
           attn_impl="kernel", remat=True, max_seq=4096)``,
           ``optimizer_for_arch`` with bf16 moments above 20e9 parameters,
           ``make_train_step`` with the dry run's microbatches, the batch
           shaped by ``launch.specs.input_specs``, 256 sequences cut to 4
           and 1): tinyllama-1.1b 8 steps of 4 x 4096 and gemma2-2b 8 of
           1 x 4096 at published widths, then tinyllama at the float32
           run's 4 x 2048 for 4 steps: flash forward launches 2 x layers
           a step (the remat recompute) and backward layers a step,
           finite losses, the last and the mean of the last three below
           the first (not for the 4-step run), step ms, peak memory.
           Every run has the launch counts zeroed just before it and read
           just after;
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
           bus off and on; one meta-fitness call (ms, inner evaluations/s),
           one inner generation phase by phase, the kernel at the meta
           shape with the uniforms shared and expanded per run beside
           each bound, and the plain version, the (5,) form at the main
           shape, the meta run's wall s and the resize ms; one LM
           fitness call at 128 and 1024 genomes (ms, training runs/s,
           tokens/s, peak memory; one launch of each flash kernel per
           layer and step at both sizes), the per-genome loop at 128
           genomes, which the batched call must beat, and the mamba2-780m
           train step (ms, tokens/s); the flash kernel at the new archs'
           layer shapes beside its bound; the flash kernel at the audio,
           VLM and hybrid layer shapes and SSD at jamba's serving shape,
           each beside its bound and its plain version, flash at every
           serving shape also beside SDPA's fastest float32 backend; the
           flash backward and forward at the trained families' shapes
           beside the bound, the plain version and SDPA's backward, and
           each training run's flash share of a step; the bf16 train
           runs' step ms (median of steps 2-N), tokens/s and peak memory,
           the bf16 step at 4 x 2048 beside the float32 one; the bf16
           backward at tinyllama's and gemma2-2b's shapes (device_ms)
           beside its bound (bf16 bytes; the two bf16 x bf16 products at
           the bf16 rate, the three with a float32 operand at the
           cheaper of 2 TF32 and 3 bf16 passes), its plain version, each
           of its three kernels' traced ms (``say_bwd_split``) and, at
           tinyllama's, SDPA's bf16 backward by every backend like for
           like; the bf16 forward with lse at those shapes beside its
           bound (Q K^T at the bf16 rate, P V at 3 bf16 passes), its plain
           version and, at tinyllama's, SDPA's bf16 forward by every
           backend that takes it;
6. trace:  one prefill and 8 decode steps of each served model, and one
           train step of the training path, under torch.profiler: the
           device's idle share and the kernels' share of each window and
           the largest device entries, read from the trace; in the train
           step each flash kernel's ms per launch (a flash kernel missing
           from FLASH_SYMBOLS fails the run), and one granite-moe-1b-a400m
           train step (4 x 2048) likewise; one batched LM fitness call
           (128 genomes): idle share, flash share, largest entries; one
           tinyllama-1.1b step at the bf16 train_4k cell (4 x 4096,
           remat): idle share, each bf16 flash kernel's ms, launches and
           ms a launch (the forward 44 times, each backward kernel 22, no
           float32 flash kernel), the GEMMs' share, largest entries;
7. the ``{"kernels": [...]}`` line (seven kernel sources, an entry
   each: the bf16 flash backward's and forward's launches in entries of
   their own;
   flash and SSD with their launches by path, the families' prefills
   among them), the card line, and last
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
# the mesh phase: the GA cell on a one-rank NCCL mesh and on MESH_RANKS
# gloo ranks sharing the card; HVDC at German size on the one-rank mesh.
# MESH_EPOCHS cut from 3 to 2 for the smoke's time (each epoch of a gloo
# rank took 4.5 s on an H100): every run still migrates between epochs
MESH_EPOCHS, MESH_RANKS, MESH_MIGRATIONS, MESH_TIMEOUT_S = 2, 4, 5, 300
MESH_HVDC = dict(fitness="hvdc", islands=1, pop=8, gens_per_epoch=1,
                 epochs=1, grid_size=2715, hvdc_lines=18, contingencies=4,
                 screen_top_k=0)
MESH_HVDC_WORKERS = 4
# the mesh runs' continuation through RESIZE_ISLANDS (cost dispatch over
# RESIZE_WORKERS lanes); the gloo ranks' CostEMA: EMA_DISPATCH's first
# dispatch after a reset, then MESH_EMA_ROUNDS learned ones (a warm-up and
# the timed rest)
MESH_EMA_ROUNDS = 4
# the mesh training phase (train(mesh=)): tinyllama-1.1b at its published
# widths, all 22 layers, MESH_TRAIN_STEPS steps (a) at the training path's
# 4 x 2048 on a one-rank NCCL mesh against the unsharded run, bit for bit;
# (b) on MESH_TRAIN_RANKS gloo ranks sharing the card on (data 2, model 2)
# and (c) granite-moe-1b-a400m on the same ranks (16 experts a tp rank,
# MESH_MOE_STEPS steps), both against one rank at the same shape; (d) on
# MESH_POD_RANKS gloo ranks on (pod 2, data 1, model 1) with the int8
# compressed pod reduce against the exact run. (b)-(d) run MESH_TRAIN_CUT
# (batch, context): cut from 4 x 2048 so that the phase fits its budget;
# MESH_TRAIN_STEPS cut from 3 to 2 for the smoke's time (a gloo step of
# (b) takes ~12 s), MESH_MOE_STEPS from 2 to 1 (its checks are step 1's;
# a gloo step of (c) took 9.8 s on an H100). (b) and (c) carry the
# hidden state as each rank's sequence block (make_train_ctx's default);
# "b whole" runs (b)'s first MESH_WHOLE_STEPS steps on the same ranks with
# make_train_ctx(mesh, seq_parallel=False), the hidden state whole on
# every model rank, held to (b)'s (one step for the phase's time)
MESH_TRAIN_ARCH, MESH_MOE_ARCH = "tinyllama-1.1b", "granite-moe-1b-a400m"
MESH_TRAIN_STEPS, MESH_MOE_STEPS, MESH_WHOLE_STEPS = 2, 1, 1
MESH_TRAIN_ONE = (4, 2048)
MESH_TRAIN_CUT = (4, 512)
MESH_TRAIN_RANKS, MESH_POD_RANKS, MESH_TRAIN_TIMEOUT_S = 4, 2, 600
# losses, grad norms, aux against one rank; tests/test_torch_train.py's
# parameter rule (PARAM_TOL on the elements whose every one-rank gradient
# is at least G_FLOOR_FRAC of its leaf's largest or exactly 0, over
# MIN_KEPT of all; every element within 2 lr a step); the compressed
# reduce's final loss within 5% of the exact run's
# (tests/test_multidevice.py:98)
MESH_TRAIN_RTOL, MESH_PARAM_TOL = 2e-5, (1e-4, 2e-6)
MESH_G_FLOOR, MESH_MIN_KEPT, MESH_TRAIN_LR = 1e-3, 0.9, 1e-3
MESH_COMPRESS_TOL = 0.05
# (d)'s loss change over its steps against the exact run's (zero or one
# pod's gradients move it otherwise), and its pod bytes against int8's
# quarter of a float32 gather (each leaf's two scales and the metrics
# add ~1e-6 of it)
MESH_COMPRESS_DROP_TOL, MESH_COMPRESS_BYTES_TOL = 0.1, 0.01
# the routes of a step are held exactly on every token whose one-rank
# top-k margin (the k-th router probability less the (k+1)-th) is at
# least MESH_ROUTE_MARGIN: float32 sums in another order move the router
# probabilities by ~1e-7 (ROADMAP's rule: MoE results are held where the
# routers keep their top-k margins)
MESH_ROUTE_MARGIN = 1e-5
# (b)'s parameter check gathers the embedding, the final norm and the
# leaves of layers MESH_GATHER_LAYERS (the first and the last: every spec
# a layer's leaves take), cut from all leaves for the smoke's time (17.2 s
# on an H100). The unembedding is left out: most of its gradient is below
# the held-element floor, and with it the held share of this subset fell
# to 0.851, under MESH_MIN_KEPT
MESH_GATHER_LAYERS = (0, 21)
# the mesh serving phase (serve(mesh=)): gemma2-2b at its published
# widths, all 26 layers, greedy; (a) MESH_SERVE_ONE (batch, prompt, gen)
# on a one-rank NCCL mesh against the unsharded serve, tokens equal and
# logits bit for bit; (b) MESH_SERVE_CUT on MESH_SERVE_RANKS gloo ranks
# sharing the card on (data 2, model 2) against one rank in this process,
# tokens equal and logits within MODEL_TOL. (b)'s prompt is cut from 4500
# so that the phase fits its budget (each decode step of a rank stages
# ~190 collectives through the host)
MESH_SERVE_ARCH = "gemma2-2b"
MESH_SERVE_ONE = (4, 4500, 8)
MESH_SERVE_CUT = (4, 1024, 16)
MESH_SERVE_RANKS, MESH_SERVE_TIMEOUT_S = 4, 300
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
# (full AC on 4 outages per genome)
HVDC_SMALL = dict(n_bus=60, n_line=110, n_gen=15, n_hvdc=4, seed=1)
HVDC_BRIDGE = 11
HVDC_TOL, HVDC_PF_ATOL = (1e-4, 1e-4), 1e-4
HVDC_BUSES, HVDC_GENS_PER_EPOCH = 2715, 2
HVDC_ARGS = ["--fitness", "hvdc", "--grid-size", str(HVDC_BUSES),
             "--hvdc-lines", str(HVDC_GENES), "--islands", "2",
             "--num-workers", "4", "--device", "cuda"]
# run: (its flags, epochs, generations an epoch). The vertical run keeps
# one epoch of one generation (it took ~100 s at two epochs of two on an
# H100, 57.4 s for its second generation) and 4 outages a genome (46.6 s
# at 8 on a slow host), the horizontal one epoch of two generations, so
# the smoke stays within its time with the audio, VLM and hybrid phases,
# the mesh training phase and the bf16 training phase
HVDC_RUNS = {"horizontal": (["--pop", "16"], 1, HVDC_GENS_PER_EPOCH),
             "vertical": (["--pop", "8", "--contingencies", "4"], 1, 1)}
HVDC_SOLVE_BATCHES = (1, 16)
# the decoupled host backend: the GA main path under host-thread,
# host-process and host-thread pipelined (fitness.hostsim's numpy
# rastrigin on HOST_WORKERS workers; the three must give the same best
# genome), and HVDC on the German-size grid under host-thread with the
# learned cost model (2 islands of 8, one epoch of one generation); the
# host pool's padded dispatch check runs over HOST_PAD_WORKERS (32768 %
# 6 != 0)
HOST_WORKERS, HOST_PAD_WORKERS = 4, 6
HOST_ARGS = ["--num-workers", str(HOST_WORKERS)]
HOST_RUNS = {
    "host-thread": ["--dispatch-backend", "host-thread"] + HOST_ARGS,
    "host-process": ["--dispatch-backend", "host-process"] + HOST_ARGS,
    "host-thread pipelined": ["--dispatch-backend", "host-thread"] + HOST_ARGS
    + ["--sync-every", "2", "--pipeline-depth", "2"]}
HVDC_HOST_GENS = 1
HVDC_HOST_ARGS = ["--fitness", "hvdc", "--grid-size", str(HVDC_BUSES),
                  "--hvdc-lines", str(HVDC_GENES), "--islands", "2",
                  "--pop", "8", "--gens-per-epoch", str(HVDC_HOST_GENS),
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
# runs cut to fewer epochs (slurm-mock: 37.0 s at the main shape's 3 on an
# H100's host; its mock spawns numpy-only worker processes for every job):
# checked against host-thread's best fitness after as many epochs
QUEUE_EPOCHS = {"slurm-mock": 1}
QUEUE_LATENCY_REPS, QUEUE_METRICS_REPS = 30, 5
# the paper's hierarchical meta-GA (§4.2.2, Fig. 6): meta_ga_config() (3
# islands x 32 meta-individuals, 2 generations an epoch, 4 epochs, the
# outer GA unfused) over make_meta_fitness (5 seeds, 20 inner generations)
# at Tab. 4's upper bound on pop_size, p_max = 500, on rastrigin at the
# GA's G with bounds +-5.12: R = 96 x 5 = 480 inner runs a meta-fitness
# call, each inner generation one kernel launch; 1 + 4 x 2 calls a run.
# The kernel's per-run checks: (individuals, seeds, P, G) at the meta
# shape and at G = 6 (the scalar-load template; the reference examples'
# inner width), with the uniforms shared across individuals (as the path
# draws them) and per run
META = dict(islands=3, pop=32, epochs=4, seeds=5, p_max=500, gens=20,
            genes=MAIN["genes"], base_seed=17)
META_CALLS = 1 + 2 * META["epochs"]
META_N = META["islands"] * META["pop"]
META_KERNEL_CASES = [(META_N, META["seeds"], META["p_max"], META["genes"]),
                     (META_N, META["seeds"], META["p_max"], 6)]
# elastic resize of the GA main shape between epochs (islands per epoch;
# cost-balanced dispatch over RESIZE_WORKERS lanes, rescaled with the
# islands, against a run that keeps them fixed); speculative backup
# dispatch on the main shape's population over BACKUP_WORKERS lanes
RESIZE_ISLANDS = (32, 16, 32)
RESIZE_WORKERS, BACKUP_WORKERS = 8, 4
# the LM hyperparameter search: ``ga_run --fitness lm`` at the reference's
# defaults (4 islands x 32, 5 generations an epoch, 6 training steps of
# batch 4 x 32 a genome) for 2 epochs, on each arch, and tinyllama-1.1b
# under host-thread; a fitness call trains all of its genomes as one
# vmapped run, so each attention layer launches the flash forward and
# backward kernels once a step, whatever the population. Checked: the
# flash wrapper under vmap(grad) over LM_VMAP_RUNS runs at the reduced
# layers' shapes (a 128-genome call's folded batch) against the plain
# versions; the fitness for LM_CHECK_N genomes (the corners of
# tests/test_system.py among them) on the card against the CPU
# (tests/test_torch_train.py's PARAM_TOL), against one plain run per
# genome and in two chunks (LM_SELF_RTOL). Timed at LM_TIME_N genomes
# (the main run's population, and 32 x 32), the per-genome loop at
# LM_LOOP_N. mamba2-780m trains at its published widths through the plain
# chunked scan (SSM_TRAIN_ARGS)
LM_ARCHS = ("tinyllama-1.1b", "gemma2-2b", "mamba2-780m")
LM = dict(islands=4, pop=32, gens_per_epoch=5, epochs=2, steps=6)
LM_ARGS = ["--fitness", "lm", "--islands", str(LM["islands"]), "--pop",
           str(LM["pop"]), "--gens-per-epoch", str(LM["gens_per_epoch"]),
           "--epochs", str(LM["epochs"]), "--lm-steps", str(LM["steps"]),
           "--device", "cuda"]
LM_CORNERS = ([0.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0])
LM_CHECK_N = 8
LM_CPU_TOL, LM_SELF_RTOL = (1e-4, 2e-6), 1e-5
LM_TIME_N, LM_LOOP_N = (128, 1024), 128
LM_VMAP_RUNS = LM_TIME_N[0]
SSM_TRAIN_STEPS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 24, 2, 1024
SSM_TRAIN_ARGS = ["--arch", "mamba2-780m", "--full", "--steps",
                  str(SSM_TRAIN_STEPS), "--batch", str(SSM_TRAIN_BATCH),
                  "--seq", str(SSM_TRAIN_SEQ), "--device", "cuda"]
# host time of a wrapper call: mean over this many calls, one sync at the
# end, at the main shape and at a small one where the device keeps up
HOST_CALLS = 1000
HOST_SMALL = (1, 16, 4)
# the busy-wait (GPU clock cycles, ~2 ms) that device_ms queues its calls
# behind
SLEEP_CYCLES = 1 << 22

# Peak rates from NVIDIA's data sheets (dense, at the full 700 W limit):
# memory bytes/s, float32 operations/s outside the tensor cores, TF32
# tensor-core operations/s and bf16 tensor-core operations/s.
PEAKS = {"H200": (4.8e12, 67e12, 495e12, 989e12),
         "H100": (3.35e12, 67e12, 495e12, 989e12)}
# the flash and SSD kernels issue each float32 product as three TF32
# tensor-core products (3xTF32, src/repro_torch/kernels/csrc/mma_tf32.cuh)
TF32_PRODUCTS = 3
# LM serving path: (arch, prompt length, kernel launches of its run, one
# prefill: gemma2-2b's 26 attention layers, mamba2-780m's 48 SSD layers)
SERVE_RUNS = [("gemma2-2b", 4500, {"flash_attention": 26}),
              ("mamba2-780m", 4000, {"ssd_chunk": 48})]
SERVE_BATCH, SERVE_GEN = 4, 32
# the dense and MoE families at published widths, float32: (arch, prompt
# length, batch, gen); each prefill launches flash once per layer (24, 24,
# 36, 40). qwen2-moe-a2.7b's 14.3 B parameters are 57.3 GB of the card's 80
SERVE_NEW = [("granite-moe-1b-a400m", 4096, 4, 32),
             ("qwen2-moe-a2.7b", 2048, 4, 32),
             ("granite-8b", 2048, 4, 16),
             ("minicpm-2b", 2048, 4, 16)]
# the flash kernel at their layer shapes, as SERVE_NEW runs them (B, S, H,
# KV, hd, causal, window, softcap, dtype): granite-moe (GQA 16/8, hd 64),
# qwen2-moe (MHA 16, hd 128), granite-8b (GQA 32/8, hd 128), minicpm-2b
# (MHA 36, hd 64)
ATTN_NEW = [(4, 4096, 16, 8, 64, True, 0, 0.0, "float32"),
            (4, 2048, 16, 16, 128, True, 0, 0.0, "float32"),
            (4, 2048, 32, 8, 128, True, 0, 0.0, "float32"),
            (4, 2048, 36, 36, 64, True, 0, 0.0, "float32")]
# whole models: tests/torch_parity.py's MODEL_TOL (rtol, atol)
MODEL_TOL = (2e-4, 2e-4)
# the audio, VLM and hybrid families served at published widths, float32
# compute, kernels on: (arch, prompt length, batch, gen). whisper-large-v3
# at its full depth (32 encoder + 32 decoder layers) on 1500 frames;
# llava-next-34b at its 60 layers on 576 patches, bfloat16 parameters
# (68.8 GB); jamba-1.5-large-398b cut (FAMILY_CUTS) to one published
# period of 8 layers with its expert FFN width 24576 -> 6144 (one period
# at 24576 holds 77.3 GB of expert weights), 32.4 GB of bfloat16
FAMILY_RUNS = [("whisper-large-v3", 128, 8, 64),
               ("llava-next-34b", 1024, 2, 16),
               ("jamba-1.5-large-398b", 2048, 2, 16)]
FAMILY_CUTS = {"jamba-1.5-large-398b": dict(num_layers=8, moe_d_ff=6144)}
# each family's prefill on the card, kernel path against the plain path
# (attn_impl "auto": dense or blocked; the plain chunked SSD scan) on the
# same weights: (batch, prompt tokens), the frontends at their defaults
FAMILY_CHECK_TOKENS = (1, 256)
# the flash kernel at the families' layer shapes, as FAMILY_RUNS gives
# them (B, S, H, KV, hd, causal, window, softcap, dtype[, T]): whisper's
# encoder (T = 1500 = 23 x 64 + 28, a partial last key tile), its
# cross-attention (the prompt's queries against 1500 frames, Sq != T) and
# its causal decoder; llava's GQA 7:1 over 576 + 1024 positions; jamba's
# attention layer (GQA 8:1, no RoPE). Kept apart from ATTN_CASES, whose
# cases the backward checks take too (no family trains in this smoke)
ATTN_FAMILIES = [(8, 1500, 20, 20, 64, False, 0, 0.0, "float32"),
                 (8, 128, 20, 20, 64, False, 0, 0.0, "float32", 1500),
                 (8, 128, 20, 20, 64, True, 0, 0.0, "float32"),
                 (2, 1600, 56, 8, 128, True, 0, 0.0, "float32"),
                 (2, 2048, 64, 8, 128, True, 0, 0.0, "float32")]
# the SSD kernel at jamba's (H, P, N, chunk) = (128, 128, 128, 256), one
# head a block: the card tests' case and the serving path's shape, with
# Mamba-2's dt and a (the chunk-decay check)
SSD_FAMILIES = [(1, 512, 8, 128, 128, 256), (2, 2048, 128, 128, 128, 256)]
# one published-width MoE layer on (batch, tokens); each new arch at its
# published widths cut to NEW_ARCH_DEPTH layers, prefill of NEW_ARCH_TOKENS
# on the card against the CPU
MOE_LAYER_TOKENS = (2, 256)
NEW_ARCH_DEPTH, NEW_ARCH_TOKENS = 2, (2, 64)
# the continuous batcher on gemma2-2b at published widths: BATCH_N requests
# through BATCH_SLOTS lanes, prompts spread over BATCH_PROMPT (past the
# 4096 window, so local ring caches wrap per lane), max_new_tokens in
# BATCH_NEW; each request held against its own batch-1 decoding up to the
# first step whose top-2 logit margin is below BATCH_MARGIN
BATCH_ARCH, BATCH_SLOTS, BATCH_CACHE, BATCH_N = "gemma2-2b", 4, 4608, 12
BATCH_PROMPT, BATCH_NEW, BATCH_SEED = (256, 4500), (8, 32), 65
BATCH_MARGIN = 1e-3
# decode steps in each traced decode window; the device symbols of the
# port's kernels, as they appear in a trace: the float32 flash forward,
# then the float32 backward's two kernels (flash_attention_bwd.cu: dk, dv
# and dq partials; the partials' sum), which every float32 training trace
# must show; the bf16 forward (flash_attention_fwd_bf16.cu) and the bf16
# backward's three (flash_attention_bwd_bf16.cu: D, the dk / dv pass, the
# dq pass), which every bf16 training trace must show
TRACE_DECODE = 8
FLASH_SYMBOLS = ("flash_fwd_kernel", "flash_bwd_kernel",
                 "flash_bwd_dq_reduce_kernel")
BF16_FWD_SYMBOLS = ("flash_fwd_bf16_kernel",)
BF16_BWD_SYMBOLS = ("flash_bwd_bf16_dsum_kernel", "flash_bwd_bf16_dkdv_kernel",
                    "flash_bwd_bf16_dq_kernel")
KERNEL_SYMBOLS = ("fused_variation_kernel", *FLASH_SYMBOLS,
                  *BF16_FWD_SYMBOLS, *BF16_BWD_SYMBOLS, "ssd_chunk_kernel",
                  "delay_chain_kernel")
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
# float32 at tests/test_kernels.py:75's tolerance; bf16 (the bf16 forward,
# computed in float32 and rounded once, as the plain version) by
# ``fwd_close``: the output at one rounding step (GRAD_TOL's bf16 entry),
# lse at BF16_LSE_TOL (the float32 sums' order, base-2 exponentials)
ATTN_TOL = {"float32": (3e-5, 3e-5)}
BF16_LSE_TOL = (1e-5, 1e-5)
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
# the backward kernel's float32 checks beyond ATTN_CASES (its bf16 case
# is checked with BF16_TINYLLAMA's): tinyllama-1.1b's layer shape at
# batch 1 and at the training path's batch 4; gemma2-2b's layer shapes
# with S > its 4096 window, so
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
# gradients (rtol, atol): float32 at tests/test_kernels.py:96-97's
# tolerance; bf16 (computed in float32 and rounded once on both sides) at
# one rounding step elementwise (2^-7 of the value) plus the float32 sums'
# own difference, an atol of 2^-12 of the gradient's largest magnitude
GRAD_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -12)}
# the backward needs five products of 2 hd FLOP per visible (query, key)
# pair and query head: Q K^T, dO V^T, P^T dO, dS^T Q, dS K
BWD_PRODUCTS = 5

# training the MoE, audio and VLM families on the card at published
# widths: granite-moe-1b-a400m through ``launch.train`` (32 experts top-8,
# the sorted dispatch, 8 steps of 4 x 2048), then ``Model(remat=True)``
# for 3 steps at its served shape 4 x 4096 (without remat its saved
# activations would pass the card's memory); whisper-large-v3 through
# ``launch.train`` (32 + 32 layers, 1500 frames, 8 steps of 4 x 448);
# llava-next-34b cut to LLAVA_TRAIN_CUT layers (34.4 B parameters would
# need 412 GB of training state), bfloat16 parameters, 4 steps of 2 x
# (576 patches + 1024 tokens) through ``make_train_step``
MOE_TRAIN_ARCH, MOE_TRAIN_STEPS = "granite-moe-1b-a400m", 8
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 2048
MOE_TRAIN_ARGS = ["--arch", MOE_TRAIN_ARCH, "--full", "--steps",
                  str(MOE_TRAIN_STEPS), "--batch", str(MOE_TRAIN_BATCH),
                  "--seq", str(MOE_TRAIN_SEQ), "--device", "cuda"]
MOE_REMAT = dict(steps=3, batch=4, seq=4096)
WHISPER_TRAIN_STEPS, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 8, 4, 448
WHISPER_TRAIN_ARGS = ["--arch", "whisper-large-v3", "--full", "--steps",
                      str(WHISPER_TRAIN_STEPS), "--batch",
                      str(WHISPER_TRAIN_BATCH), "--seq",
                      str(WHISPER_TRAIN_SEQ), "--device", "cuda"]
LLAVA_TRAIN = dict(arch="llava-next-34b", steps=4, batch=2, patches=576,
                   seq=1024)
LLAVA_TRAIN_CUT = dict(num_layers=4)
# the flash backward at these runs' layer shapes (B, S, H, KV, hd, causal,
# window, softcap, dtype[, T]), with the layers of a step that run each:
# whisper's encoder (T = 1500 = 23 x 64 + 28, non-causal), decoder
# (causal) and cross-attention (448 queries against 1500 frames, no
# mask); llava's GQA 7:1 over 576 + 1024 positions; granite-moe's 16:8 at
# hd 64, at 4 x 2048 and at the remat run's 4 x 4096
TRAIN_FAMILY_BWD = {
    "whisper encoder": ((4, 1500, 20, 20, 64, False, 0, 0.0, "float32"),
                        32),
    "whisper decoder": ((4, 448, 20, 20, 64, True, 0, 0.0, "float32"), 32),
    "whisper cross": ((4, 448, 20, 20, 64, False, 0, 0.0, "float32",
                       1500), 32),
    "llava": ((2, 1600, 56, 8, 128, True, 0, 0.0, "float32"),
              LLAVA_TRAIN_CUT["num_layers"]),
    "granite-moe": ((4, 2048, 16, 8, 64, True, 0, 0.0, "float32"), 24),
    "granite-moe remat": ((4, 4096, 16, 8, 64, True, 0, 0.0, "float32"),
                          24)}
# bf16 training (the dry run's train_4k cell, repro/launch/dryrun.py:
# 159-173, trained for real on one card): Model(compute_dtype="bfloat16",
# attn_impl="kernel", remat=True, max_seq=4096), optimizer_for_arch with
# bf16 moments above 20e9 parameters, make_train_step with the dry run's
# microbatches (its MICROBATCHES table, dryrun.py:37, lists neither arch
# run here: 1), the batch shaped by launch/specs.py::input_specs(arch,
# "train_4k"). Cuts:
# the global batch of 256 sequences to BF16_TRAIN's (the smoke's time;
# the card's memory would hold more of tinyllama's), the dry run's
# optimizer schedule (warmup 100 of 10,000 steps, which a few steps never
# leave) to launch.train's (lr 1e-3, 5 warmup steps); bigram data
BF16_SHAPE = "train_4k"
BF16_TRAIN = {"tinyllama-1.1b": dict(batch=4, steps=8),
              "gemma2-2b": dict(batch=1, steps=8)}
BF16_OPT = dict(lr=1e-3, warmup_steps=5)
# the same bf16 step at the float32 main run's shape, beside it
BF16_SIDE = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=4)
# the bf16 backward against its plain version (``check_flash_bwd``): the
# tests' bf16 case, tinyllama-1.1b's train_4k layer, gemma2-2b's at 4500
# keys (its 4096 window binds there, never at 4096), windowed and global,
# softcap 50, and the trained families' shapes; repeat calls and one-key-
# tile chunks bit-equal at BF16_BITS
BF16_TINYLLAMA = (4, 4096, 32, 4, 64, True, 0, 0.0, "bfloat16")
BF16_GEMMA = [(1, 4500, 8, 4, 256, True, 4096, 50.0, "bfloat16"),
              (1, 4500, 8, 4, 256, True, 0, 50.0, "bfloat16")]
BF16_BITS = (BF16_TINYLLAMA, BF16_GEMMA[1])
# the bf16 forward's checks beyond those shapes (with the backward too):
# ATTN_MASKED in bf16 (rows that see no key are 0), and hd 32 (held as 64
# columns) with a window and a softcap
BF16_MASKED = dict(ATTN_MASKED, case=ATTN_MASKED["case"][:8] + ("bfloat16",))
BF16_HD32 = (2, 200, 4, 4, 32, True, 50, 30.0, "bfloat16")

# one train step of each reduced family on the card against the CPU
# (``train_step.reduced_train_step``): (arch, Model switches)
TRAIN_FAMILY_REDUCED = [("whisper-large-v3", {}), ("llava-next-34b", {}),
                        ("jamba-1.5-large-398b", {}),
                        ("granite-moe-1b-a400m", dict(moe_impl="sorted")),
                        ("granite-moe-1b-a400m", dict(moe_impl="sorted",
                                                      remat=True))]
# the LM search on the new families: ``ga_run --fitness lm --lm-arch A
# --epochs 0``, one fitness call of LM_FAMILY_GENOMES genomes (the initial
# population), held against the same call on the CPU at LM_CPU_TOL;
# jamba's at 3 training steps, not 6: its reduced routers (8 experts,
# top-2) come closer to ties the longer they train, and a near-tie lets
# another summation order swap two experts (as granite-moe's, ROADMAP
# queue 1 item 4.2)
LM_FAMILY_ARCHS = {"whisper-large-v3": 6, "llava-next-34b": 6,
                   "jamba-1.5-large-398b": 3}
LM_FAMILY_GENOMES = (2, 8)
# with MoE layers, a genome's card loss is held to the CPU's only where
# round-off alone cannot move it past the tolerance: where the same CPU
# call from the initialisation scaled by (1 + LM_PERTURB x N(0, 1))
# moves it by at most LM_SPREAD_MAX (the larger of LM_PERTURB_DRAWS
# draws). A router is discontinuous: on
# reduced jamba a 1e-7 perturbation moves one genome of 32 by 1.1e-3
# after 3 steps (a CPU run), ten times the tolerance. At least
# LM_MIN_HELD of the genomes must qualify
LM_PERTURB, LM_PERTURB_DRAWS, LM_SPREAD_MAX, LM_MIN_HELD = 1e-7, 2, 1e-5, 0.5

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


# ---------------------------------------------------------------------------
# the GA and the HVDC fitness on a device mesh (GAEngine(ctx=))
# ---------------------------------------------------------------------------

def mesh_args(**kw):
    """ga_run's arguments for ``ga_run.build``: the GA cell's by default."""
    import types
    args = dict(genes=MAIN["genes"], pop=MAIN["pop"], islands=MAIN["islands"],
                gens_per_epoch=MAIN["gens_per_epoch"], epochs=MESH_EPOCHS,
                seed=0)
    args.update(kw)
    return types.SimpleNamespace(**args)


def mesh_engine_run(eng, epochs):
    """Run ``eng`` from its own init: the global population, the best
    trace, kernel 1's launches in the run and its epoch s (the run's wall
    time, synchronised, over its epochs)."""
    import numpy as np
    import torch
    from repro_torch.kernels.genetic import ops
    local = eng.init()
    torch.cuda.synchronize()
    ops.launches = 0
    t0 = time.perf_counter()
    pop, hist = eng.run(local, epochs=epochs)
    torch.cuda.synchronize()
    return {"pop": pop, "trace": np.stack([h["trace"] for h in hist]),
            "launches": ops.launches,
            "epoch_s": (time.perf_counter() - t0) / epochs}


def same_run(a, b, label):
    import numpy as np
    import torch
    if not (torch.equal(a["pop"].genomes.cpu(), b["pop"].genomes.cpu())
            and torch.equal(a["pop"].fitness.cpu(), b["pop"].fitness.cpu())
            and np.array_equal(a["trace"], b["trace"])):
        fail(f"{label}: the population or the best trace differs from the "
             f"unsharded engine's")


def mesh_hvdc(ctx, device, card):
    """HVDC at German size on the one-rank mesh with the cost model (4
    lanes): init and one generation, then the survivors' fitness against
    the unsharded fitness through the same dispatch."""
    import torch
    from repro_torch.core.broker import Broker
    from repro_torch.core.engine import GAEngine
    from repro_torch.fitness.powerflow import HVDCDispatchFitness
    from repro_torch.kernels.genetic import ops
    from repro_torch.launch import ga_run
    args = mesh_args(**MESH_HVDC)
    cfg, one, cost = ga_run.build("hvdc", args, device)
    fit = HVDCDispatchFitness(one.grid, contingencies=args.contingencies,
                              ctx=ctx, device=device)
    eng = GAEngine(cfg, fit, cost_fn=fit.cost_model(), ctx=ctx,
                   num_workers=MESH_HVDC_WORKERS, device=device)
    ops.launches = 0
    t0 = time.perf_counter()
    pop, hist = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launches
    if launches != cfg.generations_per_epoch * cfg.num_epochs:
        fail(f"mesh HVDC: fused_variation launched {launches} times")
    genomes = pop.genomes.reshape(-1, cfg.num_genes)
    want, _ = Broker(one, cost, num_workers=MESH_HVDC_WORKERS).evaluate(
        genomes)
    got = pop.fitness.reshape(want.shape)
    if not torch.equal(got, want):
        fail(f"mesh HVDC: fitness differs from the unsharded fitness "
             f"(max abs {float((got - want).abs().max())})")
    say(f"mesh: HVDC {one.grid.n_bus} buses, {cfg.num_genes} lines, pop "
        f"{genomes.shape[0]}, {args.contingencies} contingencies, one "
        f"generation on a one-rank NCCL mesh, cost model over "
        f"{MESH_HVDC_WORKERS} lanes: {seconds:.3f} s (init + generation), "
        f"fused_variation launches {launches}, skew {hist[-1]['skew']:.4f}, "
        f"fitness bit-equal to the unsharded fitness; card: {card}")
    return {"launches": launches, "seconds": seconds}


def resize_cost(genomes):
    """The resize runs' static cost model."""
    return genomes.abs().sum(-1) + 0.1


def mesh_resize(cfg, fit, pop, ctx, device):
    """Go on from a mesh-phase run's global population ``pop`` through
    RESIZE_ISLANDS' resizes, one epoch after each, cost dispatch over
    RESIZE_WORKERS lanes rescaled with the islands (as resize_schedule),
    on ``ctx`` (no mesh: the unsharded run). Returns the global
    population, the best traces, kernel 1's launches and, for each
    resize, its ms (host clock, synchronised), its collectives, the lanes
    after it and the global population's best before and after."""
    import numpy as np
    import torch
    from repro_torch.core import collectives, island
    from repro_torch.core.engine import GAEngine
    from repro_torch.kernels.genetic import ops
    eng = GAEngine(cfg, fit, cost_fn=resize_cost, num_workers=RESIZE_WORKERS,
                   ctx=ctx, device=device)
    ops.launches = 0
    traces, resizes = [], {}
    for old, new in zip(RESIZE_ISLANDS, RESIZE_ISLANDS[1:]):
        before = float(pop.fitness.min())
        collectives.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pop = eng.resize(pop, new)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: dict(v) for k, v in collectives.counts.items()}
        after = island.gather_pop(pop, ctx).fitness
        resizes[f"{old}->{new}"] = {
            "ms": ms, "collectives": counts,
            "workers": eng.broker.num_workers,
            "best": (before, float(after.min())),
            "finite": bool(torch.isfinite(after).all())}
        pop, hist = eng.run(pop, epochs=1)
        traces.append(np.stack([h["trace"] for h in hist]))
    torch.cuda.synchronize()
    return {"pop": pop, "traces": traces, "launches": ops.launches,
            "resizes": resizes}


def check_mesh_resize(label, run, base=None):
    """A mesh_resize run's own checks, and bit-equality with ``base``."""
    import numpy as np
    import torch
    shrink, grow = run["resizes"].values()
    if shrink["best"][1] != shrink["best"][0]:
        fail(f"{label}: the shrink lost the best: {shrink['best']}")
    if not grow["finite"]:
        fail(f"{label}: the grow left unevaluated (+inf) fitness")
    expect = MAIN["gens_per_epoch"] * (len(RESIZE_ISLANDS) - 1)
    if run["launches"] != expect:
        fail(f"{label}: fused_variation launched {run['launches']} times "
             f"over the resize run, expected {expect}")
    if base is not None and not (
            torch.equal(run["pop"].genomes.cpu(), base["pop"].genomes.cpu())
            and torch.equal(run["pop"].fitness.cpu(),
                            base["pop"].fitness.cpu())
            and all(np.array_equal(a, b) for a, b in
                    zip(run["traces"], base["traces"]))):
        fail(f"{label}: the resized run's population or best trace differs "
             f"from the unsharded run's")


def say_mesh_resize(label, run, card):
    parts = []
    for step, r in run["resizes"].items():
        c = {axis: {k: v[k] for k in ("calls", "bytes", "staged_calls",
                                      "staged_bytes")}
             for axis, v in r["collectives"].items()}
        parts.append(f"{step} {r['ms']:.3f} ms, {r['workers']} lanes after, "
                     f"collectives {json.dumps(c)}")
    say(f"mesh: resize {' -> '.join(map(str, RESIZE_ISLANDS))} on {label} "
        f"(host clock, synchronised; cost dispatch over {RESIZE_WORKERS} "
        f"lanes rescaled): " + "; ".join(parts)
        + f"; fused_variation launches {run['launches']}; card: {card}")


def ema_batches(device):
    """EMA_DISPATCH's batches (benchmarks/broker_overhead.py:150-180): the
    heterogeneous one, whose hot rows are exactly one lane of the uniform
    balanced assignment, and an all-fast one."""
    import numpy as np
    import torch
    from repro_torch.core.broker import balanced_permutation
    n, w, genes = (EMA_DISPATCH[k] for k in ("n", "w", "genes"))
    perm0 = balanced_permutation(torch.ones(n), w).numpy()
    hot = np.zeros(n, bool)
    hot[perm0[:n // w]] = True
    het = np.random.default_rng(0).uniform(-1, 1, (n, genes)).astype(
        np.float32)
    het[:, 0] = np.where(hot, 1.0, -1.0)
    fast = het.copy()
    fast[:, 0] = -1.0
    return tuple(torch.tensor(a, device=device) for a in (het, fast))


def mesh_ema(ctx, device):
    """The learned cost model over this rank's rows of EMA_DISPATCH's
    batches, each rank with its own host thread pool: a round on the fast
    batch, a reset, the first dispatch of the heterogeneous batch, then
    MESH_EMA_ROUNDS learned ones. After each evaluate every rank's table
    and next permutation must be rank 0's. Returns ms per evaluate (host
    clock, synchronised; learned: the mean after a warm-up) and the
    stats of the first and last."""
    import functools
    import torch
    import torch.distributed as dist
    from repro_torch.core.broker import (Broker, CostEMA, HostPoolBackend,
                                         balanced_permutation)
    from repro_torch.fitness import hostsim
    n, w, slow_s = (EMA_DISPATCH[k] for k in ("n", "w", "slow_s"))
    het, fast = ema_batches(device)
    rows = ctx.sizes(n, ctx.dp)
    first, end = ctx.rows(n, ctx.dp)
    ema = CostEMA(alpha=0.6)
    fn = functools.partial(hostsim.delay_sphere, slow_s=slow_s)
    with HostPoolBackend(fn, num_workers=w) as backend:
        broker = Broker(cost_fn=ema, num_workers=w, backend=backend, ctx=ctx)

        def evaluate(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, stats = broker.evaluate(x[first:end], rows=rows)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            table = ema.snapshot(n)
            perm = balanced_permutation(torch.from_numpy(table), w).numpy()
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, (table.tobytes(), perm.tobytes()))
            if any(e != every[0] for e in every):
                fail(f"mesh CostEMA: the ranks' tables or permutations "
                     f"part after an evaluate (rank {dist.get_rank()})")
            return ms, {k: float(v) for k, v in stats.items()}

        evaluate(fast)
        ema.reset()
        first_ms, first_stats = evaluate(het)
        learned = [evaluate(het) for _ in range(MESH_EMA_ROUNDS)]
    return {"first_ms": first_ms, "first": first_stats,
            "learned_ms": statistics.mean(ms for ms, _ in learned[1:]),
            "learned": learned[-1][1], "updates": ema.updates,
            "lanes": broker.lanes}


def mesh_rank(rank, world, where):
    """One of the MESH_RANKS gloo ranks sharing the card (run in its own
    process by phase_mesh): the GA cell on its islands; rank 0 saves the
    global population, the best trace and every rank's report."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import collectives, island
    from repro_torch.core.engine import GAEngine
    from repro_torch.core.population import population_to_numpy
    from repro_torch.launch import ga_run
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models.sharding import ShardingCtx
    device = init_distributed(rank, world, f"file://{where}/ranks.store",
                              local_world_size=world)
    try:
        ctx = ShardingCtx(mesh=make_local_mesh(world, 1), dp=("data",),
                          tp="model")
        cfg, fit, _ = ga_run.build("rastrigin", mesh_args(), device)
        eng = GAEngine(cfg, fit, ctx=ctx, device=device)
        collectives.reset_counts()
        run = mesh_engine_run(eng, MESH_EPOCHS)
        counts = {k: dict(v) for k, v in collectives.counts.items()}
        local = island.constrain_pop(run["pop"], ctx)
        gen = torch.Generator(device=device)
        gen.manual_seed(rank)
        times = []
        for _ in range(MESH_MIGRATIONS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            island.migrate_ring(cfg, local, gen, ctx)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        resized = mesh_resize(cfg, fit, run["pop"], ctx, device)
        check_mesh_resize(f"gloo rank {rank}", resized)
        report = {"rank": rank, "device": str(device),
                  "backend": str(dist.get_backend()),
                  "islands": local.genomes.shape[0],
                  "epoch_s": run["epoch_s"],
                  "migration_ms": statistics.median(times),
                  "launches": run["launches"], "collectives": counts,
                  "resize": {k: v for k, v in resized.items()
                             if k not in ("pop", "traces")},
                  "ema": mesh_ema(ctx, device)}
        reports = [None] * world
        dist.all_gather_object(reports, report)
        if rank == 0:
            torch.save({"genomes": run["pop"].genomes.cpu(),
                        "fitness": run["pop"].fitness.cpu(),
                        "trace": np.asarray(run["trace"]),
                        "resized": {"genomes": resized["pop"].genomes.cpu(),
                                    "fitness": resized["pop"].fitness.cpu(),
                                    "traces": resized["traces"]},
                        "reports": reports}, Path(where) / "mesh.pt")
    finally:
        dist.destroy_process_group()


def mesh_spawn(where):
    """MESH_RANKS processes of mesh_rank; rank 0's results."""
    import torch
    cmd = "import sys; sys.path.insert(0, {!r}); import chip_smoke; " \
          "chip_smoke.mesh_rank({}, {}, {!r})"
    procs = [subprocess.Popen(
        [sys.executable, "-c", cmd.format(str(ROOT), r, MESH_RANKS, where)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    try:
        logs = [p.communicate(timeout=MESH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"mesh rank {r} of {MESH_RANKS} exited {p.returncode}:\n"
                 f"{log[-3000:]}")
    return torch.load(Path(where) / "mesh.pt", weights_only=False)


def phase_mesh(device, card):
    """GAEngine(ctx=) at the GA cell's shape: unsharded, on a one-rank NCCL
    mesh (bit-equal; then HVDC at German size on it), and on MESH_RANKS
    gloo ranks sharing the card (bit-equal to the one-rank run)."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives
    from repro_torch.core.engine import GAEngine
    from repro_torch.launch import ga_run
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models.sharding import ShardingCtx
    expect = MAIN["gens_per_epoch"] * MESH_EPOCHS
    cfg, fit, _ = ga_run.build("rastrigin", mesh_args(), device)
    one = mesh_engine_run(GAEngine(cfg, fit, device=device), MESH_EPOCHS)
    shape = tuple(one["pop"].genomes.shape)
    one_resized = mesh_resize(cfg, fit, one["pop"], ShardingCtx(), device)
    check_mesh_resize("unsharded", one_resized)
    say_mesh_resize("the unsharded engine", one_resized, card)
    with tempfile.TemporaryDirectory() as where:
        init_distributed(0, 1, f"file://{where}/one.store",
                         local_world_size=1)
        try:
            if dist.get_backend() != "nccl":
                fail(f"a one-rank mesh on the card runs on "
                     f"{dist.get_backend()}, not NCCL")
            ctx = ShardingCtx(mesh=make_local_mesh(1, 1), dp=("data",),
                              tp="model")
            collectives.reset_counts()
            mesh1 = mesh_engine_run(GAEngine(cfg, fit, ctx=ctx,
                                             device=device), MESH_EPOCHS)
            counts = {k: dict(v) for k, v in collectives.counts.items()}
            resized1 = mesh_resize(cfg, fit, mesh1["pop"], ctx, device)
            hvdc = mesh_hvdc(ctx, device, card)
        finally:
            dist.destroy_process_group()
        for run in (one, mesh1):
            if run["launches"] != expect:
                fail(f"mesh: fused_variation launched {run['launches']} "
                     f"times, expected {expect}")
        same_run(one, mesh1, "one-rank NCCL mesh")
        if counts["data"]["staged_calls"]:
            fail("the NCCL mesh staged a collective through the host")
        say(f"mesh: GAEngine(ctx=) one-rank NCCL mesh at {shape}, "
            f"{MESH_EPOCHS} epochs: population and best trace bit-equal to "
            f"the unsharded engine; epoch {mesh1['epoch_s']:.4f} s "
            f"(unsharded {one['epoch_s']:.4f} s); fused_variation launches "
            f"{mesh1['launches']} (unsharded {one['launches']}); "
            f"collectives {json.dumps(counts)}; card: {card}")
        check_mesh_resize("one-rank NCCL mesh", resized1, one_resized)
        say_mesh_resize("a one-rank NCCL mesh", resized1, card)
        say("mesh: resize on a one-rank NCCL mesh: population and best "
            "traces bit-equal to the unsharded engine's")
        del one
        torch.cuda.empty_cache()
        got = mesh_spawn(where)
    four = {"pop": mesh1["pop"]._replace(genomes=got["genomes"],
                                         fitness=got["fitness"]),
            "trace": got["trace"]}
    same_run(mesh1, four, f"{MESH_RANKS} gloo ranks")
    res = got["resized"]
    check_mesh_resize(f"{MESH_RANKS} gloo ranks", {
        "pop": one_resized["pop"]._replace(genomes=res["genomes"],
                                           fitness=res["fitness"]),
        "traces": res["traces"], **got["reports"][0]["resize"]},
        one_resized)
    for rep in got["reports"]:
        if rep["launches"] != expect or rep["backend"] != "gloo":
            fail(f"mesh rank {rep['rank']}: {rep['backend']}, "
                 f"fused_variation launches {rep['launches']}")
        c = rep["collectives"]["data"]
        say(f"mesh: gloo rank {rep['rank']}/{MESH_RANKS} on {rep['device']}:"
            f" {rep['islands']} islands, epoch {rep['epoch_s']:.4f} s, "
            f"migration {rep['migration_ms']:.3f} ms (median of "
            f"{MESH_MIGRATIONS}), collectives {c['calls']} calls "
            f"{c['bytes']} B ({c['staged_calls']} staged, "
            f"{c['staged_bytes']} B), fused_variation launches "
            f"{rep['launches']}; card: {card}")
        say_mesh_resize(f"gloo rank {rep['rank']}/{MESH_RANKS}",
                        rep["resize"], card)
        e = rep["ema"]
        say(f"mesh: CostEMA on gloo rank {rep['rank']}/{MESH_RANKS} (n "
            f"{EMA_DISPATCH['n']}, w {EMA_DISPATCH['w']}, {e['lanes']} lanes "
            f"a rank, delay_sphere slow_s {EMA_DISPATCH['slow_s']}, its own "
            f"host thread pool; host clock, synchronised): first dispatch "
            f"{e['first_ms']:.3f} ms per evaluate, skew "
            f"{e['first']['skew']:.4f} vs naive skew "
            f"{e['first']['naive_skew']:.4f}; learned {e['learned_ms']:.3f} "
            f"ms per evaluate (mean of {MESH_EMA_ROUNDS - 1} after a "
            f"warm-up), skew {e['learned']['skew']:.4f} vs naive skew "
            f"{e['learned']['naive_skew']:.4f}; {e['updates']} folded "
            f"observations; card: {card}")
    say(f"mesh: {MESH_RANKS} gloo ranks sharing the card: population and "
        f"best trace bit-equal to the one-rank run, before and after the "
        f"resizes; every rank's CostEMA table and permutation equal after "
        f"each evaluate")
    return {"one_rank": mesh1["launches"], "hvdc": hvdc["launches"],
            "ranks": [r["launches"] for r in got["reports"]],
            "one_rank_resize": resized1["launches"],
            "ranks_resize": [r["resize"]["launches"]
                             for r in got["reports"]]}


def mesh_train_counts(steps):
    """This process's collectives a step, by mesh axis."""
    from repro_torch.core import collectives
    return {axis: {k: ({op: n / steps for op, n in v.items()}
                       if isinstance(v, dict) else v / steps)
                   for k, v in c.items()}
            for axis, c in collectives.counts.items()}


def mesh_train_report(label, device, stats, steps, state_numel):
    """One run's numbers on this rank: step ms (the first, with the set-up
    of the kernels, and the median of the others), collectives a step,
    peak device memory, the bytes of its parameter and moment blocks and
    its flash launches."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    return {"run": label, "device": str(device),
            "step_ms_first": stats["step_ms"][0],
            "step_ms": statistics.median(stats["step_ms"][1:]
                                         or stats["step_ms"]),
            "collectives_per_step": mesh_train_counts(steps),
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "param_and_moment_bytes": 3 * 4 * state_numel,
            "flash_launches": [attn_ops.launches, attn_ops.bwd_launches]}


def mesh_train_zero():
    import torch
    from repro_torch.core import collectives
    from repro_torch.kernels.attention import ops as attn_ops
    collectives.reset_counts()
    attn_ops.launches = attn_ops.bwd_launches = 0
    torch.cuda.empty_cache()


def mesh_route_check(got, base):
    """Step 1's routes on the mesh against one rank's: (router calls,
    tokens, tokens held (margin at least MESH_ROUTE_MARGIN), routes that
    differ on held tokens, on the others, and the smallest margin)."""
    held = bad = loose = tokens = 0
    for a, b, m in zip(got, base["routes"], base["margins"]):
        differ = (a != b).any(-1)
        keep = m >= MESH_ROUTE_MARGIN
        tokens += keep.numel()
        held += int(keep.sum())
        bad += int((differ & keep).sum())
        loose += int((differ & ~keep).sum())
    low = min(float(m.min()) for m in base["margins"])
    return {"calls": len(got), "calls_one_rank": len(base["routes"]),
            "tokens": tokens, "held": held, "differ_held": bad,
            "differ_below_margin": loose, "min_margin": low}


def mesh_train_baseline(arch, device, steps, batch, seq, **model_kw):
    """One rank of ``launch.train.train(arch, reduced=False)``'s run (the
    same model, initialisation, optimizer and bigram batches), with each
    step's gradients taken first: losses, grad norms and aux, the first
    step's routes with each token's top-k margin, the elements whose every
    gradient is sure, the last parameters (on the CPU)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, place
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import ShardingCtx
    from repro_torch.train.optimizer import optimizer_for_arch
    from repro_torch.train.train_step import (init_train_state,
                                              make_compute_grads,
                                              make_train_step)
    cfg = get_config(arch)
    model = Model(cfg, device=device, attn_impl="kernel",
                  use_ssd_kernel=False, max_seq=seq + 8, **model_kw)
    state = init_train_state(model,
                             torch.Generator(device=device).manual_seed(0))
    step = make_train_step(model, optimizer_for_arch(
        arch, lr=MESH_TRAIN_LR, warmup_steps=max(steps // 20, 5),
        total_steps=steps))
    grads_fn = make_compute_grads(model)
    data = SyntheticTokens(cfg, batch, seq, seed=0, mode="bigram")
    out = {"loss": [], "grad_norm": [], "aux": []}
    sure = None
    for i in range(steps):
        b = place(data.batch(i), ShardingCtx(), device)
        with (recorded_routes() if i == 0 else
              contextlib.nullcontext()) as routes:
            grads, _ = grads_fn(state["params"], b)
        if i == 0:
            out["routes"] = [r for r, _ in routes]
            out["margins"] = [m for _, m in routes]
        with torch.no_grad():
            now = {n: (g.abs() >= MESH_G_FLOOR * g.abs().max()) | (g == 0)
                   for n, g in grads.items()}
        sure = now if sure is None else {n: sure[n] & now[n] for n in now}
        del grads
        state, met = step(state, b)
        for key in ("loss", "grad_norm", "aux"):
            out[key].append(float(met[key]))
    out["params"] = {n: p.detach().cpu() for n, p in state["params"].items()
                     if mesh_gathered(n)}
    out["sure"] = {n: m.cpu() for n, m in sure.items() if mesh_gathered(n)}
    del state, model, step, grads_fn, sure
    torch.cuda.empty_cache()
    return out


def mesh_gathered(name):
    """Whether (b)'s parameter check gathers leaf ``name``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return int(parts[1]) in MESH_GATHER_LAYERS
    return parts[0] != "unembed"


def mesh_params_check(got, base, steps):
    """tests/test_torch_train.py's rule (MESH_PARAM_TOL on the sure
    elements, over MESH_MIN_KEPT of all; every element within 2 lr a step):
    (kept share, largest difference) or the failure."""
    rtol, atol = MESH_PARAM_TOL
    kept = total = 0
    worst = 0.0
    for name, want in base["params"].items():
        ok, diff = base["sure"][name], (got[name] - want).abs()
        bad = ok & (diff > atol + rtol * want.abs())
        if bool(bad.any()):
            return f"{name}: {int(bad.sum())} sure elements off"
        worst = max(worst, float(diff.max()))
        kept, total = kept + int(ok.sum()), total + ok.numel()
    if worst > 2 * MESH_TRAIN_LR * steps or kept / total <= MESH_MIN_KEPT:
        return f"largest difference {worst}, kept {kept / total}"
    return kept / total, worst


def mesh_train_steps(ctx, device, batch, seq, steps, **step_kw):
    """``steps`` steps of MESH_TRAIN_ARCH over ``ctx`` as train(mesh=)
    takes them (the same model, initialisation, optimizer and bigram
    batches; the peak memory reset after the set-up): (stats with each
    step's ms, loss and grad norm; this rank's parameter elements; the
    leaves)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, place
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import optimizer_for_arch
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = get_config(MESH_TRAIN_ARCH)
    model = Model(cfg, device=device, attn_impl="kernel",
                  use_ssd_kernel=False, max_seq=seq + 8, ctx=ctx)
    state = init_train_state(model,
                             torch.Generator(device=device).manual_seed(0))
    step = make_train_step(model, optimizer_for_arch(
        MESH_TRAIN_ARCH, lr=MESH_TRAIN_LR,
        warmup_steps=max(MESH_TRAIN_STEPS // 20, 5),
        total_steps=MESH_TRAIN_STEPS), **step_kw)
    data = SyntheticTokens(cfg, batch, seq, seed=0, mode="bigram")
    torch.cuda.reset_peak_memory_stats(device)
    stats = {"step_ms": [], "loss": [], "grad_norm": []}
    for i in range(steps):
        b = place(data.batch(i), ctx, device)
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize(device)
        stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
        stats["loss"].append(float(met["loss"]))
        stats["grad_norm"].append(float(met["grad_norm"]))
    params = state["params"]
    return stats, sum(p.numel() for p in params.values()), len(params)


def mesh_train_rank(rank, world, where, kind):
    """One rank of a mesh training world sharing the card (run in its own
    process by phase_mesh_train): "dm" runs (b), (c) and "b whole" on
    (data 2, model 2), rank 0 first running the one-rank baselines; "pod"
    runs (d). Rank 0 saves every rank's reports and its checks' numbers."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models.sharding import ShardingCtx, gather_params
    device = init_distributed(rank, world, f"file://{where}/{kind}.store",
                              local_world_size=world)
    batch, seq = MESH_TRAIN_CUT
    reports, out = [], {"backend": dist.get_backend(), "seconds": {}}
    clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        out["seconds"][name] = now - clock
        clock = now

    try:
        if kind == "dm":
            base = {}
            if rank == 0:
                base["b"] = mesh_train_baseline(MESH_TRAIN_ARCH, device,
                                                MESH_TRAIN_STEPS, batch, seq)
                base["c"] = mesh_train_baseline(MESH_MOE_ARCH, device,
                                                MESH_MOE_STEPS, batch, seq,
                                                moe_groups=2)
                out["base"] = {k: {key: v[key] for key in
                                   ("loss", "grad_norm", "aux")}
                               for k, v in base.items()}
            lap("one-rank baselines")
            mesh = make_local_mesh(2, 2)
            for run, arch, steps in (("b", MESH_TRAIN_ARCH,
                                      MESH_TRAIN_STEPS),
                                     ("c", MESH_MOE_ARCH, MESH_MOE_STEPS)):
                mesh_train_zero()
                stats = {}
                with recorded_routes() as routes:
                    state, _ = train_cli.train(
                        arch, reduced=False, steps=steps, batch=batch,
                        seq=seq, mesh=mesh, device=device,
                        log_fn=lambda *_: None, stats=stats)
                params = state["params"]
                numel = sum(p.numel() for p in params.values())
                reports.append(mesh_train_report(run, device, stats, steps,
                                                 numel))
                lap(f"({run}) train")
                model_ctx = train_cli.make_train_ctx(mesh)
                layouts = {n: p._layout for n, p in params.items()}
                if run == "b":
                    whole = gather_params(
                        {n: p for n, p in params.items() if mesh_gathered(n)},
                        layouts, model_ctx)
                else:
                    first = [r for r, _ in routes][
                        :get_config(arch).num_layers]
                    whole = [model_ctx.gather(r, batch, model_ctx.dp)
                             for r in first]
                    # tp peers route their data rank's tokens alike
                    peers = [None] * world
                    dist.all_gather_object(peers, [r.numpy() for r in
                                                   first])
                    out["tp_peers_alike"] = all(
                        all((a == b).all() for a, b in zip(peers[2 * d],
                                                           peers[2 * d + 1]))
                        for d in range(2))
                del state, params
                if rank == 0:
                    out[run] = {k: stats[k] for k in ("loss", "grad_norm",
                                                      "aux")}
                    if run == "b":
                        out["b"]["params"] = mesh_params_check(
                            whole, base["b"], steps)
                    else:
                        out["c"]["routes"] = mesh_route_check(whole,
                                                              base["c"])
                del whole
                lap(f"({run}) gather and check")
            # (b) with the hidden state whole on every model rank
            mesh_train_zero()
            stats, numel, _ = mesh_train_steps(
                train_cli.make_train_ctx(mesh, seq_parallel=False), device,
                batch, seq, MESH_WHOLE_STEPS)
            reports.append(mesh_train_report("b whole", device, stats,
                                             MESH_WHOLE_STEPS, numel))
            out["b whole"] = {k: stats[k] for k in ("loss", "grad_norm")}
            lap("(b whole) build and train")
        else:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cuda", (2, 1, 1),
                                    mesh_dim_names=("pod", "data", "model"))
            ctx = ShardingCtx(mesh=mesh, dp=("pod", "data"), tp="model",
                              fsdp=("data",))
            mesh_train_zero()
            stats, numel, out["leaves"] = mesh_train_steps(
                ctx, device, batch, seq, MESH_TRAIN_STEPS,
                compress_pod_reduce=True)
            reports.append(mesh_train_report("d", device, stats,
                                             MESH_TRAIN_STEPS, numel))
            reports[-1]["state_numel"] = numel
            out["d"] = {k: stats[k] for k in ("loss", "grad_norm")}
            lap("(d) build and train")
        every = [None] * world
        dist.all_gather_object(every, reports)
        if rank == 0:
            out["reports"] = every
            torch.save(out, Path(where) / f"{kind}.pt")
    finally:
        dist.destroy_process_group()


def mesh_train_spawn(where, kind, world, rank_fn="mesh_train_rank",
                     timeout_s=None):
    """``world`` processes of ``rank_fn`` (mesh_train_rank, or
    mesh_serve_rank; each one's output in a file under ``where``); rank
    0's results. A rank that fails stops the others at once."""
    import torch
    cmd = "import sys; sys.path.insert(0, {!r}); import chip_smoke; " \
          "chip_smoke." + rank_fn + "({}, {}, {!r}, {!r})"
    logs = [Path(where) / f"{kind}.rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     cmd.format(str(ROOT), r, world, where, kind)],
                    stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + (timeout_s or MESH_TRAIN_TIMEOUT_S)
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"mesh {kind}: rank {r} of {world} exited "
                 f"{p.returncode}:\n{logs[r].read_text()[-3000:]}")
    return torch.load(Path(where) / f"{kind}.pt", weights_only=False)


def mesh_rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def say_mesh_report(rep, card):
    c = rep["collectives_per_step"]
    say(f"mesh train: ({rep['run']}) rank on {rep['device']}: step "
        f"{rep['step_ms']:.3f} ms (median of steps 2-N; the first "
        f"{rep['step_ms_first']:.3f}), peak device memory "
        f"{rep['peak_bytes']} B, parameter + moment blocks "
        f"{rep['param_and_moment_bytes']} B, flash forward / backward "
        f"launches {rep['flash_launches'][0]} / {rep['flash_launches'][1]}, "
        f"collectives a step " + json.dumps(
            {a: {k: round(v, 1) if not isinstance(v, dict) else v
                 for k, v in x.items()} for a, x in c.items()})
        + f"; card: {card}")


def say_seq_parallel(reports, card):
    """Each rank's (b) (sequence-parallel) beside "b whole" (the hidden
    state whole on every model rank) at the same shape: peak memory,
    model-axis collectives a step and step time."""
    for rep in reports:
        by = {r["run"]: r for r in rep}
        sp, whole = by["b"], by["b whole"]
        on = [r["collectives_per_step"]["model"] for r in (sp, whole)]
        say(f"mesh train: sequence parallelism on rank {rep[0]['device']} "
            f"at (b)'s shape, (b) / b whole: peak device memory "
            f"{sp['peak_bytes']} / {whole['peak_bytes']} B; model-axis "
            f"collective bytes a step {on[0]['bytes']:.0f} / "
            f"{on[1]['bytes']:.0f} (by kind {json.dumps(on[0]['op_bytes'])} "
            f"/ {json.dumps(on[1]['op_bytes'])}); step {sp['step_ms']:.3f} / "
            f"{whole['step_ms']:.3f} ms ((b): the median of steps 2-N; b "
            f"whole: its one step, after (b) and (c) on the same ranks); "
            f"card: {card}")


def seq_parallel_errors(reports):
    """(b) and (c) gather and reduce-scatter along the sequence over
    model on every rank; "b whole" sums its activations by all-reduce, more
    bytes of it than (b)."""
    errors = []
    for rep in reports:
        by = {r["run"]: r["collectives_per_step"]["model"] for r in rep}
        dev = rep[0]["device"]
        for run in ("b", "c"):
            if not all(by[run]["ops"].get(op) for op in ("all_gather",
                                                         "reduce_scatter")):
                errors.append(f"({run}) on {dev}: no all-gather and "
                              f"reduce-scatter over model")
        if not (by["b whole"]["op_bytes"].get("all_reduce_sum", 0)
                > by["b"]["op_bytes"].get("all_reduce_sum", 0)):
            errors.append(f"(b whole) on {dev}: model-axis all-reduce "
                          f"bytes not above (b)'s")
    return errors


def phase_mesh_train(device, card):
    """train(mesh=) on the card: (a) tinyllama-1.1b at 4 x 2048 on a
    one-rank NCCL mesh, bit-equal to the unsharded train; (b), (c) on
    MESH_TRAIN_RANKS gloo ranks (sequence-parallel), and (b)'s first step
    with the hidden state whole ("b whole"), (d) on MESH_POD_RANKS with
    the compressed pod reduce, against one rank. Returns the flash
    launches by run."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    t_phase = time.perf_counter()
    batch, seq = MESH_TRAIN_ONE
    layers = get_config(MESH_TRAIN_ARCH).num_layers
    runs, launches = [], {}
    with tempfile.TemporaryDirectory() as where:
        for mesh_run in (False, True):
            mesh_train_zero()
            if mesh_run:
                init_distributed(0, 1, f"file://{where}/one.store",
                                 local_world_size=1)
            try:
                if mesh_run and dist.get_backend() != "nccl":
                    fail(f"mesh train: a one-rank mesh on the card runs on "
                         f"{dist.get_backend()}, not NCCL")
                stats = {}
                state, _ = train_cli.train(
                    MESH_TRAIN_ARCH, reduced=False, steps=MESH_TRAIN_STEPS,
                    batch=batch, seq=seq, device=device,
                    mesh=make_local_mesh(1, 1) if mesh_run else None,
                    log_fn=lambda *_: None, stats=stats)
                params = {n: p.detach().cpu()
                          for n, p in state["params"].items()}
                rep = mesh_train_report(
                    "a" if mesh_run else "a unsharded", device, stats,
                    MESH_TRAIN_STEPS, sum(p.numel() for p in params.values()))
                del state
            finally:
                if mesh_run:
                    dist.destroy_process_group()
            runs.append((stats, params, rep))
            expect = [layers * MESH_TRAIN_STEPS] * 2
            if rep["flash_launches"] != expect:
                fail(f"mesh train (a): flash launches "
                     f"{rep['flash_launches']}, expected {expect}")
        (s1, p1, r1), (s2, p2, r2) = runs
        if not (s1["loss"] == s2["loss"]
                and s1["grad_norm"] == s2["grad_norm"]
                and all(torch.equal(p1[n], p2[n]) for n in p1)):
            fail(f"mesh train (a): the one-rank NCCL mesh differs from the "
                 f"unsharded train (losses {s2['loss']} vs {s1['loss']}, "
                 f"grad norms {s2['grad_norm']} vs {s1['grad_norm']})")
        del runs, p1, p2
        say(f"mesh train: (a) {MESH_TRAIN_ARCH} {batch} x {seq}, "
            f"{MESH_TRAIN_STEPS} steps, one-rank NCCL mesh: losses "
            f"{s2['loss']}, grad norms {s2['grad_norm']} and parameters "
            f"bit-equal to the unsharded train; card: {card}")
        for rep in (r1, r2):
            say_mesh_report(rep, card)
        launches["a"] = r2["flash_launches"]
        launches["a unsharded"] = r1["flash_launches"]
        torch.cuda.empty_cache()
        a_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        dm = mesh_train_spawn(where, "dm", MESH_TRAIN_RANKS)
        dm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pod = mesh_train_spawn(where, "pod", MESH_POD_RANKS)
        pod_s = time.perf_counter() - t0
    batch, seq = MESH_TRAIN_CUT
    for got, ranks in ((dm, MESH_TRAIN_RANKS), (pod, MESH_POD_RANKS)):
        if got["backend"] != "gloo":
            fail(f"mesh train: {ranks} ranks sharing the card ran on "
                 f"{got['backend']}, not gloo")
    base = dm["base"]
    b, c, d, whole = dm["b"], dm["c"], pod["d"], dm["b whole"]
    routes = c["routes"]
    exact = base["b"]["loss"][-1]
    gap = abs(d["loss"][-1] - exact) / exact
    pod_reports = pod["reports"]
    wire = pod_reports[0][0]["collectives_per_step"]["pod"]
    f32 = 2 * 4 * pod_reports[0][0]["state_numel"]
    exact_drop = base["b"]["loss"][0] - exact
    comp_drop = d["loss"][0] - d["loss"][-1]
    say(f"mesh train: (b) {MESH_TRAIN_ARCH} {batch} x {seq}, "
        f"{MESH_TRAIN_STEPS} steps on {MESH_TRAIN_RANKS} gloo ranks "
        f"(data 2, model 2): losses {b['loss']} (one rank "
        f"{base['b']['loss']}, largest rel "
        f"{mesh_rel(b['loss'], base['b']['loss']):.3e}), grad norms "
        f"{b['grad_norm']} (one rank {base['b']['grad_norm']}, "
        f"{mesh_rel(b['grad_norm'], base['b']['grad_norm']):.3e}); gathered "
        f"parameters (held share, largest difference) {b['params']}; "
        f"card: {card}")
    say(f"mesh train: (b whole) (b)'s first {MESH_WHOLE_STEPS} step(s) on "
        f"the same ranks with make_train_ctx(mesh, seq_parallel=False): "
        f"losses {whole['loss']}, grad norms {whole['grad_norm']} "
        f"(sequence-parallel (b): largest rel "
        f"{mesh_rel(whole['loss'], b['loss']):.3e} and "
        f"{mesh_rel(whole['grad_norm'], b['grad_norm']):.3e}); card: {card}")
    say(f"mesh train: (c) {MESH_MOE_ARCH} {batch} x {seq}, {MESH_MOE_STEPS} "
        f"steps on the same ranks (16 experts a tp rank): step 1's routes "
        f"against one rank with num_groups=2 {json.dumps(routes)} "
        f"(tokens held: one-rank top-k margin >= {MESH_ROUTE_MARGIN}); "
        f"losses {c['loss']} (one rank {base['c']['loss']}; step 1 "
        f"{mesh_rel(c['loss'][:1], base['c']['loss'][:1]):.3e}, all "
        f"{mesh_rel(c['loss'], base['c']['loss']):.3e}), aux {c['aux']} "
        f"(one rank {base['c']['aux']}; step 1 "
        f"{mesh_rel(c['aux'][:1], base['c']['aux'][:1]):.3e}, all "
        f"{mesh_rel(c['aux'], base['c']['aux']):.3e}), grad norms "
        f"{c['grad_norm']} (one rank {base['c']['grad_norm']}; step 1 "
        f"{mesh_rel(c['grad_norm'][:1], base['c']['grad_norm'][:1]):.3e}, "
        f"all {mesh_rel(c['grad_norm'], base['c']['grad_norm']):.3e}); "
        f"card: {card}")
    say(f"mesh train: (d) {MESH_TRAIN_ARCH} {batch} x {seq}, "
        f"{MESH_TRAIN_STEPS} steps on {MESH_POD_RANKS} gloo ranks (pod 2, "
        f"data 1, model 1), compress_pod_reduce=True: losses {d['loss']}, "
        f"the last {gap:.4%} from the exact run's {exact} (the exact "
        f"run's loss moved {exact_drop:.6f} = {exact_drop / exact:.4%} "
        f"over the steps, the compressed run's {comp_drop:.6f}: "
        f"{abs(comp_drop - exact_drop) / exact_drop:.4%} apart); pod axis "
        f"{wire['bytes']:.0f} B a step ({wire['ops']}), a float32 gather "
        f"of the same blocks {f32} B: {wire['bytes'] / f32:.4f} of it; "
        f"card: {card}")
    for rep in dm["reports"] + pod["reports"]:
        for r in rep:
            say_mesh_report(r, card)
            launches.setdefault(r["run"], []).append(r["flash_launches"])
    say_seq_parallel(dm["reports"], card)
    say(f"mesh train: phase {time.perf_counter() - t_phase:.1f} s ((a) "
        f"{a_s:.1f} s, 4-rank world {dm_s:.1f} s, 2-rank world {pod_s:.1f} "
        f"s); rank 0's seconds {json.dumps(dm['seconds'])} "
        f"{json.dumps(pod['seconds'])}; card: {card}")
    errors = []
    for key in ("loss", "grad_norm"):
        if mesh_rel(b[key], base["b"][key]) > MESH_TRAIN_RTOL:
            errors.append(f"(b) {key} off one rank's")
    if isinstance(b["params"], str):
        errors.append(f"(b) parameters: {b['params']}")
    for key in ("loss", "grad_norm"):
        if mesh_rel(whole[key], b[key]) > MESH_TRAIN_RTOL:
            errors.append(f"(b whole) {key} off (b)'s")
    errors += seq_parallel_errors(dm["reports"])
    if (routes["differ_held"] or not dm["tp_peers_alike"]
            or routes["calls"] != routes["calls_one_rank"]):
        errors.append("(c) routes differ from one rank's where its margin "
                      "holds, or between tp peers")
    for key in ("loss", "aux", "grad_norm"):
        # the step whose routes are held (its grad norm is the backward
        # before any update); a route that flips below the margin moves
        # the later steps' parameters
        if mesh_rel(c[key][:1], base["c"][key][:1]) > MESH_TRAIN_RTOL:
            errors.append(f"(c) step 1's {key} off one rank's")
    if gap >= MESH_COMPRESS_TOL or not all(
            map(math.isfinite, d["loss"] + d["grad_norm"])):
        errors.append("(d) the compressed loss is off the exact run's")
    if abs(comp_drop - exact_drop) > MESH_COMPRESS_DROP_TOL * exact_drop:
        errors.append("(d) the compressed run's loss moved "
                      f"{comp_drop}, the exact run's {exact_drop}")
    leaves = pod["leaves"]
    for rep in pod["reports"]:
        w = rep[0]["collectives_per_step"]["pod"]
        if w["ops"] != {"all_gather": 2 * leaves, "all_reduce_sum": 2}:
            errors.append(f"(d) pod axis calls a step {w['ops']}, not 2 "
                          f"int8 all-gathers a leaf ({leaves} leaves), "
                          f"the metrics' and the grad norm's sums")
        if abs(w["bytes"] / f32 - 0.25) > MESH_COMPRESS_BYTES_TOL:
            errors.append(f"(d) pod axis bytes {w['bytes'] / f32:.4f} "
                          "of a float32 gather's, not int8's 0.25")
    layers_moe = get_config(MESH_MOE_ARCH).num_layers
    for rep in dm["reports"] + pod["reports"]:
        for r in rep:
            steps = {"c": MESH_MOE_STEPS, "b whole": MESH_WHOLE_STEPS}.get(
                r["run"], MESH_TRAIN_STEPS)
            nl = layers_moe if r["run"] == "c" else layers
            if r["flash_launches"] != [nl * steps] * 2:
                errors.append(f"({r['run']}) flash launches "
                              f"{r['flash_launches']} on {r['device']}")
            for axis, cnt in r["collectives_per_step"].items():
                if not cnt["calls"] or cnt["staged_calls"] != cnt["calls"]:
                    errors.append(f"({r['run']}) axis {axis}: not every "
                                  f"call staged through the host on gloo")
    if errors:
        fail("mesh train: " + "; ".join(errors))
    return launches


@contextlib.contextmanager
def recorded_logits():
    """Every greedy step's logits under it (``train.serve_step.greedy``'s
    input: this rank's rows and vocab block, kept on the device), and the
    collective counts after the first (the prefill's)."""
    import copy
    from repro_torch.core import collectives
    from repro_torch.train import serve_step
    seen, at_prefill = [], {}
    greedy = serve_step.greedy

    def record(model, logits):
        out = greedy(model, logits)
        seen.append(logits.clone())
        if len(seen) == 1:
            at_prefill.update(copy.deepcopy(collectives.counts))
        return out

    serve_step.greedy = record
    try:
        yield seen, at_prefill
    finally:
        serve_step.greedy = greedy


def mesh_serve_run(device, mesh, batch, prompt, gen):
    """``launch.serve.serve`` of MESH_SERVE_ARCH at its published widths
    (over ``mesh`` where given, this process one rank), the flash launches
    and the collective counts zeroed just before: its tokens and every
    step's logits (on the CPU), CUDA-event times, peak memory, cache bytes,
    flash launches and the collectives of the prefill and of a decode
    step, by axis."""
    import torch
    from repro_torch.core import collectives
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import serve as serve_cli
    collectives.reset_counts()
    attn_ops.launches = 0
    torch.cuda.empty_cache()
    stats = {}
    with recorded_logits() as (seen, at_prefill):
        toks = serve_cli.serve(MESH_SERVE_ARCH, reduced=False, batch=batch,
                               prompt_len=prompt, gen=gen, device=device,
                               mesh=mesh, log_fn=lambda *_: None,
                               stats=stats)
        logits = [x.cpu() for x in seen]
    keys = ("calls", "bytes", "staged_calls")
    decode = {axis: {k: (c[k] - at_prefill.get(axis, {}).get(k, 0))
                     / (gen - 1) for k in keys}
              for axis, c in collectives.counts.items()}
    torch.cuda.empty_cache()
    return {"tokens": toks, "logits": logits, "device": str(device),
            "flash_launches": attn_ops.launches,
            "prefill_ms": stats["prefill_ms"],
            "decode_ms_per_token": stats["decode_ms_per_token"],
            "peak_bytes": stats["peak_bytes"],
            "cache_bytes": stats["cache_bytes"],
            "logits_finite": stats["logits_finite"],
            "collectives_prefill": {a: {k: c[k] for k in keys}
                                    for a, c in at_prefill.items()},
            "collectives_per_decode_step": decode}


def mesh_serve_check(run, base, coord):
    """A (b) rank's run against the one-rank run ``base``: whether its
    tokens are its rows of base's, whether every step's logits (its rows
    and vocab block) are within MODEL_TOL of base's, and the largest
    difference."""
    import torch
    from repro_torch.configs import get_config
    b = MESH_SERVE_CUT[0]
    vp = get_config(MESH_SERVE_ARCH).padded_vocab
    d, m = coord
    rows = slice(d * b // 2, (d + 1) * b // 2)
    lo = sum(vp // 2 + (i < vp % 2) for i in range(m))
    rtol, atol = MODEL_TOL
    close, worst = len(run["logits"]) == len(base["logits"]), 0.0
    for x, y in zip(run["logits"], base["logits"]):
        y = y[rows, lo:lo + x.shape[1]]
        worst = max(worst, float((x - y).abs().max()))
        close &= torch.allclose(x, y, rtol=rtol, atol=atol)
    return {"tokens_equal": torch.equal(run["tokens"],
                                        base["tokens"][rows]),
            "logits_close": close, "max_abs_diff": worst}


def mesh_serve_rank(rank, world, where, kind):
    """One rank of (b) (run in its own process by phase_mesh_serve): serve
    over (data 2, model 2) on the card shared over gloo, checked here
    against the one-rank run the phase saved; rank 0 saves every rank's
    report."""
    import torch.distributed as dist
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    device = init_distributed(rank, world, f"file://{where}/{kind}.store",
                              local_world_size=world)
    try:
        t0 = time.perf_counter()
        mesh = make_local_mesh(2, 2)
        run = mesh_serve_run(device, mesh, *MESH_SERVE_CUT)
        run["coord"] = [int(c) for c in mesh.get_coordinate()]
        run["seconds"] = time.perf_counter() - t0
        run["backend"] = dist.get_backend()
        run["steps"] = len(run["logits"])
        run.update(mesh_serve_check(run, torch.load(
            Path(where) / f"{kind}.base.pt"), run["coord"]))
        del run["tokens"], run["logits"]
        every = [None] * world
        dist.all_gather_object(every, run)
        if rank == 0:
            torch.save(every, Path(where) / f"{kind}.pt")
    finally:
        dist.destroy_process_group()


def say_serve_report(label, run, card, one=None):
    """One serving run's numbers on this rank (with the one-rank run's
    cache bytes beside its own)."""
    cache = f"cache {run['cache_bytes']} B"
    if one is not None:
        cache += (f" (the one-rank cache {one['cache_bytes']} B: "
                  f"{run['cache_bytes'] / one['cache_bytes']:.4f} of it)")
    say(f"mesh serve: {label} on {run['device']}: prefill "
        f"{run['prefill_ms']:.3f} ms, decode "
        f"{run['decode_ms_per_token']:.3f} ms/token (CUDA events), flash "
        f"launches {run['flash_launches']}, peak device memory "
        f"{run['peak_bytes']} B, {cache}; collectives of the prefill "
        + json.dumps(run["collectives_prefill"]) + ", a decode step "
        + json.dumps({a: {k: round(v, 1) for k, v in c.items()}
                      for a, c in run["collectives_per_decode_step"].items()})
        + f"; card: {card}")


def phase_mesh_serve(device, card):
    """serve(mesh=) on the card: (a) one NCCL rank against the unsharded
    serve, (b) MESH_SERVE_RANKS gloo ranks against one rank. Returns the
    flash launches by run."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    t_phase = time.perf_counter()
    cfg = get_config(MESH_SERVE_ARCH)
    layers = cfg.num_layers
    runs, launches = [], {}
    with tempfile.TemporaryDirectory() as where:
        for mesh_run in (False, True):
            if mesh_run:
                init_distributed(0, 1, f"file://{where}/serve_one.store",
                                 local_world_size=1)
            try:
                if mesh_run and dist.get_backend() != "nccl":
                    fail(f"mesh serve: a one-rank mesh on the card runs on "
                         f"{dist.get_backend()}, not NCCL")
                runs.append(mesh_serve_run(
                    device, make_local_mesh(1, 1) if mesh_run else None,
                    *MESH_SERVE_ONE))
            finally:
                if mesh_run:
                    dist.destroy_process_group()
        plain, one = runs
        b, p, g = MESH_SERVE_ONE
        if not (torch.equal(plain["tokens"], one["tokens"])
                and len(plain["logits"]) == len(one["logits"]) == g
                and all(torch.equal(x, y) for x, y in
                        zip(plain["logits"], one["logits"]))):
            fail("mesh serve (a): the one-rank NCCL mesh's tokens or logits "
                 "differ from the unsharded serve's")
        for r in runs:
            if r["flash_launches"] != layers or not r["logits_finite"]:
                fail(f"mesh serve (a): flash launches "
                     f"{r['flash_launches']}, expected {layers}; logits "
                     f"finite {r['logits_finite']}")
        say(f"mesh serve: (a) {MESH_SERVE_ARCH} {b} x {p}, {g} tokens, "
            f"one-rank NCCL mesh: tokens and every step's logits bit-equal "
            f"to the unsharded serve; card: {card}")
        say_serve_report("(a) unsharded", plain, card)
        say_serve_report("(a) one-rank NCCL mesh", one, card, plain)
        launches["(a) unsharded"] = plain["flash_launches"]
        launches["(a) one-rank NCCL mesh"] = one["flash_launches"]
        del runs, plain, one
        a_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        base = mesh_serve_run(device, None, *MESH_SERVE_CUT)
        torch.save({k: base[k] for k in ("tokens", "logits")},
                   Path(where) / "serve.base.pt")
        base_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = mesh_train_spawn(where, "serve", MESH_SERVE_RANKS,
                                 "mesh_serve_rank", MESH_SERVE_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
    b, p, g = MESH_SERVE_CUT
    errors = []
    rtol, atol = MODEL_TOL
    worst = max(run["max_abs_diff"] for run in ranks)
    for r, run in enumerate(ranks):
        if run["backend"] != "gloo":
            errors.append(f"rank {r} ran on {run['backend']}, not gloo")
        if not run["tokens_equal"]:
            errors.append(f"rank {r}'s tokens differ from one rank's")
        if not run["logits_close"]:
            errors.append(f"rank {r}'s logits off one rank's")
        if run["steps"] != g:
            errors.append(f"rank {r}: {run['steps']} steps")
        if run["flash_launches"] != layers or not run["logits_finite"]:
            errors.append(f"rank {r}: flash launches "
                          f"{run['flash_launches']}, expected {layers}")
        for axis, c in run["collectives_per_decode_step"].items():
            if c["staged_calls"] != c["calls"]:
                errors.append(f"rank {r} axis {axis}: not every call staged "
                              f"through the host on gloo")
        launches[f"(b) rank {r}"] = run["flash_launches"]
    say(f"mesh serve: (b) {MESH_SERVE_ARCH} {b} x {p}, {g} tokens on "
        f"{MESH_SERVE_RANKS} gloo ranks (data 2, model 2): every rank's "
        f"tokens one rank's rows, its logits (its rows and vocab block) "
        f"within {rtol} / {atol} of one rank's (largest difference "
        f"{worst:.3e}); card: {card}")
    say_serve_report("(b) one rank", base, card)
    for r, run in enumerate(ranks):
        say_serve_report(f"(b) rank {r} {tuple(run['coord'])}", run, card,
                         base)
    say(f"mesh serve: phase {time.perf_counter() - t_phase:.1f} s ((a) "
        f"{a_s:.1f} s, (b)'s one rank {base_s:.1f} s, its {MESH_SERVE_RANKS}"
        f"-rank world {ranks_s:.1f} s; rank 0's own "
        f"{ranks[0]['seconds']:.1f} s); card: {card}")
    if errors:
        fail("mesh serve: " + "; ".join(errors))
    return launches


def variation_bound(args, card, label="fused_variation"):
    """(bound ms, "bytes" or "operations") of one fused variation launch
    on ``args``: every input read once (the parents, each uniform array
    as it is given: shared across runs, read once; the hyperparameter
    rows, the bounds) and the offspring written once at the memory rate,
    or the float32 operations these inputs need (OPS_*, each powf one
    operation; per-run probabilities where the rows are per run) at the
    float32 rate, whichever is longer."""
    parents, rnd, scalars, lo, hi = args
    g = parents.shape[-1]
    rows = parents.numel() // g
    mem_rate, f32_rate = peaks(card)[:2]
    nbytes = 4 * (2 * parents.numel() + sum(v.numel() for v in rnd.values())
                  + scalars.numel() + lo.numel() + hi.numel())
    sc = (scalars if scalars.dim() == 1
          else scalars.reshape(scalars.shape[:-1] + (1, 1, 5)))
    prob_cx, prob_mut, indpb = (sc[..., k] for k in (1, 3, 4))
    n_cx = int(((rnd["m_pair"] < prob_cx) & (rnd["m_gene"] < 0.5)).sum())
    n_mut = int(((rnd["m_ind"] < prob_mut) & (rnd["m_genem"] < indpb)).sum())
    nops = (OPS_PAIR_GENE * (rows // 2) * g + OPS_CROSSOVER * n_cx
            + OPS_MUTATION * n_mut)
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
    say(f"times: {label} bound: {nbytes} bytes at {mem_rate:.3g} "
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
    read just after: exactly one launch a generation (the initial evaluation
    launches none), finite fitness, genomes in [-1, 1]."""
    import torch
    from repro_torch.kernels.genetic import ops
    from repro_torch.launch import ga_run
    runs = {}
    for name, (extra, epochs, per_epoch) in HVDC_RUNS.items():
        gens = per_epoch * epochs
        extra = extra + ["--gens-per-epoch", str(per_epoch)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.launches = 0
        t0 = time.perf_counter()
        pop, hist = ga_run.main(HVDC_ARGS + extra + ["--epochs", str(epochs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches
        peak = torch.cuda.max_memory_allocated()
        i, p, g = pop.genomes.shape
        evals = i * p * (1 + gens)
        contingencies = int(extra[extra.index("--contingencies") + 1]) \
            if "--contingencies" in extra else 0
        say(f"main: ga_run hvdc {name} {' '.join(extra)} --epochs {epochs}: "
            f"{wall:.3f} s wall "
            f"(set-up included), fused_variation launches {launches}, "
            f"{evals} evaluations, peak memory {peak} B")
        if launches != gens:
            fail(f"fused_variation launched {launches} times in ga_run hvdc "
                 f"{name}, expected {gens}")
        if g != HVDC_GENES or len(hist) != epochs or \
                not bool(torch.isfinite(pop.fitness).all()) or \
                not all(math.isfinite(h["best"]) for h in hist):
            fail(f"ga_run hvdc {name}: genes {g}, {len(hist)} epochs, "
                 f"fitness finite {bool(torch.isfinite(pop.fitness).all())}")
        if not bool((pop.genomes.abs() <= 1.0).all()):
            fail(f"ga_run hvdc {name}: genomes outside [-1, 1]")
        if any(h["balanced"] != 1.0 for h in hist):
            fail(f"ga_run hvdc {name}: balanced dispatch did not engage")
        runs[name] = dict(pop=pop, launches=launches, wall_s=wall,
                          epochs=epochs, gens_per_epoch=per_epoch,
                          evaluations=evals,
                          contingencies=contingencies,
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
    for name in HVDC_RUNS:
        pop = runs[name]["pop"]
        i, p, g = pop.genomes.shape
        ns = argparse.Namespace(
            grid_size=HVDC_BUSES, hvdc_lines=HVDC_GENES, pop=p, islands=i,
            gens_per_epoch=runs[name]["gens_per_epoch"],
            epochs=runs[name]["epochs"],
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
    mem_rate, f32_rate = peaks(card)[:2]
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
                          best_fitness=hist[-1]["best"],
                          hist_best=[h["best"] for h in hist])
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
    mem_rate, f32_rate = peaks(card)[:2]
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
    from repro_torch.core.broker import Broker, CostEMA, HostPoolBackend
    from repro_torch.fitness import hostsim
    n, w, slow_s = (EMA_DISPATCH[k] for k in ("n", "w", "slow_s"))
    het_g, fast_g = ema_batches(device)
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
    runs = {}
    for name, extra in QUEUE_RUNS.items():
        epochs = QUEUE_EPOCHS.get(name, MAIN["epochs"])
        expect = MAIN["gens_per_epoch"] * epochs
        evaluations = expect + 1             # the initial population too
        with tempfile.TemporaryDirectory() as root:
            argv = MAIN_ARGS + HOST_ARGS + extra + ["--epochs", str(epochs)]
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
            host = host_runs["host-thread"]
            if epochs != MAIN["epochs"]:
                if hist[-1]["best"] != host["hist_best"][epochs - 1]:
                    fail(f"ga_run {name}: best fitness after {epochs} "
                         f"epoch(s) {hist[-1]['best']!r}, host-thread's "
                         f"{host['hist_best'][epochs - 1]!r}")
            elif not torch.equal(best, host["best"]):
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
        f"host-thread's (cut to fewer epochs {QUEUE_EPOCHS}: the best "
        f"fitness, host-thread's after as many); stored fitness "
        f"hostsim.rastrigin bit for bit; brokers clean")
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
    """q, k, v of ``case``; the keys' length ``t``, or the case's tenth
    entry, or S."""
    import torch
    b, s, h, kv, hd = case[:5]
    dtype = getattr(torch, case[8])
    t = t if t is not None else case[9] if len(case) > 9 else s
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


def attn_kwargs(case, q_offset=0):
    hd, causal, window, cap = case[4:8]
    return dict(scale=hd ** -0.5, causal=causal, window=window,
                attn_softcap=cap, q_offset=q_offset)


def fwd_close(out, ref):
    """(all close, max abs error) of a flash forward's output against its
    plain version's: float32 at ATTN_TOL, bf16 at one rounding step (rtol
    2^-7, atol 2^-12 of the plain output's largest magnitude)."""
    if str(out.dtype) == "torch.float32":
        return close(out, ref, *ATTN_TOL["float32"])
    rtol, frac = GRAD_TOL["bfloat16"]
    return close(out.float(), ref.float(), rtol,
                 frac * float(ref.float().abs().max()))


def check_flash(case, device, seed, t=None, q_offset=0):
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    q, k, v = attn_tensors(case, device, seed, t)
    kw = attn_kwargs(case, q_offset)
    out = attn_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = attn_ops.flash_attention_plain(q, k, v, **kw)
    ok, err = fwd_close(out, ref)
    if not ok or out.dtype != q.dtype:
        fail(f"flash attention kernel disagrees with its plain version at "
             f"{case} q_offset={q_offset}: max abs err {err}")
    return err, out


def ssd_tensors(b, l, h, p, n, device, seed, mamba2=False):
    """x, dt, a, B, C. By default drawn as tests/test_kernels.py draws them
    (dt = softplus(z), a = -exp(0.3 z): ~-0.8 per step, so a 256-step
    chunk decays to 0 in float32); with ``mamba2``, in the range of
    Mamba-2's own initialisation (dt log-uniform in [1e-3, 1e-1],
    a = -U(1, 16), one head per 1/H stratum of the range and the first at
    its slow end, a = -1, so the slowest heads are always drawn whatever
    H), where the decay across a chunk and between chunks stays above 0
    on the heads of small |a|."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)
    x = rnd(b, l, h, p) * 0.5
    if mamba2:
        dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1), b, l, h))
        u = uniform(0.0, 1.0, h)
        u[0] = 0.0
        a = -(1.0 + 15.0 * (torch.arange(h, device=device) + u) / h)
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


def tensor_bound(flops, nbytes, card, tc_ms=None, tc_rates=None):
    """The least time of a kernel whose float32 products run as 3xTF32 on
    the tensor cores: the larger of its bytes over the memory rate and
    3 x its FLOP over the TF32 rate, or ``tc_ms`` (counted as
    ``tc_rates`` says) where the products' operands allow cheaper passes:
    the bf16 backward's (``flash_bwd_bound``). Also the bound at the
    float32 rate outside the tensor cores, for comparison with SIMT
    designs."""
    mem_rate, f32_rate, tf32_rate = peaks(card)[:3]
    bytes_ms = nbytes / mem_rate * 1e3
    if tc_ms is None:
        tc_ms = TF32_PRODUCTS * flops / tf32_rate * 1e3
        tc_rates = (f"{flops} FLOP x {TF32_PRODUCTS} at {tf32_rate:.3g} "
                    f"TF32 op/s")
    simt_ms = flops / f32_rate * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(bytes_ms, tc_ms),
            "bound_by": "bytes" if bytes_ms >= tc_ms else "operations",
            "simt_bound_ms": max(bytes_ms, simt_ms), "rates": (
                f"{tc_rates}, or at {f32_rate:.3g} float32 op/s; {nbytes} "
                f"bytes at {mem_rate:.3g} B/s")}


def flash_bound(case, card):
    """float32 multiply-adds over the visible (query, key) pairs (2 hd for
    Q K^T, 2 hd for P V, per query head), and q, k, v, out each moved
    once (``tensor_bound``); T keys (the case's tenth entry) or S."""
    b, s, h, kv, hd, causal, window = case[:7]
    t = case[9] if len(case) > 9 else s
    pairs = 0
    for pos in range(s):
        vis = pos + 1 if causal else t
        pairs += min(vis, window) if window else vis
    itemsize = 2 if case[8] == "bfloat16" else 4
    return tensor_bound(4 * hd * b * h * pairs,
                        itemsize * (2 * b * s * h * hd + 2 * b * t * kv * hd),
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
        f"{bnd['rates']}): {bnd['bound_ms'] / ms:.3f} of the tensor-core "
        f"bound, "
        f"{bnd['simt_bound_ms'] / ms:.3f} of the float32 SIMT bound "
        f"({bnd['simt_bound_ms']:.4f} ms)")


def sdpa_yardstick(q, k, v, scale, out, causal=True):
    """The fastest backend of F.scaled_dot_product_attention that computes
    this GQA case (causal or not, no softcap, no window; Sq may
    differ from T where it is not causal) on the kernel's
    own tensors, in SDPA's (B, H, S, hd) layout: (ms, backend). The flash
    backend refuses float32 (tried for bfloat16 only, with K and V
    repeated). MATH takes the KV heads as they are
    (enable_gqa); EFFICIENT_ATTENTION and CUDNN_ATTENTION refuse
    enable_gqa, so they get K and V with each KV head repeated for its G
    query heads (what enable_gqa means), built before the timed calls.
    Each backend's output is held against the kernel's ``out``. The port
    never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    g = qt.shape[1] // kt.shape[1]
    ke, ve = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    tries = [(SDPBackend.EFFICIENT_ATTENTION, ke, ve, False),
             (SDPBackend.CUDNN_ATTENTION, ke, ve, False),
             (SDPBackend.MATH, kt, vt, True)]
    if q.dtype == torch.bfloat16:
        tries.insert(0, (SDPBackend.FLASH_ATTENTION, ke, ve, False))
    best = None
    for backend, kb, vb, gqa in tries:
        def call(backend=backend, kb=kb, vb=vb, gqa=gqa):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kb, vb, is_causal=causal, enable_gqa=gqa,
                    scale=scale)
        try:
            with warnings.catch_warnings():   # the refusal's reasons
                warnings.simplefilter("ignore")
                got = call()
        except RuntimeError as err:
            say(f"times: scaled_dot_product_attention {backend.name}: "
                f"refused ({str(err).splitlines()[0][:120]})")
            continue
        err = float((got.transpose(1, 2) - out).float().abs().max())
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
    """q, k, v (``attn_tensors``) and an output gradient dO in their
    dtype."""
    import torch
    q, k, v = attn_tensors(case, device, seed, t)
    gen = torch.Generator(device=device).manual_seed(seed + 1000)
    return q, k, v, torch.randn(q.shape, generator=gen,
                                device=device).to(q.dtype)


def check_flash_bwd(case, device, seed, t=None, q_offset=0):
    """Autograd through the wrapper ``ops.flash_attention`` (forward kernel
    with its lse, backward kernel: one launch each) in the case's dtype
    against the plain backward (``flash_attention_bwd_plain``) on the same
    q, k, v, dO and the forward kernel's out and lse. The wrapper's output
    and the forward kernel's lse (``flash_attention_fwd_cuda(with_lse=
    True)``, what the backward reads) are held against the plain forward
    (``flash_attention_fwd_plain``), the output by ``fwd_close``, lse at
    ATTN_TOL in float32 and BF16_LSE_TOL in bf16, where two forward calls
    must also give the same bits; dq, dk, dv at GRAD_TOL of the dtype (in
    bf16 the atol a share of each gradient's largest magnitude): (max abs
    error of dq, dk, dv, (out max abs error, lse max relative error, share
    of the output bit-equal to the plain one), (dq, dk, dv), share of
    bit-equal gradient elements)."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.flash import flash_attention_fwd_cuda
    from repro_torch.kernels.attention.ref import (flash_attention_bwd_plain,
                                                   flash_attention_fwd_plain)
    q, k, v, do = grad_tensors(case, device, seed, t)
    kw = attn_kwargs(case, q_offset)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    before = (attn_ops.launches, attn_ops.bwd_launches)
    out = attn_ops.flash_attention(qg, kg, vg, **kw)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    launched = (attn_ops.launches - before[0],
                attn_ops.bwd_launches - before[1])
    fwd, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    if launched != (1, 1) or not torch.equal(fwd, out.detach()):
        fail(f"flash attention under autograd at {case}: launches "
             f"{launched}, expected (1, 1); output equal to the forward "
             f"kernel's {torch.equal(fwd, out.detach())}")
    p_out, p_lse = flash_attention_fwd_plain(q, k, v, **kw)
    ok_out, out_err = fwd_close(out.detach(), p_out)
    ok_lse, _ = close(lse, p_lse, *(ATTN_TOL["float32"] if case[8] ==
                                    "float32" else BF16_LSE_TOL))
    lse_err = float(((lse - p_lse).abs() / p_lse.abs().clamp_min(1.0)).max())
    out_same = float((out.detach() == p_out).float().mean())
    if case[8] == "bfloat16":
        again = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
        if not (torch.equal(again[0], fwd) and torch.equal(again[1], lse)):
            fail(f"the bf16 flash forward is not deterministic at {case}: "
                 f"a second call's out and lse differ from the first's")
        del again
    if not (ok_out and ok_lse):
        fail(f"flash attention forward kernel's output or lse (training "
             f"path) disagrees with its plain version at {case} "
             f"q_offset={q_offset}: out max abs err {out_err}, lse max rel "
             f"err {lse_err}")
    ref = flash_attention_bwd_plain(q, k, v, fwd, lse, do, **kw)
    rtol, atol = GRAD_TOL[case[8]]
    err, same, n = 0.0, 0, 0
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
        if case[8] == "bfloat16":
            atol = GRAD_TOL["bfloat16"][1] * float(b.float().abs().max())
        ok, e = close(a.float(), b.float(), rtol, atol)
        if not ok or a.dtype != q.dtype:
            fail(f"flash attention backward kernel's {name} disagrees with "
                 f"its plain version at {case} q_offset={q_offset}: max abs "
                 f"err {e} (rtol {rtol:.3g}, atol {atol:.3g}), dtype "
                 f"{a.dtype}")
        err = max(err, e)
        same += int((a == b).sum())
        n += a.numel()
    return err, (out_err, lse_err, out_same), grads, same / n


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
    with no scratch budget (float32: its key tiles in chunks of one; the
    bf16 backward keeps no scratch and takes no budget, so there it is the
    same path a third time): dq, dk, dv must equal ``grads`` bit for bit,
    or fail."""
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
    chunks = ("a call in one-key-tile chunks" if case[8] == "float32" else
              "a fourth with no scratch budget (no chunks in bf16)")
    say(f"check: flash attention backward {case}: three calls, and "
        f"{chunks}, give the same dq, dk, dv bit for bit")


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


def train_step_card_vs_cpu(arch, device, **model_kw):
    """One train step of reduced ``arch`` (``Model`` switches
    ``model_kw``) on the card (the flash kernels, forward and backward)
    against the same step on the CPU (their plain versions), from the same
    parameters, tokens and frontend embeddings
    (``train_step.reduced_train_step``): (loss rel err, grad norm rel err,
    max over leaves of max |dg| / max |g|)."""
    from repro_torch.train.train_step import reduced_train_step
    (ggpu, mgpu, _), (gcpu, mcpu, _) = (
        reduced_train_step(arch, dev, seq=128, **model_kw)
        for dev in (device, "cpu"))
    loss_err = abs(mgpu["loss"] - mcpu["loss"]) / abs(mcpu["loss"])
    norm_err = abs(mgpu["grad_norm"] - mcpu["grad_norm"]) / mcpu["grad_norm"]
    grad_err = max(float((ggpu[n] - g).abs().max() / g.abs().max())
                   for n, g in gcpu.items())
    if not (loss_err < 1e-4 and norm_err < 1e-4
            and grad_err < GRAD_TOL["float32"][0]):
        fail(f"a train step of reduced {arch} {model_kw} on the card "
             f"differs from the CPU's: loss {loss_err}, grad norm "
             f"{norm_err}, grads {grad_err} (relative)")
    return loss_err, norm_err, grad_err


def phase_check_train(device):
    """The backward kernel against its plain version, its bits over calls
    and chunkings, its memory at a long sequence, and one train step on the
    card against the CPU. Returns the largest error at the training path's
    shape."""
    import torch
    for i, case in enumerate(ATTN_CASES):
        if case[8] != "float32":
            continue                   # phase_check_bf16
        err, fwd, _, _ = check_flash_bwd(case, device, seed=i)
        say(f"check: flash attention backward {case}: max abs err "
            f"{err:.3g}; {fwd_errs(fwd)}")
    m = ATTN_MASKED
    err, fwd, (dq, dk, dv), _ = check_flash_bwd(
        m["case"], device, seed=7, t=m["t"], q_offset=m["q_offset"])
    if not bool((dq[:, m["first_masked"]:] == 0).all()):
        fail("flash attention backward: fully masked rows have a nonzero dq")
    say(f"check: flash attention backward q_offset {m['q_offset']} (rows "
        f">= {m['first_masked']} fully masked, zero dq): max abs err "
        f"{err:.3g}; {fwd_errs(fwd)}")
    main_err = 0.0
    for i, case in enumerate(BWD_MAIN):
        err, fwd, grads, _ = check_flash_bwd(case, device, seed=400 + i)
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
    head; q, k, v, out, dO read once and dq, dk, dv written once in the
    case's dtype, lse read once in float32 (``tensor_bound``); T keys (the
    case's tenth entry) or S. float32 products at float32 accuracy take
    3 TF32 passes each. In bf16 the reference widens and computes in
    float32: S^T = K Q^T and dP^T = V dO^T multiply two bf16 tensors, which
    is one bf16 product with float32 sums at the bf16 rate; dV, dK and dQ
    have a float32 operand (P or dS), bounded at the cheaper of its two
    float32-exact forms: 2 TF32 passes (hi and lo of the float32 operand,
    the bf16 one exact in TF32) or 3 bf16 passes (the float32 operand split
    into three bf16 planes, 24 significand bits)."""
    b, s, h, kv, hd = case[:5]
    t = case[9] if len(case) > 9 else s
    # flash_bound counts 2 products (4 hd FLOP) per pair and head
    flops = flash_bound(case, card)["flops"] * BWD_PRODUCTS // 2
    item = 2 if case[8] == "bfloat16" else 4
    nbytes = (item * (3 * b * s * h * hd + 2 * b * t * kv * hd
                      + b * s * h * hd + 2 * b * t * kv * hd)
              + 4 * b * s * h)
    if item == 4:
        return tensor_bound(flops, nbytes, card)
    raw = flops * 2 // BWD_PRODUCTS
    return bf16_bound(raw, flops - raw, nbytes, card)


def bf16_bound(raw, mixed, nbytes, card):
    """``tensor_bound`` of bf16 inputs computed in float32: ``raw`` FLOP
    of bf16 x bf16 products at the bf16 rate (exact in float32 sums),
    ``mixed`` FLOP with a float32 operand at the cheaper of its two
    float32-exact forms: 2 TF32 passes (hi and lo of the float32 operand,
    the bf16 one exact in TF32) or 3 bf16 passes (the float32 operand as
    three bf16 planes, 24 significand bits)."""
    _, _, tf32_rate, bf16_rate = peaks(card)
    mixed_s = mixed * min(2 / tf32_rate, 3 / bf16_rate)
    return tensor_bound(raw + mixed, nbytes, card,
                        tc_ms=(raw / bf16_rate + mixed_s) * 1e3,
                        tc_rates=(
                            f"{raw} FLOP bf16 x bf16 at {bf16_rate:.3g} "
                            f"op/s, {mixed} FLOP with a float32 "
                            f"operand at min(2 TF32 at {tf32_rate:.3g}, 3 "
                            f"bf16 at {bf16_rate:.3g}) passes"))


def flash_fwd_bf16_bound(case, card):
    """The bf16 forward with its lse output (the training path's call):
    Q K^T multiplies two bf16 tensors, P V a float32 P by bf16 V
    (``bf16_bound``), over ``flash_bound``'s pairs; q, k, v read and out
    written once in bf16, lse written in float32."""
    b, s, h, kv, hd = case[:5]
    t = case[9] if len(case) > 9 else s
    flops = flash_bound(case, card)["flops"]
    return bf16_bound(flops // 2, flops - flops // 2,
                      2 * (2 * b * s * h * hd + 2 * b * t * kv * hd)
                      + 4 * b * s * h, card)


def sdpa_bwd_yardstick(q, k, v, do, scale, dq, causal=True):
    """Autograd backward through the fastest backend of
    F.scaled_dot_product_attention that computes this GQA case (causal or
    not, no softcap, no window) in the tensors' dtype on the same tensors,
    in SDPA's (B, H, S, hd) layout, K and V repeated to H heads for the
    backends that refuse enable_gqa (MATH takes GQA as it is; FLASH_ATTENTION
    is tried for bfloat16 only, as it takes no float32). Only the backward
    is timed (``torch.autograd.grad`` on a kept graph). Each backend's dq
    is held against the kernel's. (ms, backend). The port never calls
    it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    dot = do.transpose(1, 2).contiguous()
    tries = [(SDPBackend.EFFICIENT_ATTENTION, False),
             (SDPBackend.CUDNN_ATTENTION, False), (SDPBackend.MATH, True)]
    if q.dtype == torch.bfloat16:
        tries.insert(0, (SDPBackend.FLASH_ATTENTION, False))
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
                    qt, kt, vt, is_causal=causal, enable_gqa=gqa,
                    scale=scale)
                got = torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
        except RuntimeError as err:
            say(f"times: scaled_dot_product_attention backward "
                f"{backend.name}: refused ({str(err).splitlines()[0][:120]})")
            continue
        err = float((got[0].transpose(1, 2) - dq).float().abs().max())
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


def phase_check_bf16(device):
    """The bf16 forward and backward kernels at every BF16 shape: the
    tests' bf16 case, tinyllama-1.1b's and gemma2-2b's, the trained
    families' in bf16, BF16_MASKED (rows that see no key 0) and BF16_HD32
    (``check_flash_bwd``: the forward's output at one rounding step, lse at
    BF16_LSE_TOL, two forward calls bit-equal; the gradients at one
    rounding step). Returns (largest gradient max abs error, {case:
    gradients' bit-equal share}, the forward's {"max_abs_err",
    "lse_max_rel_err", "out_bit_equal_share": {case: share}})."""
    import torch
    from repro_torch.kernels.attention.flash import flash_attention_fwd_cuda
    m = BF16_MASKED
    cases = ([(c, None, 0) for c in ATTN_CASES if c[8] == "bfloat16"]
             + [(BF16_TINYLLAMA, None, 0)] + [(c, None, 0) for c in BF16_GEMMA]
             + [(c[:8] + ("bfloat16",) + c[9:], None, 0)
                for c, _ in TRAIN_FAMILY_BWD.values()]
             + [(m["case"], m["t"], m["q_offset"]), (BF16_HD32, None, 0)])
    errs, shares = [], {}
    fwd = {"max_abs_err": 0.0, "lse_max_rel_err": 0.0,
           "out_bit_equal_share": {}}
    for i, (case, t, q_offset) in enumerate(cases):
        e, (out_err, lse_err, out_same), grads, share = check_flash_bwd(
            case, device, seed=700 + i, t=t, q_offset=q_offset)
        say(f"check: flash attention bf16 forward {case} q_offset "
            f"{q_offset}: out max abs err {out_err:.3g}, {out_same:.4f} "
            f"bit-equal to the plain version; lse max rel err "
            f"{lse_err:.3g}; two calls bit-equal")
        say(f"check: flash attention bf16 backward {case} q_offset "
            f"{q_offset}: max abs err {e:.3g}, {share:.4f} of dq, dk, dv "
            f"bit-equal to the plain version")
        if case in BF16_BITS:
            check_bwd_deterministic(case, device, seed=700 + i, grads=grads)
        errs.append(e)
        shares[str(case)] = share
        fwd["max_abs_err"] = max(fwd["max_abs_err"], out_err)
        fwd["lse_max_rel_err"] = max(fwd["lse_max_rel_err"], lse_err)
        fwd["out_bit_equal_share"][str(case)] = out_same
        del grads
        torch.cuda.empty_cache()
    q, k, v = attn_tensors(m["case"], device, 7, m["t"])
    out = flash_attention_fwd_cuda(q, k, v, **attn_kwargs(m["case"],
                                                          m["q_offset"]))
    if not bool((out[:, m["first_masked"]:] == 0).all()):
        fail("the bf16 flash forward: fully masked rows are not zero")
    say(f"check: flash attention bf16 forward q_offset {m['q_offset']}: "
        f"rows >= {m['first_masked']} (fully masked) are zero")
    return max(errs), shares, fwd


def bf16_train_setup(arch, device, *, batch, steps, seq=None):
    """``arch`` at its published widths in the dry run's train_4k
    configuration (see BF16_TRAIN), built through the library's entry
    points: (config, input_specs' token spec, sequence length, moment
    dtype, microbatches, model, step function, train state, bigram data,
    attention layers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import optimizer_for_arch
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = get_config(arch)
    spec = input_specs(arch, BF16_SHAPE)["batch"]["tokens"]
    seq = seq or spec.shape[1] - 1
    moment = "bfloat16" if cfg.total_params() > 20e9 else "float32"
    mb = 1
    model = Model(cfg, device=device, compute_dtype="bfloat16",
                  attn_impl="kernel", remat=True, max_seq=seq)
    opt_cfg = optimizer_for_arch(cfg.name, moment_dtype=moment,
                                 total_steps=steps, **BF16_OPT)
    step_fn = make_train_step(model, opt_cfg, microbatches=mb)
    state = init_train_state(model, torch.Generator(
        device=device).manual_seed(0), moment)
    data = SyntheticTokens(cfg, batch, seq, seed=0, mode="bigram")
    layers = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.num_layers))
    return cfg, spec, seq, moment, mb, model, step_fn, state, data, layers


def bf16_train_run(arch, device, *, batch, steps, seq=None, falls=True):
    """``arch`` at its published widths in the dry run's train_4k
    configuration (see BF16_TRAIN) for ``steps`` steps of ``batch``
    sequences of ``seq`` tokens (the cell's 4096 by default), with the
    launch counts zeroed just before and read just after. Fails unless
    every loss is finite, the last loss and the mean of the last three
    are below the first (the mamba2 run's rule), and the flash forward
    launched 2 x layers x microbatches a step (the forward and the remat
    recompute) and the backward layers x microbatches. Returns its
    numbers. ``falls=False`` (a run too short to leave the warmup) skips
    the loss's rule."""
    import torch
    from repro_torch.data.pipeline import place
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.sharding import ShardingCtx
    cfg, spec, seq, moment, mb, model, step_fn, state, data, layers = \
        bf16_train_setup(arch, device, batch=batch, steps=steps, seq=seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    attn_ops.launches = attn_ops.bwd_launches = 0
    ssd_ops.launches = ops.launches = 0
    losses, norms, step_ms = [], [], []
    for i in range(steps):
        b = place(data.batch(i), ShardingCtx(), device, mb)
        if seq == spec.shape[1] - 1 and \
                tuple(b["tokens"].shape) != (batch, spec.shape[1]):
            fail(f"bf16 train {arch}: tokens {tuple(b['tokens'].shape)}, "
                 f"input_specs gives {tuple(spec.shape)} before the cut")
        t0 = time.perf_counter()
        state, met = step_fn(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    got = (attn_ops.launches, attn_ops.bwd_launches, ssd_ops.launches,
           ops.launches)
    peak = torch.cuda.max_memory_allocated(device)
    expect = (2 * layers * mb * steps, layers * mb * steps, 0, 0)
    label = f"bf16 train {arch} ({batch} x {seq}, remat, microbatches {mb})"
    say(f"main: {label}: flash forward / backward launches {got[0]} / "
        f"{got[1]}, ssd {got[2]}, fused variation {got[3]}; losses "
        f"{losses}; grad norms {norms}; step ms {step_ms}; peak device "
        f"memory {peak} B; moments {moment}, parameters "
        f"{cfg.total_params()}")
    if got != expect:
        fail(f"{label}: kernel launches {got}, expected {expect}")
    if not all(map(math.isfinite, losses + norms)):
        fail(f"{label}: losses {losses}, grad norms {norms}")
    if falls and not (losses[-1] < losses[0]
                      and statistics.mean(losses[-3:]) < losses[0]):
        fail(f"{label}: the last loss {losses[-1]} or the mean of the last "
             f"three {statistics.mean(losses[-3:])} is not below the first "
             f"{losses[0]}")
    steady = statistics.median(step_ms[1:])
    run = dict(batch=batch, seq=seq, steps=steps, microbatches=mb,
               moment_dtype=moment, losses=losses, grad_norms=norms,
               step_ms_all=step_ms, step_ms=steady,
               tokens_per_s=batch * seq / (steady / 1e3), peak_bytes=peak,
               flash_launches=got[0], bwd_launches=got[1])
    del state, model, step_fn
    torch.cuda.empty_cache()
    return run


def phase_train_bf16(device):
    """The BF16_TRAIN runs at the train_4k cell, then tinyllama-1.1b in
    the same configuration at the float32 main run's shape (BF16_SIDE).
    Returns {label: run}."""
    runs = {arch: bf16_train_run(arch, device, **kw)
            for arch, kw in BF16_TRAIN.items()}
    runs[f"{TRAIN_ARCH} at {BF16_SIDE['batch']} x {BF16_SIDE['seq']}"] = \
        bf16_train_run(TRAIN_ARCH, device, falls=False, **BF16_SIDE)
    return runs


def phase_times_bf16(device, card, runs, f32_stats, err, shares, fwd_check):
    """The bf16 train runs' step ms, tokens/s and peak memory (the float32
    main run's beside the bf16 one at its shape); at tinyllama-1.1b's and
    gemma2-2b's train_4k layers the bf16 backward (device_ms, the wrapper's
    three kernels) beside its bound, its plain version, its traced split
    (each kernel's ms a launch, ``say_bwd_split``) and, where SDPA computes
    the same function (causal, global, no softcap), SDPA's bf16 backward
    by every backend that takes it; and the bf16 forward with its lse
    output (the training path's call) beside its bound, its plain version
    and SDPA's bf16 forward. Returns the kernels entries of the bf16
    backward and of the bf16 forward (``fwd_check``: phase_check_bf16's
    forward numbers)."""
    import torch
    from repro_torch.kernels.attention.flash import (flash_attention_bwd_cuda,
                                                     flash_attention_fwd_cuda)
    from repro_torch.kernels.attention.ref import (flash_attention_bwd_plain,
                                                   flash_attention_fwd_plain)
    f32_ms = statistics.median(f32_stats["step_ms"][1:])
    for label, r in runs.items():
        say(f"times: bf16 train {label} ({card}): step {r['step_ms']:.3f} ms "
            f"(median of steps 2-{r['steps']}), {r['tokens_per_s']:.1f} "
            f"tokens/s, peak device memory {r['peak_bytes']} B")
    side = runs[f"{TRAIN_ARCH} at {BF16_SIDE['batch']} x {BF16_SIDE['seq']}"]
    say(f"times: {TRAIN_ARCH} at {TRAIN_BATCH} x {TRAIN_SEQ}: float32 step "
        f"{f32_ms:.3f} ms (no remat, {f32_stats['peak_bytes']} B peak) | "
        f"bf16 step {side['step_ms']:.3f} ms (remat, {side['peak_bytes']} B "
        f"peak); information, not a claim: remat recomputes the forward")
    rows, fwd_rows = {}, {}
    for i, case in enumerate([BF16_TINYLLAMA] + BF16_GEMMA):
        q, k, v, do = grad_tensors(case, device, seed=800 + i)
        kw = attn_kwargs(case)
        out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
        ms = device_ms(lambda: flash_attention_bwd_cuda(
            q, k, v, out, lse, do, **kw), launches=5, repeats=5)
        plain = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw), repeats=3, inner=1)
        bnd = flash_bwd_bound(case, card)
        say_kernel_time(f"flash attention bf16 backward {case}", ms, plain,
                        bnd)
        split = say_bwd_split(case, device, card, seed=800 + i)
        fwd_ms = cuda_ms(lambda: flash_attention_fwd_cuda(
            q, k, v, with_lse=True, **kw), repeats=5, inner=3)
        fwd_plain = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, **kw),
                            repeats=3, inner=1)
        fbnd = flash_fwd_bf16_bound(case, card)
        say_kernel_time(f"flash attention bf16 forward with lse {case}",
                        fwd_ms, fwd_plain, fbnd)
        sdpa = backend = sdpa_fwd = fwd_backend = None
        if not case[6] and not case[7]:
            dq = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)[0]
            sdpa, backend = sdpa_bwd_yardstick(q, k, v, do, kw["scale"], dq)
            say(f"times: like for like at {case}: bf16 backward kernel "
                f"{ms:.4f} ms, scaled_dot_product_attention's bf16 backward "
                f"({backend}) {sdpa:.4f} ms")
            del dq
            sdpa_fwd, fwd_backend = sdpa_yardstick(q, k, v, kw["scale"], out)
            say(f"times: like for like at {case}: bf16 forward kernel with "
                f"lse {fwd_ms:.4f} ms, scaled_dot_product_attention's bf16 "
                f"forward ({fwd_backend}) {sdpa_fwd:.4f} ms")
        else:
            say(f"times: like for like at {case}: none "
                f"(scaled_dot_product_attention has no softcap or window)")
        rows[str(case)] = dict(
            ms=ms, plain_ms=plain, bound_ms=bnd["bound_ms"],
            bound_by=bnd["bound_by"], library_ms=sdpa,
            library_backend=backend, kernels={
                next((s for s in BF16_BWD_SYMBOLS if s in name), name[:60]):
                {"launches": n, "ms": t} for name, (n, t) in split.items()})
        fwd_rows[str(case)] = dict(
            ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fbnd["bound_ms"],
            bound_by=fbnd["bound_by"], library_ms=sdpa_fwd,
            library_backend=fwd_backend)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    main = rows[str(BF16_TINYLLAMA)]
    fwd_launches = {f"bf16 train {k}": r["flash_launches"] / r["steps"]
                    for k, r in runs.items()}
    say("times: " + json.dumps({"card": card, "bf16_train": runs,
                                "f32_step_ms_at_side_shape": f32_ms,
                                "flash_bwd_bf16": rows,
                                "flash_fwd_bf16": fwd_rows,
                                "flash_fwd_bf16_launches_per_step":
                                fwd_launches}))
    launches = {f"bf16 train {k}": r["bwd_launches"] for k, r in runs.items()}
    entry = {"name": "flash_attention_bwd_bf16", "route": "cuda",
             "source": "src/repro_torch/kernels/attention/csrc/"
                       "flash_attention_bwd_bf16.cu",
             "replaces": "src/repro/kernels/attention/ops.py:37",
             "launches": sum(launches.values()), "max_abs_err": err,
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": main["library_ms"],
             "library_backend": main["library_backend"],
             "shape": list(BF16_TINYLLAMA[:8]), "launches_by_path": launches,
             "kernels": main["kernels"], "bit_equal_share": shares,
             "gemma2_shapes": {k: v for k, v in rows.items()
                               if k != str(BF16_TINYLLAMA)}}
    fmain = fwd_rows[str(BF16_TINYLLAMA)]
    fwd_paths = {f"bf16 train {k}": r["flash_launches"]
                 for k, r in runs.items()}
    fwd_entry = {
        "name": "flash_attention_fwd_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/"
                  "flash_attention_fwd_bf16.cu",
        "replaces": "src/repro/kernels/attention/flash.py:119",
        "launches": sum(fwd_paths.values()),
        "max_abs_err": fwd_check["max_abs_err"], "ms": fmain["ms"],
        "plain_ms": fmain["plain_ms"], "bound_ms": fmain["bound_ms"],
        "bound_by": fmain["bound_by"], "library_ms": fmain["library_ms"],
        "library_backend": fmain["library_backend"], "with_lse": True,
        "shape": list(BF16_TINYLLAMA[:8]), "launches_by_path": fwd_paths,
        "launches_per_step": fwd_launches,
        "lse_max_rel_err": fwd_check["lse_max_rel_err"],
        "out_bit_equal_share": fwd_check["out_bit_equal_share"],
        "gemma2_shapes": {k: v for k, v in fwd_rows.items()
                          if k != str(BF16_TINYLLAMA)}}
    return entry, fwd_entry


def bwd_split(case, device, seed=800):
    """One backward call (``flash_attention_bwd_cuda``) at ``case`` traced
    under torch.profiler after a warm-up call: {device kernel name:
    (launches, summed ms)}. The wrapper's row sum D = rowsum(dO O) shows
    as torch's elementwise and reduction kernels, the port's kernels by
    their FLASH_SYMBOLS and BF16_BWD_SYMBOLS names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.attention.flash import (flash_attention_bwd_cuda,
                                                     flash_attention_fwd_cuda)
    q, k, v, do = grad_tensors(case, device, seed)
    kw = attn_kwargs(case)
    out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = split.get(e.name, (0, 0.0))
            split[e.name] = (n + 1, ms + (e.time_range.end
                                          - e.time_range.start) / 1e3)
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return split


def say_bwd_split(case, device, card, seed=800):
    """Print ``bwd_split`` at ``case``, one "times:" line: each device
    kernel's launches, summed ms and ms per launch, the port's kernels
    named by their symbol; returns the split."""
    split = bwd_split(case, device, seed)
    total = sum(ms for _, ms in split.values())
    parts = []
    for name, (n, ms) in sorted(split.items(), key=lambda x: -x[1][1]):
        sym = next((s for s in FLASH_SYMBOLS + BF16_BWD_SYMBOLS
                    if s in name), name[:60])
        parts.append(f"{sym}: {n} launch(es), {ms:.4f} ms "
                     f"({ms / n:.4f} a launch)")
    say(f"times: traced split of one flash attention backward {case} "
        f"({card}): {total:.4f} ms of device kernels; " + "; ".join(parts))
    return split


def profiled(fn, counts=None):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity), then
    synchronise. Returns (window ms from the first to the last traced
    event, device busy ms = the union of the device's kernel, copy and
    set intervals, {device event name: summed ms}); busy is None where the
    trace holds no device activity. ``counts``, a dict, receives {device
    event name: events}."""
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
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1
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


def phase_trace_train(device, card, arch=TRAIN_ARCH, batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, layers=TRAIN_LAYERS):
    """One train step of ``arch`` (published widths, batch x seq, kernels
    on; the training path's tinyllama-1.1b by default, ``layers``
    attention layers) under torch.profiler, after a warm-up step and one
    unprofiled step: the device's idle share, the flash kernels' share and
    the largest device entries, read from the trace."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import optimizer_for_arch
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = get_config(arch)
    model = Model(cfg, device=device, attn_impl="kernel", max_seq=seq + 8)
    state = {"s": init_train_state(
        model, torch.Generator(device=device).manual_seed(0))}
    step = make_train_step(model, optimizer_for_arch(
        arch, lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS))
    data = SyntheticTokens(cfg, batch, seq, seed=0)
    batch_t = {k: torch.from_numpy(v).to(device)
               for k, v in data.batch(0).items()}

    def run():
        state["s"], _ = step(state["s"], batch_t)

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
                and not any(k in name for k in FLASH_SYMBOLS
                            + BF16_FWD_SYMBOLS + BF16_BWD_SYMBOLS)]
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
        say(f"trace: {arch} train step (batch {batch} x {seq}): host "
            f"{host_ms:.3f} ms unprofiled, {span:.3f} ms traced; device busy "
            f"{busy:.3f} ms, idle share {row['idle_share']:.4f} of the "
            f"traced window, {1 - busy / host_ms:.4f} of the unprofiled "
            f"one; flash "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in flash.items())
            + f" = {row['flash_share']:.4f} of the traced window")
        say("trace: per launch (" + str(layers) + " a step): "
            + ", ".join(f"{k} {v / layers:.4f} ms"
                        for k, v in flash.items()))
        say(f"trace: {arch} train step, largest device entries: "
            + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    key = "train_step" if arch == TRAIN_ARCH else f"train_step {arch}"
    say("trace: " + json.dumps({"card": card, key: row}))
    return row


# the device entries of matrix products outside the port's kernels
# (cuBLAS and cuBLASLt on Hopper: sm90_xmma_gemm_*, nvjet_*, cutlass*)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def phase_trace_bf16_train(device, card, arch=TRAIN_ARCH):
    """One step of ``arch`` at the bf16 train_4k cell (``bf16_train_setup``
    at BF16_TRAIN's batch, published widths, remat) under torch.profiler,
    after a warm-up step and one unprofiled step: the device's idle share,
    each bf16 flash kernel's ms, launches and ms a launch and the flash
    share, the GEMMs' share (GEMM_NAMES) and the largest device entries,
    read from the trace. Fails unless the bf16 forward ran 2 x layers times
    (the forward and the remat recompute), each bf16 backward kernel layers
    times, and no float32 flash kernel ran."""
    import torch
    from repro_torch.data.pipeline import place
    from repro_torch.models.sharding import ShardingCtx
    batch = BF16_TRAIN[arch]["batch"]
    _, _, seq, _, mb, model, step_fn, state, data, layers = \
        bf16_train_setup(arch, device, **BF16_TRAIN[arch])
    st = {"s": state}
    tokens = place(data.batch(0), ShardingCtx(), device, mb)
    del state

    def run():
        st["s"], _ = step_fn(st["s"], tokens)

    run()                                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = {}
    span, busy, by_name = profiled(run, counts)
    kernels = {}
    for sym in FLASH_SYMBOLS + BF16_FWD_SYMBOLS + BF16_BWD_SYMBOLS:
        names = [n for n in by_name if sym in n]
        kernels[sym] = (sum(counts[n] for n in names),
                        sum(by_name[n] for n in names))
    want = {sym: (2 * layers * mb if sym in BF16_FWD_SYMBOLS else
                  layers * mb if sym in BF16_BWD_SYMBOLS else 0)
            for sym in kernels}
    if busy is not None and {s: n for s, (n, _) in kernels.items()} != want:
        fail(f"bf16 train trace {arch}: flash kernel launches "
             f"{ {s: n for s, (n, _) in kernels.items()} }, expected {want}")
    gemm = sum(v for n, v in by_name.items()
               if any(g in n.lower() for g in GEMM_NAMES))
    flash = sum(ms for _, ms in kernels.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"host_ms": host_ms, "traced_ms": span, "device_busy_ms": busy,
           "idle_share": None if busy is None else 1 - busy / span,
           "kernels": {s: {"launches": n, "ms": ms} for s, (n, ms)
                       in kernels.items() if n},
           "flash_share": flash / span, "gemm_ms": gemm,
           "gemm_share": gemm / span,
           "top_device_ms": {k[:90]: v for k, v in top}}
    del st, model, step_fn
    torch.cuda.empty_cache()
    if busy is None:
        say(f"trace: bf16 train_4k {arch} step: the profiler recorded no "
            f"device activity; idle share not measured")
    else:
        say(f"trace: bf16 train_4k {arch} step ({batch} x {seq}, remat; "
            f"{card}): host {host_ms:.3f} ms unprofiled, {span:.3f} ms "
            f"traced; device busy {busy:.3f} ms, idle share "
            f"{row['idle_share']:.4f} of the traced window; "
            + ", ".join(f"{s} {ms:.3f} ms in {n} launches ({ms / n:.4f} a "
                        f"launch)" for s, (n, ms) in kernels.items() if n)
            + f": flash {flash / span:.4f} of the window; GEMMs "
            f"({'/'.join(GEMM_NAMES)}) {gemm:.3f} ms = "
            f"{row['gemm_share']:.4f}")
        say(f"trace: bf16 train_4k {arch} step, largest device entries: "
            + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    say("trace: " + json.dumps({"card": card, "bf16_train_step": row}))
    return row


# ---------------------------------------------------------------------------
# Training the MoE, audio and VLM families at published widths, and
# Model(remat=True)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_routes():
    """Every ``moe.router_topk`` call inside the block, in call order: a
    list of (expert indices, each token's top-k margin: the k-th largest
    router probability less the (k+1)-th), both on the CPU."""
    import torch
    from repro_torch.models import moe
    topk, calls = moe.router_topk, []

    def record(cfg, router_w, x, *ctx):
        out = topk(cfg, router_w, x, *ctx)
        with torch.no_grad():
            probs = torch.softmax(x.detach().float()
                                  @ router_w.detach().float(), dim=-1)
            srt = probs.sort(dim=-1, descending=True).values
            k = cfg.experts_per_token
            margins = (srt[..., k - 1] - srt[..., k]).cpu()
        calls.append((out[0].detach().cpu(), margins))
        return out

    moe.router_topk = record
    try:
        yield calls
    finally:
        moe.router_topk = topk


def check_remat_moe(device):
    """granite-moe-1b-a400m at its published widths, one gradient
    evaluation of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens from the same
    parameters and batch with ``remat=False`` and ``remat=True``: the
    router's experts equal exactly, the backward's recomputed ones (layer
    by layer from the last) included; the loss and aux at 1e-6, every
    gradient within GRAD_TOL of its leaf's largest |g| (the dispatch's
    backward sums with atomics); flash forward launches layers and 2 x
    layers, backward layers. Returns (largest gradient error, smallest
    top-k margin, peak bytes without and with remat)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.train.train_step import make_compute_grads
    cfg = get_config(MOE_TRAIN_ARCH)
    layers = cfg.num_layers
    model = Model(cfg, device=device, attn_impl="kernel",
                  max_seq=MOE_TRAIN_SEQ + 8)
    model.init_params(torch.Generator(device=device).manual_seed(80))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    data = SyntheticTokens(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed=81)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(0).items()}
    runs = []
    for remat in (False, True):
        model.remat = remat
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        with recorded_routes() as routes:
            grads, metrics = make_compute_grads(model)(params, batch)
        torch.cuda.synchronize()
        runs.append((grads, {k: float(v) for k, v in metrics.items()},
                     routes, lm_counts()[:2],
                     torch.cuda.max_memory_allocated(device)))
    (g0, m0, r0, n0, peak0), (g1, m1, r1, n1, peak1) = runs
    routes_equal = (len(r0) == layers and len(r1) == 2 * layers and all(
        torch.equal(a[0], b[0]) and torch.equal(a[0], c[0])
        for a, b, c in zip(r0, r1[:layers], reversed(r1[layers:]))))
    grad_err = max(float((g1[n] - g).abs().max() / g.abs().max())
                   for n, g in g0.items())
    margin = min(float(m.min()) for _, m in r0)
    loss_err = abs(m1["loss"] - m0["loss"]) / abs(m0["loss"])
    aux_err = abs(m1["aux"] - m0["aux"]) / abs(m0["aux"])
    del g0, g1, runs, params, model, grads
    gc.collect()
    torch.cuda.empty_cache()
    if not (routes_equal and n0 == (layers, layers)
            and n1 == (2 * layers, layers)
            and grad_err < GRAD_TOL["float32"][0]
            and loss_err < 1e-6 and aux_err < 1e-6):
        fail(f"{MOE_TRAIN_ARCH} at published widths: remat=True differs "
             f"from remat=False: routes equal {routes_equal}, flash "
             f"launches {n0} / {n1}, grads {grad_err}, loss {loss_err}, aux "
             f"{aux_err} (relative)")
    say(f"check: {MOE_TRAIN_ARCH} at published widths ({cfg.num_experts} "
        f"experts, top-{cfg.experts_per_token}, sorted dispatch), one "
        f"gradient evaluation of {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}: "
        f"remat=True vs remat=False, the router's experts equal in all "
        f"{layers} layers and in the {layers} recomputed ones; grads "
        f"{grad_err:.3g} of each leaf's largest, loss {loss_err:.3g}, aux "
        f"{aux_err:.3g} (relative); flash launches (forward, backward) "
        f"{n0} / {n1}; smallest top-k margin {margin:.3g}; peak device "
        f"memory {peak0} B without remat, {peak1} B with")
    return grad_err, margin, peak0, peak1


def phase_check_train_families(device):
    """The flash backward at TRAIN_FAMILY_BWD against its plain version;
    remat against no remat at granite-moe's published widths
    (``check_remat_moe``); one train step of each TRAIN_FAMILY_REDUCED
    case on the card against the CPU (the MoE cases with the smallest
    top-k margin of the card's routers). Returns (largest backward error,
    the remat check's numbers)."""
    import torch
    bwd_err = 0.0
    for i, (label, (case, _)) in enumerate(TRAIN_FAMILY_BWD.items()):
        err, fwd, grads, _ = check_flash_bwd(case, device, seed=700 + i)
        bwd_err = max(bwd_err, err)
        say(f"check: flash attention backward, {label} {case}: max abs err "
            f"{err:.3g}; {fwd_errs(fwd)}")
        del grads
        torch.cuda.empty_cache()
    remat = check_remat_moe(device)
    for arch, kw in TRAIN_FAMILY_REDUCED:
        with recorded_routes() as routes:
            errs = train_step_card_vs_cpu(arch, device, **kw)
        margin = (f"; smallest top-k margin "
                  f"{min(float(m.min()) for _, m in routes):.3g}"
                  if routes else "")
        say(f"check: one train step of reduced {arch} {kw}, card vs CPU: "
            f"loss {errs[0]:.3g}, grad norm {errs[1]:.3g} (relative), grads "
            f"{errs[2]:.3g} of each leaf's largest{margin}")
    return bwd_err, remat


def llava_train_config():
    """llava-next-34b's published config with LLAVA_TRAIN_CUT applied."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LLAVA_TRAIN["arch"]),
                               **LLAVA_TRAIN_CUT)


def train_direct(arch, cfg, device, *, steps, batch, seq, seed,
                 frontend_seq=0, **model_kw):
    """``make_train_step`` on ``Model(cfg, attn_impl="kernel",
    **model_kw)`` for ``steps`` steps of ``SyntheticTokens`` (bigram;
    ``frontend_seq`` patches), AdamW as ``launch.train`` sets it (lr 1e-3,
    5 warm-up steps): stats with launch.train's keys (loss, grad_norm,
    aux, step_ms, peak_bytes from the first step on), and for parameters
    kept in another dtype than float32 (bf16) whether each kept its dtype
    and, by name, the share of 4096 of its elements (evenly strided) that
    the steps moved."""
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import optimizer_for_arch
    from repro_torch.train.train_step import init_train_state, make_train_step
    model = Model(cfg, device=device, attn_impl="kernel", max_seq=seq + 8,
                  **model_kw)
    state = init_train_state(model,
                             torch.Generator(device=device).manual_seed(seed))
    step = make_train_step(model, optimizer_for_arch(
        arch, lr=1e-3, warmup_steps=5, total_steps=steps))
    data = SyntheticTokens(cfg, batch, seq, seed=seed, mode="bigram",
                           frontend_seq=frontend_seq)
    def sample(p):
        return p.detach().flatten()[::max(1, p.numel() // 4096)][:4096]

    low = {n: (p.dtype, sample(p).clone())
           for n, p in state["params"].items() if p.dtype != torch.float32}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    step_ms, per_step = [], []
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(i).items()}
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: metrics[k] for k in ("loss", "grad_norm",
                                                 "aux")})
    stats = {k: [float(m[k]) for m in per_step]
             for k in ("loss", "grad_norm", "aux")}
    stats.update(step_ms=step_ms,
                 peak_bytes=torch.cuda.max_memory_allocated(device))
    if low:
        params = state["params"]
        stats["dtypes_kept"] = all(params[n].dtype == dt
                                   for n, (dt, _) in low.items())
        stats["moved_shares"] = {
            n: float((sample(params[n]) != x).float().mean())
            for n, (_, x) in low.items()}
    del state, model, step
    return stats


def train_family_run(label, run, expect, tokens):
    """``run()`` (a training run returning launch.train's stats) with the
    launch counts zeroed just before and read just after, which must be
    ``expect`` (flash forward, backward, SSD, fused variation); every loss
    and grad norm finite. ``tokens``: the text tokens of a step. Prints
    and returns its numbers: step ms (median of steps 2-N), tokens/s, peak
    bytes, the MoE aux, launches."""
    import gc
    import torch
    zero_counts()
    t0 = time.perf_counter()
    stats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = lm_counts()
    losses, norms = stats["loss"], stats["grad_norm"]
    step_ms = statistics.median(stats["step_ms"][1:])
    tok_s = tokens / (step_ms / 1e3)
    say(f"main: train {label}: {wall:.3f} s wall (set-up included), flash "
        f"forward / backward launches {got[0]} / {got[1]}, ssd {got[2]}, "
        f"fused variation {got[3]}; step {step_ms:.3f} ms (median of steps "
        f"2-{len(losses)}; step 1 {stats['step_ms'][0]:.3f} ms), "
        f"{tok_s:.1f} tokens/s, peak device memory {stats['peak_bytes']} B")
    fell = "below" if losses[-1] < losses[0] else "not below"
    say(f"main: train {label}: losses {losses}; grad norms {norms}; MoE aux "
        f"{stats['aux']}; the last loss {fell} the first")
    if got != expect:
        fail(f"train {label}: kernel launches {got}, expected {expect}")
    if not all(map(math.isfinite, losses + norms)):
        fail(f"train {label}: losses {losses}, grad norms {norms}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(stats, wall_s=wall, step_ms_median=step_ms,
                tokens_per_s=tok_s, flash_launches=got[0],
                bwd_launches=got[1])


def phase_train_families(device):
    """granite-moe-1b-a400m (``launch.train``, then remat at 4 x 4096),
    whisper-large-v3 (``launch.train``) and llava-next-34b (cut,
    ``train_direct``) at their published widths (``train_family_run``).
    The bf16 parameters of llava must keep their dtype through AdamW and
    move. Returns {label: numbers}."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    def cli(args):
        stats = {}
        train.main(args, stats=stats)
        return stats

    moe_layers = get_config(MOE_TRAIN_ARCH).num_layers
    runs = {}
    n, b, s = MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ
    runs[MOE_TRAIN_ARCH] = train_family_run(
        f"{' '.join(MOE_TRAIN_ARGS)}", lambda: cli(MOE_TRAIN_ARGS),
        (moe_layers * n, moe_layers * n, 0, 0), b * s)
    r = MOE_REMAT
    runs[f"{MOE_TRAIN_ARCH} remat"] = train_family_run(
        f"{MOE_TRAIN_ARCH} --full Model(remat=True) {r['steps']} steps of "
        f"{r['batch']} x {r['seq']}",
        lambda: train_direct(MOE_TRAIN_ARCH, get_config(MOE_TRAIN_ARCH),
                             device, seed=82, remat=True, **r),
        (2 * moe_layers * r["steps"], moe_layers * r["steps"], 0, 0),
        r["batch"] * r["seq"])
    wcfg = get_config("whisper-large-v3")
    n, b, s = WHISPER_TRAIN_STEPS, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ
    per = 2 * wcfg.num_layers + wcfg.encoder_layers
    runs["whisper-large-v3"] = train_family_run(
        f"{' '.join(WHISPER_TRAIN_ARGS)} ({wcfg.encoder_seq} frames)",
        lambda: cli(WHISPER_TRAIN_ARGS), (per * n, per * n, 0, 0), b * s)
    lt, lcfg = LLAVA_TRAIN, llava_train_config()
    run = train_family_run(
        f"{lt['arch']} --full cut to {lcfg.num_layers} layers, "
        f"{lcfg.param_dtype} parameters, {lt['steps']} steps of "
        f"{lt['batch']} x ({lt['patches']} patches + {lt['seq']} tokens)",
        lambda: train_direct(lt["arch"], lcfg, device, steps=lt["steps"],
                             batch=lt["batch"], seq=lt["seq"], seed=83,
                             frontend_seq=lt["patches"]),
        (lcfg.num_layers * lt["steps"],) * 2 + (0, 0),
        lt["batch"] * lt["seq"])
    moved = run["moved_shares"]
    median = statistics.median(moved.values())
    say(f"main: train {lt['arch']}: {len(moved)} {lcfg.param_dtype} "
        f"parameters, dtype kept through AdamW {run['dtypes_kept']}; share "
        f"of 4096 sampled elements the steps moved: smallest "
        f"{min(moved.values()):.3f} ({min(moved, key=moved.get)}; an "
        f"embedding moves only the rows of the tokens drawn), median "
        f"{median:.3f}")
    if not (run["dtypes_kept"] and min(moved.values()) > 0
            and median > 0.5):
        fail(f"train {lt['arch']}: bf16 parameters kept their dtype "
             f"{run['dtypes_kept']}, moved shares {moved}")
    runs[lt["arch"]] = dict(run, layers=lcfg.num_layers,
                            positions_per_s=run["tokens_per_s"]
                            * (lt["patches"] + lt["seq"]) / lt["seq"])
    return runs


def phase_times_train_families(device, card, runs):
    """The flash backward (and the forward with its lse, what training
    runs) at TRAIN_FAMILY_BWD beside its bound, its plain version and
    SDPA's backward on the same tensors (CUDA events, median); each run's
    flash share of a step (kernel ms x launches a step / step ms). Returns
    {label: row}."""
    import torch
    from repro_torch.kernels.attention.flash import (flash_attention_bwd_cuda,
                                                     flash_attention_fwd_cuda)
    from repro_torch.kernels.attention.ref import flash_attention_bwd_plain
    rows = {}
    for i, (label, (case, layers)) in enumerate(TRAIN_FAMILY_BWD.items()):
        q, k, v, do = grad_tensors(case, device, seed=720 + i)
        kw = attn_kwargs(case)
        out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
        fwd_ms = cuda_ms(lambda: flash_attention_fwd_cuda(
            q, k, v, with_lse=True, **kw), repeats=5, inner=3)
        ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                      **kw),
                     repeats=5, inner=3)
        plain = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, lse,
                                                          do, **kw),
                        repeats=3, inner=1)
        bnd = flash_bwd_bound(case, card)
        say_kernel_time(f"flash attention backward, {label} {case}", ms,
                        plain, bnd)
        dq = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)[0]
        lib_ms, backend = sdpa_bwd_yardstick(q, k, v, do, kw["scale"], dq,
                                             causal=case[5])
        say(f"times: like for like at {case}: backward kernel {ms:.4f} ms, "
            f"scaled_dot_product_attention's backward ({backend}) "
            f"{lib_ms:.4f} ms; forward with lse {fwd_ms:.4f} ms")
        rows[label] = dict(shape=list(case), layers=layers, ms=ms,
                           plain_ms=plain, bound_ms=bnd["bound_ms"],
                           bound_by=bnd["bound_by"], library_ms=lib_ms,
                           library_backend=backend, fwd_lse_ms=fwd_ms)
        del q, k, v, do, out, lse, dq
        torch.cuda.empty_cache()
    shapes = {MOE_TRAIN_ARCH: (["granite-moe"], 1),
              f"{MOE_TRAIN_ARCH} remat": (["granite-moe remat"], 2),
              "whisper-large-v3": (["whisper encoder", "whisper decoder",
                                    "whisper cross"], 1),
              LLAVA_TRAIN["arch"]: (["llava"], 1)}
    for name, (labels, fwd_per_layer) in shapes.items():
        run = runs[name]
        bwd = sum(rows[x]["ms"] * rows[x]["layers"] for x in labels)
        fwd = sum(rows[x]["fwd_lse_ms"] * rows[x]["layers"] for x in labels)
        run["flash_bwd_share"] = bwd / run["step_ms_median"]
        run["flash_fwd_share"] = fwd_per_layer * fwd / run["step_ms_median"]
        say(f"times: train {name}: step {run['step_ms_median']:.3f} ms, "
            f"{run['tokens_per_s']:.1f} tokens/s, peak device memory "
            f"{run['peak_bytes']} B; flash's share of a step (kernel ms x "
            f"launches a step / step ms): backward "
            f"{run['flash_bwd_share']:.4f}, forward "
            f"{run['flash_fwd_share']:.4f}")
    say("times: " + json.dumps({"card": card, "train_families": runs,
                                "flash_bwd_family_shapes": rows}))
    return rows


# ---------------------------------------------------------------------------
# The paper's hierarchical meta-GA, elastic resize, speculative backups
# ---------------------------------------------------------------------------

def meta_inner_cfg():
    from repro_torch.configs.base import GAConfig
    return GAConfig(num_genes=META["genes"], lower=-BOUND, upper=BOUND)


def meta_fitness_fn():
    from repro_torch.core.meta import make_meta_fitness
    from repro_torch.fitness import rastrigin
    return make_meta_fitness(meta_inner_cfg(), rastrigin,
                             p_max=META["p_max"], generations=META["gens"],
                             num_seeds=META["seeds"],
                             base_seed=META["base_seed"])


def meta_genomes(n, device, seed):
    """(n, 5) meta genomes drawn inside Tab. 4's bounds (numpy seed)."""
    import numpy as np
    import torch
    from repro_torch.core.meta import meta_bounds
    lo, hi = meta_bounds()
    g = np.random.default_rng(seed).uniform(lo, hi, (n, 5))
    return torch.tensor(g, dtype=torch.float32, device=device)


def meta_kernel_args(n, s, p, g, device, seed, shared=True, rows=None):
    """Parents (n, s, p, g) in [-BOUND, BOUND], the uniforms of s seeds
    shared across the n individuals (or drawn per run), and one Tab. 4
    hyperparameter row per individual for all its seeds (or ``rows``):
    a meta-fitness call's variation."""
    import torch
    from repro_torch.core.meta import decode_meta_genome
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    parents = (torch.rand((n, s, p, g), generator=gen, device=device)
               * 2 - 1) * BOUND
    rnd = draw_uniforms(gen, p, g, device,
                        islands=(s,) if shared else (n, s))
    if rows is None:
        hp = decode_meta_genome(meta_genomes(n, device, seed)[:, None, :]
                                .expand(n, s, 5))
        rows = ops.pack_scalars(hp["eta_cx"], hp["cx_prob"], hp["eta_mut"],
                                hp["mut_prob"], torch.tensor(
                                    1.0 / g, device=device))
    lo = torch.full((g,), -BOUND, device=device)
    return parents, rnd, rows, lo, -lo


def phase_check_meta(device):
    """The kernel with one hyperparameter row per run against its plain
    version, bit for bit; a full-size meta-fitness call through the kernel
    against the same call on the plain variation; backup dispatch on card
    genomes against direct evaluation."""
    import torch
    from repro_torch.fitness import rastrigin
    from repro_torch.kernels.genetic import ops
    from repro_torch.runtime import backup_dispatch_eval
    for k, case in enumerate(META_KERNEL_CASES):
        for shared in (True, False):
            args = meta_kernel_args(*case, device, 400 + k, shared)
            if not torch.equal(ops.fused_variation(*args),
                               ops.fused_variation_plain(*args)):
                fail(f"per-run fused_variation at {case} (uniforms "
                     f"{'shared' if shared else 'per run'}) differs from "
                     f"its plain version")
            say(f"check: kernel per-run rows {case}, uniforms "
                f"{'shared across individuals' if shared else 'per run'}: "
                f"bit-equal to the plain version")
    # equal rows reduce to the (5,) form: R runs of one row, and R = 1
    n, s, p, g = META_KERNEL_CASES[0]
    one = ops.pack_scalars(*HP.values(), 1.0 / g, device=device)
    args = meta_kernel_args(n, s, p, g, device, 410, shared=False,
                            rows=one.expand(n, s, 5).contiguous())
    per_run = ops.fused_variation(*args)
    if not torch.equal(per_run, ops.fused_variation(args[0], args[1], one,
                                                    *args[3:])):
        fail("per-run rows all equal to one row differ from the (5,) form")
    first = {k: v[:1, :1] for k, v in args[1].items()}
    if not torch.equal(
            ops.fused_variation(args[0][:1, :1], first, one[None, None],
                                *args[3:]),
            ops.fused_variation(args[0][0, 0], {k: v[0, 0] for k, v in
                                                first.items()},
                                one, *args[3:])[None, None]):
        fail("R = 1 per-run row differs from the (5,) form")
    say(f"check: {n} x {s} equal per-run rows and R = 1 equal the (5,) "
        f"form bit for bit")

    # one full-size meta-fitness call: kernel vs the plain variation
    fit = meta_fitness_fn()
    hg = meta_genomes(META_N, device, 7)
    ops.launches = 0
    kernel = fit(hg)
    launches = ops.launches
    saved = ops.fused_variation
    ops.fused_variation = ops.fused_variation_plain
    try:
        plain = fit(hg)
    finally:
        ops.fused_variation = saved
    if launches != META["gens"] or not torch.equal(kernel, plain):
        fail(f"meta fitness through the kernel ({launches} launches) "
             f"differs from the plain variation's")
    if not bool(torch.isfinite(kernel).all()):
        fail("meta fitness not finite")
    say(f"check: meta fitness ({META_N} individuals x {META['seeds']} seeds, "
        f"p_max {META['p_max']}, G {META['genes']}, {META['gens']} inner "
        f"generations) through the kernel ({launches} launches) bit-equal "
        f"to the plain variation's; best {float(kernel.min())!r}")

    # speculative backups on card genomes
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    rows = MAIN["islands"] * MAIN["pop"]
    genomes = (torch.rand((rows, MAIN["genes"]), generator=gen,
                          device=device) * 2 - 1) * BOUND
    got, stats = backup_dispatch_eval(rastrigin, genomes,
                                      genomes.abs().sum(-1) + 0.1,
                                      num_workers=BACKUP_WORKERS)
    if not torch.equal(got, rastrigin(genomes)):
        fail("backup_dispatch_eval differs from direct evaluation")
    say(f"check: backup_dispatch_eval(rastrigin) on ({rows}, "
        f"{MAIN['genes']}) card genomes, {BACKUP_WORKERS} workers: "
        f"bit-equal to direct evaluation, stats {stats}")


def gene_stats(pop):
    """{gene: (mean, std, min, max)} over the population (Fig. 6)."""
    from repro_torch.core.meta import META_GENE_SPEC
    g = pop.genomes.reshape(-1, 5).double()
    return {name: (float(g[:, k].mean()), float(g[:, k].std()),
                   float(g[:, k].min()), float(g[:, k].max()))
            for k, (name, _, _) in enumerate(META_GENE_SPEC)}


def phase_main_meta(device):
    """The meta-GA at Fig. 6's setup through ``GAEngine`` on the card,
    epoch by epoch: launches, finite fitness, genomes in Tab. 4's bounds,
    a non-increasing best, and each gene's trajectory."""
    import torch
    from repro_torch.core.engine import GAEngine
    from repro_torch.core.meta import meta_bounds, meta_ga_config
    from repro_torch.kernels.genetic import ops
    cfg = meta_ga_config(num_epochs=META["epochs"], pop_per_island=META["pop"],
                         num_islands=META["islands"])
    ops.launches = 0
    t0 = time.perf_counter()
    eng = GAEngine(cfg, meta_fitness_fn(), device=device)
    pop = eng.init()
    bests, trajectory = [], []
    for e in range(META["epochs"]):
        pop, hist = eng.run(pop, epochs=1)
        bests.append(hist[-1]["best"])
        trajectory.append(gene_stats(pop))
        say(f"main: meta-GA epoch {e}: best {bests[-1]!r}; " + ", ".join(
            f"{k} {v[0]:.4f}+-{v[1]:.4f} [{v[2]:.4f}, {v[3]:.4f}]"
            for k, v in trajectory[-1].items()))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ops.launches
    expect = META_CALLS * META["gens"]
    say(f"main: meta-GA {META['islands']} x {META['pop']}, {META['epochs']} "
        f"epochs, {META['seeds']} seeds x {META['gens']} inner generations "
        f"at p_max {META['p_max']}: {wall_s:.3f} s wall, fused_variation "
        f"launches {launches}")
    if launches != expect:
        fail(f"meta-GA launched the kernel {launches} times, expected "
             f"{expect}")
    if not bool(torch.isfinite(pop.fitness).all()):
        fail("meta-GA fitness not finite")
    lo, hi = (torch.tensor(b, device=pop.genomes.device)
              for b in meta_bounds())
    if not bool(((pop.genomes >= lo) & (pop.genomes <= hi)).all()):
        fail("meta-GA genomes outside Tab. 4's bounds")
    if any(b > a for a, b in zip(bests, bests[1:])):
        fail(f"meta-GA best worsened across epochs: {bests}")
    g, f = eng.best(pop)
    say(f"main: meta-GA best hyperparameters {g.tolist()}, best inner "
        f"fitness {float(f[0])!r}")
    return {"launches": launches, "wall_s": wall_s, "bests": bests,
            "trajectory": trajectory}


def resize_schedule(fixed_workers, device):
    """The GA main shape through ``GAEngine`` with a resize between epochs
    (RESIZE_ISLANDS), cost-balanced dispatch over RESIZE_WORKERS lanes,
    rescaled with the islands unless ``fixed_workers``. Returns (pop,
    launches, {resize: ms by host clock, synchronised, the clones'
    evaluation included}, workers per epoch, (best before, best after)
    each resize)."""
    import torch
    from repro_torch.configs.base import GAConfig
    from repro_torch.core.engine import GAEngine
    from repro_torch.fitness import rastrigin
    from repro_torch.kernels.genetic import ops
    cfg = GAConfig(num_genes=MAIN["genes"], pop_per_island=MAIN["pop"],
                   num_islands=RESIZE_ISLANDS[0], lower=-BOUND, upper=BOUND,
                   generations_per_epoch=MAIN["gens_per_epoch"],
                   mutation_prob=0.7, mutation_eta=20.0, crossover_prob=0.9,
                   crossover_eta=15.0, seed=2)
    eng = GAEngine(cfg, rastrigin, cost_fn=resize_cost,
                   num_workers=RESIZE_WORKERS, device=device)
    ops.launches = 0
    pop, _ = eng.run(eng.init(), epochs=1)
    ms, workers, kept = {}, [eng.broker.num_workers], []
    for old, new in zip(RESIZE_ISLANDS, RESIZE_ISLANDS[1:]):
        before = float(pop.fitness.min())          # synchronises
        t0 = time.perf_counter()
        pop = eng.resize(pop, new, num_workers=fixed_workers)
        torch.cuda.synchronize()
        ms[f"{old}->{new}"] = (time.perf_counter() - t0) * 1e3
        kept.append((before, float(pop.fitness.min())))
        if not bool(torch.isfinite(pop.fitness).all()):
            fail(f"resize {old}->{new} left unevaluated (+inf) fitness")
        workers.append(eng.broker.num_workers)
        pop, _ = eng.run(pop, epochs=1)
    return pop, ops.launches, ms, workers, kept


def phase_main_resize(device):
    """The GA main shape resized 32 -> 16 -> 32 islands between epochs:
    the best kept through the shrink, the clones re-evaluated, 15
    launches, a re-balanced run bit-identical to a fixed-lane run."""
    import torch
    t0 = time.perf_counter()
    pop, launches, ms, workers, kept = resize_schedule(None, device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fixed, fixed_launches, fixed_ms, fixed_workers, _ = resize_schedule(
        RESIZE_WORKERS, device)
    expect = MAIN["gens_per_epoch"] * len(RESIZE_ISLANDS)
    say(f"main: resize {' -> '.join(map(str, RESIZE_ISLANDS))} islands at "
        f"({MAIN['pop']}, {MAIN['genes']}): workers {workers} (fixed run "
        f"{fixed_workers}), resize ms {ms} (fixed run {fixed_ms}), "
        f"{wall_s:.3f} s wall, launches {launches} / {fixed_launches}; "
        f"best before / after each resize {kept}")
    if launches != expect or fixed_launches != expect:
        fail(f"resize runs launched the kernel {launches} / "
             f"{fixed_launches} times, expected {expect}")
    if kept[0][1] != kept[0][0]:
        fail(f"the shrink lost the best: {kept[0]}")
    if tuple(pop.genomes.shape) != (RESIZE_ISLANDS[-1], MAIN["pop"],
                                    MAIN["genes"]):
        fail(f"resized population has shape {tuple(pop.genomes.shape)}")
    if not torch.equal(pop.genomes, fixed.genomes):
        fail("the re-balanced run differs from the fixed-lane run")
    say("main: re-balanced run bit-identical to the fixed-lane run")
    return {"launches": launches, "resize_ms": ms, "wall_s": wall_s,
            "workers": workers}


def meta_generation_phases(device):
    """One inner generation of a full-size meta-fitness call, phase by
    phase (CUDA events, median of 3 single calls): tournament with the
    parent gather, the variation's uniform draws (per seed), one kernel
    launch, the fitness over the whole width, the stable sort and the
    survivors' gather."""
    import torch
    from repro_torch.core import operators
    from repro_torch.core.island import take_rows
    from repro_torch.core.meta import (active_size, decode_meta_genome,
                                       seed_generators)
    from repro_torch.core.uniforms import SeedUniforms
    from repro_torch.fitness import rastrigin
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms
    n, s, p, g = META_KERNEL_CASES[0]
    rand = SeedUniforms(seed_generators(META["base_seed"], s, device),
                        device)
    hp = decode_meta_genome(meta_genomes(n, device, 7)[:, None, :]
                            .expand(n, s, 5))
    p_act = active_size(hp["pop_size"], p)
    active = torch.arange(p, device=device) < p_act[..., None]
    genomes = (rand((n, s, p, g)) * 2 - 1).mul(BOUND).expand(
        n, s, p, g).contiguous()
    fit = torch.where(active, rastrigin(genomes.reshape(-1, g))
                      .reshape(n, s, p), torch.inf)
    rows = ops.pack_scalars(hp["eta_cx"], hp["cx_prob"], hp["eta_mut"],
                            hp["mut_prob"], torch.tensor(1.0 / g,
                                                         device=device))
    lo = torch.full((g,), -BOUND, device=device)
    state = {}

    def tournament():
        state["parents"] = take_rows(genomes, operators.tournament_select(
            rand, fit, p, active=p_act))

    def draws():
        state["rnd"] = draw_uniforms(rand, p, g, device, islands=(n, s))

    def variation():
        state["off"] = ops.fused_variation(state["parents"], state["rnd"],
                                           rows, lo, -lo)

    def fitness():
        state["fit"] = torch.where(active, rastrigin(
            state["off"].reshape(-1, g)).reshape(n, s, p), torch.inf)

    def survivors():
        cf = torch.cat([fit, state["fit"]], dim=-1)
        order = torch.argsort(cf, dim=-1, stable=True)[..., :p]
        take_rows(torch.cat([genomes, state["off"]], dim=-2), order)
        torch.gather(cf, -1, order)

    steps = [("tournament_gather", tournament), ("uniform_draws", draws),
             ("variation_kernel", variation), ("fitness", fitness),
             ("sort_survivors", survivors)]
    return {name: cuda_ms(fn, repeats=3, inner=1) for name, fn in steps}


def phase_times_meta(device, card, main_kernel_ms, meta_run, resize_run):
    """Times of the meta path: one meta-fitness call, one inner generation
    phase by phase, the kernel at the meta shape (uniforms shared across
    individuals, as the path reads them, and expanded per run) beside its
    bound and its plain version, and the (5,) form's time at the main
    shape. Returns the kernel's meta entry for the kernels line."""
    from repro_torch.kernels.genetic import ops
    n, s, p, g = META_KERNEL_CASES[0]
    fit = meta_fitness_fn()
    hg = meta_genomes(META_N, device, 7)
    call_ms = cuda_ms(lambda: fit(hg), repeats=3, inner=1)
    evals = META_N * META["seeds"] * p * (META["gens"] + 1)
    say(f"times: one meta-fitness call ({META_N} x {META['seeds']} runs, "
        f"p_max {p}, G {g}, {META['gens']} inner generations): "
        f"{call_ms:.4f} ms, {evals / call_ms * 1e3:.1f} inner "
        f"evaluations/s ({evals} evaluations)")
    phases = meta_generation_phases(device)
    gen_ms = sum(phases.values())
    say("times: one inner generation at (N, S, P, G) = "
        f"({n}, {s}, {p}, {g}), ms per phase: "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
        + f"; total {gen_ms:.4f}")
    kernel = {}
    for form, shared in (("shared", True), ("per_run", False)):
        args = meta_kernel_args(n, s, p, g, device, 11, shared)
        ms = device_ms(lambda: ops.fused_variation(*args))
        bound_ms, bound_by = variation_bound(
            args, card, f"fused_variation meta ({form} uniforms)")
        kernel[form] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by)
        if shared:
            kernel[form]["plain_ms"] = cuda_ms(
                lambda: ops.fused_variation_plain(*args), repeats=5, inner=1)
        say(f"times: fused_variation ({n}, {s}, {p}, {g}), one row per run, "
            f"uniforms {form}: kernel {ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {bound_ms / ms:.3f} of the bound"
            + (f", plain version {kernel[form]['plain_ms']:.5f} ms"
               if shared else ""))
        del args
    say(f"times: fused_variation (5,) form at the main shape "
        f"({MAIN['islands']}, {MAIN['pop']}, {MAIN['genes']}): "
        f"{main_kernel_ms:.5f} ms")
    say("times: meta " + json.dumps({
        "card": card, "meta_fitness_call_ms": call_ms,
        "inner_evaluations_per_s": evals / call_ms * 1e3,
        "inner_generation_phase_ms": phases, "kernel_meta_shape": kernel,
        "kernel_main_shape_ms": main_kernel_ms,
        "meta_run_wall_s": meta_run["wall_s"],
        "resize_ms": resize_run["resize_ms"],
        "resize_run_wall_s": resize_run["wall_s"]}))
    return {"shape": [n, s, p, g], "launches": meta_run["launches"],
            **kernel["shared"], "per_run_uniforms": kernel["per_run"]}


# ---------------------------------------------------------------------------
# The LM hyperparameter search (ga_run --fitness lm), mamba2 training
# ---------------------------------------------------------------------------

def lm_attn_layers(arch):
    """Attention layers of ``arch``'s reduced config (the LM fitness's
    model)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return sum(cfg.mixer_kind(i % cfg.scan_period) == "attn"
               for i in range(cfg.num_layers))


def lm_genomes(n, device, seed):
    """(n, 4) genomes in [0, 1] drawn on the CPU from ``seed``, the first
    two LM_CORNERS."""
    import torch
    g = torch.rand((n, 4), generator=torch.Generator().manual_seed(seed))
    g[:2] = torch.tensor(LM_CORNERS)
    return g.to(device)


def lm_counts():
    """(flash forward, flash backward, SSD, fused variation) launches."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return (attn_ops.launches, attn_ops.bwd_launches, ssd_ops.launches,
            ops.launches)


def zero_counts():
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    attn_ops.launches = attn_ops.bwd_launches = 0
    ssd_ops.launches = ops.launches = 0


def check_flash_vmap(arch, device, seed):
    """The flash wrapper under vmap(grad(...)) over LM_VMAP_RUNS runs at
    ``arch``'s reduced layer shapes (the LM fitness's batch x sequence, so
    the runs fold into the batch of a call at LM_TIME_N[0] genomes; each
    window the config has, its softcap): one forward and one backward
    launch a call; each run's output against the plain forward
    (``flash_attention_fwd_plain``) at ATTN_TOL, and its dq, dk, dv
    against the plain backward (``flash_attention_bwd_plain``) on the same
    card tensors and against a separate wrapper call's, at GRAD_TOL.
    Returns the largest gradient error against the plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import (flash_attention_bwd_plain,
                                                   flash_attention_fwd_plain)
    cfg = get_config(arch).reduced()
    r, b, s = LM_VMAP_RUNS, 4, 32
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = 0.0
    for window in sorted({cfg.sliding_window, 0}):
        kw = dict(scale=(cfg.query_pre_attn_scalar or hd) ** -0.5,
                  causal=True, window=window, attn_softcap=cfg.attn_softcap)
        gen = torch.Generator(device=device).manual_seed(seed + window)
        q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                       for shape in ((r, b, s, h, hd), (r, b, s, kv, hd),
                                     (r, b, s, kv, hd), (r, b, s, h, hd)))

        def loss(q, k, v, do, kw=kw):
            out = attn_ops.flash_attention(q, k, v, **kw)
            return (out * do).sum(), out

        before = lm_counts()
        grads, out = torch.func.vmap(torch.func.grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v, do)
        torch.cuda.synchronize()
        got = tuple(a - b_ for a, b_ in zip(lm_counts(), before))[:2]
        if got != (1, 1):
            fail(f"flash under vmap(grad) at {arch}'s layer (window "
                 f"{window}): launches {got}, expected one forward and one "
                 f"backward")
        out_err = plain_err = self_err = 0.0
        for i in range(r):
            p_out, p_lse = flash_attention_fwd_plain(q[i], k[i], v[i], **kw)
            ok, e = close(out[i], p_out, *ATTN_TOL["float32"])
            if not ok:
                fail(f"flash under vmap(grad) at {arch}'s layer (window "
                     f"{window}), run {i}: the output differs from the plain "
                     f"forward's by {e}")
            out_err = max(out_err, e)
            plain = flash_attention_bwd_plain(q[i], k[i], v[i], p_out, p_lse,
                                              do[i], **kw)
            qi, ki, vi = (x[i].clone().requires_grad_() for x in (q, k, v))
            own = torch.autograd.grad(loss(qi, ki, vi, do[i])[0],
                                      (qi, ki, vi))
            for name, a, p_, w in zip(("dq", "dk", "dv"), grads, plain, own):
                ok, e = close(a[i], p_, *GRAD_TOL["float32"])
                ok_own, e_own = close(a[i], w, *GRAD_TOL["float32"])
                if not (ok and ok_own):
                    fail(f"flash under vmap(grad) at {arch}'s layer (window "
                         f"{window}), run {i}: {name} differs from the plain "
                         f"backward's by {e}, from a separate call's by "
                         f"{e_own}")
                plain_err, self_err = max(plain_err, e), max(self_err, e_own)
        say(f"check: flash attention under vmap(grad), {r} runs at {arch}'s "
            f"reduced layer ({b}, {s}, {h}, {kv}, {hd}), window {window}, "
            f"softcap {cfg.attn_softcap}: one forward and one backward "
            f"launch; max abs err against the plain versions: out "
            f"{out_err:.3g}, grads {plain_err:.3g}; grads against {r} "
            f"separate calls {self_err:.3g}")
        worst = max(worst, plain_err)
    return worst


def check_lm_fitness(arch, device):
    """LMTrainFitness for LM_CHECK_N genomes on the card against the CPU
    (LM_CPU_TOL), against one plain run per genome on the card and in two
    chunks (LM_SELF_RTOL); every loss finite. Returns the errors."""
    import torch
    from repro_torch.fitness.lm import LMTrainFitness
    g = lm_genomes(LM_CHECK_N, "cpu", seed=7)
    fit = LMTrainFitness(arch, steps=LM["steps"], device=device)
    got = fit(g.to(device))
    if not bool(torch.isfinite(got).all()):
        fail(f"LM fitness {arch}: losses {got.flatten().tolist()}")
    cpu = LMTrainFitness(arch, steps=LM["steps"], device="cpu")(g)
    loop = fit.per_genome_loop(g.to(device))
    fit.chunk_runs = lambda: LM_CHECK_N // 2
    two = fit(g.to(device))
    errs = {}
    for label, a, b, tol in (("card vs CPU", got.cpu(), cpu, LM_CPU_TOL),
                             ("batched vs per-genome loop", got, loop,
                              (LM_SELF_RTOL, 0.0)),
                             ("one chunk vs two", got, two,
                              (LM_SELF_RTOL, 0.0))):
        ok, errs[label] = close(a, b, *tol)
        if not ok:
            fail(f"LM fitness {arch}, {label}: {a.flatten().tolist()} vs "
                 f"{b.flatten().tolist()}")
    say(f"check: LM fitness {arch} ({LM_CHECK_N} genomes, corners "
        f"included, {LM['steps']} steps): losses "
        f"{[round(x, 6) for x in got.flatten().tolist()]}; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def phase_check_lm_fitness(device):
    """The flash wrapper under vmap(grad), the LM fitness against itself
    and the CPU, and one reduced mamba2-780m train step on the card
    against the CPU. Returns the largest vmap(grad) gradient error against
    the plain backward."""
    err = max(check_flash_vmap(arch, device, seed=40 + i)
              for i, arch in enumerate(LM_ARCHS[:2]))
    for arch in LM_ARCHS:
        check_lm_fitness(arch, device)
    errs = train_step_card_vs_cpu("mamba2-780m", device)
    say(f"check: one train step of reduced mamba2-780m (plain chunked "
        f"scan), card vs CPU: loss {errs[0]:.3g}, grad norm {errs[1]:.3g} "
        f"(relative), grads {errs[2]:.3g} of each leaf's largest")
    return err


def lm_run(arch, extra=(), chunks=1):
    """``ga_run --fitness lm --lm-arch arch`` (LM_ARGS + ``extra``) with
    the launch counts zeroed just before and read just after: the flash
    forward and backward exactly attention layers x steps x fitness calls
    (the engine's evaluations of the population, ``chunks`` calls each),
    no SSD or fused variation launch; finite losses in [0, 1]-bounded
    genomes; the best no worse than the corner [0, 0, 1, 1] + 1e-3
    (tests/test_system.py:40-55)."""
    import torch
    from repro_torch.fitness.lm import LMTrainFitness
    label = f"ga_run lm {arch}{' ' + ' '.join(extra) if extra else ''}"
    zero_counts()
    t0 = time.perf_counter()
    pop, hist, lines = run_captured(LM_ARGS + ["--lm-arch", arch]
                                    + list(extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = lm_counts()
    per_eval = LM["islands"] * LM["pop"]
    evaluations = 1 + LM["epochs"] * LM["gens_per_epoch"]
    if pop.evals != evaluations * per_eval:
        fail(f"{label}: {pop.evals} evaluations, expected "
             f"{evaluations} x {per_eval}")
    calls = evaluations * chunks
    expect = lm_attn_layers(arch) * LM["steps"] * calls
    say(f"main: {label}: {wall:.3f} s wall, {calls} fitness calls, flash "
        f"forward / backward launches {got[0]} / {got[1]}, ssd {got[2]}, "
        f"fused variation {got[3]}")
    if got != (expect, expect, 0, 0):
        fail(f"{label}: kernel launches {got}, expected ({expect}, "
             f"{expect}, 0, 0)")
    if extra:
        check_dispatch_line(lines, label)
    if not bool(torch.isfinite(pop.fitness).all()) or not bool(
            ((pop.genomes >= 0) & (pop.genomes <= 1)).all()):
        fail(f"{label}: fitness not finite or genomes outside [0, 1]")
    best, device = float(pop.fitness.min()), pop.genomes.device
    corners = LMTrainFitness(arch, steps=LM["steps"], device=device)(
        torch.tensor(LM_CORNERS, device=device)).flatten().tolist()
    if not best <= corners[0] + 1e-3:
        fail(f"{label}: best {best} worse than the corner [0, 0, 1, 1]'s "
             f"{corners[0]} + 1e-3")
    say(f"main: {label}: epoch bests {[h['best'] for h in hist]}, best "
        f"{best!r} vs the corners' {corners}")
    return {"launches": got[0], "bwd_launches": got[1], "calls": calls,
            "wall_s": wall, "best": best, "corners": corners}


def lm_roundoff_spread(arch, steps, genomes, losses):
    """How far round-off alone moves each genome's LM fitness: the larger,
    over LM_PERTURB_DRAWS draws, of |the same CPU call from the
    initialisation scaled by (1 + LM_PERTURB x N(0, 1)) - ``losses``|
    (n,)."""
    import torch
    from repro_torch.fitness.lm import LMTrainFitness
    spread = torch.zeros(len(losses))
    for seed in range(LM_PERTURB_DRAWS):
        fit = LMTrainFitness(arch, steps=steps, device="cpu")
        gen = torch.Generator().manual_seed(90 + seed)
        with torch.no_grad():
            for p in fit._init.values():
                p.mul_(1 + LM_PERTURB * torch.randn(p.shape, generator=gen))
        spread = torch.maximum(spread,
                               (fit(genomes) - losses).abs().flatten())
    return spread


def lm_family_run(arch, steps):
    """``ga_run --fitness lm --lm-arch arch --epochs 0``: one fitness call
    of the initial LM_FAMILY_GENOMES population, ``steps`` training steps
    a genome, with the launch counts zeroed just before and read just
    after: the flash forward and backward once per attention layer
    (self-, encoder and cross-attention) and step, no SSD or fused
    variation launch (jamba trains through the plain chunked scan); its
    losses held against the same call on the CPU at LM_CPU_TOL, where the
    arch has MoE layers on the genomes that round-off alone moves by at
    most LM_SPREAD_MAX (``lm_roundoff_spread``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fitness.lm import LMTrainFitness
    islands, pop_size = LM_FAMILY_GENOMES
    label = f"ga_run lm {arch} (one call of {islands * pop_size} genomes)"
    zero_counts()
    t0 = time.perf_counter()
    pop, _, _ = run_captured(
        ["--fitness", "lm", "--lm-arch", arch, "--islands", str(islands),
         "--pop", str(pop_size), "--epochs", "0", "--lm-steps", str(steps),
         "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = lm_counts()
    expect = family_layers(get_config(arch).reduced())[0] * steps
    genomes = pop.genomes.reshape(-1, 4).cpu()
    card = pop.fitness.reshape(-1, 1).cpu()
    cpu = LMTrainFitness(arch, steps=steps, device="cpu")(genomes)
    spread = (lm_roundoff_spread(arch, steps, genomes, cpu)
              if get_config(arch).num_experts else torch.zeros(len(cpu)))
    held = spread <= LM_SPREAD_MAX
    ok, err = (close(card[held], cpu[held], *LM_CPU_TOL) if bool(held.any())
               else (False, math.nan))
    apart = {i: (float(spread[i]), float((card[i] - cpu[i]).abs()))
             for i in range(len(cpu)) if not held[i]}
    say(f"main: {label}, {steps} steps: {wall:.3f} s wall, flash forward / "
        f"backward launches {got[0]} / {got[1]}, ssd {got[2]}, fused "
        f"variation {got[3]}; losses "
        f"{[round(x, 6) for x in card.flatten().tolist()]}; card vs CPU max "
        f"abs err {err:.3g} over {int(held.sum())} genomes"
        + (f"; moved past {LM_SPREAD_MAX} by a {LM_PERTURB} perturbation "
           f"of the start, not held (genome: (that move, card vs CPU)) "
           f"{apart}" if apart else ""))
    if got != (expect, expect, 0, 0) or pop.evals != islands * pop_size:
        fail(f"{label}: kernel launches {got}, expected ({expect}, "
             f"{expect}, 0, 0); {pop.evals} evaluations")
    if not ok or not bool(torch.isfinite(card).all()) or \
            float(held.float().mean()) < LM_MIN_HELD:
        fail(f"{label}: losses on the card {card.flatten().tolist()} vs the "
             f"CPU's {cpu.flatten().tolist()}, held on {held.tolist()}")
    return {"launches": got[0], "bwd_launches": got[1], "calls": 1,
            "steps": steps, "wall_s": wall, "card_vs_cpu_max_abs_err": err,
            "held": int(held.sum()), "not_held": apart}


def phase_main_lm():
    """``ga_run --fitness lm`` on each arch, tinyllama-1.1b under
    host-thread (HOST_WORKERS chunks a generation, each a fitness call on
    the card behind one lock), and one call on each of LM_FAMILY_ARCHS
    (``lm_family_run``)."""
    runs = {arch: lm_run(arch) for arch in LM_ARCHS}
    runs["tinyllama-1.1b host-thread"] = lm_run(
        "tinyllama-1.1b", ["--dispatch-backend", "host-thread"] + HOST_ARGS,
        chunks=HOST_WORKERS)
    for arch, steps in LM_FAMILY_ARCHS.items():
        runs[f"{arch} (one call)"] = lm_family_run(arch, steps)
    return runs


def phase_train_ssm():
    """``launch.train --arch mamba2-780m --full`` (SSM_TRAIN_ARGS) through
    the plain chunked scan, with the launch counts zeroed just before and
    read just after: no kernel launch, finite losses, the last and the mean
    of the last three below the first. Each step's loss is on its own
    batch, and the first steps differ by more than they learn (the
    learning rate warms up over 5 steps), so the run takes
    SSM_TRAIN_STEPS steps. Returns the run's stats."""
    import torch
    from repro_torch.launch import train
    zero_counts()
    stats = {}
    t0 = time.perf_counter()
    train.main(SSM_TRAIN_ARGS, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = lm_counts()
    say(f"main: train {' '.join(SSM_TRAIN_ARGS)}: {wall:.3f} s wall (set-up "
        f"included), launches (flash forward, backward, ssd, fused "
        f"variation) {got}; peak device memory {stats['peak_bytes']} B")
    if got != (0, 0, 0, 0):
        fail(f"train mamba2-780m: kernel launches {got}, expected none")
    losses, norms = stats["loss"], stats["grad_norm"]
    if len(losses) != SSM_TRAIN_STEPS or not all(
            map(math.isfinite, losses + norms)):
        fail(f"train mamba2-780m: losses {losses}, grad norms {norms}")
    if not (losses[-1] < losses[0]
            and statistics.mean(losses[-3:]) < losses[0]):
        fail(f"train mamba2-780m: the last loss {losses[-1]} or the mean of "
             f"the last three {statistics.mean(losses[-3:])} is not below "
             f"the first {losses[0]}")
    say(f"main: train mamba2-780m losses {losses}; grad norms {norms}")
    torch.cuda.empty_cache()
    return dict(stats, wall_s=wall)


def phase_times_lm_fitness(device, card, ssm_stats):
    """One fitness call (tinyllama-1.1b, LM['steps'] steps) at each of
    LM_TIME_N genomes (CUDA events, median of 3 after a warm-up): ms,
    training runs/s, tokens/s and peak device memory, which must stay
    below the chunk sizing's estimate (``run_bytes()`` x genomes), and its
    launches, which must be one forward and one backward per attention
    layer and step at every size; the per-genome loop at LM_LOOP_N genomes (one
    timed call), which the batched call must beat; the mamba2-780m train
    step at its published widths (host clock, synchronised, median of
    steps 2-N)."""
    import torch
    from repro_torch.fitness.lm import LMTrainFitness
    fit = LMTrainFitness(steps=LM["steps"], device=device)
    per_call = lm_attn_layers(fit.arch) * LM["steps"]
    tokens = LM["steps"] * fit.batch_size * fit.seq_len
    rows = {}
    for n in LM_TIME_N:
        g = lm_genomes(n, device, seed=n)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        before = lm_counts()
        fit(g)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(lm_counts(), before))[:2]
        if got != (per_call, per_call):
            fail(f"one LM fitness call at {n} genomes: flash launches "
                 f"{got}, expected {per_call} each (the count must not "
                 f"depend on the population)")
        peak, estimate = torch.cuda.max_memory_allocated(device), \
            fit.run_bytes() * n
        if not peak < estimate:
            fail(f"one LM fitness call at {n} genomes: peak device memory "
                 f"{peak} B above the chunk sizing's estimate {estimate} B")
        ms = cuda_ms(lambda: fit(g), repeats=3, inner=1)
        rows[n] = {"ms": ms, "runs_per_s": n / ms * 1e3,
                   "tokens_per_s": n * tokens / ms * 1e3,
                   "peak_bytes": peak, "estimate_bytes": estimate,
                   "chunk_runs": fit.chunk_runs(), "launches": got}
        say(f"times: one LM fitness call at {n} genomes ({fit.arch}, "
            f"{LM['steps']} steps of {fit.batch_size} x {fit.seq_len}): "
            f"{ms:.3f} ms, {rows[n]['runs_per_s']:.1f} training runs/s, "
            f"{rows[n]['tokens_per_s']:.0f} tokens/s, peak device memory "
            f"{peak} B ({peak / estimate:.4f} of the chunk sizing's "
            f"estimate), flash launches {got}")
    g = lm_genomes(LM_LOOP_N, device, seed=LM_LOOP_N)
    fit.per_genome_loop(g[:1])
    loop_ms = once_ms(lambda: fit.per_genome_loop(g))
    batched = rows[LM_LOOP_N]["ms"]
    say(f"times: the per-genome loop at {LM_LOOP_N} genomes: {loop_ms:.3f} "
        f"ms, against {batched:.3f} ms batched ({loop_ms / batched:.2f}x)")
    if not batched < loop_ms:
        fail(f"the batched LM fitness ({batched} ms) does not beat the "
             f"per-genome loop ({loop_ms} ms)")
    steady = ssm_stats["step_ms"][1:]
    ssm_ms = statistics.median(steady)
    ssm_tok = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ / (ssm_ms / 1e3)
    say(f"times: train mamba2-780m --full batch {SSM_TRAIN_BATCH} seq "
        f"{SSM_TRAIN_SEQ} (plain chunked scan): step {ssm_ms:.3f} ms (median "
        f"of steps 2-{SSM_TRAIN_STEPS}; step 1 {ssm_stats['step_ms'][0]:.3f} "
        f"ms with set-up), {ssm_tok:.1f} tokens/s, peak device memory "
        f"{ssm_stats['peak_bytes']} B")
    out = {"card": card, "lm_fitness": {str(n): r for n, r in rows.items()},
           "per_genome_loop_ms": loop_ms, "loop_genomes": LM_LOOP_N,
           "mamba2_train_step_ms": ssm_ms,
           "mamba2_train_step_ms_all": ssm_stats["step_ms"],
           "mamba2_train_tokens_per_s": ssm_tok,
           "mamba2_train_peak_bytes": ssm_stats["peak_bytes"],
           "mamba2_train_losses": ssm_stats["loss"]}
    say("times: " + json.dumps(out))
    return out


def phase_trace_lm_fitness(device, card):
    """One batched LM fitness call (tinyllama-1.1b, LM_TIME_N[0] genomes)
    under torch.profiler, after a warm-up call and one unprofiled call:
    the device's idle share, the flash kernels' share and the largest
    device entries, read from the trace."""
    import torch
    from repro_torch.fitness.lm import LMTrainFitness
    fit = LMTrainFitness(steps=LM["steps"], device=device)
    g = lm_genomes(LM_TIME_N[0], device, seed=3)
    fit(g)                                                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(g)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    span, busy, by_name = profiled(lambda: fit(g))
    flash = {k: sum(v for name, v in by_name.items() if k in name)
             for k in FLASH_SYMBOLS}
    unlisted = [name for name in by_name if "flash" in name
                and not any(k in name for k in FLASH_SYMBOLS
                            + BF16_FWD_SYMBOLS + BF16_BWD_SYMBOLS)]
    if unlisted or (busy is not None and not all(flash.values())):
        fail(f"LM fitness trace: flash kernels {unlisted} are not in "
             f"FLASH_SYMBOLS, or a listed one did not run: {flash}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"genomes": LM_TIME_N[0], "host_ms": host_ms, "traced_ms": span,
           "device_busy_ms": busy,
           "idle_share": None if busy is None else 1 - busy / span,
           "flash_ms": flash, "flash_share": sum(flash.values()) / span,
           "top_device_ms": {k[:90]: v for k, v in top}}
    if busy is None:
        say("trace: LM fitness call: the profiler recorded no device "
            "activity; idle share not measured")
    else:
        say(f"trace: one LM fitness call ({fit.arch}, {LM_TIME_N[0]} "
            f"genomes, {LM['steps']} steps): host {host_ms:.3f} ms "
            f"unprofiled, {span:.3f} ms traced; device busy {busy:.3f} ms, "
            f"idle share {row['idle_share']:.4f} of the traced window, "
            f"{1 - busy / host_ms:.4f} of the unprofiled one; flash "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in flash.items())
            + f" = {row['flash_share']:.4f} of the traced window")
    say("trace: " + json.dumps({"card": card, "lm_fitness_call": row}))
    return row


# ---------------------------------------------------------------------------
# The dense and MoE families served at published widths; the continuous
# batcher (serve/batching.py) with per-lane decode positions
# ---------------------------------------------------------------------------

def check_moe_layer(arch, device):
    """One MoE layer of ``arch`` at its published widths on the card, float32
    (random weights from a seed): ``moe_sorted`` with room for every token
    against ``moe_dense`` at MODEL_TOL, and ``router_topk``'s expert
    indices on the card exactly the CPU's (TF32 off), its weights at
    MODEL_TOL. Returns the largest error."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import MoE
    cfg = get_config(arch)
    layer = MoE(cfg, torch.float32, device, "sorted", 1.25, cfg.num_experts)
    layer.reset_parameters(torch.Generator(device=device).manual_seed(60))
    p = dict(layer.named_parameters(recurse=False))
    gen = torch.Generator(device=device).manual_seed(61)
    x = layer.ln(torch.randn(MOE_LAYER_TOKENS + (cfg.d_model,),
                             generator=gen, device=device))
    with torch.inference_mode():
        idx, w, _ = moe.router_topk(cfg, p["router"], x)
        cidx, cw, _ = moe.router_topk(cfg, p["router"].cpu(), x.cpu())
        factor = cfg.num_experts / cfg.experts_per_token    # capacity = T
        out, _ = moe.moe_sorted(cfg, p, x, capacity_factor=factor)
        dense, _ = moe.moe_dense(cfg, p, x)
    torch.cuda.synchronize()
    if not torch.equal(idx.cpu(), cidx):
        fail(f"{arch}: router_topk's experts on the card differ from the "
             f"CPU's at {int((idx.cpu() != cidx).sum())} choices")
    ok_w, err_w = close(w.cpu(), cw, *MODEL_TOL)
    ok, err = close(out, dense, *MODEL_TOL)
    if not (ok and ok_w and bool(torch.isfinite(out).all())):
        fail(f"{arch}: moe_sorted vs moe_dense on the card: max abs err "
             f"{err} (router weights vs the CPU {err_w})")
    say(f"check: {arch} MoE layer at published widths ({cfg.num_experts} "
        f"experts of d_ff {cfg.moe_d_ff}, top-{cfg.experts_per_token}"
        f"{', shared expert' if cfg.num_shared_experts else ''}; "
        f"{MOE_LAYER_TOKENS} tokens): moe_sorted vs moe_dense max abs err "
        f"{err:.3g}; router experts equal to the CPU's, weights {err_w:.3g}")
    return max(err, err_w)


def check_arch_card_vs_cpu(arch, device):
    """``arch`` at its published widths cut to NEW_ARCH_DEPTH periods:
    prefill on the card (flash kernel, one launch a layer) against the
    port on the CPU (plain attention) on the same weights and tokens,
    last logits at MODEL_TOL and finite. Returns the error."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models.model import Model
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=NEW_ARCH_DEPTH
                              * full.scan_period)
    b, s = NEW_ARCH_TOKENS
    card = Model(cfg, device=device, attn_impl="kernel", max_seq=s)
    card.init_params(torch.Generator(device=device).manual_seed(62))
    import numpy as np
    toks = torch.from_numpy(np.random.default_rng(63).integers(
        0, cfg.vocab_size, (b, s)))
    zero_counts()
    with torch.inference_mode():
        logits, _ = card.prefill({"tokens": toks.to(device)}, s)
    torch.cuda.synchronize()
    launches = attn_ops.launches
    cpu = Model(cfg, device="cpu", max_seq=s)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    del card
    torch.cuda.empty_cache()
    with torch.inference_mode():
        ref, _ = cpu.prefill({"tokens": toks}, s)
    ok, err = close(logits.cpu(), ref, *MODEL_TOL)
    if launches != cfg.num_layers or not ok or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{arch} ({cfg.num_layers} layers, published widths): prefill "
             f"on the card vs the CPU max abs err {err}, flash launches "
             f"{launches} (expected {cfg.num_layers})")
    say(f"check: {arch} at published widths, {cfg.num_layers} layers, "
        f"prefill {b} x {s}: card (flash kernel, {launches} launches) vs "
        f"the CPU, last logits max abs err {err:.3g}")
    return err


def phase_check_serving(device):
    """The flash kernel at the new archs' layer shapes, one published-width
    MoE layer of each MoE arch, and each new arch's prefill card vs CPU.
    Returns the largest flash error."""
    import torch
    flash_err = 0.0
    for i, case in enumerate(ATTN_NEW):
        err, _ = check_flash(case, device, seed=400 + i)
        flash_err = max(flash_err, err)
        say(f"check: flash attention at {case}: max abs err {err:.3g}")
        torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 matrix products: the router's top-k "
             "would not be the CPU's")
    for arch, *_ in SERVE_NEW:
        if "moe" in arch:
            check_moe_layer(arch, device)
            torch.cuda.empty_cache()
    for arch, *_ in SERVE_NEW:
        check_arch_card_vs_cpu(arch, device)
    return flash_err


def serve_new_args(arch, prompt, batch, gen):
    return ["--arch", arch, "--no-reduced", "--device", "cuda", "--batch",
            str(batch), "--prompt-len", str(prompt), "--gen", str(gen)]


def phase_serve_new():
    """``launch.serve --no-reduced`` on each new arch (SERVE_NEW), the
    launch counts zeroed just before and read just after: the flash kernel
    once per layer in the prefill, no SSD launch, finite logits, tokens in
    the vocabulary; prefill ms, decode ms/token, tokens/s, peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve
    runs = {}
    for arch, prompt, batch, gen in SERVE_NEW:
        layers = get_config(arch).num_layers      # one launch a layer
        zero_counts()
        stats = {}
        t0 = time.perf_counter()
        out = serve.main(serve_new_args(arch, prompt, batch, gen),
                         stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (attn_ops.launches, ssd_ops.launches)
        vocab = get_config(arch).vocab_size
        tok_s = batch * gen / stats["seconds"]
        say(f"main: serve {arch} --no-reduced batch {batch} prompt {prompt} "
            f"gen {gen}: {wall:.3f} s wall (set-up included), flash / SSD "
            f"launches {got}; prefill {stats['prefill_ms']:.3f} ms, decode "
            f"{stats['decode_ms_per_token']:.4f} ms/token, {tok_s:.2f} "
            f"tokens/s, peak memory {stats['peak_bytes']} B")
        if got != (layers, 0):
            fail(f"serve {arch}: launches {got}, expected ({layers}, 0)")
        if not stats.get("logits_finite"):
            fail(f"serve {arch}: a logit is not finite")
        if tuple(out.shape) != (batch, gen) or int(out.min()) < 0 or \
                int(out.max()) >= vocab:
            fail(f"serve {arch}: tokens of shape {tuple(out.shape)} in "
                 f"[{int(out.min())}, {int(out.max())}]")
        runs[arch] = dict(stats, launches=got[0], wall_s=wall,
                          tokens_per_s=tok_s, prompt=prompt, batch=batch,
                          gen=gen)
        torch.cuda.empty_cache()
    return runs


def batcher_requests(vocab):
    """BATCH_N requests drawn from BATCH_SEED: prompt lengths spread evenly
    over BATCH_PROMPT (shuffled; two pass gemma2's 4096 window), tokens
    uniform over the vocabulary, max_new_tokens in BATCH_NEW."""
    import numpy as np
    from repro_torch.serve import Request
    rs = np.random.default_rng(BATCH_SEED)
    lens = rs.permutation(np.linspace(*BATCH_PROMPT, BATCH_N).astype(int))
    new = rs.integers(BATCH_NEW[0], BATCH_NEW[1] + 1, BATCH_N)
    return [Request(uid=i, prompt=rs.integers(0, vocab, int(n)),
                    max_new_tokens=int(m))
            for i, (n, m) in enumerate(zip(lens, new))]


def recording_batcher(model, slots, max_cache_len, reqs):
    """A ContinuousBatcher with ``reqs`` submitted, whose model calls also
    keep each request's logits rows over the real vocabulary (its
    admission prefill's, then its lane's in each tick) and the CUDA events
    around each prefill and tick. Admissions follow submission order. The
    recording methods sit on ``model``; ``del model.prefill,
    model.decode_step`` takes them off (and frees the batcher with the
    model)."""
    from repro_torch.serve import ContinuousBatcher
    import torch
    b = ContinuousBatcher(model, slots=slots, max_cache_len=max_cache_len)
    vocab, rows = model.cfg.vocab_size, {}
    times = {"prefill": [], "tick": []}
    prefill, decode = model.prefill, model.decode_step

    def timed(kind, fn, *args):
        start, stop = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        start.record()
        out = fn(*args)
        stop.record()
        times[kind].append((start, stop))
        return out

    def rec_prefill(batch, max_cache_len):
        logits, cache = timed("prefill", prefill, batch, max_cache_len)
        rows[reqs[len(rows)].uid] = [logits[0, -1, :vocab].clone()]
        return logits, cache

    def rec_decode(cache, tokens, pos):
        logits, cache = timed("tick", decode, cache, tokens, pos)
        for slot, req in b.active.items():
            rows[req.uid].append(logits[slot, -1, :vocab].clone())
        return logits, cache

    model.prefill, model.decode_step = rec_prefill, rec_decode
    for req in reqs:
        b.submit(req)
    return b, rows, times


def request_rows(model, prompt, n, max_cache_len):
    """One request decoded alone at batch 1 (``make_prefill_step``, then
    n - 1 ``make_decode_step`` calls, as ``generate`` runs them): each
    step's logits over the real vocabulary."""
    import torch
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    vocab = model.cfg.vocab_size
    prefill = make_prefill_step(model, max_cache_len)
    decode = make_decode_step(model)
    tok, logits, cache = prefill(
        {"tokens": torch.as_tensor(prompt, device=model.device)[None]})
    cur, rows = tok[:, None], [logits[0, -1, :vocab]]
    for i in range(n - 1):
        cur, logits, cache = decode(cache, cur, len(prompt) + i)
        rows.append(logits[0, -1, :vocab])
    return rows


def check_request(req, got, want):
    """A batcher request's logits rows ``got`` against its own batch-1
    decoding's ``want`` (``request_rows``): every logit finite, and the
    token equal and the logits within MODEL_TOL at every step up to the
    first whose top-2 margin at batch 1 is below BATCH_MARGIN. Returns
    (max abs error, that step or None)."""
    import torch
    err = 0.0
    for j, (g, w) in enumerate(zip(got, want)):
        if not (bool(torch.isfinite(g).all())
                and bool(torch.isfinite(w).all())):
            fail(f"batcher request {req.uid} step {j}: a logit is not "
                 f"finite")
    for j, (g, w) in enumerate(zip(got, want)):
        top = torch.topk(w, 2).values
        if float(top[0] - top[1]) < BATCH_MARGIN:
            return err, j
        ok, e = close(g, w, *MODEL_TOL)
        if not ok or req.out[j] != int(torch.argmax(w)):
            fail(f"batcher request {req.uid} step {j}: token {req.out[j]} "
                 f"vs {int(torch.argmax(w))} at batch 1, logits max abs "
                 f"err {e}")
        err = max(err, e)
    return err, None


def phase_batcher(device):
    """The continuous batcher on gemma2-2b at its published widths
    (BATCH_SLOTS lanes, max_cache_len BATCH_CACHE, BATCH_N requests): the
    flash launches counted around its run alone equal 26 x BATCH_N (one
    prefill a request); then each request against its own decoding at
    batch 1 on the card: tokens equal and logits at MODEL_TOL up to the
    first step whose top-2 margin is below BATCH_MARGIN; every logit
    finite. Ticks, tokens/s, admission prefill ms, decode ms a tick."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.model import Model
    cfg = get_config(BATCH_ARCH)
    model = Model(cfg, device=device, attn_impl="kernel",
                  max_seq=BATCH_CACHE)
    model.init_params(torch.Generator(device=device).manual_seed(64))
    reqs = batcher_requests(cfg.vocab_size)
    b, rows, times = recording_batcher(model, BATCH_SLOTS, BATCH_CACHE,
                                       reqs)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = b.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (attn_ops.launches, ssd_ops.launches)
    del model.prefill, model.decode_step
    want = (cfg.num_layers * BATCH_N, 0)
    tokens = sum(len(r.out) for r in done)
    prefill_ms = [a.elapsed_time(z) for a, z in times["prefill"]]
    tick_ms = [a.elapsed_time(z) for a, z in times["tick"]]
    ticks = len(tick_ms)
    lens = sorted(len(r.prompt) for r in reqs)
    say(f"main: ContinuousBatcher {BATCH_ARCH} --no-reduced, {BATCH_SLOTS} "
        f"slots, max_cache_len {BATCH_CACHE}, {BATCH_N} requests (prompts "
        f"{lens}, max_new_tokens {[r.max_new_tokens for r in reqs]}): "
        f"{ticks} ticks, {tokens} tokens in {wall:.3f} s "
        f"({tokens / wall:.2f} tokens/s), admission prefill median "
        f"{statistics.median(prefill_ms):.3f} ms, decode "
        f"{statistics.median(tick_ms):.3f} ms a tick (median; CUDA events), "
        f"flash / SSD launches {got}")
    if got != want:
        fail(f"batcher: launches {got}, expected {want}")
    if sorted(r.uid for r in done) != list(range(BATCH_N)) or any(
            len(r.out) != r.max_new_tokens for r in done):
        fail("batcher: a request did not finish with its max_new_tokens")
    if not sum(n > cfg.sliding_window for n in lens) >= 2:
        fail(f"batcher: prompts {lens} do not pass the window twice")
    err, cut = 0.0, {}
    with torch.inference_mode():
        for req in sorted(done, key=lambda r: r.uid):
            e, stop = check_request(req, rows[req.uid], request_rows(
                model, req.prompt, req.max_new_tokens, BATCH_CACHE))
            err = max(err, e)
            if stop is not None:
                cut[req.uid] = stop
    compared = sum(cut.get(r.uid, len(r.out)) for r in done)
    say(f"check: batcher vs each request alone at batch 1 on the card: "
        f"{compared} of {tokens} steps compared, tokens equal, logits max "
        f"abs err {err:.3g}; steps where the top-2 margin fell below "
        f"{BATCH_MARGIN} (comparison stopped there): "
        f"{cut if cut else 'none'}")
    del model, b, rows
    gc.collect()              # the model's 10.5 GB must not reach the
    torch.cuda.empty_cache()  # next phases' peak memory
    return {"launches": got[0], "ticks": ticks, "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "prefill_ms_median": statistics.median(prefill_ms),
            "tick_ms_median": statistics.median(tick_ms),
            "prompt_lens": lens, "logits_max_abs_err": err,
            "margin_cut": cut}


def flash_times(case, device, card, seed):
    """The flash kernel at ``case`` (no softcap, no window) beside its
    bound, its plain version and SDPA's fastest float32 backend on the
    same tensors (``sdpa_yardstick``; CUDA events, median): its row."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    q, k, v = attn_tensors(case, device, seed=seed)
    kw = attn_kwargs(case)
    out = attn_ops.flash_attention(q, k, v, **kw)
    ms = cuda_ms(lambda: attn_ops.flash_attention(q, k, v, **kw),
                 repeats=5, inner=3)
    plain = cuda_ms(lambda: attn_ops.flash_attention_plain(q, k, v, **kw),
                    repeats=3, inner=1)
    bnd = flash_bound(case, card)
    say_kernel_time(f"flash attention {case}", ms, plain, bnd)
    lib_ms, backend = sdpa_yardstick(q, k, v, kw["scale"], out,
                                     causal=case[5])
    say(f"times: like for like at {case}: kernel {ms:.4f} ms, "
        f"scaled_dot_product_attention ({backend}) {lib_ms:.4f} ms")
    del q, k, v, out
    torch.cuda.empty_cache()
    return {"shape": list(case), "ms": ms, "plain_ms": plain,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "library_ms": lib_ms, "library_backend": backend}


def phase_times_serving(device, card):
    """The flash kernel at the new archs' layer shapes (ATTN_NEW)
    (``flash_times``)."""
    return [flash_times(case, device, card, seed=410 + i)
            for i, case in enumerate(ATTN_NEW)]


# ---------------------------------------------------------------------------
# the audio, VLM and hybrid families: whisper-large-v3, llava-next-34b,
# jamba-1.5-large-398b
# ---------------------------------------------------------------------------

def family_config(arch):
    """``arch``'s published config, with FAMILY_CUTS applied."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **FAMILY_CUTS.get(arch, {}))


def family_layers(cfg):
    """(flash, SSD) launches of one prefill of ``cfg``: one a
    self-attention, encoder and cross-attention layer; one a Mamba-2
    layer."""
    attn = sum(cfg.mixer_kind(i % cfg.scan_period) == "attn"
               for i in range(cfg.num_layers))
    enc = (cfg.encoder_layers + cfg.num_layers if cfg.is_encoder_decoder
           else 0)
    return attn + enc, cfg.num_layers - attn


def set_plain(model, plain):
    """Switch every attention and Mamba-2 sub-layer of ``model`` between
    the kernels (flash, SSD) and the plain paths (attention "auto": dense,
    or blocked past 2048 keys; the chunked SSD scan), in place."""
    from repro_torch.models.model import Attention, Mamba2
    for mod in model.modules():
        if isinstance(mod, Attention):
            mod.attn_impl = "auto" if plain else "kernel"
        elif isinstance(mod, Mamba2):
            mod.use_kernel = not plain


def leaves(tree):
    """The tensors of a nested cache, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def check_family(arch, device):
    """``arch`` (FAMILY_CUTS applied) at its published widths: one prefill
    of FAMILY_CHECK_TOKENS (frontends at the pipeline's defaults) through
    the kernels, then through the plain paths on the same model, every
    count zeroed before and read after each: flash and SSD launches one a
    layer in the first and none in the second; the last logits and every
    cache leaf at MODEL_TOL; finite. Returns the largest error."""
    import gc
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.model import Model
    from repro_torch.train.train_step import frontend_len
    cfg = family_config(arch)
    b, s = FAMILY_CHECK_TOKENS
    data = SyntheticTokens(cfg, b, s, seed=70, mode="bigram")
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(0).items()}
    batch["tokens"] = batch["tokens"][:, :s]
    cache_len = frontend_len(cfg, batch) + s
    model = Model(cfg, device=device, attn_impl="kernel",
                  use_ssd_kernel=True, max_seq=cache_len)
    model.init_params(torch.Generator(device=device).manual_seed(71))
    runs = []
    for plain in (False, True):
        set_plain(model, plain)
        zero_counts()
        with torch.inference_mode():
            last, cache = model.prefill(batch, cache_len)
        torch.cuda.synchronize()
        runs.append((last, leaves(cache),
                     (attn_ops.launches, ssd_ops.launches)))
        del cache
    (kl, kc, kn), (pl, pc, pn) = runs
    want = family_layers(cfg)
    ok, err = close(kl, pl, *MODEL_TOL)
    for a, p in zip(kc, pc):
        ok_c, e = close(a, p, *MODEL_TOL)
        ok, err = ok and ok_c, max(err, e)
    finite = bool(torch.isfinite(kl).all())
    del model, runs, kc, pc
    gc.collect()
    torch.cuda.empty_cache()
    if kn != want or pn != (0, 0) or not ok or not finite:
        fail(f"{arch}: prefill through the kernels vs the plain paths on "
             f"the card: max abs err {err} (logits and {len(pc)} cache "
             f"leaves), flash / SSD launches {kn} (expected {want}) and "
             f"{pn} (expected (0, 0)), finite {finite}")
    fe = batch.get("frontend_embeds")
    front = ("" if fe is None else f" after {fe.shape[1]} patches"
             if cfg.frontend == "vision_patches"
             else f" on {fe.shape[1]} encoder frames")
    say(f"check: {arch} ({cfg.num_layers} layers, published widths"
        f"{', cut ' + str(FAMILY_CUTS[arch]) if arch in FAMILY_CUTS else ''}"
        f"), prefill {b} x {s} tokens{front}: kernels (flash / SSD launches "
        f"{kn}) vs plain paths, last logits and every cache leaf max abs "
        f"err {err:.3g}")
    return err


def phase_check_families(device):
    """The flash kernel at ATTN_FAMILIES, the SSD kernel at SSD_FAMILIES
    (the tests' draws and Mamba-2's), and each family's prefill kernels
    vs plain paths (``check_family``). Returns (flash error, SSD error,
    model error)."""
    import torch
    flash_err = ssd_err = 0.0
    for i, case in enumerate(ATTN_FAMILIES):
        err, _ = check_flash(case, device, seed=500 + i)
        flash_err = max(flash_err, err)
        say(f"check: flash attention at {case}: max abs err {err:.3g}")
        torch.cuda.empty_cache()
    for i, case in enumerate(SSD_FAMILIES):
        for mamba2 in (False, True):
            err = check_ssd(case, device, seed=510 + i, mamba2=mamba2)
            ssd_err = max(ssd_err, err)
            draws = "Mamba-2's range" if mamba2 else "the tests' draws"
            say(f"check: SSD {case}, {draws}: max abs err {err:.3g}")
            torch.cuda.empty_cache()
    model_err = max(check_family(arch, device) for arch, *_ in FAMILY_RUNS)
    return flash_err, ssd_err, model_err


def phase_serve_families():
    """Each family served at published widths (FAMILY_RUNS): whisper and
    llava through ``launch.serve --no-reduced`` (the pipeline's 1500
    frames and 576 patches), jamba through ``launch.serve.serve`` on its
    cut config; the launch counts zeroed just before and read just after:
    flash and SSD once per layer of the prefill (``family_layers``), finite
    logits, tokens in the vocabulary; prefill ms, decode ms/token,
    tokens/s, peak memory."""
    import gc
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve
    runs = {}
    for arch, prompt, batch, gen in FAMILY_RUNS:
        cfg = family_config(arch)
        want = family_layers(cfg)
        zero_counts()
        stats = {}
        t0 = time.perf_counter()
        if arch in FAMILY_CUTS:
            out = serve.serve(cfg, reduced=False, batch=batch,
                              prompt_len=prompt, gen=gen, device="cuda",
                              log_fn=say, stats=stats)
        else:
            out = serve.main(serve_new_args(arch, prompt, batch, gen),
                             stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (attn_ops.launches, ssd_ops.launches)
        tok_s = batch * gen / stats["seconds"]
        cut = f" (cut: {FAMILY_CUTS[arch]})" if arch in FAMILY_CUTS else ""
        say(f"main: serve {arch} --no-reduced{cut}, {cfg.num_layers} layers"
            f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
            f", batch {batch} prompt {prompt} gen {gen}: {wall:.3f} s wall "
            f"(set-up included), flash / SSD launches {got}; prefill "
            f"{stats['prefill_ms']:.3f} ms, decode "
            f"{stats['decode_ms_per_token']:.4f} ms/token, {tok_s:.2f} "
            f"tokens/s, peak memory {stats['peak_bytes']} B")
        if got != want:
            fail(f"serve {arch}: launches {got}, expected {want}")
        if not stats.get("logits_finite"):
            fail(f"serve {arch}: a logit is not finite")
        if tuple(out.shape) != (batch, gen) or int(out.min()) < 0 or \
                int(out.max()) >= cfg.vocab_size:
            fail(f"serve {arch}: tokens of shape {tuple(out.shape)} in "
                 f"[{int(out.min())}, {int(out.max())}]")
        runs[arch] = dict(stats, flash_launches=got[0], ssd_launches=got[1],
                          wall_s=wall, tokens_per_s=tok_s, prompt=prompt,
                          batch=batch, gen=gen, layers=cfg.num_layers,
                          cut=FAMILY_CUTS.get(arch))
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def phase_times_families(device, card):
    """The flash kernel at ATTN_FAMILIES (``flash_times``) and the SSD
    kernel at jamba's serving shape beside its bound and plain version
    (CUDA events, median)."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain
    flash = [flash_times(case, device, card, seed=520 + i)
             for i, case in enumerate(ATTN_FAMILIES)]
    ssd = []
    case = SSD_FAMILIES[-1]
    args = ssd_tensors(*case[:5], device, seed=530, mamba2=True)
    ms = cuda_ms(lambda: ssd_ops.ssd_intra_chunk(*args, chunk=case[5]),
                 repeats=5, inner=3)
    plain = cuda_ms(lambda: ssd_intra_chunk_plain(*args, chunk=case[5]),
                    repeats=3, inner=1)
    bnd = ssd_bound(case, card)
    say_kernel_time(f"SSD intra-chunk {case}", ms, plain, bnd)
    ssd.append({"shape": list(case), "ms": ms, "plain_ms": plain,
                "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]})
    del args
    torch.cuda.empty_cache()
    return flash, ssd


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
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    clock, laps = [time.perf_counter()], {}

    def lap(name):
        """Seconds since the last lap, kept for the phases line."""
        now = time.perf_counter()
        laps[name] = round(now - clock[0], 1)
        clock[0] = now

    t0 = time.perf_counter()
    logs = _build.build()
    say(f"build: {len(logs)} kernel(s) compiled in "
        f"{time.perf_counter() - t0:.2f} s (nvcc of each source, all "
        f"started together: " + ", ".join(
            f"{n} {sec:.2f} s" for n, sec in _build.build_seconds.items())
        + ")")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                say(f"build: {name}: {line.strip()}")
    lap("build")

    main_err = phase_check(device)
    flash_err, ssd_err = phase_check_lm(device)
    lap("check: variation, lm")
    bwd_err = phase_check_train(device)
    bf16_err, bf16_shares, bf16_fwd_check = phase_check_bf16(device)
    fam_bwd_err, remat_check = phase_check_train_families(device)
    lap("check: train, bf16, families' train")
    phase_check_hvdc(device)
    delay_err = phase_check_host(device)
    phase_check_queue(device)
    lap("check: hvdc, host, queue")
    phase_check_meta(device)
    vmap_err = phase_check_lm_fitness(device)
    serving_err = phase_check_serving(device)
    fam_flash_err, fam_ssd_err, fam_model_err = phase_check_families(device)
    lap("check: meta, lm fitness, serving, families")
    launches, pop = phase_main()
    mesh_runs = phase_mesh(device, card)
    lap("main GA and mesh")
    mesh_train = phase_mesh_train(device, card)
    lap("mesh train")
    mesh_serve = phase_mesh_serve(device, card)
    lap("mesh serve")
    lm_launches = phase_serve()
    new_runs = phase_serve_new()
    batch_run = phase_batcher(device)
    family_runs = phase_serve_families()
    lap("serve")
    train_fwd, train_bwd, train_stats = phase_train()
    bf16_runs = phase_train_bf16(device)
    lap("train and bf16 train")
    family_train = phase_train_families(device)
    lap("train families")
    hvdc_runs = phase_main_hvdc()
    lap("hvdc")
    host_runs = phase_main_host()
    queue_runs = phase_main_queue(host_runs)
    lap("host and queue")
    meta_run = phase_main_meta(device)
    resize_run = phase_main_resize(device)
    lm_runs = phase_main_lm()
    ssm_stats = phase_train_ssm()
    lap("meta, resize, lm, ssm")
    kernels = [phase_times(pop, main_err, launches, device, card)]
    kernels[0]["launches_by_path"] = dict(
        {"ga_run rastrigin": launches},
        **{f"ga_run rastrigin {k}": v["launches"]
           for k, v in host_runs.items() if not k.startswith("hvdc")},
        **{f"ga_run rastrigin {k}": v["launches"]
           for k, v in queue_runs.items()},
        **{f"ga_run hvdc {k}": v["launches"] for k, v in hvdc_runs.items()},
        **{f"ga_run {k}": v["launches"] for k, v in host_runs.items()
           if k.startswith("hvdc")},
        **{"GAEngine(ctx=) one-rank NCCL mesh": mesh_runs["one_rank"],
           "ga hvdc GAEngine(ctx=) one-rank NCCL mesh": mesh_runs["hvdc"]},
        **{f"GAEngine(ctx=) {MESH_RANKS} gloo ranks, rank {r}": n
           for r, n in enumerate(mesh_runs["ranks"])},
        **{"GAEngine(ctx=) one-rank NCCL mesh, resize "
           + "->".join(map(str, RESIZE_ISLANDS)):
           mesh_runs["one_rank_resize"]},
        **{f"GAEngine(ctx=) {MESH_RANKS} gloo ranks, rank {r}, resize "
           + "->".join(map(str, RESIZE_ISLANDS)): n
           for r, n in enumerate(mesh_runs["ranks_resize"])},
        **{"meta-GA (Fig. 6)": meta_run["launches"],
           "resize " + "->".join(map(str, RESIZE_ISLANDS)):
           resize_run["launches"]})
    kernels[0]["meta"] = phase_times_meta(device, card, kernels[0]["ms"],
                                          meta_run, resize_run)
    kernels += phase_times_lm(device, card, lm_launches, flash_err, ssd_err)
    lm_paths = {f"ga_run lm {k}": v for k, v in lm_runs.items()}
    serving = {"serve gemma2-2b prefill": lm_launches["flash_attention"],
               **{f"serve {k} prefill": v["launches"]
                  for k, v in new_runs.items()},
               f"ContinuousBatcher {BATCH_ARCH} ({BATCH_N} admissions)":
               batch_run["launches"],
               **{f"serve {k} prefill": v["flash_launches"]
                  for k, v in family_runs.items()}}
    trained = {f"train {k}": v for k, v in family_train.items()}
    meshed = {f"train(mesh=) ({run}) rank {r}": n
              for run, ns in mesh_train.items()
              for r, n in enumerate(ns if isinstance(ns[0], list)
                                    else [ns])}
    served = {f"serve(mesh=) {run}": n for run, n in mesh_serve.items()}
    kernels[1]["launches"] = sum(serving.values()) + sum(
        v["flash_launches"] for v in trained.values()) + sum(
        n[0] for n in meshed.values()) + sum(served.values())
    kernels[1]["max_abs_err"] = max(flash_err, serving_err, fam_flash_err)
    kernels[1]["launches_by_path"] = {
        **serving, f"train {TRAIN_ARCH} ({TRAIN_STEPS} steps)": train_fwd,
        **{k: v["flash_launches"] for k, v in trained.items()},
        **{k: n[0] for k, n in meshed.items()}, **served,
        **{k: v["launches"] for k, v in lm_paths.items()}}
    kernels[1]["serving_shapes"] = phase_times_serving(device, card)
    fam_flash, fam_ssd = phase_times_families(device, card)
    kernels[1]["family_shapes"] = fam_flash
    ssd_paths = {"serve mamba2-780m prefill": lm_launches["ssd_chunk"],
                 **{f"serve {k} prefill": v["ssd_launches"]
                    for k, v in family_runs.items() if v["ssd_launches"]}}
    kernels[2]["launches"] = sum(ssd_paths.values())
    kernels[2]["launches_by_path"] = ssd_paths
    kernels[2]["max_abs_err"] = max(ssd_err, fam_ssd_err)
    kernels[2]["family_shapes"] = fam_ssd
    say("times: serving " + json.dumps({
        "card": card, "serve": new_runs, "batcher": batch_run,
        "families": family_runs,
        "families_kernel_vs_plain_max_abs_err": fam_model_err}))
    fwd_train, bwd_entry = phase_times_train(device, card, train_fwd,
                                             train_bwd, bwd_err, train_stats)
    kernels[1]["train_shape"] = fwd_train
    bwd_entry["launches"] += sum(v["bwd_launches"] for v in trained.values())
    bwd_entry["launches"] += sum(n[1] for n in meshed.values())
    bwd_entry["max_abs_err"] = max(bwd_err, fam_bwd_err)
    bwd_entry["launches_by_path"] = {
        f"train {TRAIN_ARCH} ({TRAIN_STEPS} steps)": train_bwd,
        **{k: v["bwd_launches"] for k, v in trained.items()},
        **{k: n[1] for k, n in meshed.items()},
        **{k: v["bwd_launches"] for k, v in lm_paths.items()}}
    bwd_entry["family_shapes"] = phase_times_train_families(
        device, card, family_train)
    bwd_entry["remat_check"] = dict(zip(
        ("grad_max_rel_err", "min_topk_margin", "peak_bytes_no_remat",
         "peak_bytes_remat"), remat_check))
    kernels.append(bwd_entry)
    bf16_bwd, bf16_fwd = phase_times_bf16(
        device, card, bf16_runs, train_stats, bf16_err, bf16_shares,
        bf16_fwd_check)
    kernels += [bf16_bwd, bf16_fwd]
    lm_times = phase_times_lm_fitness(device, card, ssm_stats)
    for entry in (kernels[1], bwd_entry):
        entry["lm_fitness"] = {
            "fitness_calls": {k: v["calls"] for k, v in lm_paths.items()},
            "launches_per_call": {n: r["launches"] for n, r in
                                  lm_times["lm_fitness"].items()},
            "vmap_grad_max_abs_err_vs_plain": vmap_err}
    lap("times: kernels, meta, serving, train, lm")
    phase_times_hvdc(hvdc_runs, device, card)
    del hvdc_runs
    lap("times: hvdc")
    kernels.append(phase_times_host(pop, device, card, host_runs, delay_err))
    phase_times_queue(pop, device, card, queue_runs)
    lap("times: host and queue")
    phase_trace(device, card)
    phase_trace_train(device, card)
    phase_trace_train(device, card, MOE_TRAIN_ARCH, MOE_TRAIN_BATCH,
                      MOE_TRAIN_SEQ, get_config(MOE_TRAIN_ARCH).num_layers)
    phase_trace_bf16_train(device, card)
    phase_trace_lm_fitness(device, card)
    lap("trace")
    say("phases (s): " + json.dumps(laps))
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
