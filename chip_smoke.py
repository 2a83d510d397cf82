#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right and runs its main
path on the card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. card:   the GPU's name and power limit, as nvidia-smi reports them;
2. build:  every CUDA kernel of the port, compiled from this checkout's
           sources for sm_90a (one nvcc per source, all started together);
3. check:  each kernel against its plain PyTorch version on the card, at
           the reference's test shapes, a hyperparameter sweep and the main
           path's shape; and one generation on the card against the same
           generation on the CPU, replayed from the same uniforms;
4. main:   ``python -m repro_torch.launch.ga_run --fitness rastrigin`` at
           I=32 islands x P=1024 individuals x G=128 genes, 5 generations x
           3 epochs, with the kernel launch counts zeroed just before and
           read just after; then again with --sync-every 2
           --pipeline-depth 2, which must give the bit-identical best genome;
5. times:  with CUDA events, medians of repeats: the kernel beside its
           bound and its plain version, one generation phase by phase,
           and epoch seconds, generations/s and evaluations/s;
6. the ``{"kernels": [...]}`` line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Without a GPU, or outside a checkout, it exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package ``repro``.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN = dict(islands=32, pop=1024, genes=128, gens_per_epoch=5, epochs=3)
MAIN_ARGS = ["--fitness", "rastrigin", "--genes", str(MAIN["genes"]),
             "--islands", str(MAIN["islands"]), "--pop", str(MAIN["pop"]),
             "--gens-per-epoch", str(MAIN["gens_per_epoch"]),
             "--epochs", str(MAIN["epochs"]), "--device", "cuda"]
# main-path hyperparameters (launch/ga_run.py::build)
HP = dict(eta_cx=15.0, prob_cx=0.9, eta_mut=20.0, prob_mut=0.7)
BOUND = 5.12
# tolerances of tests/test_kernels.py for the genetic kernel
TOL, SWEEP_TOL = (1e-5, 1e-6), (1e-4, 1e-5)
TEST_SHAPES = [(16, 4), (64, 18), (130, 33), (256, 128)]

# Peak rates from NVIDIA's data sheets (dense, at the full 700 W limit):
# memory bytes/s and float32 (non-tensor-core) operations/s.
PEAKS = {"H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}
# float32 operations of the fused variation, counted from the source with
# each powf as ONE operation (a lower bound): per gene pair always (mask
# compares and selects), per gene pair where crossover applies, and per
# child gene where mutation applies
OPS_PAIR_GENE, OPS_CROSSOVER, OPS_MUTATION = 8, 46, 18


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(*parts):
    print(*parts, flush=True)


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


def close(a, b, rtol, atol):
    """(all close, max abs error) of two tensors, NaN-aware."""
    import torch
    err = (a - b).abs()
    both_nan = torch.isnan(a) & torch.isnan(b)
    ok = (err <= atol + rtol * b.abs()) | both_nan
    return bool(ok.all()), float(torch.where(both_nan, 0.0, err).max())


def kernel_args(rows, genes, seed, hp, bound, device, islands=None):
    """Parents (rows, genes) — or (islands, rows, genes), as the main path
    calls the wrapper — uniforms, scalars and bounds for one launch."""
    import torch
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lead = () if islands is None else (islands,)
    parents = (torch.rand(lead + (rows, genes), generator=gen, device=device)
               * 2 - 1) * bound
    rnd = draw_uniforms(gen, rows, genes, device, islands=islands)
    scalars = ops.pack_scalars(hp["eta_cx"], hp["prob_cx"], hp["eta_mut"],
                               hp["prob_mut"], hp["indpb"], device=device)
    lo = torch.full((genes,), -bound, device=device)
    hi = torch.full((genes,), bound, device=device)
    return parents, rnd, scalars, lo, hi


def check_kernel(rows, genes, seed, hp, bound, tol, device, islands=None):
    from repro_torch.kernels.genetic import ops
    args = kernel_args(rows, genes, seed, hp, bound, device, islands)
    out = ops.fused_variation(*args)
    ref = ops.fused_variation_plain(*args)
    ok, err = close(out, ref, *tol)
    inside = bool(((out >= -bound) & (out <= bound)).all())
    if not (ok and inside):
        fail(f"fused_variation kernel disagrees with its plain version at "
             f"({rows}, {genes}) hp={hp}: max abs err {err}, within bounds "
             f"{inside}")
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


def phase_times(pop, main_err, launches, device, card):
    import torch
    from repro_torch.configs.base import GAConfig
    from repro_torch.core import island, nsga2, operators
    from repro_torch.core.broker import Broker
    from repro_torch.core.engine import GAEngine
    from repro_torch.core.uniforms import GeneratorUniforms
    from repro_torch.fitness import rastrigin
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms

    i, p, g = pop.genomes.shape
    rows = i * p
    args = kernel_args(p, g, 11, dict(HP, indpb=1.0 / g), BOUND, device, i)
    kernel_ms = cuda_ms(lambda: ops.fused_variation(*args))
    plain_ms = cuda_ms(lambda: ops.fused_variation_plain(*args), repeats=5,
                       inner=2)
    mem_rate, f32_rate = next(
        (v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    nbytes = 4 * (rows * g * 4 + (rows // 2) * g * 2 + rows // 2 + rows
                  + 2 * g + 5)
    _, rnd, scalars, _, _ = args
    prob_cx, prob_mut, indpb = (float(scalars[k]) for k in (1, 3, 4))
    n_cx = int(((rnd["m_pair"] < prob_cx) & (rnd["m_gene"] < 0.5)).sum())
    n_mut = int(((rnd["m_ind"] < prob_mut) & (rnd["m_genem"] < indpb)).sum())
    nops = (OPS_PAIR_GENE * (rows // 2) * g + OPS_CROSSOVER * n_cx
            + OPS_MUTATION * n_mut)
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    say(f"times: fused_variation ({i}, {p}, {g}): kernel {kernel_ms:.5f} ms, "
        f"plain version {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}: {nbytes} bytes at {mem_rate:.3g} B/s; {nops} ops at "
        f"{f32_rate:.3g} op/s), {bound_ms / kernel_ms:.3f} of the bound")

    # one generation, phase by phase, on the main path's population
    cfg = GAConfig(num_genes=g, pop_per_island=p, num_islands=i,
                   lower=-BOUND, upper=BOUND, mutation_prob=0.7,
                   mutation_eta=20.0, crossover_prob=0.9, crossover_eta=15.0)
    broker = Broker(rastrigin)
    lo = torch.full((g,), -BOUND, device=device)
    hi = torch.full((g,), BOUND, device=device)
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
                                           args[2], lo, hi)

    def fitness():
        state["fit"] = broker.evaluate(state["off"].reshape(rows, g))[0]

    def survivors():
        nsga2.survivor_select(
            torch.cat([pop.genomes, state["off"]], 1),
            torch.cat([pop.fitness, state["fit"].reshape(i, p, 1)], 1), p)

    def migration():
        island.migrate_ring(cfg, pop, rand)

    phases = {}
    for name, fn in [("nsga2_keys", keys), ("tournament", tournament),
                     ("uniform_draws", draws), ("variation_kernel", variation),
                     ("fitness", fitness), ("survivor_select", survivors),
                     ("migration", migration)]:
        phases[name] = cuda_ms(fn, repeats=3, inner=1)
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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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
            if "registers" in line or "spill" in line:
                say(f"build: {name}: {line.strip()}")

    main_err = phase_check(device)
    launches, pop = phase_main()
    kernel = phase_times(pop, main_err, launches, device, card)
    say(json.dumps({"kernels": [kernel]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
