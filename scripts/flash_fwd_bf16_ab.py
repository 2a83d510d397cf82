#!/usr/bin/env python3
"""Times variants of the bf16 flash forward source
(``src/repro_torch/kernels/attention/csrc/flash_attention_fwd_bf16.cu``)
against the source as it is, on one card, in one process; or the bf16
train_4k steps of another checkout against this one's.

    python3 scripts/flash_fwd_bf16_ab.py [VARIANT ...]    # default: all
    python3 scripts/flash_fwd_bf16_ab.py source           # no variant
    python3 scripts/flash_fwd_bf16_ab.py --steps PARENT   # PARENT: a checkout

A variant is a list of (file, old, new) text substitutions applied to a
copy of the source or of its header ``wgmma_bf16.cuh`` (VARIANTS below),
built with the library's nvcc flags into ``build/flash_fwd_bf16_ab/``
(gitignored; the copied header is found beside the source first) while the
library itself builds. ptxas's register and spill lines of each build are
printed. The source and each design variant are first held against
``flash_attention_fwd_plain`` at one bf16 rounding step for the output
(``chip_smoke.GRAD_TOL``) and at 1e-5 relative plus 1e-5 absolute for lse,
with repeat calls bit-equal and fully masked rows 0; ablations
(``ABLATIONS``) give wrong outputs by design and are only timed. Then at
tinyllama-1.1b's and gemma2-2b's train_4k layers (``chip_smoke.
BF16_TINYLLAMA``, ``BF16_GEMMA``) each is timed with lse (the training
path's call) with ``chip_smoke.cuda_ms`` in turns (the source, the
variants, then the same in reverse), beside the bound, the plain version
and, at tinyllama's, SDPA's cuDNN bf16 forward.

``--steps PARENT`` runs ``chip_smoke.bf16_train_run`` for each BF16_TRAIN
arch in a process of its own per checkout, in turns (PARENT, this
checkout, this checkout, PARENT), and prints each run's step ms (median of
steps 2-N), first loss and peak memory.
Needs an NVIDIA GPU with the CUDA toolkit; prints one line per result.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    flash_attention_fwd_plain)

NAME = flash.FWD_BF16_KERNEL
SRC = _build.SOURCES[NAME]
HEADER = _build.INCLUDE_DIR / "wgmma_bf16.cuh"
OUT = ROOT / "build" / "flash_fwd_bf16_ab"


def cfg(hd, line):
    """Cfg<hd>'s fields replaced by ``line``."""
    old = next(s for s in SRC.read_text().split("template <> struct Cfg<")
               if s.startswith(f"{hd}>"))
    old = old.split("\n")[1]
    return ("src", old, f"    static constexpr int {line};")


RS_LOOP = "for (int p = 0; p < 3; ++p) wg::rs(d, pl[kk][p], b);"
# the loop from its first line to the line after it (the source as it is)
LOOP = (SRC.read_text().split("    // one commit group a tile")[1]
        .split("    tf32x3::cp_async_wait<0>();        // the Q copy")[0])
LOOP = "    // one commit group a tile" + LOOP
# FA3's intra-warpgroup overlap: S of tile it + 1 is issued before P V of
# tile it, and its softmax runs while P V is in flight (wgmma.wait_group
# 1); three stages, so that tiles it and it + 1 stay while it + 2 lands.
# One warpgroup a block (every tile of the block's range has rows)
OVERLAP_LOOP = """    static_assert(C::NW == 1, "one warpgroup a block");
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (s < nsteps) issue((int)k_lo + s * BN, s);
        else tf32x3::cp_async_commit();
    }
    auto tile_at = [&](int it, int& kb, int& kmax) -> bool {
        kb = (int)k_lo + it * BN;
        kmax = a.tk - kb < BN ? a.tk - kb : BN;
        return kmax == BN && wr0 + 64 <= rows.total &&
               (!a.causal || kb + BN - 1 <= p_lo) &&
               (a.window <= 0 || p_hi - kb < a.window);
    };
    float sc[NS], corr[2];
    if (nsteps > 0) {
        tf32x3::cp_async_wait<1>();
        fence_async_smem();
        block_sync<NT>();
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            wg::ss(sc, wg::kdesc(Qs, BQ, 0, kk), wg::kdesc(Ks, BN, 0, kk), kk);
        wg::commit();
        wg::wait<0>();
        wg::hold(sc);
        int kb, kmax;
        const bool full = tile_at(0, kb, kmax);
        sm_rows.tile(sc, corr, !full, pos, ra, rows.total, kb, kmax, t);
    }
    for (int it = 0; it < nsteps; ++it) {
        const bool more = it + 1 < nsteps;
        tf32x3::cp_async_wait<0>();
        fence_async_smem();
        block_sync<NT>();
        if (it + 2 < nsteps)
            issue((int)k_lo + (it + 2) * BN, (it + 2) % STAGES);
        else tf32x3::cp_async_commit();
        float sn[NS];
        if (more) {
            const uint8_t* Kn = Ks + ((it + 1) % STAGES) * tile_bytes<HD>(BN);
            wg::fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                wg::ss(sn, wg::kdesc(Qs, BQ, 0, kk), wg::kdesc(Kn, BN, 0, kk),
                       kk);
            wg::commit();
        }
        const uint8_t* Vt = Vs + (it % STAGES) * tile_bytes<HD>(BN);
        uint32_t pl[BN / 16][3][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                split3(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1],
                       pl[kk][2][i], pl[kk][1][i], pl[kk][0][i]);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            const uint64_t bd = wg::mdesc(Vt, BN, kk);
#pragma unroll
            for (int p = 0; p < 3; ++p) wg::rs(o, pl[kk][p], bd);
        }
        wg::commit();
        if (more) {
            wg::wait<1>();
            wg::hold(sn);
            int kb, kmax;
            const bool full = tile_at(it + 1, kb, kmax);
            sm_rows.tile(sn, corr, !full, pos, ra, rows.total, kb, kmax, t);
        }
        wg::wait<0>();
        wg::hold(o);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    asm volatile("" :: "r"(pl[kk][p][i]) : "memory");
        if (more) {
#pragma unroll
            for (int j = 0; j < ND / 4; ++j) {
                o[4 * j] *= corr[0];
                o[4 * j + 1] *= corr[0];
                o[4 * j + 2] *= corr[1];
                o[4 * j + 3] *= corr[1];
            }
#pragma unroll
            for (int i = 0; i < NS; ++i) sc[i] = sn[i];
        }
    }
"""
STAGES3 = ("src", "constexpr int STAGES = 2;", "constexpr int STAGES = 3;")
RESCALE = """        sm_rows.tile(sc, corr, !full, pos, ra, rows.total, kb, kmax, t);
#pragma unroll
        for (int j = 0; j < ND / 4; ++j) {
            o[4 * j] *= corr[0];
            o[4 * j + 1] *= corr[0];
            o[4 * j + 2] *= corr[1];
            o[4 * j + 3] *= corr[1];
        }
"""
VARIANTS = {
    # hd <= 64: two warpgroups a block sharing the key tiles, one block
    "hd64_two_warpgroups": [cfg(64, "BN = 64, NW = 2, NB = 1")],
    # hd <= 64: 128 keys a step
    "hd64_bn128": [cfg(64, "BN = 128, NW = 1, NB = 2")],
    # hd 256: two warpgroups a block sharing the key tiles, one block
    "hd256_two_warpgroups": [cfg(256, "BN = 32, NW = 2, NB = 1")],
    # hd 256: two warpgroups, 64 keys a step (spills)
    "hd256_bn64": [cfg(256, "BN = 64, NW = 2, NB = 1")],
    # two key tiles copied ahead of the one in use
    "stages3": [STAGES3],
    # O rescaled only where a row of the warp has a correction other than 1
    # (a warp vote; the max of most rows stops moving after a few tiles)
    "skip_rescale": [("src", RESCALE, RESCALE.replace(
        "#pragma unroll\n", "        if (__any_sync(0xffffffffu, corr[0] != "
        "1.0f || corr[1] != 1.0f)) {\n#pragma unroll\n", 1) + "        }\n")],
    # FA3's intra-warpgroup overlap (OVERLAP_LOOP)
    "overlap": [("src", LOOP, OVERLAP_LOOP), STAGES3],
}
ABLATIONS = {
    # only P's hi plane into V: a third of the P V passes, P rounded
    # toward zero to bf16 (what a one-plane kernel costs)
    "one_plane": [("header", RS_LOOP, RS_LOOP.replace("p = 0", "p = 2"))],
    # the softcap's scaling without its tanhf (what the accurate tanhf costs)
    "no_tanh": [("src", "s[i] = tanhf(s[i] * pre);", "s[i] = s[i] * pre;")],
}
# (B, Sq, T, H, KV, hd, causal, window, softcap, q_offset): the card
# tests' bf16 forward cases (tests/test_torch_cuda.py), fully masked rows
# (window 16, q_offset 64, rows from 15 on see no key)
CASES = [(1, 256, 256, 8, 8, 64, True, 0, 0.0, 0),
         (1, 99, 99, 6, 2, 256, True, 40, 50.0, 0),
         (2, 33, 33, 4, 4, 128, True, 0, 0.0, 0),
         (2, 384, 384, 32, 4, 64, True, 0, 0.0, 0),
         (1, 300, 300, 8, 4, 256, True, 128, 50.0, 0),
         (1, 200, 200, 56, 8, 128, True, 0, 0.0, 0),
         (2, 65, 129, 4, 4, 32, False, 0, 30.0, 0),
         (1, 32, 64, 4, 2, 64, True, 16, 0.0, 64),
         (1, 70, 100, 6, 2, 32, True, 0, 0.0, 30),
         (2, 45, 77, 6, 3, 128, True, 20, 30.0, 40)]
LSE_TOL = (1e-5, 1e-5)


def start_build(name, subs):
    texts = {"src": SRC.read_text(), "header": HEADER.read_text()}
    for where, old, new in subs:
        if old not in texts[where]:
            raise SystemExit(f"variant {name}: text not found in {where}: "
                             f"{old[:60]!r}")
        texts[where] = texts[where].replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    src, lib = d / SRC.name, d / f"lib{name}.so"
    src.write_text(texts["src"])
    (d / HEADER.name).write_text(texts["header"])
    cmd = [_build.nvcc_path(), *_build.flags(NAME), "-I",
           str(_build.INCLUDE_DIR), "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def launcher(lib):
    fn = getattr(ctypes.CDLL(str(lib)), "flash_attention_fwd_bf16_launch")
    fn.argtypes, fn.restype = flash._ARGTYPES, ctypes.c_int

    def call(q, k, v, *, scale, causal, window, attn_softcap, q_offset,
             with_lse=True):
        b, sq, h, hd = q.shape
        t, kvh = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, sq, t, h, kvh, hd, float(scale),
                 int(causal), int(window), float(attn_softcap),
                 int(q_offset), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out, lse
    return call


def ptxas(log):
    """Each kernel's registers and spills, by head dim (the template
    argument in the entry's mangled name, ``...ILi64EEv...``)."""
    out, hd = [], "?"
    for line in log.splitlines():
        if "entry function" in line:
            hd = line.split("ILi")[1].split("E")[0] if "ILi" in line else "?"
        elif "Used" in line or "spill" in line:
            out.append(f"hd {hd}: " + (line.split("Used")[1] if "Used" in line
                                       else line.split(":", 1)[-1]).strip())
    return out


def check(name, fn, device):
    """Elements past the tolerances, or not repeatable, at each case."""
    bad, worst = 0, (0.0, 0.0)
    for case in CASES:
        b, sq, t, h, kv, hd, causal, win, cap, qo = case
        gen = torch.Generator(device=device).manual_seed(sq + t)
        q = torch.randn(b, sq, h, hd, generator=gen, device=device).bfloat16()
        k, v = (torch.randn(b, t, kv, hd, generator=gen,
                            device=device).bfloat16() for _ in range(2))
        kw = dict(scale=hd ** -0.5, causal=causal, window=win,
                  attn_softcap=cap, q_offset=qo)
        (out, lse), (out2, lse2) = fn(q, k, v, **kw), fn(q, k, v, **kw)
        ref, rlse = flash_attention_fwd_plain(q, k, v, **kw)
        r = ref.float()
        err = (out.float() - r).abs()
        rtol, atol = cs.GRAD_TOL["bfloat16"]
        bad += int((err > atol * float(r.abs().max()) + rtol * r.abs()).sum())
        lerr = (lse - rlse).abs()
        bad += int((lerr > LSE_TOL[1] + LSE_TOL[0] * rlse.abs()).sum())
        bad += int(not (torch.equal(out, out2) and torch.equal(lse, lse2)))
        if win and causal and qo:
            bad += int(not bool((out[:, t + win - 1 - qo:] == 0).all()))
        worst = (max(worst[0], float(err.max())),
                 max(worst[1], float((lerr / rlse.abs().clamp_min(1.0))
                                     .max())))
        same = float((out == ref).float().mean())
        print(f"check {name} {case}: out max abs err {float(err.max()):.3g}, "
              f"{same:.4f} bit-equal; lse max abs err "
              f"{float(lerr.max()):.3g}", flush=True)
    print(f"check {name}: {bad} elements past the tolerances, not "
          f"repeatable or not 0 where masked, over {len(CASES)} cases; "
          f"worst out {worst[0]:.3g}, lse rel {worst[1]:.3g}", flush=True)
    return bad == 0


def main(names):
    every = {**VARIANTS, **ABLATIONS}
    names = (list(every) if not names else
             [] if names == ["source"] else names)
    builds = {n: start_build(n, every[n]) for n in names}
    logs = _build.build([flash.KERNEL, NAME])
    for n, log in logs.items():
        print(f"build {n}: ptxas {ptxas(log)}", flush=True)
    fns = {"source": lambda q, k, v, **kw: flash.flash_attention_fwd_cuda(
        q, k, v, with_lse=True, **kw)}
    for n, (proc, lib) in builds.items():
        log = proc.communicate()[0]
        print(f"build {n}: rc {proc.returncode}; ptxas {ptxas(log)}",
              flush=True)
        if proc.returncode == 0:
            fns[n] = launcher(lib)
        else:
            print(log[-3000:], flush=True)
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    good = {n: fn for n, fn in fns.items()
            if n in ABLATIONS or check(n, fn, device)}
    if "source" not in good:
        raise SystemExit("the source disagrees with the plain version")
    for case in [cs.BF16_TINYLLAMA] + cs.BF16_GEMMA:
        q, k, v = cs.attn_tensors(case, device, 800)
        kw = cs.attn_kwargs(case)
        times = {n: [] for n in good}
        for n in list(good) + list(good)[::-1]:
            times[n].append(cs.cuda_ms(lambda f=good[n]: f(q, k, v, **kw),
                                       repeats=5, inner=3))
        bnd = cs.flash_fwd_bf16_bound(case, card)
        plain = cs.cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, **kw),
                           repeats=3, inner=1)
        for n in good:
            ms = statistics.mean(times[n])
            print(f"times {case} {n}: {ms:.4f} ms (turns "
                  f"{[round(t, 4) for t in times[n]]}), "
                  f"{bnd['bound_ms'] / ms:.3f} of the {bnd['bound_ms']:.4f} "
                  f"ms bound; plain version {plain:.4f} ms", flush=True)
        if not case[6] and not case[7]:
            out = good["source"](q, k, v, **kw)[0]
            sdpa, backend = cs.sdpa_yardstick(q, k, v, kw["scale"], out)
            print(f"times {case}: fastest SDPA bf16 forward {backend} "
                  f"{sdpa:.4f} ms", flush=True)
        del q, k, v
        torch.cuda.empty_cache()


STEP_RUN = """
import json, sys, torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as cs
device = torch.device("cuda", 0)
for arch, kw in cs.BF16_TRAIN.items():
    r = cs.bf16_train_run(arch, device, **kw)
    print("STEP " + json.dumps(dict(arch=arch, step_ms=r["step_ms"],
          loss1=r["losses"][0], peak=r["peak_bytes"])), flush=True)
"""


def steps(parent):
    """bf16 train_4k steps of ``parent`` and of this checkout, in turns."""
    print(f"card: {cs.card_line()}", flush=True)
    runs = {}
    for tree in (parent, ROOT, ROOT, parent):
        root = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, "-c",
                               STEP_RUN.format(root=root)], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"{root}: rc {proc.returncode}")
        for line in proc.stdout.splitlines():
            if line.startswith("STEP "):
                r = json.loads(line[5:])
                runs.setdefault((root, r["arch"]), []).append(r)
                print(f"steps {'parent' if tree is parent else 'change'} "
                      f"{line[5:]}", flush=True)
    for (root, arch), rs in runs.items():
        print(f"steps mean {root} {arch}: "
              f"{statistics.mean(r['step_ms'] for r in rs):.3f} ms", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--steps"]:
        steps(sys.argv[2])
    else:
        main(sys.argv[1:])
