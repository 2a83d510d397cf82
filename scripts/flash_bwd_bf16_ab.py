#!/usr/bin/env python3
"""Times variants of the bf16 flash backward source
(``src/repro_torch/kernels/attention/csrc/flash_attention_bwd_bf16.cu``)
against the source as it is, on one card, in one process.

    python3 scripts/flash_bwd_bf16_ab.py [VARIANT ...]   # default: all

A variant is a list of (old, new) text substitutions applied to a copy of
the source (VARIANTS below), built with the library's nvcc flags into
``build/flash_bwd_bf16_ab/`` (gitignored) while the library itself builds.
The source and each design variant are first held against
``flash_attention_bwd_plain`` at the card tests' bf16 tolerance (one bf16
rounding step, ``tests/torch_parity.py::bf16_grad_tol``) and for repeat
bits; ablations (``ABLATIONS``) give wrong gradients by design and are only
timed. Then at tinyllama-1.1b's and gemma2-2b's train_4k layers
(``chip_smoke.BF16_TINYLLAMA``, ``BF16_GEMMA``) each is timed with
``chip_smoke.device_ms`` in turns (the source, the variants, then the same
in reverse), and one call of each is traced: each kernel's device ms.
Needs an NVIDIA GPU with the CUDA toolkit; prints one line per result.
"""
import ctypes
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
    flash_attention_bwd_plain)

NAME = "flash_attention_bwd_bf16"
SRC = _build.SOURCES[NAME]
OUT = ROOT / "build" / "flash_bwd_bf16_ab"

CFG64 = """    static constexpr int HDP = 64, BR = 64, BN = 64, KW = 2, QW = 1, KB = 1,
                         QB = 3;"""


def cfg64(**kw):
    """Cfg<32> and Cfg<64> with the given fields changed."""
    d = dict(BR=64, BN=64, KW=2, QW=1, KB=1, QB=3)
    d.update(kw)
    return (CFG64, f"""    static constexpr int HDP = 64, BR = {d['BR']}, BN = {d['BN']}, \
KW = {d['KW']}, QW = {d['QW']}, KB = {d['KB']},
                         QB = {d['QB']};""")


PLANES = """    const float r0 = x0 - chop(x0), r1 = x1 - chop(x1);
    const float s0 = r0 - chop(r0), s1 = r1 - chop(r1);
    hi = pack(x0, x1);
    mid = pack(r0, r1);
    lo = pack(s0, s1);"""
RS_LOOP = "for (int p = 0; p < 3; ++p) wg::rs(d, pl[kk][p], b);"
VARIANTS = {
    # each plane rounded to nearest even (cvt.rn.bf16x2.f32) in place of
    # rounded toward zero: as exact
    "round_to_nearest": [(PLANES, """    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const float r0 = x0 - hf.x, r1 = x1 - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m);
    const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    mid = *reinterpret_cast<const uint32_t*>(&m);
    lo = *reinterpret_cast<const uint32_t*>(&l);""")],
    # hd <= 64: the dk/dv pass as one warpgroup a block, two blocks an SM
    # (each loads its own Q and dO)
    "dkdv_one_warpgroup": [cfg64(KW=1, KB=2)],
    # hd <= 64: the dq pass as two warpgroups sharing K and V, one block
    "dq_two_warpgroups": [cfg64(QW=2, QB=1)],
    # hd <= 64: 32 rows a dk/dv step
    "br32": [cfg64(BR=32)],
}
ABLATIONS = {
    # P and dS left as S and dP (no exp, no masks): its elementwise work
    "no_p_ds": [("""                                     float dsum, float scale, \
float cap) {""", """                                     float dsum, float scale, \
float cap) {
    if (scale != 12345.0f) return;""")],
    # one plane issued three times: the split's ALU work without its planes
    "no_split": [(PLANES, """    hi = pack(x0, x1);
    mid = hi;
    lo = hi;""")],
    # only the hi plane's product: a third of the dV, dK, dQ passes
    "one_plane": [(RS_LOOP, RS_LOOP.replace("p = 0", "p = 2"))],
    # no dV, dK, dQ products (so no P, dS or planes either)
    "no_plane_products": [(RS_LOOP, RS_LOOP.replace("p = 0", "p = 3"))],
}
# (B, Sq, T, H, KV, hd, causal, window, softcap, q_offset): the card tests'
# bf16 cases (tests/test_torch_cuda.py::BF16_BWD_CASES)
CASES = [(1, 256, 256, 8, 8, 64, True, 0, 0.0, 0),
         (2, 384, 384, 32, 4, 64, True, 0, 0.0, 0),
         (1, 300, 300, 8, 4, 256, True, 128, 50.0, 0),
         (1, 200, 200, 56, 8, 128, True, 0, 0.0, 0),
         (2, 65, 129, 4, 4, 32, False, 0, 30.0, 0),
         (1, 40, 64, 4, 2, 64, True, 16, 0.0, 64),
         (1, 70, 100, 6, 2, 32, True, 0, 0.0, 30),
         (2, 45, 77, 6, 3, 128, True, 20, 30.0, 40)]


def start_build(name, subs):
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: text not found: {old[:60]!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    cmd = [_build.nvcc_path(), *_build.flags(NAME), "-I",
           str(_build.INCLUDE_DIR), "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def launcher(lib):
    fn = getattr(ctypes.CDLL(str(lib)), "flash_attention_bwd_bf16_launch")
    fn.argtypes, fn.restype = flash._BWD_BF16_ARGTYPES, ctypes.c_int

    def call(q, k, v, out, lse, dout, *, scale, causal, window,
             attn_softcap, q_offset):
        b, sq, h, hd = q.shape
        t, kvh = k.shape[1], k.shape[2]
        dsum = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, t, h,
                 kvh, hd, float(scale), int(causal), int(window),
                 float(attn_softcap), int(q_offset),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return dq, dk, dv
    return call


def check(name, fn, device):
    """max abs error and the elements past the tolerance, at each case."""
    bad = 0
    for case in CASES:
        b, sq, t, h, kv, hd, causal, win, cap, qo = case
        gen = torch.Generator(device=device).manual_seed(sq + t)
        q, do = (torch.randn(b, sq, h, hd, generator=gen,
                             device=device).bfloat16() for _ in range(2))
        k, v = (torch.randn(b, t, kv, hd, generator=gen,
                            device=device).bfloat16() for _ in range(2))
        kw = dict(scale=hd ** -0.5, causal=causal, window=win,
                  attn_softcap=cap, q_offset=qo)
        out, lse = flash.flash_attention_fwd_cuda(q, k, v, with_lse=True,
                                                  **kw)
        got, again = fn(q, k, v, out, lse, do, **kw), fn(q, k, v, out, lse,
                                                          do, **kw)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        for a, a2, r in zip(got, again, ref):
            r = r.float()
            err = (a.float() - r).abs()
            tol = 2.0 ** -12 * float(r.abs().max()) + 2.0 ** -7 * r.abs()
            bad += int((err > tol).sum()) + int(not torch.equal(a, a2))
    print(f"check {name}: {bad} elements past the tolerance or not "
          f"repeatable over {len(CASES)} cases", flush=True)
    return bad == 0


def trace(fn, args, kw):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args, **kw)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            sym = next((s for s in cs.BF16_BWD_SYMBOLS if s in e.name),
                       e.name[:40])
            ms[sym] = ms.get(sym, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e3
    return ms


def main(names):
    every = {**VARIANTS, **ABLATIONS}
    names = names or list(every)
    builds = {n: start_build(n, every[n]) for n in names}
    _build.build([flash.KERNEL, NAME])
    fns = {"source": flash.flash_attention_bwd_cuda}
    for n, (proc, lib) in builds.items():
        log = proc.communicate()[0]
        regs = [line.split("Used")[1].strip() for line in log.splitlines()
                if "Used" in line]
        print(f"build {n}: rc {proc.returncode}; ptxas {regs}", flush=True)
        if proc.returncode == 0:
            fns[n] = launcher(lib)
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    for n, fn in fns.items():
        if n not in ABLATIONS and not check(n, fn, device):
            raise SystemExit(f"{n} disagrees with the plain version")
    for case in [cs.BF16_TINYLLAMA] + cs.BF16_GEMMA:
        q, k, v, do = cs.grad_tensors(case, device, 800)
        kw = cs.attn_kwargs(case)
        out, lse = flash.flash_attention_fwd_cuda(q, k, v, with_lse=True,
                                                  **kw)
        args = (q, k, v, out, lse, do)
        times = {n: [] for n in fns}
        for n in list(fns) + list(fns)[::-1]:
            times[n].append(cs.device_ms(lambda f=fns[n]: f(*args, **kw),
                                         launches=5, repeats=5))
        for n, fn in fns.items():
            split = {s: round(t, 4) for s, t in trace(fn, args, kw).items()}
            print(f"times {case} {n}: {statistics.mean(times[n]):.4f} ms "
                  f"(turns {[round(t, 4) for t in times[n]]}); traced "
                  f"{split}", flush=True)
        del q, k, v, do, out, lse, args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
