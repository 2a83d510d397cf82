"""Tests that need an NVIDIA GPU: each CUDA kernel against its plain
version, the wrappers' refusals, and the port's paths on the card (the GA
main path; the host pool on CUDA genomes; prefill with the kernels against prefill with their plain
versions; the serving entry point; the HVDC power flow against the same
code on the CPU).
They skip without a card. This file imports no JAX, so it runs on a
machine that has PyTorch for CUDA and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import GAConfig
from repro_torch.core import island, nsga2
from repro_torch.core.broker import Broker, CostEMA, HostPoolBackend
from repro_torch.core.population import init_population
from repro_torch.core.uniforms import ArrayUniforms
from repro_torch.fitness import delay_proxy, hostsim, rastrigin, sphere
from repro_torch.configs import get_config
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.delay import ops as delay_ops
from repro_torch.kernels.delay.ref import delay_chain_ref
from repro_torch.kernels.attention.ref import (flash_attention_blocked,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd_plain)
from repro_torch.kernels.genetic import fused_variation, ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.launch import ga_run, serve, train
from repro_torch.models.convert import cache_to_numpy
from repro_torch.models.model import Model
from repro_torch.powerflow.contingency import contingency_loadings
from repro_torch.powerflow.grid import make_german_grid, make_synthetic_grid
from repro_torch.powerflow.hvdc import apply_hvdc
from repro_torch.powerflow.newton import newton_powerflow
from repro_torch.train.train_step import reduced_train_step
from torch_parity import (ATTN_BF16_TOL, ATTN_CASES, ATTN_TOL,  # noqa: F401
                          GA_RUN_HP, GRAD_TOL, MASKED_CASE, MODEL_TOL,
                          SSD_CASES, SSD_CHUNK256_CASES, SSD_MIN_DECAY,
                          SSD_TOL, TOL, attn_grad_inputs, attn_inputs,
                          cuda_device, kernel_args, ssd_inputs, to_np)

pytestmark = pytest.mark.cuda


# (P, G, islands, kernel_args case, floats per load of the template the
# launcher must pick): G % 4 == 0 with aligned streams takes the float4
# path, any other G or an unaligned stream the scalar-load one
@pytest.mark.parametrize("p,g,islands,case,vec", [
    (16, 4, None, "ga_run", 4), (130, 33, None, "ga_run", 1),
    (256, 128, None, "ga_run", 4), (1024, 128, 4, "ga_run", 4),
    (64, 1000, None, "ga_run", 4), (64, 18, None, "ga_run", 1),
    (256, 128, None, "unaligned", 1), (130, 33, None, "unaligned", 1),
    (256, 128, None, "bounds", 4), (130, 33, None, "bounds", 1),
    (256, 128, None, "table3", 4), (64, 18, None, "table3", 1),
    (256, 128, None, "all_cross", 4), (130, 33, None, "all_cross", 1),
    (256, 128, None, "no_cross", 4), (130, 33, None, "no_cross", 1)])
def test_kernel_matches_plain_version(cuda_device, p, g, islands, case, vec):
    args = kernel_args(p, g, p + g, islands=islands, device=cuda_device,
                       case=case)
    parents, rnd, _, lo, hi = args
    assert fused_variation.template(parents, rnd, lo, hi,
                                    torch.empty_like(parents)) == (vec, 32)
    before = ops.launches
    out = ops.fused_variation(*args)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    plain = ops.fused_variation_plain(*args)      # on the card as well
    np.testing.assert_allclose(to_np(out), to_np(plain), **TOL)
    assert bool(((out >= lo) & (out <= hi)).all())


@pytest.mark.parametrize("g,vec", [(128, 4), (33, 1)])
def test_kernel_64bit_index_template(cuda_device, g, vec):
    """pairs * G >= 2^31 takes the 64-bit template. The streams alias, so
    the inputs fit on one card (~40 GB): one (R, G) tensor stands for the
    parents, u_mut and m_genem, one (R/2, G) for u_cx and m_gene. The
    first 64 rows and the last 64, which lie wholly past 2^32 elements,
    are held against the plain version."""
    pairs = -(-(1 << 31) // g) + 32
    rows = 2 * pairs
    gen = torch.Generator(device=cuda_device).manual_seed(g)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda_device)
    full, half = rand(rows, g), rand(pairs, g)
    rnd = {"u_cx": half, "m_pair": rand(pairs, 1), "m_gene": half,
           "u_mut": full, "m_ind": rand(rows, 1), "m_genem": full}
    scalars = ops.pack_scalars(*GA_RUN_HP, 0.4, device=cuda_device)
    lo = torch.full((g,), -1.0, device=cuda_device)
    hi = torch.full((g,), 1.0, device=cuda_device)
    out = ops.fused_variation(full, rnd, scalars, lo, hi)
    torch.cuda.synchronize()
    assert fused_variation.template(full, rnd, lo, hi, out) == (vec, 64)
    for first in (0, rows - 64):
        r, h = slice(first, first + 64), slice(first // 2, first // 2 + 32)
        part = {"u_cx": half[h], "m_pair": rnd["m_pair"][h],
                "m_gene": half[h], "u_mut": full[r], "m_ind": rnd["m_ind"][r],
                "m_genem": full[r]}
        plain = ops.fused_variation_plain(full[r], part, scalars, lo, hi)
        np.testing.assert_allclose(to_np(out[r]), to_np(plain), **TOL)
    del full, half, rnd, out
    torch.cuda.empty_cache()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    parents, rnd, scalars, lo, hi = kernel_args(16, 8, 1, device=cuda_device)
    before = ops.launches
    with pytest.raises(ValueError, match="float32"):
        ops.fused_variation(parents.double(), rnd, scalars, lo, hi)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_variation(parents.t().contiguous().t(), rnd, scalars,
                            lo, hi)
    with pytest.raises(ValueError, match="shape"):
        ops.fused_variation(parents, dict(rnd, m_ind=rnd["m_ind"][:8]),
                            scalars, lo, hi)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_variation(parents, rnd, scalars.cpu(), lo, hi)
    assert ops.launches == before


def test_generation_on_card_matches_cpu(cuda_device):
    cfg = GAConfig(num_genes=8, pop_per_island=16, num_islands=4,
                   lower=-5.12, upper=5.12, mutation_prob=0.7,
                   mutation_eta=20.0, crossover_prob=0.9, crossover_eta=15.0)
    rs = np.random.default_rng(0)
    draws = [rs.random(s, dtype=np.float32) for s in
             [(4, 16, 2), (4, 8, 8), (4, 8, 1), (4, 8, 8), (4, 16, 8),
              (4, 16, 1), (4, 16, 8)]]
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        broker = Broker(rastrigin)
        pop = island.evaluate_population(cfg, broker,
                                         init_population(cfg, 3, "cpu"))
        pop = pop._replace(genomes=pop.genomes.to(dev),
                           fitness=pop.fitness.to(dev))
        new, _ = island.make_generation_step(cfg, broker, dev)(
            pop, ArrayUniforms(draws, dev))
        out.append((new, nsga2.nsga2_keys(pop.fitness)[2]))
    (gpu, gkeys), (cpu, ckeys) = out
    assert torch.equal(gkeys.cpu(), ckeys)
    np.testing.assert_allclose(to_np(gpu.genomes), to_np(cpu.genomes),
                               rtol=1e-5, atol=1e-5)


def test_ga_run_on_card_launches_the_kernel(cuda_device, capsys):
    args = ["--fitness", "rastrigin", "--genes", "16", "--islands", "4",
            "--pop", "64", "--epochs", "2", "--gens-per-epoch", "3"]
    ops.launches = 0
    pop, hist = ga_run.main(args)
    assert ops.launches == 6
    assert pop.genomes.device.type == "cuda"
    ops.launches = 0
    pop2, _ = ga_run.main(args + ["--sync-every", "2",
                                  "--pipeline-depth", "2"])
    assert ops.launches == 6
    assert torch.equal(pop.genomes, pop2.genomes)
    assert hist[-1]["best"] <= hist[0]["best"]
    assert "best fitness:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _attn(shape_args, dtype, device, seed=0, t=None):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in attn_inputs(*shape_args, seed=seed, t=t)]


@pytest.mark.parametrize("b,s,h,kv,hd,causal,win,cap,dtype", ATTN_CASES)
def test_flash_kernel_matches_plain_version(cuda_device, b, s, h, kv, hd,
                                            causal, win, cap, dtype):
    q, k, v = _attn((b, s, h, kv, hd), dtype, cuda_device, seed=s)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap)
    before = attn_ops.launches
    out = attn_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attn_ops.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    plain = attn_ops.flash_attention_plain(q, k, v, **kw)
    tol = ATTN_BF16_TOL if dtype == "bfloat16" else ATTN_TOL
    np.testing.assert_allclose(to_np(out.float()), to_np(plain.float()),
                               **tol)


def test_flash_kernel_fully_masked_rows(cuda_device):
    c = MASKED_CASE
    q, k, v = _attn((c["b"], c["sq"], c["h"], c["kv"], c["hd"]), "float32",
                    cuda_device, seed=5, t=c["t"])
    kw = dict(scale=c["hd"] ** -0.5, causal=True, window=c["window"],
              q_offset=c["q_offset"])
    out = to_np(attn_ops.flash_attention(q, k, v, **kw))
    np.testing.assert_allclose(
        out, to_np(attn_ops.flash_attention_plain(q, k, v, **kw)), **ATTN_TOL)
    first_masked = c["t"] + c["window"] - 1 - c["q_offset"]
    assert np.all(out[:, first_masked:] == 0.0)


# tiling edges of the kernel (8 warps of 16 rows = 128 flattened (position,
# head) rows, 32-key tiles): G = 1, 2, 3, 4, 8; rows and keys that are not
# multiples of the tiles; a window shorter than one key tile; q_offset > 0
# with Sq < Tk; hd 32 to 256; bf16.
# (B, Sq, Tk, H, KV, hd, causal, window, softcap, q_offset, dtype)
FLASH_EDGE_CASES = [
    (1, 100, 100, 4, 4, 64, True, 0, 0.0, 0, "float32"),       # G = 1
    (2, 77, 77, 4, 2, 128, True, 0, 50.0, 0, "float32"),       # G = 2
    (1, 131, 131, 6, 2, 64, True, 20, 0.0, 0, "float32"),      # G = 3
    (1, 90, 90, 8, 2, 32, True, 0, 30.0, 0, "float32"),        # G = 4
    (1, 70, 70, 8, 1, 256, True, 0, 0.0, 0, "float32"),        # G = 8
    (1, 37, 101, 4, 2, 64, True, 0, 0.0, 64, "float32"),       # Sq < Tk
    (2, 45, 99, 6, 3, 128, True, 7, 50.0, 54, "float32"),      # window 7
    (1, 50, 83, 4, 1, 32, False, 0, 0.0, 0, "float32"),        # Tk % 32
    (1, 99, 99, 6, 2, 256, True, 40, 50.0, 0, "bfloat16"),
    (2, 33, 33, 4, 4, 128, True, 0, 0.0, 0, "bfloat16"),
]


@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,win,cap,q_offset,dtype",
                         FLASH_EDGE_CASES)
def test_flash_kernel_tiling_edges(cuda_device, b, sq, t, h, kv, hd, causal,
                                   win, cap, q_offset, dtype):
    q, k, v = _attn((b, sq, h, kv, hd), dtype, cuda_device, seed=sq + t,
                    t=t)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap,
              q_offset=q_offset)
    before = attn_ops.launches
    out = attn_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attn_ops.launches == before + 1
    plain = attn_ops.flash_attention_plain(q, k, v, **kw)
    tol = ATTN_BF16_TOL if dtype == "bfloat16" else ATTN_TOL
    np.testing.assert_allclose(to_np(out.float()), to_np(plain.float()),
                               **tol)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _attn((1, 32, 4, 2, 64), "float32", cuda_device)
    kw = dict(scale=0.125)
    before = attn_ops.launches
    with pytest.raises(ValueError, match="float32 or"):
        attn_ops.flash_attention(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="float32 or"):
        attn_ops.flash_attention(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        attn_ops.flash_attention(q.transpose(1, 2).contiguous()
                                 .transpose(1, 2), k, v, **kw)
    with pytest.raises(ValueError, match="head dim"):
        attn_ops.flash_attention(q[..., :48].contiguous(),
                                 k[..., :48].contiguous(),
                                 v[..., :48].contiguous(), **kw)
    with pytest.raises(ValueError, match="match"):
        attn_ops.flash_attention(q[:, :, :3].contiguous(), k, v, **kw)
    shifted = k.new_empty(k.numel() + 1)[1:].view(k.shape).copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        attn_ops.flash_attention(q, shifted, v, **kw)
    with pytest.raises(ValueError, match="backward kernel takes float32"):
        attn_ops.flash_attention(q.bfloat16().requires_grad_(), k.bfloat16(),
                                 v.bfloat16(), **kw)
    assert attn_ops.launches == before


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

def _grad_case(shape_args, device, seed=0, t=None):
    return [torch.from_numpy(a).to(device)
            for a in attn_grad_inputs(*shape_args, seed=seed, t=t)]


FLOAT32_ATTN = [c for c in ATTN_CASES if c[-1] == "float32"]
# the forward's float32 edges, then the backward kernel's own tiles
# (flash_attention_bwd.cu: BKV keys x BR rows, 128 x 64 at hd 32 and 64,
# 64 x 32 at hd 128, 32 x 32 at hd 256; dq partials per key tile)
BWD_EDGE_CASES = [c for c in FLASH_EDGE_CASES if c[-1] == "float32"] + [
    # Sq and T straddling a key tile (128) and a row tile (64)
    (1, 130, 130, 8, 1, 64, True, 0, 0.0, 0, "float32"),
    (2, 65, 129, 4, 4, 32, False, 0, 30.0, 0, "float32"),
    (1, 33, 97, 4, 2, 128, True, 0, 0.0, 64, "float32"),
    (1, 47, 47, 8, 4, 256, True, 0, 50.0, 0, "float32"),
    # one position's G = 3 rows split across two row tiles
    (1, 100, 100, 6, 2, 64, True, 0, 0.0, 0, "float32"),
    (1, 70, 70, 6, 2, 128, True, 0, 30.0, 0, "float32"),
    # q_offset > 0 with a window, Sq < Tk
    (1, 90, 200, 8, 2, 64, True, 50, 0.0, 110, "float32"),
    (1, 40, 150, 4, 2, 256, True, 33, 50.0, 110, "float32"),
    # row tiles wholly inside the causal limit beside diagonal ones
    (1, 320, 320, 2, 2, 64, True, 0, 0.0, 0, "float32"),
    (1, 300, 300, 4, 1, 32, True, 0, 0.0, 0, "float32"),
    (2, 200, 200, 4, 2, 128, True, 150, 0.0, 0, "float32"),
]


def _check_backward(q, k, v, do, kw):
    """The forward kernel's out and lse, then the backward kernel against
    flash_attention_bwd_plain on the same tensors."""
    from repro_torch.kernels.attention.flash import (
        flash_attention_bwd_cuda, flash_attention_fwd_cuda)
    out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    plain_out, plain_lse = flash_attention_fwd_plain(q, k, v, **kw)
    np.testing.assert_allclose(to_np(out), to_np(plain_out), **ATTN_TOL)
    np.testing.assert_allclose(to_np(lse), to_np(plain_lse), **ATTN_TOL)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(to_np(a), to_np(b), **GRAD_TOL,
                                   err_msg=name)
    return got


@pytest.mark.parametrize("b,s,h,kv,hd,causal,win,cap,dtype", FLOAT32_ATTN)
def test_flash_backward_kernel_matches_plain_version(cuda_device, b, s, h,
                                                     kv, hd, causal, win,
                                                     cap, dtype):
    q, k, v, do = _grad_case((b, s, h, kv, hd), cuda_device, seed=s)
    _check_backward(q, k, v, do, dict(scale=hd ** -0.5, causal=causal,
                                      window=win, attn_softcap=cap,
                                      q_offset=0))


@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,win,cap,q_offset,dtype",
                         BWD_EDGE_CASES)
def test_flash_backward_kernel_tiling_edges(cuda_device, b, sq, t, h, kv,
                                            hd, causal, win, cap, q_offset,
                                            dtype):
    q, k, v, do = _grad_case((b, sq, h, kv, hd), cuda_device, seed=sq + t,
                             t=t)
    _check_backward(q, k, v, do, dict(scale=hd ** -0.5, causal=causal,
                                      window=win, attn_softcap=cap,
                                      q_offset=q_offset))


def test_flash_backward_kernel_fully_masked_rows(cuda_device):
    c = MASKED_CASE
    q, k, v, do = _grad_case((c["b"], c["sq"], c["h"], c["kv"], c["hd"]),
                             cuda_device, seed=5, t=c["t"])
    dq, dk, dv = _check_backward(q, k, v, do, dict(
        scale=c["hd"] ** -0.5, causal=True, window=c["window"],
        attn_softcap=0.0, q_offset=c["q_offset"]))
    first_masked = c["t"] + c["window"] - 1 - c["q_offset"]
    assert bool((dq[:, first_masked:] == 0).all())
    assert bool(torch.isfinite(dk).all() and torch.isfinite(dv).all())


# (B, S, H, KV, hd, causal, window, softcap): tinyllama-1.1b's G = 8 at a
# reduced size, and hd 256 with a window and softcap 50 (gemma2-2b's)
@pytest.mark.parametrize("b,s,h,kv,hd,causal,win,cap", [
    (2, 384, 32, 4, 64, True, 0, 0.0),
    (1, 300, 8, 4, 256, True, 128, 50.0),
])
def test_flash_backward_kernel_is_deterministic(cuda_device, b, s, h, kv, hd,
                                                causal, win, cap):
    """Two backward calls on the same tensors give the same bits: the dq
    partials are summed in a fixed order and nothing is atomic."""
    from repro_torch.kernels.attention.flash import (
        flash_attention_bwd_cuda, flash_attention_fwd_cuda)
    q, k, v, do = _grad_case((b, s, h, kv, hd), cuda_device, seed=s)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap,
              q_offset=0)
    out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    first = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    second = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


# (B, Sq, T, H, KV, hd, causal, window, softcap, q_offset): causal with
# tinyllama-1.1b's G = 8, hd 256 with a window and softcap, q_offset > 0
# with a window, and no mask (every key tile seen by every row)
@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,win,cap,q_offset", [
    (2, 384, 384, 32, 4, 64, True, 0, 0.0, 0),
    (1, 300, 300, 8, 4, 256, True, 128, 50.0, 0),
    (1, 90, 200, 8, 2, 64, True, 50, 0.0, 110),
    (2, 200, 300, 4, 2, 32, False, 0, 30.0, 0),
])
@pytest.mark.parametrize("budget", ["one_tile", "two_tiles"])
def test_flash_backward_kernel_in_key_tile_chunks(cuda_device, monkeypatch,
                                                  b, sq, t, h, kv, hd, causal,
                                                  win, cap, q_offset, budget):
    """Where the dq partials of all key tiles would pass the scratch
    budget, the backward runs its key tiles in chunks that fit: the same
    bits as one launch, which holds against the plain version. A budget of
    0 gives chunks of one key tile, ``two_tiles`` of about two."""
    from repro_torch.kernels.attention import flash
    q, k, v, do = _grad_case((b, sq, h, kv, hd), cuda_device, seed=sq + t,
                             t=t)
    kw = dict(scale=hd ** -0.5, causal=causal, window=win, attn_softcap=cap,
              q_offset=q_offset)
    whole = _check_backward(q, k, v, do, kw)
    out, lse = flash.flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    monkeypatch.setattr(flash, "BWD_SCRATCH_BYTES",
                        0 if budget == "one_tile" else 2 * q.numel() * 4)
    chunked = flash.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), whole, chunked):
        assert torch.equal(a, b_), name


def test_flash_backward_long_sequence_scratch_is_bounded(cuda_device,
                                                         monkeypatch):
    """tinyllama-1.1b's attention at (1, 16384): the dq partials of all key
    tiles would take 17,179,869,184 bytes. Within the default budget the
    backward's device memory beyond its inputs stays under the budget plus
    its outputs and D, and it gives the bits of one launch with no
    budget."""
    from repro_torch.kernels.attention import flash
    q, k, v, do = _grad_case((1, 16384, 32, 4, 64), cuda_device, seed=16)
    kw = dict(scale=0.125, causal=True, window=0, attn_softcap=0.0,
              q_offset=0)
    out, lse = flash.flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    grads, peaks = [], []
    default = flash.BWD_SCRATCH_BYTES
    for budget in (default, 1 << 62):
        monkeypatch.setattr(flash, "BWD_SCRATCH_BYTES", budget)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        grads.append(flash.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                    **kw))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(cuda_device) - base)
    outputs = 4 * (2 * q.numel() + 2 * k.numel() + lse.numel())
    assert peaks[0] <= default + outputs, peaks
    assert peaks[1] >= 17_179_869_184, peaks
    for name, a, b_ in zip(("dq", "dk", "dv"), *grads):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b_), name


def test_flash_attention_autograd_launches_both_kernels(cuda_device):
    q, k, v, do = _grad_case((2, 96, 8, 2, 64), cuda_device, seed=3)
    kw = dict(scale=0.125, causal=True, window=40, attn_softcap=30.0)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (attn_ops.launches, attn_ops.bwd_launches)
    out = attn_ops.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (attn_ops.launches, attn_ops.bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
    ref_out = flash_attention_blocked(q, k, v, **kw)
    ref = torch.autograd.grad(ref_out, (q, k, v), do)
    np.testing.assert_allclose(to_np(out), to_np(ref_out), **ATTN_TOL)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(to_np(a), to_np(b), **GRAD_TOL)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,l,h,p,n,q,mamba2",
    [c + (False,) for c in SSD_CASES + [(2, 100, 4, 32, 16, 32)]]
    + [c + (True,) for c in SSD_CHUNK256_CASES])
def test_ssd_kernel_matches_plain_version(cuda_device, b, l, h, p, n, q,
                                          mamba2):
    """At the reference's cases, and at chunk 256 (four 64-row tiles,
    three chunks) with dt and a in Mamba-2's range, where the far tiles,
    the state loop and the recurrence between chunks carry weight."""
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in ssd_inputs(b, l, h, p, n, seed=l + n, mamba2=mamba2)]
    before = ssd_ops.launches
    y, s = ssd_ops.ssd_chunked(*arrs, q)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    y_ref, s_ref = ssd_chunked_ref(*arrs, q)
    np.testing.assert_allclose(to_np(y), to_np(y_ref), **SSD_TOL)
    np.testing.assert_allclose(to_np(s), to_np(s_ref), **SSD_TOL)
    if l % q == 0:
        from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain
        out = ssd_ops.ssd_intra_chunk(*arrs, chunk=q)
        plain = ssd_intra_chunk_plain(*arrs, chunk=q)
        for got, want in zip(out, plain):
            np.testing.assert_allclose(to_np(got), to_np(want), **SSD_TOL)
        if mamba2:
            assert float(out[2][..., -1].max()) > SSD_MIN_DECAY


# head groups (H = 3 and 5 leave a partial last group), chunk 32, 64 and
# 256, P 32 and 128, N 16: (B, L, H, P, N, chunk, mamba2)
SSD_EDGE_CASES = [
    (1, 128, 5, 64, 128, 64, False),     # groups of 2: 2 + 2 + 1
    (2, 96, 3, 64, 64, 32, False),       # groups of 2: 2 + 1
    (1, 256, 3, 32, 16, 256, True),      # a group of 3, one chunk of 256
    (2, 128, 5, 32, 16, 32, True),       # groups of 4: 4 + 1
    (1, 512, 6, 128, 128, 256, True),    # P = 128: one head per block
]


@pytest.mark.parametrize("b,l,h,p,n,q,mamba2", SSD_EDGE_CASES)
def test_ssd_kernel_head_groups_and_chunks(cuda_device, b, l, h, p, n, q,
                                           mamba2):
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in ssd_inputs(b, l, h, p, n, seed=l + h, mamba2=mamba2)]
    before = ssd_ops.launches
    out = ssd_ops.ssd_intra_chunk(*arrs, chunk=q)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    plain = ssd_intra_chunk_plain(*arrs, chunk=q)
    for got, want in zip(out, plain):
        np.testing.assert_allclose(to_np(got), to_np(want), **SSD_TOL)
    if mamba2:
        assert float(out[2][..., -1].max()) > SSD_MIN_DECAY


def test_ssd_chunked_serving_length(cuda_device):
    """mamba2-780m's serving prompt, L = 4000 (padded to 16 chunks of 256),
    with dt and a in Mamba-2's range."""
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in ssd_inputs(1, 4000, 48, 64, 128, seed=4000,
                                mamba2=True)]
    x, dt, a = arrs[:3]
    before = ssd_ops.launches
    y, s = ssd_ops.ssd_chunked(*arrs, 256)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    y_ref, s_ref = ssd_chunked_ref(*arrs, 256)
    np.testing.assert_allclose(to_np(y), to_np(y_ref), **SSD_TOL)
    np.testing.assert_allclose(to_np(s), to_np(s_ref), **SSD_TOL)
    decay = torch.exp((dt[:, :256] * a).sum(1)).max()
    assert float(decay) > SSD_MIN_DECAY


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, dt, a, bm, cm = [torch.from_numpy(t).to(cuda_device)
                        for t in ssd_inputs(1, 64, 2, 32, 16)]
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_intra_chunk(x.double(), dt, a, bm, cm, chunk=32)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_intra_chunk(x, dt, a.cpu(), bm, cm, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_intra_chunk(x, dt, a, bm.mT.contiguous().mT, cm,
                                chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd_intra_chunk(x, dt[:, :32], a, bm, cm, chunk=32)
    with pytest.raises(ValueError, match="multiple"):
        ssd_ops.ssd_intra_chunk(x, dt, a, bm, cm, chunk=48)
    shifted = x.new_empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        ssd_ops.ssd_intra_chunk(shifted, dt, a, bm, cm, chunk=32)
    with pytest.raises(ValueError, match="P in"):
        ssd_ops.ssd_intra_chunk(x[..., :8].contiguous(), dt, a, bm, cm,
                                chunk=32)
    assert ssd_ops.launches == before


def test_ssd_wrapper_refuses_inputs_that_need_a_gradient(cuda_device):
    """The kernel has no backward: under autograd its outputs would drop
    the gradient silently, so the wrapper raises instead."""
    x, dt, a, bm, cm = (torch.from_numpy(arr).to(cuda_device)
                        for arr in ssd_inputs(1, 64, 4, 32, 16, seed=2))
    before = ssd_ops.launches
    with pytest.raises(RuntimeError, match="forward only"):
        ssd_ops.ssd_intra_chunk(x.requires_grad_(), dt, a, bm, cm, chunk=32)
    with torch.no_grad():
        ssd_ops.ssd_intra_chunk(x, dt, a, bm, cm, chunk=32)
    assert ssd_ops.launches == before + 1


# ---------------------------------------------------------------------------
# the model and the serving entry point on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m"])
def test_prefill_with_kernels_matches_plain_versions(cuda_device, arch):
    cfg = get_config(arch).reduced()
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(0))
    outs = []
    for impl, ssd_kernel in (("kernel", True), ("blocked", False)):
        m = Model(cfg, device=cuda_device, attn_impl=impl,
                  use_ssd_kernel=ssd_kernel, max_seq=96)
        m.init_params(torch.Generator(device=cuda_device).manual_seed(0))
        launches = (attn_ops.launches, ssd_ops.launches)
        with torch.inference_mode():
            last, cache = m.prefill({"tokens": toks.to(cuda_device)}, 64)
        torch.cuda.synchronize()
        grew = (attn_ops.launches - launches[0],
                ssd_ops.launches - launches[1])
        outs.append((last, cache_to_numpy(cache), grew))
    (kl, kc, kgrew), (pl, pc, pgrew) = outs
    n = cfg.num_layers
    assert kgrew == ((n, 0) if arch == "gemma2-2b" else (0, n))
    assert pgrew == (0, 0)
    np.testing.assert_allclose(to_np(kl), to_np(pl), **MODEL_TOL)
    for sub in kc:
        for kind in kc[sub]:
            for leaf in kc[sub][kind]:
                np.testing.assert_allclose(kc[sub][kind][leaf],
                                           pc[sub][kind][leaf], **MODEL_TOL)


def test_serve_on_card_launches_the_kernels(cuda_device):
    for arch in ("gemma2-2b", "mamba2-780m"):
        n = get_config(arch).reduced().num_layers        # one per layer
        expect = (n, 0) if arch == "gemma2-2b" else (0, n)
        attn_ops.launches = ssd_ops.launches = 0
        stats = {}
        out = serve.serve(arch, batch=2, prompt_len=40, gen=4,
                          log_fn=lambda s: None, stats=stats)
        assert (attn_ops.launches, ssd_ops.launches) == expect
        assert out.shape == (2, 4)
        assert stats["prefill_ms"] > 0 and stats["decode_ms_per_token"] > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One train step of a reduced config, the flash kernels forward and
    backward on the card against their plain versions on the CPU; float32
    GEMMs on both (TF32 off). Gradients at GRAD_TOL scaled to each leaf's
    largest |g|, loss and grad norm at 1e-4; the parameters where the
    CPU's gradient is at least 1e-3 of its leaf's largest (AdamW's first
    step is lr x sign(g) there)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    layers = get_config(arch).reduced().num_layers
    before = (attn_ops.launches, attn_ops.bwd_launches)
    gpu = reduced_train_step(arch, cuda_device)
    torch.cuda.synchronize()
    assert (attn_ops.launches - before[0],
            attn_ops.bwd_launches - before[1]) == (2 * layers, 2 * layers)
    cpu = reduced_train_step(arch, "cpu")
    for name, g in cpu[0].items():
        np.testing.assert_allclose(
            to_np(gpu[0][name]), to_np(g), rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["atol"] * float(g.abs().max()), err_msg=name)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(gpu[1][key], cpu[1][key], rtol=1e-4,
                                   err_msg=key)
    for name, p in cpu[2].items():
        g = cpu[0][name].abs()
        sure = g >= 1e-3 * g.max()
        np.testing.assert_allclose(to_np(gpu[2][name][sure]),
                                   to_np(p[sure]), rtol=1e-4, atol=2e-6,
                                   err_msg=name)


def test_train_on_card_launches_both_kernels(cuda_device):
    n = get_config("tinyllama-1.1b").reduced().num_layers
    attn_ops.launches = attn_ops.bwd_launches = 0
    stats = {}
    train.train("tinyllama-1.1b", steps=3, batch=2, seq=64,
                log_fn=lambda s: None, stats=stats)
    assert (attn_ops.launches, attn_ops.bwd_launches) == (3 * n, 3 * n)
    assert np.all(np.isfinite(stats["loss"] + stats["grad_norm"]))
    assert stats["peak_bytes"] > 0 and len(stats["step_ms"]) == 3


def test_hvdc_newton_german_grid_card_matches_cpu(cuda_device):
    """The German-size base case (2715 buses, 18 HVDC lines) for a zero and
    an alternating +-pmax dispatch: cuSOLVER's LU on the card against
    LAPACK's on the CPU, vm and va atol 1e-4, iters and converged exact."""
    assert not torch.backends.cuda.matmul.allow_tf32
    grid = make_german_grid(0)
    genomes = torch.stack([torch.zeros(18), torch.tensor([1.0, -1.0] * 9)])
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        gridt = grid.to_torch(dev)
        pe = apply_hvdc(gridt, genomes.to(dev) * gridt["hvdc_pmax"])
        out.append(newton_powerflow(gridt, p_extra=pe, num_iters=10))
    card, cpu = out
    assert bool(cpu.converged.all())
    for field in ("vm", "va"):
        np.testing.assert_allclose(to_np(getattr(card, field)),
                                   to_np(getattr(cpu, field)), rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(to_np(card.iters), to_np(cpu.iters))
    np.testing.assert_array_equal(to_np(card.converged),
                                  to_np(cpu.converged))


def test_hvdc_islanded_outage_reads_overload_on_card(cuda_device):
    """Line 11 of the 60-bus grid cuts a degree-1 bus loose: its singular
    Jacobian reads inf/NaN through solve_ex, not an error, and the case
    reads 10.0 on every line; line 3's case agrees with the CPU."""
    grid = make_synthetic_grid(n_bus=60, n_line=110, n_gen=15, n_hvdc=4,
                               seed=1)
    out = [contingency_loadings(grid.to_torch(dev),
                                torch.tensor([11, 3], device=dev))
           for dev in (cuda_device, torch.device("cpu"))]
    assert bool((out[0][:, 0] == 10.0).all())
    assert bool((out[0][:, 1] < 10.0).all())
    np.testing.assert_allclose(to_np(out[0]), to_np(out[1]), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# delay chain kernel and the host pool on the card
# ---------------------------------------------------------------------------

def _delay_inputs(n, iters, device, seed=0):
    rs = np.random.default_rng(seed)
    acc0 = torch.tensor(1.0 + rs.uniform(-1, 1, n) * 1e-3,
                        dtype=torch.float32, device=device)
    counts = (rs.integers(0, 2001, n) if iters == "hetero"
              else np.full(n, int(iters)))
    return acc0, torch.tensor(counts, dtype=torch.int32, device=device)


@pytest.mark.parametrize("n", [1, 33, 32768])
@pytest.mark.parametrize("iters", ["0", "1", "1000", "hetero"])
def test_delay_kernel_matches_plain_version(cuda_device, n, iters):
    """rtol 1e-6: both sides run CUDA's sinf and round the product, then
    the sum, step by step."""
    acc0, counts = _delay_inputs(n, iters, cuda_device, seed=n)
    out = delay_ops.delay_chain(acc0, counts)
    torch.cuda.synchronize()
    ref = delay_chain_ref(acc0, counts)
    np.testing.assert_allclose(to_np(out), to_np(ref), rtol=1e-6, atol=0)
    if iters == "0":
        assert torch.equal(out, acc0)


def test_delay_wrapper_counts_launches_and_refuses(cuda_device):
    acc0, counts = _delay_inputs(64, "hetero", cuda_device)
    before = delay_ops.launches
    delay_ops.delay_chain(acc0, counts)
    delay_ops.delay_chain(acc0, counts)
    assert delay_ops.launches == before + 2
    for bad in (counts.to(torch.int64), counts.cpu(), counts[:10],
                counts.repeat(2)[::2]):
        with pytest.raises(ValueError, match="delay_chain"):
            delay_ops.delay_chain(acc0, bad)
    assert delay_ops.launches == before + 2


def test_delay_proxy_on_card_keeps_the_fitness(cuda_device):
    g = torch.tensor(np.random.default_rng(1).uniform(-1, 1, (96, 8)),
                     dtype=torch.float32, device=cuda_device)
    before = delay_ops.launches
    out = delay_proxy(sphere, flop_iters=500)(g)
    assert delay_ops.launches == before + 1
    assert torch.equal(out, sphere(g))


@pytest.mark.parametrize("cost", ["none", "static", "ema"])
def test_host_pool_evaluates_cuda_genomes_in_row_order(cuda_device, cost):
    """Genomes on the card, fitness on the host's cores: the result comes
    back on the card, in row order, bit-equal to the simulator on the
    genomes copied to the host (29 rows over 4 workers: padded)."""
    g = torch.tensor(np.random.default_rng(2).uniform(-5, 5, (29, 16)),
                     dtype=torch.float32, device=cuda_device)
    cost_fn = {"none": None,
               "static": lambda x: torch.sum(torch.abs(x), -1),
               "ema": CostEMA(prime_fn=lambda x: torch.sum(torch.abs(x),
                                                           -1))}[cost]
    with HostPoolBackend(hostsim.rastrigin, num_workers=4) as backend:
        broker = Broker(cost_fn=cost_fn, num_workers=4, backend=backend)
        for _ in range(2):
            fit, stats = broker.evaluate(g)
            assert fit.device == g.device and fit.dtype == torch.float32
            np.testing.assert_array_equal(
                to_np(fit), hostsim.rastrigin(g.cpu().numpy()))
    if cost == "ema":
        assert cost_fn.updates == 2
