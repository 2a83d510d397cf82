"""Shared helpers for the parity tests of ``repro_torch`` against the JAX
reference package (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays. JAX runs on the CPU. Where the reference draws random
numbers from a key, the helpers re-derive the same draws from the same
keys, so the port can be fed them through ``ArrayUniforms``. JAX is
imported only inside those helpers, so the tests that need a card
(``tests/test_torch_cuda.py``) run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

# tolerances of tests/test_kernels.py (genetic kernel, lines 30-31, 44-45)
TOL = dict(rtol=1e-5, atol=1e-6)
SWEEP_TOL = dict(rtol=1e-4, atol=1e-5)
# flash attention (tests/test_kernels.py:75): float32 3e-5, bfloat16 2e-2
ATTN_TOL = dict(rtol=3e-5, atol=3e-5)
ATTN_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# flash attention gradients (tests/test_kernels.py:96-97, the reference's
# kernel gradient against the dense one): dq, dk, dv
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
# the bfloat16 backward kernel against its plain version on the same
# inputs: both compute in float32 and round once, so one bf16 rounding
# step elementwise (2^-7 of the value) plus the float32 sums' own
# difference, 2^-12 of the gradient's largest magnitude
BF16_GRAD_RTOL, BF16_GRAD_ATOL_FRAC = 2.0 ** -7, 2.0 ** -12


def bf16_grad_tol(ref) -> dict:
    """``assert_allclose`` keywords for a bf16 gradient against ``ref``."""
    return dict(rtol=BF16_GRAD_RTOL, atol=BF16_GRAD_ATOL_FRAC
                * float(ref.float().abs().max()))
# the bf16 forward kernel against its plain version on the same inputs:
# the output at one rounding step (``bf16_grad_tol``: both compute in
# float32 and round once), its float32 lse at 1e-5 (the float32 sums'
# order, the base-2 exponentials' round-off)
BF16_LSE_TOL = dict(rtol=1e-5, atol=1e-5)
# SSD chunked scan (tests/test_kernels.py:122-125)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
# whole model (tests/test_models_smoke.py:74-99): logits and caches 2e-4,
# decode past the window through the ring cache 3e-4
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
RING_TOL = dict(rtol=3e-4, atol=3e-4)

# tests/test_kernels.py:53-61, dtype by name:
# (B, S, H, KV, hd, causal, window, softcap, dtype)
ATTN_CASES = [
    (2, 256, 8, 4, 64, True, 0, 0.0, "float32"),
    (1, 200, 4, 4, 32, True, 50, 0.0, "float32"),
    (2, 128, 8, 2, 64, False, 0, 30.0, "float32"),
    (1, 384, 6, 2, 128, True, 100, 50.0, "float32"),
    (1, 256, 8, 8, 64, True, 0, 0.0, "bfloat16"),
    (1, 160, 4, 1, 256, True, 0, 0.0, "float32"),   # MQA, gemma head_dim
]
# a q_offset that leaves rows fully masked: queries at 64..95 against keys
# 0..63 with window 16, so every query at position >= 79 sees no key
MASKED_CASE = dict(b=1, sq=32, t=64, h=4, kv=2, hd=64, window=16,
                   q_offset=64)

# tests/test_kernels.py:103-108: (B, L, H, P, N, chunk)
SSD_CASES = [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 8, 64, 128, 64),
    (2, 96, 2, 32, 64, 32),
    (1, 64, 4, 128, 128, 64),
]
# mamba2-780m's chunk 256 over three chunks (whole, and padded), with
# ssd_inputs(mamba2=True): the far 64-row tiles of a chunk and the
# recurrence between chunks carry weight there. The largest chunk decay
# exp(cum_Q) must exceed SSD_MIN_DECAY.
SSD_CHUNK256_CASES = [(1, 768, 48, 64, 128, 256), (1, 700, 48, 64, 128, 256)]
SSD_MIN_DECAY = 1e-4

UNIFORM_KEYS = ("u_cx", "m_pair", "m_gene", "u_mut", "m_ind", "m_genem")


def np32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def to_torch(x, device="cpu") -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# fused variation hyperparameters (eta_cx, prob_cx, eta_mut, prob_mut):
# launch/ga_run.py's, and the paper's Table 3 (its HVDC runs,
# repro/launch/ga_run.py:222-223)
GA_RUN_HP = (15.0, 0.9, 20.0, 0.7)
TABLE3_HP = (97.5, 1.0, 34.6, 0.7)
#: kernel_args cases: ga_run's point; Table 3's; per-gene bounds with
#: lo != -hi; parents contiguous but not 16-byte aligned (a view at element
#: offset 1); every pair-gene crossing, and none, each with indpb 0.4
VARIATION_CASES = ("ga_run", "table3", "bounds", "unaligned", "all_cross",
                   "no_cross")


def gene_bounds(g, seed):
    """Per-gene float32 bounds (lo, hi), lo in [-3, 0.5), hi - lo in
    [0.5, 4)."""
    rs = np.random.default_rng(seed)
    lo = rs.uniform(-3.0, 0.5, g)
    return np32(lo), np32(lo + rs.uniform(0.5, 4.0, g))


def kernel_args(p, g, seed, islands=None, device="cpu", case="ga_run"):
    """Parents (numpy seed), uniforms (torch seed), scalars and bounds for
    one ``ops.fused_variation`` call, at the main path's hyperparameters
    unless ``case`` (one of VARIATION_CASES) says otherwise."""
    from repro_torch.kernels.genetic import ops
    from repro_torch.kernels.genetic.ref import draw_uniforms
    if case not in VARIATION_CASES:
        raise ValueError(f"unknown case {case!r}")
    rs = np.random.default_rng(seed)
    lead = () if islands is None else (islands,)
    lo, hi = (gene_bounds(g, seed + 1) if case == "bounds"
              else (np.full(g, -1, np.float32), np.full(g, 1, np.float32)))
    parents = to_torch(rs.uniform(lo, hi, lead + (p, g)).astype(np.float32),
                       device)
    if case == "unaligned":
        buf = torch.empty(parents.numel() + 1, device=device)
        parents = buf[1:].view(parents.shape).copy_(parents)
    gen = torch.Generator().manual_seed(seed)
    rnd = {k: v.to(device) for k, v in
           draw_uniforms(gen, p, g, "cpu", islands=islands).items()}
    if case == "all_cross":
        rnd["m_pair"].zero_()
        rnd["m_gene"].zero_()
    elif case == "no_cross":
        rnd["m_gene"].fill_(0.75)
    hp = TABLE3_HP if case == "table3" else GA_RUN_HP
    indpb = 0.4 if case in ("all_cross", "no_cross") else 1.0 / g
    scalars = ops.pack_scalars(*hp, indpb, device=device)
    return (parents, rnd, scalars, to_torch(lo, device),
            to_torch(hi, device))


def attn_inputs(b, sq, h, kv, hd, seed=0, t=None):
    """float32 numpy q (B, Sq, H, hd), k/v (B, T, KV, hd)."""
    rs = np.random.default_rng(seed)
    t = sq if t is None else t
    return tuple(rs.standard_normal(shape).astype(np.float32) for shape in
                 ((b, sq, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def attn_grad_inputs(b, sq, h, kv, hd, seed=0, t=None):
    """float32 numpy q, k, v (``attn_inputs``) and an output gradient dO
    (B, Sq, H, hd)."""
    q, k, v = attn_inputs(b, sq, h, kv, hd, seed=seed, t=t)
    rs = np.random.default_rng(seed + 1000)
    return q, k, v, rs.standard_normal(q.shape).astype(np.float32)


def ssd_inputs(b, l, h, p, n, seed=0, mamba2=False):
    """float32 numpy (x, dt, a, b_mat, c_mat) distributed as
    tests/test_kernels.py draws them: dt softplus'd, a = -exp(0.3 z), so
    the decay is ~exp(-0.8) per step. With ``mamba2``, dt and a are drawn
    in the range of Mamba-2's own initialisation: dt log-uniform in
    [1e-3, 1e-1], a = -U(1, 16) with one head per 1/H stratum of the range
    and the first head at its slow end, a = -1 (with few heads a stratum
    is wide: at H = 8 the slowest spans [1, 2.9], where a chunk can decay
    below 1e-4), so a 256-step chunk's decay stays above 0 on the slow
    heads whatever H."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((b, l, h, p)) * 0.5
    if mamba2:
        dt = np.exp(rs.uniform(np.log(1e-3), np.log(1e-1), (b, l, h)))
        u = rs.random(h)
        u[0] = 0.0
        a = -(1.0 + 15.0 * (np.arange(h) + u) / h)
    else:
        dt = np.logaddexp(rs.standard_normal((b, l, h)), 0.0)
        a = -np.exp(rs.standard_normal(h) * 0.3)
    bm = rs.standard_normal((b, l, n)) * 0.3
    cm = rs.standard_normal((b, l, n)) * 0.3
    return tuple(np32(v) for v in (x, dt, a, bm, cm))


def frontend_embeds(cfg, b, rs) -> dict:
    """``frontend_embeds`` as the reference's
    ``tests/test_models_smoke.py::make_batch`` shapes them (8 VLM patches,
    ``encoder_seq`` whisper frames, N(0, 0.02)), float32 drawn with numpy
    from the generator ``rs``; {} for an arch without a frontend."""
    n = (8 if cfg.frontend == "vision_patches"
         else cfg.encoder_seq if cfg.is_encoder_decoder else 0)
    if not n:
        return {}
    return {"frontend_embeds": np32(rs.standard_normal((b, n, cfg.d_model))
                                    * 0.02)}


@pytest.fixture
def cuda_device():
    """The card, for tests that need one; they skip without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the reference's draws, re-derived from its keys
# ---------------------------------------------------------------------------

def jax_variation_draws(k_var, p: int, g: int, fused: bool) -> list:
    """The uniforms ``repro.core.operators.variation(k_var, parents(p, g))``
    consumes, in the port's draw order."""
    import jax
    from repro.kernels.genetic.ref import draw_uniforms
    if fused and p % 2 == 0:
        rnd = draw_uniforms(k_var, p, g)
        return [np32(rnd[k]) for k in UNIFORM_KEYS]
    k1, k2 = jax.random.split(k_var)
    n = (p - p % 2) // 2
    draws = []
    for key, rows in ((k1, n), (k2, p)):        # sbx pairs, then mutation
        ka, kb, kc = jax.random.split(key, 3)
        draws += [np32(jax.random.uniform(ka, (rows,))),
                  np32(jax.random.uniform(kb, (rows, g))),
                  np32(jax.random.uniform(kc, (rows, g)))]
    return draws


def jax_generation_draws(pop_rng, p: int, g: int, tsize: int,
                         fused: bool) -> list:
    """The uniforms one ``make_generation_step`` generation consumes, from
    the per-island keys ``pop_rng`` (I, 2), stacked over islands in the
    port's order: tournament first, then variation."""
    import jax
    per_island = []
    for key in np.asarray(pop_rng):
        step_rng = jax.random.split(key)[0]
        k_sel, k_var = jax.random.split(step_rng)
        per_island.append(
            [np32(jax.random.uniform(k_sel, (p, tsize)))]
            + jax_variation_draws(k_var, p, g, fused))
    return [np.stack(arrs) for arrs in zip(*per_island)]


def jax_migration_draws(pop_rng, m: int, num_shifts: int) -> list:
    """The (I, m) victim uniforms ``migrate_ring`` draws per shift."""
    import jax
    mig = [jax.random.split(key)[0] for key in np.asarray(pop_rng)]
    return [np.stack([np32(jax.random.uniform(jax.random.fold_in(k, s),
                                              (m,))) for k in mig])
            for s in range(num_shifts)]
