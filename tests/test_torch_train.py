"""Parity of the port's training path (``repro_torch.train``,
``repro_torch.launch.train``) with the JAX reference, on the CPU.

The same inputs go to both packages as numpy arrays drawn from a seed;
parameters cross over through ``models.convert``. Tolerances, each with
its reason:

* loss, grad_norm, lr: rtol 2e-5 (float32 reductions summed in another
  order; the reference itself agrees with the port to ~3e-7 here);
* the step-1 gradients, leaf by leaf: rtol 1e-4 and an atol of 2e-5 x the
  leaf's largest |g| (float32 backward passes in another order);
* ``adamw_update`` on identical gradients: rtol 1e-6 / atol 1e-7
  (elementwise float32; bf16 moments round at the same points);
* the parameters after three steps, on the elements whose reference
  gradient was, at every step, at least 1e-3 x its leaf's largest |g| or
  exactly 0: rtol 1e-4, atol 2e-6. AdamW's first step moves every element
  by about lr whatever |g| is (m / sqrt(v) = g / |g|), so an element whose
  gradient is at round-off level can move by up to 2 lr between the
  packages; above the floor an update differs by (gradient error / |g|)
  x lr. Those elements must be over 0.9 of all (0.93-0.98 here), and
  every element, kept or not, must stay within 2 lr x steps.
"""
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.models.model import Model as JaxModel
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import get_config
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model
from repro_torch.train import loss, optimizer, train_step
from torch_parity import to_np

METRIC_TOL = dict(rtol=2e-5, atol=0.0)
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 2e-5
ADAMW_TOL = dict(rtol=1e-6, atol=1e-7)
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
G_FLOOR_FRAC = 1e-3
MIN_KEPT = 0.9
STEPS, BATCH, SEQ, LR = 3, 4, 32, 1e-3


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    cfg = get_config("tinyllama-1.1b").reduced()      # vocab 512, padded
    assert cfg.padded_vocab > cfg.vocab_size
    rs = np.random.default_rng(0)
    logits = rs.standard_normal((2, 8, cfg.padded_vocab)).astype(np.float32)
    logits[..., cfg.vocab_size + 3] = 100.0           # a padding column
    labels = rs.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    labels[0, :3] = np.argmax(logits[0, :3, :cfg.vocab_size], -1)
    mask = (rs.random((2, 8)) < 0.6).astype(np.float32) if masked else None
    ref, jm = jloss.lm_loss(jax_config("tinyllama-1.1b").reduced(),
                            jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got, m = loss.lm_loss(cfg, torch.from_numpy(logits),
                          torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), **METRIC_TOL)
    for key in ("loss", "ppl_log", "tokens", "accuracy"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   **METRIC_TOL, err_msg=key)
    assert float(m["accuracy"]) > 0


def test_shift_batch_matches_reference():
    toks = np.arange(18, dtype=np.int32).reshape(2, 9)
    ref = jloss.shift_batch(jnp.asarray(toks))
    got = loss.shift_batch(torch.from_numpy(toks))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule,
              wsd_decay_frac=0.2, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 79, 80, 81, 90, 99, 100, 130):
        ref = jopt.schedule_lr(jopt.OptimizerConfig(**kw), jnp.int32(step))
        got = optimizer.schedule_lr(optimizer.OptimizerConfig(**kw), step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


def test_optimizer_for_arch_selects_wsd_for_minicpm():
    assert optimizer.optimizer_for_arch("minicpm-2b").schedule == "wsd"
    assert optimizer.optimizer_for_arch("tinyllama-1.1b").schedule == \
        "cosine"
    assert optimizer.optimizer_for_arch("gemma2-2b", lr=0.5).lr == 0.5


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rs = np.random.default_rng(3)
    grads = {"a": rs.standard_normal(10).astype(np.float32) * 10,
             "b": rs.standard_normal((3, 4)).astype(np.float32)}
    ref, ref_norm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    got, norm = optimizer.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    assert (float(norm) > max_norm) == (max_norm == 1.0)
    for key in grads:
        np.testing.assert_allclose(to_np(got[key]), np.asarray(ref[key]),
                                   **ADAMW_TOL)


# reference tree -> the port's flat names; leaves decayed or not by name
ADAMW_TREE = {"attn": {"q": (8, 16), "ln": {"scale": (16,)}},
              "ffn": {"wi": (16, 4), "ln": {"bias": (16,)}},
              "ssm": {"A_log": (4,), "D": (4,), "dt_bias": (4,),
                      "norm_scale": (6,), "conv_bias": (6,)}}


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e3, 0.5])
def test_adamw_update_matches_reference(moments, clip):
    rs = np.random.default_rng(7)
    shapes = dict(_flat(ADAMW_TREE))
    draw = {n: rs.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    grads = [{n: rs.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]

    def nest(flat):
        out = {}
        for name, val in flat.items():
            *path, leaf = name.split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = jnp.asarray(val)
        return out

    kw = dict(lr=0.05, warmup_steps=0, weight_decay=0.3, grad_clip=clip,
              moment_dtype=moments)
    jp, js = nest(draw), jopt.init_opt_state(nest(draw), moments)
    tp = {n: torch.from_numpy(v.copy()) for n, v in draw.items()}
    ts = optimizer.init_opt_state(tp, moments)
    for g in grads:
        jp, js, jstats = jopt.adamw_update(jopt.OptimizerConfig(**kw), jp,
                                           nest(g), js)
        tp, ts, tstats = optimizer.adamw_update(
            optimizer.OptimizerConfig(**kw), tp,
            {n: torch.from_numpy(v) for n, v in g.items()}, ts)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[key]),
                                       float(jstats[key]), rtol=1e-6)
    assert (float(tstats["grad_norm"]) > clip) == (clip < 1)
    assert int(ts["step"]) == int(js["step"]) == 2
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jp)))
    for name, p in tp.items():
        np.testing.assert_allclose(to_np(p), want[name], **ADAMW_TOL,
                                   err_msg=name)
        assert ts["m"][name].dtype == getattr(torch, moments)
    decayed = {n for n in shapes if optimizer._decay_mask(n)}
    assert decayed == {"attn.q", "ffn.wi"}


# ---------------------------------------------------------------------------
# the train step, three steps of reduced configs
# ---------------------------------------------------------------------------

# arch: (the reference's Model switches, the port's); tinyllama runs both
# flash kernels' paths (JAX: Pallas in interpret mode and its custom VJP;
# the port: _FlashAttention's plain versions), gemma2-2b (softcap, window
# 16, tied embeddings, GeGLU) the port's kernel path against the
# reference's default, mamba2-780m the plain chunked SSD scan on both,
# granite-moe-1b-a400m its MoE layers (the reduced 8 experts: the dense
# oracle, "auto" in both) with the load-balance aux in the loss, and
# qwen2-moe-a2.7b the sorted capacity dispatch and the shared expert
# under autograd
TRAIN_ARCHS = {
    "tinyllama-1.1b": (dict(attn_impl="pallas"), dict(attn_impl="kernel")),
    "gemma2-2b": (dict(), dict(attn_impl="kernel")),
    "mamba2-780m": (dict(), dict(attn_impl="kernel", use_ssd_kernel=False)),
    "granite-moe-1b-a400m": (dict(), dict(attn_impl="kernel")),
    "qwen2-moe-a2.7b": (dict(moe_impl="sorted"),
                        dict(attn_impl="kernel", moe_impl="sorted")),
}


# activation recomputation, each policy on both packages (the reference's
# jax.checkpoint of its period body, the port's torch.utils.checkpoint):
# reduced qwen2-moe-a2.7b through the sorted dispatch, whose router the
# backward runs again
REMAT_CASES = {
    "nothing": (dict(remat=True, moe_impl="sorted"),
                dict(attn_impl="kernel", moe_impl="sorted", remat=True)),
    "dots": (dict(remat=True, remat_policy="dots", moe_impl="sorted"),
             dict(attn_impl="kernel", moe_impl="sorted", remat=True,
                  remat_policy="dots")),
}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_train_step_matches_reference(arch, microbatches):
    _check_train_step(arch, *TRAIN_ARCHS[arch], microbatches)


@pytest.mark.parametrize("policy", sorted(REMAT_CASES))
def test_remat_train_step_matches_reference(policy):
    _check_train_step("qwen2-moe-a2.7b", *REMAT_CASES[policy], 1)


def _check_train_step(arch, jkw, tkw, microbatches):
    """STEPS steps of reduced ``arch`` on both packages, the reference's
    ``Model`` built with ``jkw`` and the port's with ``tkw``: the first
    step's gradients, every step's metrics and the final parameters, at
    the tolerances above."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jm = JaxModel(jcfg, max_seq=SEQ + 8, **jkw)
    jstate = jstep.init_train_state(jm, jax.random.PRNGKey(0))
    okw = dict(lr=LR, warmup_steps=2, total_steps=10)
    jfn = jax.jit(jstep.make_train_step(
        jm, jopt.optimizer_for_arch(arch, **okw), microbatches=microbatches))
    jgrads_fn = jax.jit(jstep.make_compute_grads(jm, microbatches))

    model = Model(cfg, device="cpu", max_seq=SEQ + 8, **tkw)
    model.load_state_dict(params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jstate["params"])),
        strict=True)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": optimizer.init_opt_state(params)}
    fn = train_step.make_train_step(
        model, optimizer.optimizer_for_arch(arch, **okw),
        microbatches=microbatches)

    rs = np.random.default_rng(1)
    before = attn_ops.launches, attn_ops.bwd_launches
    sure = None         # elements whose every reference gradient is sure
    for i in range(STEPS):
        toks = rs.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(
            np.int32)
        jgrads, _ = jgrads_fn(jstate["params"], {"tokens": jnp.asarray(toks)})
        theirs = _leaves(jax.tree_util.tree_map(np.asarray, jgrads))
        if i == 0:              # the first step's gradients, leaf by leaf
            grads, _ = train_step.make_compute_grads(model, microbatches)(
                params, {"tokens": torch.from_numpy(toks)})
            ours = params_to_numpy(cfg, grads)
            assert (jax.tree_util.tree_structure(ours)
                    == jax.tree_util.tree_structure(jgrads))
            for a, b in zip(_leaves(ours), theirs):
                np.testing.assert_allclose(
                    a, b, rtol=GRAD_RTOL,
                    atol=GRAD_ATOL_FRAC * np.abs(b).max())
        # |g| clearly above round-off, or exactly 0 (embedding rows of
        # tokens not drawn: both packages move them by the decay alone)
        step_sure = [(np.abs(g) >= G_FLOOR_FRAC * np.abs(g).max())
                     | (g == 0) for g in theirs]
        sure = step_sure if sure is None else [
            a & b for a, b in zip(sure, step_sure)]
        jstate, jmet = jfn(jstate, {"tokens": jnp.asarray(toks)})
        state, met = fn(state, {"tokens": torch.from_numpy(toks)})
        for key in ("loss", "grad_norm", "lr", "tokens", "accuracy", "aux"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       **METRIC_TOL,
                                       err_msg=f"step {i} {key}")
    assert (attn_ops.launches, attn_ops.bwd_launches) == before  # CPU
    assert int(state["opt"]["step"]) == STEPS

    ours = _leaves(params_to_numpy(cfg, model.state_dict()))
    theirs = _leaves(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    for a, b, ok in zip(ours, theirs, sure):
        np.testing.assert_allclose(a[ok], b[ok], **PARAM_TOL)
        assert np.abs(a - b).max() <= 2 * LR * STEPS
    kept = sum(int(ok.sum()) for ok in sure) / sum(ok.size for ok in sure)
    assert kept > MIN_KEPT, kept


# ---------------------------------------------------------------------------
# the port's remat against its own remat=False; reduced_train_step's draws
# ---------------------------------------------------------------------------

class _CountMM(TorchDispatchMode):
    """Counts the weight products (``aten.mm``) run under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _grads_and_counts(model, batch, monkeypatch):
    """(loss, gradients by name, flash forward calls, weight products run
    by the backward) of one gradient evaluation of ``model``."""
    calls = []
    fwd = attn_ops.flash_attention_fwd_plain
    monkeypatch.setattr(attn_ops, "flash_attention_fwd_plain",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    params = dict(model.named_parameters())
    total, _ = train_step.make_loss_fn(model)(batch)
    with _CountMM() as count:
        grads = torch.autograd.grad(total, list(params.values()))
    monkeypatch.setattr(attn_ops, "flash_attention_fwd_plain", fwd)
    return (float(total.detach()), dict(zip(params, grads)), len(calls),
            count.mm)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_remat_equals_no_remat(arch, policy, monkeypatch):
    """``Model(remat=True)`` gives the loss and gradients of
    ``remat=False`` bit for bit on the CPU (the same operations run again
    on the same inputs), and the recompute shows in the calls: every
    decoder layer's flash forward runs a second time in the backward (its
    self-attention and, on whisper, its cross-attention; the encoder is
    not recomputed, as in the reference), and under "dots" the backward
    runs no more weight products than without remat (their outputs were
    kept), under "nothing" more."""
    cfg = get_config(arch).reduced()
    init = Model(cfg, device="cpu", max_seq=SEQ + 8).init_params(
        torch.Generator().manual_seed(0)).state_dict()
    rs = np.random.default_rng(5)
    fs = cfg.encoder_seq if cfg.is_encoder_decoder else 8
    batch = {"tokens": torch.from_numpy(rs.integers(
        0, cfg.vocab_size, (2, SEQ + 1)).astype(np.int32)),
        "frontend_embeds": torch.from_numpy(rs.standard_normal(
            (2, fs, cfg.d_model)).astype(np.float32) * 0.02)}
    runs = []
    for remat in (False, True):
        model = Model(cfg, device="cpu", max_seq=SEQ + 8, attn_impl="kernel",
                      remat=remat, remat_policy=policy)
        model.load_state_dict(init)
        model.requires_grad_(True)
        runs.append(_grads_and_counts(model, batch, monkeypatch))
    (loss0, g0, f0, mm0), (loss1, g1, f1, mm1) = runs
    assert loss1 == loss0
    for name, g in g0.items():
        np.testing.assert_array_equal(to_np(g1[name]), to_np(g),
                                      err_msg=name)
    per_layer = 2 if cfg.is_encoder_decoder else 1
    assert f0 == cfg.encoder_layers + per_layer * cfg.num_layers
    assert f1 == f0 + per_layer * cfg.num_layers
    assert (mm1 == mm0) if policy == "dots" else (mm1 > mm0)


def test_remat_is_off_outside_autograd():
    """Prefill, and a forward with gradients off, never checkpoint: the
    flash forward runs once a layer and the logits equal remat=False's."""
    cfg = get_config("tinyllama-1.1b").reduced()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    out = []
    for remat in (False, True):
        model = Model(cfg, device="cpu", attn_impl="kernel", remat=remat)
        model.init_params(torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits, _ = model.forward({"tokens": toks})
            last, _ = model.prefill({"tokens": toks}, 24)
        out.append((logits, last))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert Model(cfg, device="cpu", remat=True,
                 remat_policy="other").remat_policy == "nothing"


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_reduced_train_step_draws_the_frontend(arch, monkeypatch):
    """``reduced_train_step`` hands a frontend arch its embeddings, drawn
    from seed 4 and scaled by 0.02: whisper's (B, encoder_seq, d) frames,
    which reach the encoder's weights, and llava's (B, 16, d) patches,
    whose rows the loss leaves out."""
    seen = []
    forward = Model.forward

    def spy(self, batch):
        seen.append(batch["frontend_embeds"].clone())
        return forward(self, batch)

    monkeypatch.setattr(Model, "forward", spy)
    cfg = get_config(arch).reduced()
    grads, metrics, _ = train_step.reduced_train_step(arch, "cpu", batch=2,
                                                      seq=16)
    fs = cfg.encoder_seq if cfg.is_encoder_decoder else 16
    want = torch.randn((2, fs, cfg.d_model),
                       generator=torch.Generator().manual_seed(4)) * 0.02
    assert len(seen) == 2           # the gradient evaluation, the step
    for fe in seen:
        assert torch.equal(fe, want)
    if cfg.is_encoder_decoder:
        assert float(grads["enc_layers.0.attn.q"].abs().max()) > 0
    assert np.isfinite(metrics["loss"]) and metrics["tokens"] == 2 * 16


def test_train_step_refuses_multi_device_options():
    """``compress_pod_reduce`` and ``shard_grads`` are no longer refused.
    Without a mesh (so without a "pod" axis) they change nothing, as in the
    reference: a step with either equals the plain step bit for bit. Their
    mesh semantics are held in ``tests/test_torch_train_mesh.py``."""
    cfg = get_config("tinyllama-1.1b").reduced()
    opt = optimizer.OptimizerConfig(lr=LR, warmup_steps=1, total_steps=10)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))
    runs = []
    for kw in ({}, dict(compress_pod_reduce=True), dict(shard_grads=True)):
        model = Model(cfg, device="cpu", max_seq=24, attn_impl="kernel")
        state = train_step.init_train_state(
            model, torch.Generator().manual_seed(0))
        state, met = train_step.make_train_step(model, opt, **kw)(
            state, {"tokens": toks})
        runs.append((float(met["loss"]), float(met["grad_norm"]),
                     int(state["rng"]), model.state_dict()))
    for loss_, norm, rng, params in runs[1:]:
        assert (loss_, norm, rng) == runs[0][:3]
        for name, p in params.items():
            assert torch.equal(p, runs[0][3][name]), name


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def test_train_cli_on_cpu(capsys):
    stats = {}
    state, history = train_cli.main(
        ["--arch", "gemma2-2b", "--steps", "12", "--batch", "2", "--seq",
         "24", "--device", "cpu"], stats=stats)
    out = capsys.readouterr().out
    assert [h["step"] for h in history] == [10, 12]
    assert out.count("loss") == 2 and "tok/s" in out
    assert len(stats["loss"]) == len(stats["step_ms"]) == 12
    assert all(np.isfinite(stats["loss"] + stats["grad_norm"]))
    assert int(state["opt"]["step"]) == 12


def test_train_cli_moe_on_cpu(capsys):
    """``launch.train --arch granite-moe-1b-a400m --device cpu``: the MoE
    family trains through the CLI, its load-balance aux in every step's
    metrics (E x sum f p / k: 1 for a perfectly balanced router)."""
    stats = {}
    state, history = train_cli.main(
        ["--arch", "granite-moe-1b-a400m", "--steps", "4", "--batch", "2",
         "--seq", "16", "--device", "cpu"], stats=stats)
    assert len(stats["loss"]) == 4
    assert all(np.isfinite(stats["loss"] + stats["grad_norm"]))
    assert all(a > 0.5 for a in stats["aux"])
    assert [h["step"] for h in history] == [4]
    assert int(state["opt"]["step"]) == 4


def test_train_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train_cli.main(["--steps", "1"])


def test_ssm_on_the_gpu_raises(monkeypatch):
    """Without a GPU, mamba2 on ``cuda`` raises the device error every arch
    raises; it is no longer refused as an SSM mixer (it trains on the card
    through the plain chunked scan)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train_cli.train("mamba2-780m", steps=1, device="cuda")


def test_ssm_on_the_gpu_reaches_the_device(monkeypatch):
    """``train`` takes mamba2-780m on ``cuda`` as far as resolving the
    device; here the resolver stops it."""
    seen = []

    def resolve(device):
        seen.append(device)
        raise LookupError("resolved")

    monkeypatch.setattr(train_cli, "resolve_device", resolve)
    with pytest.raises(LookupError, match="resolved"):
        train_cli.train("mamba2-780m", steps=1, device="cuda")
    assert seen == ["cuda"]


@pytest.mark.parametrize("impl", ["dense", "blocked", "auto"])
def test_plain_attention_on_the_gpu_raises(impl):
    with pytest.raises(ValueError, match="attn_impl='kernel'"):
        train_cli.main(["--steps", "1", "--attn-impl", impl])


def test_plain_attention_on_cpu_trains_as_the_kernel_path():
    """--attn-impl dense on the CPU against the default (the kernels'
    plain versions): the same losses and grad norms at 1e-4."""
    runs = []
    for extra in ([], ["--attn-impl", "dense"]):
        stats = {}
        train_cli.main(["--arch", "tinyllama-1.1b", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--device", "cpu"]
                       + extra, stats=stats)
        runs.append(stats)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(runs[1][key], runs[0][key], rtol=1e-4,
                                   err_msg=key)


def test_resume_equals_a_straight_run(tmp_path):
    """4 steps with a checkpoint at step 2; dropping the step-4 checkpoint
    and running again resumes at step 2 and must end where the straight
    run ended."""
    kw = dict(steps=4, batch=2, seq=16, device="cpu", ckpt_every=2,
              log_fn=lambda s: None)
    straight, _ = train_cli.train("tinyllama-1.1b", ckpt_dir=str(tmp_path),
                                  **kw)
    cfg = get_config("tinyllama-1.1b").reduced()
    want = params_to_numpy(cfg, straight["params"])
    shutil.rmtree(tmp_path / "step_0000000004")
    logs = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no silent dtype casts
        resumed, _ = train_cli.train("tinyllama-1.1b",
                                     ckpt_dir=str(tmp_path),
                                     **dict(kw, log_fn=logs.append))
    assert logs[0] == "resumed from step 2"
    assert int(resumed["opt"]["step"]) == 4
    got = params_to_numpy(cfg, resumed["params"])
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)
