"""The hybrid, VLM and audio families (jamba-1.5-large-398b, llava-next-34b,
whisper-large-v3) through the port's training paths against the JAX
reference, on the CPU, at the reduced configs: one train step as the
reference's ``tests/test_models_smoke.py::test_train_step_smoke`` takes
it (batch 2 x 32, lr 1e-3, 2 warmup steps of 10; llava's 8 patches,
whisper's frames, N(0, 0.02) drawn with numpy), ``launch.train`` against
the reference's ``train``, and the LM fitness that ``ga_run --lm-arch``
builds against the reference's. The port trains with its defaults for
training (flash kernel, on the CPU its plain version; plain SSD scan).

Tolerances, as ``tests/test_torch_train.py`` and
``tests/test_torch_lm_fitness.py`` give their reasons: metrics rtol 2e-5;
gradients rtol 1e-4 with an atol of 2e-5 x the leaf's largest |g|; final
LM-fitness losses rtol 1e-4 / atol 2e-6.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.fitness import lm as jlm
from repro.models.model import Model as JaxModel
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import get_config
from repro_torch.fitness import lm
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.launch import ga_run
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model
from repro_torch.train import optimizer, train_step
from torch_parity import frontend_embeds

NEW_FAMILY_ARCHS = ["jamba-1.5-large-398b", "llava-next-34b",
                    "whisper-large-v3"]
METRIC_TOL = dict(rtol=2e-5, atol=0.0)
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 2e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
LR = 1e-3
# tests/test_torch_lm_fitness.py's run and genomes
SMALL = dict(steps=3, batch_size=2, seq_len=16)
GENOMES = np.array([[0.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0],
                    [0.3, 0.6, 0.2, 0.8], [0.7, 0.1, 0.9, 0.4]], np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("arch", NEW_FAMILY_ARCHS)
def test_train_step_new_families_match_reference(arch):
    """One train step from the reference's initial parameters on the same
    batch: every gradient leaf (the encoder's, the cross-attention's, the
    learned positions' included) at the step tolerances; the step's loss,
    tokens, accuracy and aux against the reference's ``compute_grads``,
    its grad norm against the norm of the reference's gradients and its
    lr against the reference's schedule, at METRIC_TOL; and the loss
    after a second step on the same batch below the first + 1 (the smoke
    test's check). Two full reference steps, AdamW included, are held in
    ``test_train_cli_new_families_match_reference``."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jm = JaxModel(jcfg, max_seq=64)
    jstate = jstep.init_train_state(jm, jax.random.PRNGKey(0))
    okw = dict(lr=LR, warmup_steps=2, total_steps=10)
    model = Model(cfg, device="cpu", max_seq=64, attn_impl="kernel")
    model.load_state_dict(params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jstate["params"])),
        strict=True)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": optimizer.init_opt_state(params)}
    fn = train_step.make_train_step(model, optimizer.OptimizerConfig(**okw))

    rs = np.random.default_rng(2)
    batch = {"tokens": rs.integers(0, cfg.vocab_size, (2, 33)).astype(
        np.int32), **frontend_embeds(cfg, 2, rs)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    jgrads, jmet = jax.jit(jstep.make_compute_grads(jm))(jstate["params"],
                                                        jb)
    theirs = _leaves(jax.tree_util.tree_map(np.asarray, jgrads))
    grads, _ = train_step.make_compute_grads(model)(params, tb)
    ours = params_to_numpy(cfg, grads)
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(jgrads))
    for a, b in zip(_leaves(ours), theirs):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * np.abs(b).max())
    state, met = fn(state, tb)
    want = {k: float(jmet[k]) for k in ("loss", "tokens", "accuracy", "aux")}
    want["grad_norm"] = float(np.sqrt(sum(
        np.sum(np.square(g.astype(np.float64))) for g in theirs)))
    want["lr"] = float(jopt.schedule_lr(jopt.OptimizerConfig(**okw),
                                        jnp.int32(1)))
    for key, val in want.items():
        np.testing.assert_allclose(float(met[key]), val, **METRIC_TOL,
                                   err_msg=key)
    _, met2 = fn(state, tb)
    assert np.isfinite(float(met["loss"]))
    assert float(met2["loss"]) < float(met["loss"]) + 1.0


@pytest.mark.parametrize("arch", NEW_FAMILY_ARCHS)
def test_train_cli_new_families_match_reference(arch, monkeypatch):
    """``launch.train --arch`` takes the hybrid, VLM and audio archs on
    the CPU as the reference's ``train`` does (llava with 16 patches a
    sequence): from the reference's initial parameters, each step's loss,
    grad norm and lr equal the reference's ``train`` at METRIC_TOL."""
    from repro.launch import train as jax_train
    kw = dict(steps=2, batch=2, seq=16, log_every=1, log_fn=lambda s: None)
    _, want = jax_train.train(arch, **kw)
    cfg = get_config(arch).reduced()
    jstate = jstep.init_train_state(JaxModel(jax_config(arch).reduced(),
                                             max_seq=kw["seq"] + 8),
                                    jax.random.PRNGKey(0))
    init = params_from_numpy(cfg, jax.tree_util.tree_map(
        np.asarray, jstate["params"]))

    def load_reference(model, generator, moment_dtype="float32"):
        model.load_state_dict(init, strict=True)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        return {"params": params,
                "opt": optimizer.init_opt_state(params, moment_dtype)}

    monkeypatch.setattr(train_cli, "init_train_state", load_reference)
    _, got = train_cli.train(arch, device="cpu", **kw)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2]
    for a, b in zip(got, want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[key], b[key], **METRIC_TOL,
                                       err_msg=f"step {a['step']} {key}")


@pytest.mark.parametrize("arch", NEW_FAMILY_ARCHS)
def test_lm_fitness_matches_reference(arch):
    """The LM fitness of each new family from the reference's initial
    parameters: the final losses of four genomes equal the reference's
    (llava's batches carry the pipeline's 576 patches, left out of the
    loss; whisper's its encoder_seq frames)."""
    fit_ref = jlm.LMTrainFitness(arch, **SMALL)
    want = np.asarray(jax.jit(fit_ref)(jnp.asarray(GENOMES)))[:, 0]
    init = params_from_numpy(get_config(arch).reduced(),
                             jax.tree_util.tree_map(np.asarray,
                                                    fit_ref._init))
    before = (attn_ops.launches, attn_ops.bwd_launches)
    fit = lm.LMTrainFitness(arch, device="cpu", **SMALL)
    fit.model.load_state_dict(init, strict=True)
    got = fit(torch.from_numpy(GENOMES))
    assert got.shape == (4, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, 0].numpy(), want, **PARAM_TOL)
    assert (attn_ops.launches, attn_ops.bwd_launches) == before   # CPU


@pytest.mark.parametrize("arch", NEW_FAMILY_ARCHS)
def test_ga_run_lm_arch_takes_the_new_families(arch):
    """``ga_run --lm-arch`` builds the LM fitness of the hybrid, VLM and
    audio archs (reduced, as the reference's): its batches carry the
    pipeline's frontend embeddings where the arch has a frontend."""
    args = argparse.Namespace(lm_arch=arch, lm_steps=2, pop=4, islands=2,
                              gens_per_epoch=1, epochs=1, seed=0)
    _, fit, _ = ga_run.build("lm", args, torch.device("cpu"))
    cfg = get_config(arch).reduced()
    assert fit.cfg == cfg
    fe = fit._batches[0].get("frontend_embeds")
    want = {"vision_patches": 576, "audio_frames": cfg.encoder_seq}
    assert (0 if fe is None else fe.shape[1]) == want.get(cfg.frontend, 0)


def test_ga_run_lm_on_cpu_vlm(capsys):
    """A whole ``ga_run --fitness lm --lm-arch llava-next-34b`` run on the
    CPU: finite fitness, genomes in [0, 1]."""
    pop, hist = ga_run.main(["--fitness", "lm", "--device", "cpu",
                             "--lm-arch", "llava-next-34b", "--islands", "2",
                             "--pop", "4", "--epochs", "1",
                             "--gens-per-epoch", "1", "--lm-steps", "2"])
    assert "best fitness:" in capsys.readouterr().out and len(hist) == 1
    assert bool(((pop.genomes >= 0) & (pop.genomes <= 1)).all())
    assert bool(torch.isfinite(pop.fitness).all())
