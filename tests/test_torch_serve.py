"""The port's serving path (``repro_torch.launch.serve`` ->
``train.serve_step.generate`` -> ``Model.prefill`` / ``decode_step``)
against the JAX reference's, on the CPU: identical synthetic batches,
identical greedy tokens from the same parameters, the same log line; and
the port's own CLI switches."""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.launch import serve as jax_serve
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

LOG = re.compile(r"^generated \((\d+), (\d+)\) tokens in \d+\.\d\ds "
                 r"\(\d+\.\d tok/s\)$")


@pytest.mark.parametrize("mode", ["bigram", "uniform"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m"])
def test_synthetic_tokens_identical(arch, mode):
    cfg = get_config(arch).reduced()
    ours = SyntheticTokens(cfg, 3, 17, seed=4, mode=mode)
    theirs = JaxTokens(jax_config(arch).reduced(), 3, 17, seed=4, mode=mode)
    for step in (0, 5):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        assert a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m", "granite-8b",
                                  "minicpm-2b", "granite-moe-1b-a400m",
                                  "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
                                  "llava-next-34b", "whisper-large-v3"])
def test_serve_gives_the_reference_tokens(arch, monkeypatch):
    kw = dict(reduced=True, batch=2, prompt_len=24, gen=6, seed=0)
    ref_lines = []
    ref = np.asarray(jax_serve.serve(arch, log_fn=ref_lines.append, **kw))

    # the reference's parameters, as its serve() draws them
    cfg = jax_config(arch).reduced()
    jparams = JaxModel(cfg, max_seq=kw["prompt_len"] + kw["gen"] + 64
                       ).init_params(jax.random.PRNGKey(kw["seed"]))
    state = params_from_numpy(get_config(arch).reduced(),
                              jax.tree_util.tree_map(np.asarray, jparams))

    def load_reference(self, generator):
        self.load_state_dict(state, strict=True)
        return self

    monkeypatch.setattr(Model, "init_params", load_reference)
    lines = []
    out = serve.serve(arch, device="cpu", log_fn=lines.append, **kw)
    assert out.shape == ref.shape == (2, 6)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(lines) == 1 and len(ref_lines) == 1
    assert LOG.match(lines[0]) and LOG.match(ref_lines[0])
    assert LOG.match(lines[0]).groups() == LOG.match(ref_lines[0]).groups()


def test_serve_sampling_is_seeded():
    kw = dict(reduced=True, batch=2, prompt_len=8, gen=5, temperature=1.0,
              device="cpu", log_fn=lambda s: None)
    a = serve.serve("mamba2-780m", seed=1, **kw)
    b = serve.serve("mamba2-780m", seed=1, **kw)
    assert torch.equal(a, b)
    assert int(a.max()) < get_config("mamba2-780m").reduced().vocab_size


def test_serve_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve("gemma2-2b")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-780m"])


def test_cli_switches(monkeypatch, capsys):
    seen = {}
    monkeypatch.setattr(serve, "serve",
                        lambda arch, **kw: seen.update(kw, arch=arch))
    serve.main(["--arch", "mamba2-780m", "--no-reduced", "--device", "cpu",
                "--attn-impl", "blocked", "--no-ssd-kernel"])
    assert seen == dict(arch="mamba2-780m", reduced=False, batch=4,
                        prompt_len=32, gen=16, temperature=0.0, seed=0,
                        device="cpu", attn_impl="blocked",
                        use_ssd_kernel=False, stats=None)
    serve.main([])
    assert seen["reduced"] is True and seen["attn_impl"] == "kernel"
    assert seen["use_ssd_kernel"] is True and seen["device"] == "cuda"
    with pytest.raises(SystemExit):
        serve.main(["--attn-impl", "pallas"])
    capsys.readouterr()


def test_cli_takes_every_ported_arch(monkeypatch):
    """``--arch`` offers the registry's ten archs (all of the reference's
    families), each of which the CLI hands on; an unknown one is
    refused."""
    seen = []
    monkeypatch.setattr(serve, "serve", lambda arch, **kw: seen.append(arch))
    archs = ["gemma2-2b", "granite-8b", "granite-moe-1b-a400m",
             "jamba-1.5-large-398b", "llava-next-34b", "mamba2-780m",
             "minicpm-2b", "qwen2-moe-a2.7b", "tinyllama-1.1b",
             "whisper-large-v3"]
    for arch in archs:
        serve.main(["--arch", arch, "--device", "cpu"])
    assert seen == archs
    with pytest.raises(SystemExit):
        serve.main(["--arch", "jamba-1.5-large"])


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-large-v3"])
def test_generate_matches_reference(arch):
    """``generate`` against the reference's, token for token, on the same
    parameters and batch (llava's 8 patches, whisper's frames), and the
    last decode step's position: after the patch prefix on llava, as the
    reference starts decoding (``frontend_len``)."""
    from repro.train.serve_step import generate as jax_generate
    from repro_torch.train.serve_step import generate
    cfg = get_config(arch).reduced()
    jm = JaxModel(jax_config(arch).reduced(), max_seq=96)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    m = Model(cfg, device="cpu", max_seq=96)
    m.load_state_dict(params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    data = SyntheticTokens(cfg, 2, 12, seed=3, frontend_seq=8
                           if cfg.frontend == "vision_patches" else 0)
    batch = data.batch(0)
    batch["tokens"] = batch["tokens"][:, :12]
    ref = np.asarray(jax_generate(
        jm, jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()},
        steps=6, max_cache_len=40))
    seen = []
    decode_step = m.decode_step

    def record(cache, tokens, pos):
        seen.append(pos)
        return decode_step(cache, tokens, pos)

    m.decode_step = record
    out = generate(m, {k: torch.from_numpy(v) for k, v in batch.items()},
                   steps=6, max_cache_len=40)
    np.testing.assert_array_equal(out.numpy(), ref)
    off = 8 if cfg.frontend == "vision_patches" else 0
    assert seen == [off + 12 + i for i in range(5)]


def test_cli_runs_on_the_cpu(capsys):
    stats = {}
    out = serve.main(["--arch", "gemma2-2b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "20", "--gen", "3"], stats=stats)
    assert out.shape == (2, 3)
    assert stats["logits_finite"] is True and stats["seconds"] > 0
    assert "prefill_ms" not in stats        # device times only on the card
    assert LOG.match(capsys.readouterr().out.strip().splitlines()[-1])
