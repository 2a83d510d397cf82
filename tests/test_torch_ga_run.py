"""The port's GA driver on the CPU: the reference's log-line forms, its
flags, checkpoint resume, the host-pool dispatch backends, ``--fitness
lm`` under each kind of backend, and the refusal when the GPU is
absent."""
import re

import pytest
import torch

from repro.launch import ga_run as jax_ga_run
from repro_torch.launch import ga_run

ARGS = ["--fitness", "rastrigin", "--genes", "4", "--islands", "2",
        "--pop", "12", "--epochs", "3", "--gens-per-epoch", "2"]
NUM = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def _forms(text):
    """Each printed line with its numbers replaced by '#' (numpy pads an
    array's numbers to a common width, sign included)."""
    return [NUM.sub("#", " ".join(line.replace("[", "[ ").split()))
            for line in text.strip().splitlines()]


def test_log_lines_have_the_reference_forms(capsys):
    jax_ga_run.main(ARGS)
    ref = capsys.readouterr().out
    pop, hist = ga_run.main(ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _forms(out) == _forms(ref)
    assert _forms(out)[:3] == ["scaling plan: horizontal=# vertical=#",
                               "epoch # best # skew #",
                               "epoch # best # skew #"]
    assert re.search(r"^best fitness: \d+\.\d{6}$", out, re.M)
    assert len(hist) == 3 and pop.genomes.shape == (2, 12, 4)


def test_checkpoint_resume_continues_epochs(tmp_path, capsys):
    args = ARGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
    ga_run.main(args)
    capsys.readouterr()
    _, hist = ga_run.main(args)
    out = capsys.readouterr().out
    assert hist[0]["epoch"] == 3
    assert re.search(r"^epoch\s+3 best", out, re.M)


def test_pipelined_flags_give_identical_best(capsys):
    pop1, _ = ga_run.main(ARGS + ["--device", "cpu"])
    pop2, _ = ga_run.main(ARGS + ["--device", "cpu", "--sync-every", "2",
                                  "--pipeline-depth", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("best genome")]
    assert lines[0] == lines[1]
    assert torch.equal(pop1.genomes, pop2.genomes)


@pytest.mark.parametrize("extra", [["--fitness", "lm", "--dispatch-backend",
                                    "slurm-mock"],
                                   ["--fitness", "lm"],
                                   ["--fitness", "lm", "--dispatch-backend",
                                    "mq-mock"],
                                   ["--fitness", "lm", "--dispatch-backend",
                                    "k8s-mock"]])
def test_not_yet_ported_exits(extra, capsys):
    """``--fitness lm`` was refused under every dispatch backend until
    ``fitness/lm.py`` was ported; it now runs under each: inline, the CPU
    rebuild ``SpawnedLMFitness`` per spooled chunk (slurm-mock in a
    subprocess, k8s-mock on a thread), and the fitness behind one lock on
    mq-mock's thread workers."""
    pop, hist = ga_run.main(ARGS + ["--device", "cpu"] + extra + [
        "--pop", "4", "--epochs", "1", "--gens-per-epoch", "1",
        "--lm-steps", "2", "--num-workers", "1"])
    captured = capsys.readouterr()
    assert "not yet ported" not in captured.err
    assert "best fitness:" in captured.out and len(hist) == 1
    assert pop.genomes.shape == (2, 4, 4)
    assert bool(torch.isfinite(pop.fitness).all())


def test_gpu_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ga_run.main(ARGS)


@pytest.mark.parametrize("fitness", ["sphere", "rosenbrock", "ackley",
                                     "griewank"])
def test_every_benchmark_fitness_runs(fitness, capsys):
    pop, hist = ga_run.main(["--fitness", fitness, "--genes", "3",
                             "--islands", "2", "--pop", "8", "--epochs", "2",
                             "--device", "cpu"])
    assert hist[-1]["best"] <= hist[0]["best"]
    assert "best fitness:" in capsys.readouterr().out


def test_hvdc_runs_with_balanced_dispatch(capsys):
    """--fitness hvdc on the CPU: the reference's log-line forms, Table 3's
    genome bounds, and the cost model engaging the broker's balanced
    dispatch over 4 lanes with 3 x 10 % 4 != 0 (padded)."""
    args = ["--fitness", "hvdc", "--grid-size", "20", "--islands", "3",
            "--pop", "10", "--epochs", "2", "--gens-per-epoch", "2",
            "--num-workers", "4"]
    pop, hist = ga_run.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _forms(out)[:3] == ["scaling plan: horizontal=# vertical=#",
                               "epoch # best # skew #",
                               "epoch # best # skew #"]
    assert re.search(r"^best fitness: \d+\.\d{6}$", out, re.M)
    assert pop.genomes.shape == (3, 10, 4)
    assert bool((pop.genomes.abs() <= 1.0).all())
    assert bool(torch.isfinite(pop.fitness).all())
    assert len(hist) == 2 and all(h["balanced"] == 1.0 for h in hist)
    skews = re.findall(r"skew (\d+\.\d+)$", out, re.M)
    assert len(skews) == 2 and all(s != "1.000" for s in skews)
    assert hist[-1]["best"] <= hist[0]["best"]


HOST = ["--dispatch-backend", "host-thread", "--num-workers", "3",
        "--islands", "3", "--pop", "11"]


def test_host_thread_log_lines_have_the_reference_forms(capsys):
    """The decoupled backend's run log, ``dispatch stats:`` included, as
    the reference prints it (3 x 11 genomes over 3 workers)."""
    jax_ga_run.main(ARGS + HOST)
    ref = capsys.readouterr().out
    pop, hist = ga_run.main(ARGS + HOST + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _forms(out) == _forms(ref)
    assert re.search(r"^dispatch stats: retries=0$", out, re.M)
    assert len(hist) == 3 and pop.genomes.shape == (3, 11, 4)


def test_host_thread_and_host_process_give_the_same_best(capsys):
    """Both executors evaluate with fitness.hostsim's numpy rastrigin on
    the same chunks: the same run, bit for bit; and pipelined metric
    reads change nothing under a host backend either."""
    pops = [ga_run.main(ARGS + HOST + ["--device", "cpu"] + extra)[0]
            for extra in ([], ["--dispatch-backend", "host-process"],
                          ["--sync-every", "2", "--pipeline-depth", "2"])]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("best genome", "dispatch stats"))]
    assert lines[0::2] == [lines[0]] * 3 and lines[1::2] == [lines[1]] * 3
    for pop in pops[1:]:
        assert torch.equal(pop.genomes, pops[0].genomes)
        assert torch.equal(pop.fitness, pops[0].fitness)


def test_cost_ema_with_inline_exits_as_the_reference(capsys):
    errs = []
    for main in (jax_ga_run.main, lambda a: ga_run.main(a + ["--device",
                                                             "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(ARGS + ["--cost-ema"])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0].split(": ", 1)[1] == errs[1].split(": ", 1)[1]
    assert "--cost-ema needs measured per-lane wall times" in errs[1]


def test_hvdc_host_thread_with_cost_ema_runs(capsys):
    """--fitness hvdc on the host pool with the learned cost model, primed
    by the fitness's static one: balanced dispatch engages (skew != 1) and
    the run log ends with the dispatch stats."""
    args = ["--fitness", "hvdc", "--grid-size", "20", "--islands", "3",
            "--pop", "10", "--epochs", "2", "--gens-per-epoch", "2",
            "--dispatch-backend", "host-thread", "--cost-ema",
            "--device", "cpu"]
    pop, hist = ga_run.main(args)
    out = capsys.readouterr().out
    assert _forms(out)[-4:-2] == ["epoch # best # skew #",
                                  "dispatch stats: retries=#"]
    assert "dispatch stats: retries=0" in out
    assert bool(torch.isfinite(pop.fitness).all())
    assert len(hist) == 2 and all(h["balanced"] == 1.0 for h in hist)
    skews = re.findall(r"skew (\d+\.\d+)$", out, re.M)
    assert len(skews) == 2 and all(s != "1.000" for s in skews)
    assert hist[-1]["best"] <= hist[0]["best"]
