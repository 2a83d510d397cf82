"""Training over a device mesh (``Model(ctx=)``, ``models.sharding``'s
blocks, ``train.compress``, ``data.pipeline.place``, ``train(mesh=)``) on
gloo process groups on the CPU: the port's counterpart of the reference's
mesh training, which GSPMD gives the same numbers as one device.

Two worlds of ranks run once each (``tests/torch_train_mesh_worker.py``,
one process per rank, one intra-op thread, a ``file://`` store under the
test's tmp dir), every scenario of the world in one spawn, and every test
of it reads what rank 0 saved:

* 4 ranks on (data 2, model 2) (``make_train_ctx``: fsdp over data, tp
  over model, the hidden state carried as each rank's sequence block
  between sub-layers), reduced widths: tinyllama-1.1b three steps, and
  one step with ``seq_parallel=False``; granite-moe
  through the sorted dispatch (16 experts a tp rank at published widths,
  here 4) and the dense oracle; mamba2 (its mixer whole on every tp rank);
  whisper (cross-attention, learned positions); llava with a sequence of
  patches and tokens that splits unevenly over tp;
  ``lm_loss`` on vocab-split logits with ties across the blocks; a loss
  mask uneven across the data ranks; ``shard_grads``; a checkpointed
  ``train(mesh=)`` resumed; ``place``.
* 8 ranks on (pod 2, data 2, model 2): ``make_train_ctx`` (fsdp over
  pod and data); the reference test's compressed pod reduce (dp over pod
  and data, fsdp over data) against the exact reduce.

Tolerances: against one rank of the port, metrics at rtol 1e-5, the
first step's gradients at rtol 1e-5 plus 1e-5 of the leaf's largest |g|,
routes exactly; against the reference's one-device step,
``tests/test_torch_train.py``'s (``METRIC_TOL``, gradients, and
``PARAM_TOL`` on the elements whose every gradient is sure, the others
within 2 lr a step). The compressed run is held to the reference test's
own criterion (final loss within 5% of the exact run;
``tests/test_multidevice.py:98``), and ``train.compress`` to the
reference's unit semantics on its own draws.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import Model as JaxModel
from repro.train import compress as jcompress
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.uniforms import ArrayUniforms, GeneratorUniforms
from repro_torch.models.convert import params_to_numpy
from repro_torch.models.sharding import ShardingCtx
from repro_torch.train import compress
from repro_torch.train.train_step import train_rng
from torch_train_mesh_worker import (BATCH, CKPT_EVERY, CKPT_STEPS, LR,
                                     MOE_ARCH, OPT, PATCHES, POD_BATCH, SEQ,
                                     SPLITS, STEPS, loss_case, run, tokens,
                                     train_run, uneven_mask)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_train_mesh_worker.py")
SPAWN_TIMEOUT_S = 240
ONE = ShardingCtx()
RANK_TOL = dict(rtol=1e-5, atol=0.0)
RANK_GRAD_RTOL = RANK_GRAD_ATOL_FRAC = 1e-5
# tests/test_torch_train.py's
METRIC_TOL = dict(rtol=2e-5, atol=0.0)
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 2e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
G_FLOOR_FRAC = 1e-3
MIN_KEPT = 0.9
METRICS = ("loss", "grad_norm", "lr", "tokens", "accuracy", "aux")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here too, as each rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(world: int, where: Path) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(WORKER.parent)]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(world), str(r), str(where)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log[-3000:]}"
    return torch.load(where / f"{world}.pt", weights_only=False)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    where = tmp_path_factory.mktemp("four")
    out = run_ranks(4, where)
    out["where"] = where
    return out


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return run_ranks(8, tmp_path_factory.mktemp("eight"))


def assert_metrics(got, want, tol, keys=METRICS):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for key in keys:
            np.testing.assert_allclose(a[key], b[key], **tol,
                                       err_msg=f"step {i} {key}")


def assert_grads(got, want, rtol, atol_frac):
    assert set(got) == set(want)
    for name, b in want.items():
        np.testing.assert_allclose(got[name], b, rtol=rtol,
                                   atol=atol_frac * np.abs(b).max(),
                                   err_msg=name)


def assert_params(got, want, sure, steps):
    """PARAM_TOL on the sure elements (over MIN_KEPT of all), every element
    within AdamW's 2 lr a step."""
    kept = total = 0
    for name, b in want.items():
        ok = sure[name]
        np.testing.assert_allclose(got[name][ok], b[ok], **PARAM_TOL,
                                   err_msg=name)
        assert np.abs(got[name] - b).max() <= 2 * LR * steps, name
        kept, total = kept + int(ok.sum()), total + ok.size
    assert kept / total > MIN_KEPT, kept / total


def sure_elements(grads_per_step):
    """Elements whose every gradient is at least G_FLOOR_FRAC of its leaf's
    largest or exactly 0."""
    sure = None
    for grads in grads_per_step:
        step = {n: (np.abs(g) >= G_FLOOR_FRAC * np.abs(g).max()) | (g == 0)
                for n, g in grads.items()}
        sure = step if sure is None else {n: sure[n] & step[n] for n in sure}
    return sure


# ---------------------------------------------------------------------------
# train.compress: the reference's unit semantics, without a mesh
# ---------------------------------------------------------------------------

def test_quantize_bit_equal_to_reference_on_its_draws():
    key = jax.random.PRNGKey(3)
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (40, 25)) * 3)
    q, s = jcompress.quantize(jnp.asarray(x), key)
    draws = ArrayUniforms([np.asarray(jax.random.uniform(key, x.shape))])
    tq, ts = compress.quantize(torch.from_numpy(x), draws)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert float(ts) == float(s)
    np.testing.assert_array_equal(compress.dequantize(tq, ts).numpy(),
                                  np.asarray(jcompress.dequantize(q, s)))


def _uniforms(seed):
    return GeneratorUniforms(torch.Generator().manual_seed(seed), "cpu")


def test_quantize_unbiased():
    x = torch.randn(2000, generator=torch.Generator().manual_seed(0))
    errs = [compress.dequantize(*compress.quantize(x, _uniforms(i))) - x
            for i in range(20)]
    mean_err = torch.stack(errs).mean(0)
    # stochastic rounding: the bias goes to 0 as draws are averaged
    assert mean_err.abs().mean() < errs[0].abs().mean() / 2


def test_quantize_bounded_error():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1)) * 5
    q, s = compress.quantize(x, _uniforms(2))
    err = (compress.dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) + 1e-6      # one quantization step


def test_int8_wire_format():
    q, _ = compress.quantize(torch.randn(64), _uniforms(3))
    assert q.dtype == torch.int8


def test_compressed_allgather_mean_matches_reference():
    """The GSPMD formulation without a mesh, on the reference's draws
    (leaf i, pod j: ``split(split(rng, leaves)[i], pods)[j]``)."""
    rs = np.random.default_rng(4)
    stacked = {"a": rs.standard_normal((2, 5, 3)).astype(np.float32),
               "b": rs.standard_normal((2, 7)).astype(np.float32)}
    rng = jax.random.PRNGKey(8)
    want = jcompress.compressed_allgather_mean(
        {k: jnp.asarray(v) for k, v in stacked.items()}, rng)
    leaf_keys = jax.random.split(rng, len(stacked))
    draws = [[ArrayUniforms([np.asarray(jax.random.uniform(
        pk, stacked[name].shape[1:]))]) for pk in jax.random.split(lk, 2)]
        for lk, name in zip(leaf_keys, sorted(stacked))]
    got = compress.compressed_allgather_mean(
        {k: torch.from_numpy(v) for k, v in sorted(stacked.items())}, draws)
    for name in stacked:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


# ---------------------------------------------------------------------------
# 4 ranks on (data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_one():
    return run("tinyllama-1.1b", ONE, every_grad=True)


@pytest.fixture(scope="module")
def tiny_reference():
    """The reference's one-device steps from the port's initial parameters
    on the same tokens: every step's gradients and metrics, the last
    parameters."""
    arch = "tinyllama-1.1b"
    jm = JaxModel(jax_config(arch).reduced(), max_seq=SEQ + 8)
    init = run(arch, ONE, steps=0)["params"]
    cfg = get_config(arch).reduced()
    params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
        cfg, {n: torch.from_numpy(v) for n, v in init.items()}))
    state = {"params": params, "opt": jopt.init_opt_state(params),
             "rng": jax.random.PRNGKey(0)}
    fn = jax.jit(jstep.make_train_step(
        jm, jopt.optimizer_for_arch(arch, **OPT)))
    grads_fn = jax.jit(jstep.make_compute_grads(jm))
    grads, metrics = [], []
    for i in range(STEPS):
        batch = {"tokens": jnp.asarray(tokens(cfg, i))}
        grads.append(jax.tree_util.tree_map(
            np.asarray, grads_fn(state["params"], batch)[0]))
        state, met = fn(state, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    return {"grads": grads, "metrics": metrics,
            "params": jax.tree_util.tree_map(np.asarray, state["params"])}


def test_tinyllama_mesh_equals_one_rank(four, tiny_one):
    got = four["tinyllama"]
    assert_metrics(got["metrics"], tiny_one["metrics"], RANK_TOL)
    assert_grads(got["grads"][0], tiny_one["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)
    assert_params(got["params"], tiny_one["params"],
                  sure_elements(tiny_one["grads"]), STEPS)
    assert got["rng"] == tiny_one["rng"] == int(train_rng(0, STEPS))
    # the weight blocks gathered over data, the activations gathered and
    # reduce-scattered along the sequence over model, one global norm a
    # step over the whole mesh
    counts = got["counts"]
    assert counts["data"]["ops"]["all_gather"] > 0
    assert counts["model"]["ops"]["all_gather"] > 0
    assert counts["model"]["ops"]["reduce_scatter"] > 0
    assert counts["data+model"]["ops"] == {"all_reduce_sum": STEPS}


def test_seq_parallel_equals_the_whole_hidden_state(four):
    """``make_train_ctx(mesh, seq_parallel=False)``: every tp rank holds
    the whole hidden state and sums each sub-layer's output over model by
    all-reduce. Its step is the sequence-parallel run's first, which moves
    fewer all-reduce bytes over model a step."""
    sp, whole = four["tinyllama"], four["no_seq_parallel"]
    assert_metrics(whole["metrics"], sp["metrics"][:1], RANK_TOL)
    assert_grads(whole["grads"][0], sp["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)
    on_sp, on_whole = sp["counts"]["model"], whole["counts"]["model"]
    assert on_whole["ops"]["all_reduce_sum"] > 0
    assert "reduce_scatter" not in on_whole["ops"]
    assert (on_sp["op_bytes"]["all_reduce_sum"] / STEPS
            < on_whole["op_bytes"]["all_reduce_sum"])


@pytest.mark.parametrize("case,arch,kw", [
    ("whisper", "whisper-large-v3", {}),
    ("llava_uneven", "llava-next-34b", dict(patches=PATCHES))])
def test_frontends_under_seq_parallel_equal_one_rank(four, case, arch, kw):
    """whisper (its encoder whole on every tp rank, cross-attention on the
    gathered queries, learned positions on each rank's rows) and llava
    (5 patches and 32 tokens: blocks of 19 and 18 rows, the first holding
    the patches): one step, one rank's numbers."""
    got = four[case]
    want = run(arch, ONE, steps=1, **kw)
    assert_metrics(got["metrics"], want["metrics"], RANK_TOL)
    assert_grads(got["grads"][0], want["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)


def test_hidden_state_is_each_ranks_sequence_block(four):
    """The hidden state a layer returns on rank (data d, model m): its
    block of the batch over data and of the sequence over model, in
    ``tensor_split`` order, uneven blocks included."""
    for case, arch, rows in (("whisper", "whisper-large-v3", SEQ),
                             ("llava_uneven", "llava-next-34b",
                              PATCHES + SEQ)):
        d = get_config(arch).reduced().d_model
        blocks = [len(b) for b in np.array_split(np.arange(rows), 2)]
        assert four[case]["hidden"] == [(BATCH // 2, blocks[r % 2], d)
                                        for r in range(4)], case


def _nested(flat, cfg):
    return params_to_numpy(cfg, {n: torch.from_numpy(v)
                                 for n, v in flat.items()})


def test_tinyllama_mesh_matches_reference(four, tiny_reference):
    """(data 2, model 2) against the reference's one-device step at
    ``tests/test_torch_train.py``'s tolerances."""
    cfg = get_config("tinyllama-1.1b").reduced()
    got = four["tinyllama"]
    assert_metrics(got["metrics"], tiny_reference["metrics"], METRIC_TOL,
                   ("loss", "grad_norm", "lr", "tokens", "accuracy"))
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(got["grads"], tiny_reference["grads"]):
        for x, y in zip(leaves(_nested(a, cfg)), leaves(b)):
            np.testing.assert_allclose(x, y, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_FRAC * np.abs(y).max())
    sure = [leaves(jax.tree_util.tree_map(
        lambda g: (np.abs(g) >= G_FLOOR_FRAC * np.abs(g).max()) | (g == 0),
        g)) for g in tiny_reference["grads"]]
    sure = [np.logical_and.reduce(s) for s in zip(*sure)]
    names = [str(i) for i in range(len(sure))]
    assert_params(dict(zip(names, leaves(_nested(got["params"], cfg)))),
                  dict(zip(names, leaves(tiny_reference["params"]))),
                  dict(zip(names, sure)), STEPS)


def test_uneven_loss_mask_is_the_global_mean(four):
    """A mask keeping 1 in 8 tokens on the first data rank and 7 in 8 on
    the second: the loss is the mean over the global tokens, as one rank's,
    not the mean of the ranks' means."""
    got = four["uneven_mask"]
    want = run("tinyllama-1.1b", ONE, steps=1, mask=uneven_mask())
    assert_metrics(got["metrics"], want["metrics"], RANK_TOL)
    assert got["metrics"][0]["tokens"] == float(uneven_mask().sum())
    assert_grads(got["grads"][0], want["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)


def test_shard_grads_equals_the_all_reduce(four):
    """``shard_grads`` is the reference's partitioner hint: with it and
    without, the blocks' gradients are reduce-scattered over the data
    ranks, and the two steps are the same."""
    got, want = four["shard_grads"], four["tinyllama"]
    assert_metrics(got["metrics"], want["metrics"][:2],
                   dict(rtol=1e-6, atol=0.0))
    for run_ in (got, want):
        assert run_["counts"]["data"]["ops"]["reduce_scatter"] > 0


def test_moe_routes_exact_and_aux_over_global_tokens(four):
    """granite-moe through the sorted dispatch at dp 2 / tp 2 (experts
    split over tp): every router call routes as one rank dispatching in 2
    groups (one a data rank), and the loss and the aux (its means over
    the global tokens) are one rank's."""
    got = four["moe"]
    want = run(MOE_ARCH, ONE, steps=2, moe_impl="sorted", moe_groups=2)
    assert len(got["routes"]) == len(want["routes"]) == 2
    for a, b in zip(got["routes"], want["routes"]):
        np.testing.assert_array_equal(a, b)
    assert_metrics(got["metrics"], want["metrics"], RANK_TOL)
    assert_grads(got["grads"][0], want["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)
    assert all(m["aux"] > 0.5 for m in got["metrics"])


def test_moe_dense_oracle_split_over_tp(four):
    got = four["moe_dense"]
    want = run(MOE_ARCH, ONE, steps=1, moe_impl="dense")
    for a, b in zip(got["routes"], want["routes"]):
        np.testing.assert_array_equal(a, b)
    assert_metrics(got["metrics"], want["metrics"], RANK_TOL)


def test_mamba2_mesh_equals_one_rank(four):
    """The Mamba-2 mixer runs whole on every tp rank (its leaves gathered
    over both axes): the numbers stay one rank's."""
    got = four["mamba2"]
    want = run("mamba2-780m", ONE, steps=2)
    assert_metrics(got["metrics"], want["metrics"], RANK_TOL)
    assert_grads(got["grads"][0], want["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_other_tp_splits_equal_one_rank(four, case):
    """MQA (one kv head: each rank reads it whole and picks it for its
    query heads), 3 heads (attention whole on every tp rank), 3 experts
    (every expert's d_ff split over tp) and qwen2-moe's shared expert
    split with the routed ones: one step, one rank's numbers."""
    arch, cfg_kw, model_kw = SPLITS[case]
    got = four[case]
    if "moe_impl" in model_kw:          # one dispatch group a data rank
        model_kw = dict(model_kw, moe_groups=2)
    want = run(arch, ONE, steps=1, cfg_kw=cfg_kw, **model_kw)
    assert_metrics(got["metrics"], want["metrics"], RANK_TOL)
    assert_grads(got["grads"][0], want["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)
    for a, b in zip(got["routes"], want["routes"]):
        np.testing.assert_array_equal(a, b)


def test_vocab_parallel_loss_and_accuracy_ties(four):
    """``lm_loss`` on logits split over dp (rows) and tp (vocab): a value
    tied across the two vocab blocks counts as the lower column (a hit
    for its label, a miss for the other's), a padded column's 80 is
    masked, and loss, tokens and the logits' gradient are one rank's."""
    got, want = four["loss"], loss_case(ONE)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["tokens"] == want["tokens"]
    assert got["accuracy"] == want["accuracy"] > 0
    np.testing.assert_allclose(got["grad"], want["grad"], rtol=1e-5,
                               atol=1e-9)


def test_mesh_checkpoint_resumes_equal_to_one_rank(four, tmp_path):
    """``train(mesh=)`` writes the one-rank checkpoint format from rank 0
    only; resumed from its step-2 checkpoint, the mesh ends bit for bit
    where it ended straight; one rank resumed from the same checkpoint
    trains steps 3-4 as the mesh did; and the straight run's losses are
    one rank's."""
    straight, resumed = four["ckpt_straight"], four["ckpt_resumed"]
    for name, p in straight["params"].items():
        np.testing.assert_array_equal(resumed["params"][name], p)
    assert resumed["log"][0] == f"resumed from step {CKPT_EVERY}"
    assert resumed["loss"] == straight["loss"][CKPT_EVERY:]
    one = train_run(None, tmp_path / "one")
    np.testing.assert_allclose(straight["loss"], one["loss"], **RANK_TOL)
    np.testing.assert_allclose(straight["grad_norm"], one["grad_norm"],
                               **RANK_TOL)
    # the mesh's last checkpoint holds its gathered parameters
    cfg = get_config("tinyllama-1.1b").reduced()
    saved = Checkpointer(str(four["where"] / "ckpt")).restore()
    assert int(saved["opt"]["step"]) == CKPT_STEPS
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(leaves(saved["params"]),
                    leaves(_nested(straight["params"], cfg))):
        np.testing.assert_array_equal(a, b)
    # one rank resumes from the mesh's step-2 checkpoint
    shutil.copytree(four["where"] / "ckpt", tmp_path / "from_mesh")
    shutil.rmtree(tmp_path / "from_mesh" / f"step_{CKPT_STEPS:010d}")
    again = train_run(None, tmp_path / "from_mesh")
    assert again["log"][0] == f"resumed from step {CKPT_EVERY}"
    np.testing.assert_allclose(again["loss"], straight["loss"][CKPT_EVERY:],
                               **RANK_TOL)


def test_place_keeps_each_ranks_block_of_each_microbatch(four):
    # ranks (data, model) in row-major order: data rank 0 is ranks 0, 1
    assert four["place_rows"] == [[0, 1, 4, 5]] * 2 + [[2, 3, 6, 7]] * 2
    assert "does not split" in four["place_refused"]


# ---------------------------------------------------------------------------
# 8 ranks on (pod 2, data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pod_one():
    return run("tinyllama-1.1b", ONE, batch=POD_BATCH)


def test_train_ctx_on_eight_ranks_equals_one_rank(eight, pod_one):
    """``make_train_ctx`` on (pod 2, data 2, model 2): fsdp over pod and
    data together (one flat group), tp over model."""
    got = eight["train_ctx"]
    assert_metrics(got["metrics"], pod_one["metrics"][:2], RANK_TOL)
    assert_grads(got["grads"][0], pod_one["grads"][0], RANK_GRAD_RTOL,
                 RANK_GRAD_ATOL_FRAC)
    assert "pod+data" in got["counts"]


def test_compress_pod_reduce_on_eight_ranks_close_to_exact(eight, pod_one):
    """The reference test's setting (8 x 33 tokens, 3 steps; dp over pod
    and data, fsdp over data): the exact reduce is one rank's; the int8
    compressed mean over pods ends within 5% of it, and the pod axis
    carries int8: each step one all-gather of every leaf's int8 block
    and one of its float32 scale, a quarter of a float32 gather's
    bytes."""
    exact, comp = eight["pods_False"], eight["pods_True"]
    assert_metrics(exact["metrics"], pod_one["metrics"], RANK_TOL)
    final_exact = exact["metrics"][-1]["loss"]
    final_comp = comp["metrics"][-1]["loss"]
    assert abs(final_exact - final_comp) / final_exact < 0.05
    assert final_comp != final_exact
    pod = comp["counts"]["pod"]
    leaves = len(pod_one["params"])
    assert pod["ops"] == {"all_gather": 2 * leaves * STEPS,
                          "all_reduce_sum": STEPS}
    # 2 pods x this rank's block elements x 1 byte, the 2 scales of each
    # leaf, and the 5 metrics averaged over pods
    assert pod["bytes"] == STEPS * (2 * comp["block_numel"] + 2 * 4 * leaves
                                    + 4 * 5)
    assert "pod" in exact["counts"]
    assert "all_gather" not in exact["counts"]["pod"]["ops"]


def test_compressed_psum_tree_is_the_mean_over_pods(eight):
    """Every rank's leaves quantized on the same draws (the reference's
    shared key), gathered over pod as int8 and averaged: one rank's
    formula on the two pods' leaves."""
    for rank, got in enumerate(eight["psum"]):
        pods = [eight["psum_leaves"][rank % 4], eight["psum_leaves"][
            rank % 4 + 4]]
        for i, name in enumerate(got):
            parts = []
            for leaves in pods:
                src = compress._sources(5, len(got), "cpu")[i]
                q, s = compress.quantize(torch.from_numpy(leaves[name]), src)
                parts.append(compress.dequantize(q, s))
            want = (parts[0] + parts[1]) / 2
            np.testing.assert_array_equal(got[name], want.numpy())
    assert eight["psum_counts"]["pod"]["ops"] == {"all_gather": 4}


def test_compressed_reduce_refuses_parameters_blocked_over_pods(eight):
    assert "replicated over the pod axis" in eight["pods_refused"]
