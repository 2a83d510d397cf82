"""One train step in the dry run's train_4k configuration on both packages,
on the CPU: reduced tinyllama-1.1b with bfloat16 compute, ``remat=True``,
2 microbatches and bfloat16 AdamW moments (``repro/launch/dryrun.py``'s
train cell; bf16 moments there are for models above 20e9 parameters), the
port's flash wrapper (``attn_impl="kernel"``: on CPU tensors the plain
versions, in bf16) against the reference's Pallas kernel in interpret mode
with its custom VJP (``attn_impl="pallas"``), from the same parameters
(``models.convert``) and tokens.

bfloat16 rounds at other places in the two packages, so the bound comes
from the reference's own drift, the gap between its bf16 and float32
steps: for the loss, the grad norm and each parameter leaf after the step,
the gap between the packages' bf16 steps, and the gap between the port's
own bf16 and float32 steps, must each be at most 2 x the reference's
drift plus a floor: the float32 parity tolerances of
tests/test_torch_train.py (rtol 2e-5 of the value for the loss and grad
norm, atol 2e-6 for parameters), and for a parameter leaf also two
elements' sign flips (FLIPS x 2 lr / its size; see below). The port's
drift is held to the reference's, not added to the bound: a port that
rounds in the wrong place would widen a bound built on its own drift by as
much as it errs. A parameter leaf's gap
is its mean absolute difference: AdamW's first step moves an element by
about lr x sign(g), so its largest difference is 2 lr wherever one sign
flips, and the mean counts how many flip. In a leaf of 256 elements (a
norm's scale) one flip is 7.8e-6 and the reference's drift is one or two
flips, so two runs that each flip a different element or two already
differ by more than twice that: the floor's FLIPS covers that granularity,
and is below 3e-7 in every leaf of 16384 elements or more. The reference
runs two jitted steps, bf16 and float32, and nothing more."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models.model import Model as JaxModel
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import get_config
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model
from repro_torch.train import optimizer, train_step

ARCH = "tinyllama-1.1b"
BATCH, SEQ, MICROBATCHES, MOMENTS = 4, 32, 2, "bfloat16"
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, moment_dtype=MOMENTS)
METRIC_FLOOR_RTOL, PARAM_FLOOR, FLIPS = 2e-5, 2e-6, 2


def _leaves(tree):
    return [np.asarray(x, np.float32)
            for x in jax.tree_util.tree_leaves(tree)]


def _reference(jcfg, params, toks, compute_dtype):
    jm = JaxModel(jcfg, compute_dtype=compute_dtype, attn_impl="pallas",
                  remat=True, max_seq=SEQ + 8)
    step = jax.jit(jstep.make_train_step(
        jm, jopt.optimizer_for_arch(ARCH, **OPT), microbatches=MICROBATCHES))
    state = {"params": params, "opt": jopt.init_opt_state(params, MOMENTS),
             "rng": jax.random.PRNGKey(1)}
    new, met = step(state, {"tokens": jnp.asarray(toks)})
    return ({k: float(met[k]) for k in ("loss", "grad_norm")},
            _leaves(new["params"]))


def _port(cfg, params_np, toks, compute_dtype):
    model = Model(cfg, device="cpu", compute_dtype=compute_dtype,
                  attn_impl="kernel", remat=True, max_seq=SEQ + 8)
    model.load_state_dict(params_from_numpy(cfg, params_np), strict=True)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"params": params,
             "opt": optimizer.init_opt_state(params, MOMENTS)}
    step = train_step.make_train_step(
        model, optimizer.optimizer_for_arch(ARCH, **OPT),
        microbatches=MICROBATCHES)
    _, met = step(state, {"tokens": torch.from_numpy(toks)})
    assert {m.dtype for m in state["opt"]["m"].values()} == {torch.bfloat16}
    return ({k: float(met[k]) for k in ("loss", "grad_norm")},
            _leaves(params_to_numpy(cfg, model.state_dict())))


def test_bf16_remat_microbatched_step_matches_reference_within_drift():
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    params = JaxModel(jcfg, max_seq=SEQ + 8).init_params(
        jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    before = attn_ops.launches, attn_ops.bwd_launches
    runs = {(pkg, dt): fn(c, p, toks, dt)
            for pkg, fn, c, p in (("ref", _reference, jcfg, params),
                                  ("port", _port, cfg, params_np))
            for dt in ("bfloat16", "float32")}
    assert (attn_ops.launches, attn_ops.bwd_launches) == before    # CPU

    def gaps(a, b):
        (ma, pa), (mb, pb) = runs[a], runs[b]
        return ({k: abs(ma[k] - mb[k]) for k in ma},
                [float(np.abs(x - y).mean()) for x, y in zip(pa, pb)])

    (m_cross, p_cross) = gaps(("port", "bfloat16"), ("ref", "bfloat16"))
    (m_port, p_port) = gaps(("port", "bfloat16"), ("port", "float32"))
    (m_ref, p_ref) = gaps(("ref", "bfloat16"), ("ref", "float32"))
    m_bound = {k: 2 * d + METRIC_FLOOR_RTOL
               * abs(runs[("ref", "float32")][0][k]) for k, d in m_ref.items()}
    p_bound = [2 * d + PARAM_FLOOR + FLIPS * 2 * OPT["lr"] / x.size
               for d, x in zip(p_ref, runs[("ref", "float32")][1])]
    worst = max(range(len(p_bound)),
                key=lambda i: max(p_cross[i], p_port[i]) / p_bound[i])
    msg = (f"gaps (loss, grad norm) port vs reference in bf16 {m_cross}, "
           f"port bf16 vs float32 {m_port}, bound {m_bound} (reference "
           f"bf16 vs float32 {m_ref}); the closest leaf, {worst}: port vs "
           f"reference {p_cross[worst]:.3g}, port's own {p_port[worst]:.3g}"
           f", bound {p_bound[worst]:.3g} (reference's {p_ref[worst]:.3g})")
    print(msg)
    for k, bound in m_bound.items():
        assert m_cross[k] <= bound, f"{k} across packages: {msg}"
        assert m_port[k] <= bound, f"{k}, the port's own drift: {msg}"
    for i, bound in enumerate(p_bound):
        assert p_cross[i] <= bound, f"leaf {i} across packages: {msg}"
        assert p_port[i] <= bound, f"leaf {i}, the port's own drift: {msg}"
    assert all(np.isfinite(x).all() for x in runs[("port", "bfloat16")][1])
