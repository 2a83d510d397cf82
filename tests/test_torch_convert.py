"""The parameter converter (``repro_torch.models.convert``) against the JAX
reference's own trees, on the CPU: every arch's reduced parameters go
into the port's ``Model`` and back out bit for bit (whisper's encoder
stack, cross-attention and learned positions included), and bfloat16
parameters (llava's and jamba's ``param_dtype``, forced here onto the
reduced configs) cross as ``ml_dtypes.bfloat16`` <-> ``torch.bfloat16``
without a rounding. A bfloat16-parameter model computing in float32
gives the reference's logits at ``MODEL_TOL``."""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, list_archs
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model

from torch_parity import MODEL_TOL, frontend_embeds, to_np

BF16_ARCHS = ["jamba-1.5-large-398b", "llava-next-34b", "whisper-large-v3"]


def _reference(cfg, seed=0):
    """The reference's parameters of ``cfg`` as a tree of numpy arrays."""
    params = JaxModel(cfg, max_seq=48).init_params(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_same_tree(ours, theirs):
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(theirs))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", list_archs())
def test_round_trip_is_exact(arch):
    """reference tree -> the port's state dict -> ``Model`` (strict) ->
    the reference's tree again, every leaf bit for bit."""
    cfg = get_config(arch).reduced()
    tree = _reference(cfg)
    m = Model(cfg, device="cpu", max_seq=48)
    m.load_state_dict(params_from_numpy(cfg, tree), strict=True)
    _assert_same_tree(params_to_numpy(cfg, m.state_dict()), tree)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bfloat16_parameters_cross_bit_for_bit(arch):
    """``param_dtype="bfloat16"`` on the reduced config: the reference's
    ``ml_dtypes.bfloat16`` leaves become ``torch.bfloat16`` parameters of
    the same bits (the float32 ones, the router and SSM scalars, stay
    float32), and come back as ``ml_dtypes.bfloat16``; the model, computing
    in float32, matches the reference's forward logits."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16")
    tree = _reference(cfg, seed=4)
    dtypes = {leaf.dtype for leaf in jax.tree_util.tree_leaves(tree)}
    assert np.dtype(ml_dtypes.bfloat16) in dtypes
    sd = params_from_numpy(cfg, tree)
    m = Model(cfg, device="cpu", max_seq=48)
    m.load_state_dict(sd, strict=True)
    for name, p in m.state_dict().items():
        assert p.dtype == sd[name].dtype, name
        assert torch.equal(p.view(torch.uint8), sd[name].view(torch.uint8))
    assert m.embed["tokens"].dtype == torch.bfloat16
    _assert_same_tree(params_to_numpy(cfg, m.state_dict()), tree)

    rs = np.random.default_rng(5)
    batch = {"tokens": rs.integers(0, cfg.vocab_size, (2, 12)).astype(
        np.int32), **frontend_embeds(cfg, 2, rs)}
    want, _ = JaxModel(cfg, max_seq=48).forward(
        jax.tree_util.tree_map(jax.numpy.asarray, tree),
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got, _ = m.forward({k: torch.from_numpy(v)
                            for k, v in batch.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **MODEL_TOL)


def test_a_stack_of_the_wrong_depth_is_refused():
    cfg = get_config("whisper-large-v3").reduced()
    tree = _reference(cfg)
    tree["enc_stack"]["sub0"]["attn"]["q"] = \
        tree["enc_stack"]["sub0"]["attn"]["q"][:1]
    with pytest.raises(ValueError, match="enc_stack.sub0.attn.q"):
        params_from_numpy(cfg, tree)
    sd = params_from_numpy(get_config("whisper-large-v3").reduced(),
                           _reference(cfg))
    del sd["enc_layers.1.ffn.wo"]
    with pytest.raises(ValueError, match="enc_stack.sub0.ffn.wo"):
        params_to_numpy(cfg, sd)
