"""Parameters and caches carried across between the reference's layout and
the port's ``Model``.

The reference keeps parameters as a nested dict whose layer leaves are
stacked over periods: ``params["stack"]["sub{s}"][kind][leaf]`` has a
leading ``num_periods`` axis, and layer ``period * scan_period + s`` is
its slice ``[period]``. The port keeps one module per layer.

* ``params_from_numpy(cfg, params_np)`` turns that tree (numpy arrays)
  into a state dict for the port's ``Model``:
  ``model.load_state_dict(params_from_numpy(cfg, tree))``.
* ``params_to_numpy(cfg, state_dict)`` is its inverse: the reference's
  tree of numpy arrays, per-layer tensors restacked over periods (for
  comparing trained parameters, and for checkpoints in the reference's
  layout).
* ``cache_to_numpy(cache)`` stacks the port's per-layer cache lists back
  into the reference's layout, leaf by leaf. A continuous batcher's lane
  pool (``serve.batching``: ``cache_pos`` (slots, T_cache)) stacks to
  (periods, slots, ...); the reference's batcher keeps its lane axis
  first, (slots, periods, 1, ...).

Every leaf of a layer goes across under its own name, the MoE sub-layer's
(``stack.sub{s}.moe.{ln, router, wi, wg, wo, swi, swg, swo, sgate}``,
the router float32) and whisper's cross-attention
(``stack.sub{s}.cross.{ln, xq, xk, xv, xo}``) as the attention's and
FFN's. Whisper's encoder goes across the same way: the reference stacks
its layers over ``encoder_layers`` under ``enc_stack.sub0``, the port
keeps ``enc_layers.{i}``; ``enc_pos.table``, ``enc_norm`` and the learned
positions ``pos.table`` keep their names. bfloat16 leaves (llava's and
jamba's ``param_dtype``) reach numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses: they cross bit for bit through a 16-bit
integer view, both ways (``params_to_numpy`` needs ``ml_dtypes`` only
for such leaves).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# the reference's stacked trees and the port's per-layer module lists:
# (reference prefix, port prefix, layers per stack from the config)
_STACKS = (("stack", "layers"), ("enc_stack", "enc_layers"))


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _tensor(arr) -> torch.Tensor:
    """A CPU tensor of a numpy array's values, bfloat16 bit for bit."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _periods(cfg: ModelConfig, stack: str) -> tuple:
    """(periods, layers per period) of a stacked tree."""
    if stack == "enc_stack":
        return cfg.encoder_layers, 1
    return cfg.num_periods, cfg.scan_period


def params_from_numpy(cfg: ModelConfig, params_np: dict) -> dict:
    """State dict (name -> tensor on the CPU) for ``Model(cfg)`` from the
    reference's parameter tree."""
    sd = {}
    stacks = dict(_STACKS)
    for key, sub in params_np.items():
        if key in stacks:
            continue
        if isinstance(sub, dict):
            for name, val in _flatten(sub, key + "."):
                sd[name] = _tensor(val)
        else:
            sd[key] = _tensor(sub)
    for key, port in _STACKS:
        if key not in params_np:
            continue
        periods, per = _periods(cfg, key)
        for s_name, sub in params_np[key].items():
            s = int(s_name.removeprefix("sub"))
            for name, val in _flatten(sub):
                arr = np.asarray(val)
                if arr.shape[0] != periods:
                    raise ValueError(f"{key}.{s_name}.{name}: leading axis "
                                     f"{arr.shape[0]} != {periods} periods")
                for period in range(periods):
                    layer = period * per + s
                    sd[f"{port}.{layer}.{name}"] = _tensor(arr[period])
    return sd


def _put(tree: dict, dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def params_to_numpy(cfg: ModelConfig, state_dict) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, layer
    leaves stacked over periods under ``stack.sub{s}``, the encoder's
    under ``enc_stack.sub0``) from a state dict of ``Model(cfg)`` (name ->
    tensor on any device)."""
    tree: dict = {"stack": {}}
    per_layer: dict = {}
    ports = {port: key for key, port in _STACKS}
    for name, val in state_dict.items():
        head = name.split(".", 1)[0]
        if head in ports:
            key = ports[head]
            layer, leaf = name.removeprefix(head + ".").split(".", 1)
            period, s = divmod(int(layer), _periods(cfg, key)[1])
            per_layer.setdefault((key, f"sub{s}.{leaf}"), {})[period] = \
                _to_np(val)
        else:
            _put(tree, name, _to_np(val))
    for (key, name), periods in per_layer.items():
        n = _periods(cfg, key)[0]
        if sorted(periods) != list(range(n)):
            raise ValueError(f"{key}.{name}: periods {sorted(periods)}, "
                             f"expected {n}")
        _put(tree.setdefault(key, {}), name,
             np.stack([periods[p] for p in range(n)]))
    return tree


def _to_np(x):
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache ``{"sub{s}": [layer cache per period]}`` as the
    reference's tree of numpy arrays stacked over periods."""
    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack([_to_np(it) for it in items])
    return {s: stack(layers) for s, layers in cache.items()}
