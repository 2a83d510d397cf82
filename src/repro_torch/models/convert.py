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
the router float32) as the attention's and FFN's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def params_from_numpy(cfg: ModelConfig, params_np: dict) -> dict:
    """State dict (name -> float tensor on the CPU) for ``Model(cfg)`` from
    the reference's parameter tree."""
    sd = {}
    for key, sub in params_np.items():
        if key == "stack":
            continue
        if isinstance(sub, dict):
            for name, val in _flatten(sub, key + "."):
                sd[name] = torch.from_numpy(np.array(val))
        else:
            sd[key] = torch.from_numpy(np.array(sub))
    for s_name, sub in params_np["stack"].items():
        s = int(s_name.removeprefix("sub"))
        for name, val in _flatten(sub):
            arr = np.asarray(val)
            if arr.shape[0] != cfg.num_periods:
                raise ValueError(f"stack.{s_name}.{name}: leading axis "
                                 f"{arr.shape[0]} != num_periods "
                                 f"{cfg.num_periods}")
            for period in range(cfg.num_periods):
                layer = period * cfg.scan_period + s
                sd[f"layers.{layer}.{name}"] = torch.from_numpy(
                    np.array(arr[period]))
    return sd


def _put(tree: dict, dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def params_to_numpy(cfg: ModelConfig, state_dict) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, layer
    leaves stacked over periods under ``stack.sub{s}``) from a state dict
    of ``Model(cfg)`` (name -> tensor on any device)."""
    tree: dict = {"stack": {}}
    per_layer: dict = {}
    for name, val in state_dict.items():
        if name.startswith("layers."):
            layer, leaf = name.removeprefix("layers.").split(".", 1)
            period, s = divmod(int(layer), cfg.scan_period)
            per_layer.setdefault(f"sub{s}.{leaf}", {})[period] = _to_np(val)
        else:
            _put(tree, name, _to_np(val))
    for name, periods in per_layer.items():
        if sorted(periods) != list(range(cfg.num_periods)):
            raise ValueError(f"{name}: periods {sorted(periods)}, expected "
                             f"{cfg.num_periods}")
        _put(tree["stack"], name, np.stack(
            [periods[p] for p in range(cfg.num_periods)]))
    return tree


def _to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache ``{"sub{s}": [layer cache per period]}`` as the
    reference's tree of numpy arrays stacked over periods."""
    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack([_to_np(it) for it in items])
    return {s: stack(layers) for s, layers in cache.items()}
