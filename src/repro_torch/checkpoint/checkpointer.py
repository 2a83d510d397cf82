"""Atomic, async checkpointing of nested dicts of arrays: the port's own
numpy copy of ``repro.checkpoint.checkpointer``, writing the same on-disk
format, so a checkpoint of either package restores in the other.

  * write to a temp directory ``.tmp_<step>``, fsync the manifest, then
    ``os.replace`` to ``step_<step:010d>`` — a checkpoint is either fully
    present or absent, never torn;
  * ``manifest.json`` carries shapes/dtypes + CRC32 per array, and
    ``arrays.npz`` the arrays (paths flattened with '/', stored with '|');
    restores verify integrity before handing state back;
  * async mode copies the state to host numpy arrays synchronously and
    does the file I/O on a writer thread, so the GA loop never blocks on
    disk;
  * ``keep`` bounds disk usage (oldest checkpoints pruned).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _to_numpy(v) -> np.ndarray:
    """Host copy of a leaf: torch tensors (any device), numpy arrays and
    Python scalars."""
    if hasattr(v, "detach"):                  # torch.Tensor
        return np.array(v.detach().cpu())
    return np.array(v)


def _flatten(tree: Any, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten(flat: dict) -> Any:
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


class Checkpointer:
    def __init__(self, directory: str, *, async_write: bool = True,
                 keep: int = 3):
        self.dir = directory
        self.async_write = async_write
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, state: Any, step: int) -> None:
        flat = _flatten(state)
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(flat, step), daemon=True)
            self._thread.start()
        else:
            self._write(flat, step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, flat: dict, step: int) -> None:
        tmp = os.path.join(self.dir, f".tmp_{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz_path = os.path.join(tmp, _ARRAYS)
        np.savez(npz_path, **{k.replace("/", "|"): v
                              for k, v in flat.items()})
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                           "crc32": zlib.crc32(np.ascontiguousarray(v)
                                               .tobytes())}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[Any]:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, _ARRAYS)) as npz:
            flat = {}
            for key, meta in manifest["arrays"].items():
                v = npz[key.replace("/", "|")]
                crc = zlib.crc32(np.ascontiguousarray(v).tobytes())
                if crc != meta["crc32"]:
                    raise IOError(f"checkpoint corruption at {key}: "
                                  f"crc {crc} != {meta['crc32']}")
                flat[key] = v
        return _unflatten(flat)
