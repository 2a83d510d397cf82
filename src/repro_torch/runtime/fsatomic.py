"""Atomic file publication for the broker/spool file protocol (the port's
copy of the reference's ``runtime/fsatomic.py``).

Every file another process POLLS for — task files, result files, failure
markers, manifests, job payloads, run-registry entries, fleet tickets —
must appear atomically: the writer writes a tmp sibling (``<path>.tmp``),
flushes and fsyncs it, and ``os.replace``-renames it into place. A reader
that polls by name (``os.path.exists`` / ``os.listdir``) then either sees
nothing or sees the complete file — never a torn prefix, even if the
writer crashes mid-write. This is the invariant the whole queue tier
stands on (``runtime/mq.py`` claims, results, leases-by-rename;
``runtime/batchq.py`` spool chunks and results), and it is ENFORCED
statically: the protocol linter's ``atomic-write`` rule, pointed at this
package by ``tests/test_torch_imports.py``, flags any raw write-mode
``open`` / ``json.dump`` / ``pickle.dump`` / ``np.save*`` in the protocol
modules that does not go through this module (deliberate exceptions are
marked ``# exception[atomic-write]`` where the reference allows them).

Conventions shared with the pollers:

* the tmp sibling lives in the SAME directory as the target (rename must
  not cross filesystems), named ``<target>.tmp`` — every queue reader
  treats ``*.tmp`` as invisible (``claim_next`` requires ``.npz``,
  result collection polls exact names), and the run-aware GC sweeps
  orphaned tmps of crashed writers with their job;
* one live writer per target path at a time (the queue protocol already
  guarantees this: task/result names are unique per delivery, registry
  writes are per-run) — concurrent writers to one path would race on the
  tmp sibling;
* the write is fsynced before the rename, so a crash cannot publish a
  name whose bytes never reached disk. Directory fsync is deliberately
  skipped, matching the historical helpers: on the shared cluster
  filesystems this protocol targets, close-to-open consistency already
  orders the rename behind the data.

Import discipline: stdlib + numpy only — this module sits on the
numpy-only worker startup path (``repro_torch.runtime.batchq --worker``).
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

#: suffix of the in-flight tmp sibling; every poller ignores it
TMP_SUFFIX = ".tmp"


def _publish(path: str, mode: str, write) -> None:
    """Write ``<path>.tmp`` via ``write(file)``, fsync, rename into place.
    The tmp sibling is removed on a failed write so crashed writers don't
    strand partial files beyond the next GC sweep."""
    tmp = path + TMP_SUFFIX
    try:
        with open(tmp, mode) as f:  # the one raw open: this IS the helper
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str) -> None:
    """Publish ``text`` at ``path`` atomically (tmp sibling + rename)."""
    _publish(path, "w", lambda f: f.write(text))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Publish raw ``data`` at ``path`` atomically."""
    _publish(path, "wb", lambda f: f.write(data))


def atomic_write_json(path: str, obj, **dump_kwargs) -> None:
    """Publish ``json.dumps(obj)`` at ``path`` atomically."""
    # exception[atomic-write], as the reference allows: dump lands in the
    # helper's own tmp handle
    _publish(path, "w", lambda f: json.dump(obj, f, **dump_kwargs))


def atomic_pickle(path: str, obj) -> None:
    """Publish ``pickle.dumps(obj)`` at ``path`` atomically."""
    # exception[atomic-write], as the reference allows: dump lands in the
    # helper's own tmp handle
    _publish(path, "wb", lambda f: pickle.dump(obj, f))


def atomic_savez(path: str, **arrays) -> None:
    """Publish an ``.npz`` of ``arrays`` at ``path`` atomically."""
    # exception[atomic-write], as the reference allows: savez lands in the
    # helper's own tmp handle
    _publish(path, "wb", lambda f: np.savez(f, **arrays))
