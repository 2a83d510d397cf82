"""Batch-scheduled dispatch: the paper's K8s<->SLURM portability story.

The port of the reference's ``runtime/batchq.py``. Workers are spawned
as ``python -m repro_torch.runtime.batchq --worker``, and the fitness
specs they resolve name ``repro_torch.fitness.hostsim``. The manager
side bridges CUDA genomes through ``PureCallbackBridge`` (a copy to the
host and back); the worker side is numpy only.

CHAMB-GA §1 claims seamless migration of the simulation microservice
between Kubernetes and SLURM. :class:`SlurmArrayBackend` implements the
``DispatchBackend`` protocol by *spooling* each evaluation batch to a
shared filesystem and submitting it as array-job work items through a
pluggable :class:`Scheduler` — the same GA workload drives a SLURM array
job (:class:`SlurmScheduler`), a Kubernetes indexed Job
(:class:`KubernetesScheduler`), or local mock workers
(:class:`LocalMockScheduler` / :class:`MockKubectl`) by swapping only the
scheduler object.

Flow per ``evaluate`` call (see the "Batch-scheduled dispatch" section of
``repro_torch.core.broker`` for the spool layout):

1. the (shuffled, padded) genome batch is split into chunks — equal
   counts, or sized by predicted per-genome cost when the broker supplies
   a cost model (``hostbridge.cost_sized_chunk_sizes``; the batch is
   re-ordered pricier-first host-side so expensive genomes land in small
   chunks and array tasks finish together) — each written to
   ``<spool>/job_NNNNNN/chunk_IIII_tryT.npz``;
2. the scheduler submits attempt 0 as ONE array submission (``sbatch
   --array`` / one indexed Job), one work item per chunk;
3. each work item runs
   ``python -m repro_torch.runtime.batchq --worker <chunk>``
   which loads the chunk, resolves the fitness function (import spec or
   pickle), evaluates, and atomically writes ``*.result.npz`` carrying the
   fitness plus the measured wall time (fed to the broker's ``CostEMA``);
4. the backend polls result files with a per-chunk timeout clocked on
   execution time only; stragglers and failures are *re-queued* as fresh
   single-item attempts through
   :func:`repro_torch.core.broker.run_chunks_retry` — the same timeout/retry
   wrapper that hardens ``HostPoolBackend``;
5. once a job's results are collected, superseded attempt files are
   deleted, completed ``job_*`` directories beyond ``keep_jobs`` are
   pruned (checkpointer-style spool GC), and schedulers that own cluster
   objects reap them (``KubernetesScheduler`` deletes its Job objects).

Scheduler protocol contract
---------------------------
``submit(chunk_paths, *, job_dir) -> handles`` places one work item per
chunk and returns opaque per-chunk handles; a multi-chunk submit SHOULD
be a single scheduler round-trip. ``poll(handle)`` maps scheduler state
onto ``"pending"`` (queued, not started — the backend's straggler clock
does NOT run), ``"running"``, ``"done"``, ``"failed"``, or ``"unknown"``
(left the queue / object deleted; the backend keeps polling the spool and
lets the timeout decide). Result delivery is ALWAYS via the spool's
``*.result.npz`` / ``*.fail`` files, never the scheduler — which is why
the spool directory must be a filesystem shared between submitter and
workers (SLURM: the cluster FS; Kubernetes: a volume mounted at the same
path in every worker pod). ``cancel(handle)`` is best-effort: SLURM
cancels the single array task, Kubernetes can only delete whole Jobs so a
timed-out index of a multi-index Job keeps running and the re-queued
attempt races it (speculative retry). Schedulers MAY provide
``reap(handles)``: called once a batch's results are in, to delete
scheduler-side objects (K8s Job resources). ``submit`` is INCREMENTAL:
callers may invoke it again for the same ``job_dir`` at any time (the
retry path already does; ``mq.MQWorkerFleet.grow`` relies on it to scale
a persistent fleet up — one more ``sbatch --array`` / ``kubectl apply``
round-trip that leaves the work items already running untouched).

Enforced invariants (the protocol linter's checks, pointed at this
package's module names by ``tests/test_torch_imports.py``):

* **atomic-write** — everything this module publishes on a polled path
  (spooled chunks, results, ``.fail`` markers, ``payload.json`` /
  ``fn.pkl``, array manifests, k8s Job specs) goes through
  ``repro_torch.runtime.fsatomic`` (tmp sibling + fsync + ``os.replace``);
  pollers treat ``*.tmp`` as invisible, so a writer crash publishes
  nothing. This module has no exception.
* **worker-purity** — ``python -m repro_torch.runtime.batchq --worker`` is a
  worker entrypoint: its module-scope import closure must stay
  numpy-only. torch is imported lazily inside the backend methods — at
  3,500-core scale the array tasks' interpreter startup is on the
  critical path, and a fitness function that needs torch pays for it
  only when it actually imports it.
* **device boundary** — device tensors cross into this module only via
  ``PureCallbackBridge``; everything below ``_host_eval`` is host-side
  and free to do IO.
* **tmp-invisible** — spool directory listings filter entries by name
  structure (``_CHUNK_RE.fullmatch`` in the attempt pruner) before
  acting on them, so crashed writers' ``*.tmp`` droppings are skipped.

The reference's protocol model checker and thread sanitizer check the
same publish/poll discipline for the reference's copy of this module;
this copy keeps its contract: every ``stats`` increment and every
``_inflight``/``_seq`` mutation happens under ``self._lock``, and readers
use ``stats_snapshot()``.

Persistent-worker alternative: this backend is batch-synchronous — every
``evaluate`` pays scheduler submission and worker startup per chunk. The
message-queue subsystem (``repro_torch.runtime.mq``) keeps the same shared-
volume spool contract but inverts the flow: a fleet of persistent workers
(launched ONCE through this module's ``Scheduler`` protocol via
``*.worker.json`` tickets — see :func:`run_worker`) pulls leased tasks
from a queue directory and streams results back, amortizing startup
across chunks and generations and feeding the ``CostEMA`` mid-flight.
The queue is MULTI-TENANT: task names are namespaced by a run id, a
``runs/`` registry assigns each concurrent GA run a claim priority
(workers serve the highest-priority run first — cross-run work
stealing), and the fleet is ELASTIC — ``mq.FleetAutoscaler`` grows it
through this protocol's incremental ``submit`` and shrinks it with
poison ``*.stop`` tickets that idle workers honor at chunk boundaries.
Its module docstring documents the full queue contract (atomic-rename
claims, lease/heartbeat liveness, at-least-once delivery, run
namespacing, priority claims, per-run vs fleet-wide STOP).

Exported metrics
----------------
Manager-side sites publish through the no-op seam in
:mod:`repro_torch.runtime.metrics` (install
``repro_torch.obs.MetricsRegistry`` to enable; one attribute check each
when disabled; the array-task worker body emits nothing, so worker
purity is untouched):
``batchq_jobs_total{backend}`` / ``batchq_chunks_submitted_total`` /
``batchq_results_total`` / ``batchq_retries_total`` /
``batchq_timeouts_total`` (counters),
``batchq_chunk_duration_seconds`` (histogram), plus ``batchq_submit``
/ ``batchq_retry`` / ``batchq_timeout`` events.
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import (Callable, Dict, Iterable, List, Optional, Protocol,
                    runtime_checkable)

import numpy as np

from repro_torch.core.hostbridge import (PureCallbackBridge,
                                         collect_chunk_results,
                                         plan_cost_chunks,
                                         scatter_chunk_results)
from repro_torch.runtime import metrics as _metrics
from repro_torch.runtime.fsatomic import (atomic_pickle, atomic_savez,
                                          atomic_write_json,
                                          atomic_write_text)

_PAYLOAD = "payload.json"
_FN_PKL = "fn.pkl"

# directory containing the `repro` package — exported to worker
# subprocesses so `python -m repro_torch.runtime.batchq` resolves
_SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Chunk files (spool protocol)
# ---------------------------------------------------------------------------

def chunk_path(job_dir: str, index: int, attempt: int) -> str:
    return os.path.join(job_dir, f"chunk_{index:04d}_try{attempt}.npz")


def result_path(chunk: str) -> str:
    return chunk[:-len(".npz")] + ".result.npz"


def fail_path(chunk: str) -> str:
    return chunk[:-len(".npz")] + ".fail"


def resolve_fn(job_dir: str) -> Callable:
    """Fitness callable for a job: import spec first, pickle fallback."""
    with open(os.path.join(job_dir, _PAYLOAD)) as f:
        payload = json.load(f)
    spec = payload.get("fn_spec")
    if spec:
        mod, _, attr = spec.partition(":")
        return getattr(importlib.import_module(mod), attr)
    with open(os.path.join(job_dir, _FN_PKL), "rb") as f:
        return pickle.load(f)


def run_worker(chunk: str) -> int:
    """Array-task body: evaluate one spooled chunk. Exceptions become a
    ``.fail`` marker (so the polling backend re-queues) + nonzero exit.

    A ``*.worker.json`` path is not a chunk but a persistent-fleet ticket:
    the same scheduler work item then runs a long-lived message-queue
    worker (``repro_torch.runtime.mq``) instead of a single chunk — this
    is how a persistent fleet is launched as ONE long-lived SLURM array /
    Kubernetes indexed Job through the unchanged ``Scheduler`` protocol
    (see :class:`repro_torch.runtime.mq.MQWorkerFleet`)."""
    if chunk.endswith(".worker.json"):
        from repro_torch.runtime import mq
        return mq.run_worker_ticket(chunk)
    try:
        fn = resolve_fn(os.path.dirname(chunk))
        genomes = np.load(chunk)["genomes"]
        t0 = time.perf_counter()
        fit = np.asarray(fn(genomes), np.float32).reshape(len(genomes), -1)
        duration = time.perf_counter() - t0
        atomic_savez(result_path(chunk), fitness=fit,
                     duration=np.float64(duration))
        return 0
    except Exception:
        tb = traceback.format_exc()
        try:
            # the polling backend must never read a partial traceback (it
            # raises ChunkFailure with this text)
            atomic_write_text(fail_path(chunk), tb)
        except OSError:
            pass
        sys.stderr.write(tb)
        return 1


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------

@runtime_checkable
class Scheduler(Protocol):
    """Submits spooled chunks as batch work items and tracks their state.

    See the module docstring's "Scheduler protocol contract" for the full
    semantics (state meanings, shared-spool requirement, best-effort
    cancel, optional ``reap``).
    """

    name: str

    def submit(self, chunk_paths: List[str], *, job_dir: str) -> List[str]:
        """Submit one work item per chunk path; returns opaque handles."""
        ...

    def poll(self, handle: str) -> str:
        """-> "pending" | "running" | "done" | "failed" | "unknown"."""
        ...

    def cancel(self, handle: str) -> None: ...


def _spawn_local_worker(path: str, mode: str, python: str,
                        hang_substrings: tuple):
    """Shared local-worker launcher for the mock schedulers: ``None`` for
    a simulated lost node/pod (accepted, never started), else a daemon
    thread or a subprocess running the exact array-task code path
    (:func:`run_worker`)."""
    if any(s in os.path.basename(path) for s in hang_substrings):
        return None
    if mode == "subprocess":
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC_ROOT + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        return subprocess.Popen(
            [python, "-m", "repro_torch.runtime.batchq", "--worker", path],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    task = threading.Thread(target=run_worker, args=(path,), daemon=True)
    task.start()
    return task


class LocalMockScheduler:
    """Runs chunks locally — subprocesses (the CI stand-in for a cluster)
    or threads (fast conformance tests without interpreter startup). Both
    execute the exact worker code path (:func:`run_worker`).

    ``hang_substrings`` simulates lost/straggling nodes: a chunk whose
    filename contains any of them is accepted but never started, so the
    backend's per-chunk timeout fires and re-queues it (the retry file has
    a different ``tryT`` suffix and therefore runs).
    """

    name = "local-mock"

    def __init__(self, mode: str = "subprocess",
                 hang_substrings: tuple = (),
                 python: Optional[str] = None):
        if mode not in ("subprocess", "thread"):
            raise ValueError(f"mode must be subprocess|thread: {mode}")
        self.mode = mode
        self.hang_substrings = tuple(hang_substrings)
        self.python = python or sys.executable
        self._lock = threading.Lock()
        self._tasks: dict = {}
        self._seq = 0

    def submit(self, chunk_paths: List[str], *, job_dir: str) -> List[str]:
        handles = []
        for path in chunk_paths:
            with self._lock:
                handle = f"mock_{self._seq}"
                self._seq += 1
            task = _spawn_local_worker(path, self.mode, self.python,
                                       self.hang_substrings)
            with self._lock:
                self._tasks[handle] = task
            handles.append(handle)
        return handles

    def poll(self, handle: str) -> str:
        with self._lock:
            task = self._tasks.get(handle, "missing")
        if task == "missing":
            return "unknown"
        if task is None:
            return "running"                     # simulated straggler
        if isinstance(task, threading.Thread):
            return "running" if task.is_alive() else "done"
        rc = task.poll()
        if rc is None:
            return "running"
        return "done" if rc == 0 else "failed"

    def cancel(self, handle: str) -> None:
        with self._lock:
            task = self._tasks.get(handle)
        if task is not None and not isinstance(task, threading.Thread):
            if task.poll() is None:
                task.kill()


class SlurmScheduler:
    """Real SLURM submission: one ``sbatch --array`` job per batch, task i
    resolving its chunk path from a manifest by ``$SLURM_ARRAY_TASK_ID``.
    Handles are ``<jobid>_<taskidx>`` (squeue/scancel address them
    directly). Retries submit a fresh single-element array job.
    """

    name = "slurm"

    def __init__(self, *, partition: Optional[str] = None,
                 time_limit: str = "00:30:00",
                 sbatch: str = "sbatch", squeue: str = "squeue",
                 scancel: str = "scancel",
                 python: Optional[str] = None,
                 extra_sbatch_args: tuple = ()):
        self.partition = partition
        self.time_limit = time_limit
        self.sbatch = sbatch
        self.squeue = squeue
        self.scancel = scancel
        self.python = python or sys.executable
        self.extra_sbatch_args = tuple(extra_sbatch_args)
        self._lock = threading.Lock()
        self._seq = 0

    def _script(self, manifest: str, job_dir: str) -> str:
        lines = ["#!/bin/bash",
                 "#SBATCH --job-name=chambga-eval",
                 f"#SBATCH --output={job_dir}/slurm-%A_%a.out",
                 f"#SBATCH --time={self.time_limit}"]
        if self.partition:
            lines.append(f"#SBATCH --partition={self.partition}")
        lines += [
            f'export PYTHONPATH="{_SRC_ROOT}${{PYTHONPATH:+:$PYTHONPATH}}"',
            f'CHUNK=$(sed -n "$((SLURM_ARRAY_TASK_ID + 1))p" '
            f'"{manifest}")',
            f'exec "{self.python}" -m repro_torch.runtime.batchq '
            f'--worker "$CHUNK"',
        ]
        return "\n".join(lines) + "\n"

    def submit(self, chunk_paths: List[str], *, job_dir: str) -> List[str]:
        with self._lock:
            seq = self._seq
            self._seq += 1
        manifest = os.path.join(job_dir, f"manifest_{seq:04d}.txt")
        # atomic: array tasks on other nodes resolve their chunk from this
        # manifest by line number — a torn read maps every task to the
        # wrong (or a truncated) chunk path
        atomic_write_text(manifest, "\n".join(chunk_paths) + "\n")
        script = os.path.join(job_dir, f"array_{seq:04d}.sh")
        atomic_write_text(script, self._script(manifest, job_dir))
        cmd = [self.sbatch, "--parsable",
               f"--array=0-{len(chunk_paths) - 1}",
               *self.extra_sbatch_args, script]
        out = subprocess.run(cmd, check=True, capture_output=True,
                             text=True).stdout
        job_id = out.strip().splitlines()[-1].split(";")[0]
        return [f"{job_id}_{i}" for i in range(len(chunk_paths))]

    def poll(self, handle: str) -> str:
        out = subprocess.run(
            [self.squeue, "-h", "-j", handle, "-o", "%T"],
            capture_output=True, text=True)
        if out.returncode != 0:
            return "unknown"                    # job left the queue
        state = out.stdout.strip().upper()
        if not state or state in ("COMPLETED",):
            return "done"
        if state in ("PENDING", "CONFIGURING"):
            return "pending"
        if state in ("RUNNING", "COMPLETING"):
            return "running"
        return "failed"                          # FAILED/TIMEOUT/CANCELLED…

    def cancel(self, handle: str) -> None:
        subprocess.run([self.scancel, handle], capture_output=True)


# ---------------------------------------------------------------------------
# Kubernetes (indexed Jobs) — the other half of the portability pair
# ---------------------------------------------------------------------------

def _parse_index_set(spec: Optional[str]) -> set:
    """K8s ``status.completedIndexes`` syntax ("1,3-5,7") -> {1,3,4,5,7}."""
    out: set = set()
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(part))
    return out


def _compress_index_set(indexes: Iterable[int]) -> str:
    """{1,3,4,5,7} -> "1,3-5,7" (the inverse of :func:`_parse_index_set`)."""
    parts = []
    run: List[int] = []
    for i in sorted(set(int(i) for i in indexes)):
        if run and i == run[-1] + 1:
            run.append(i)
            continue
        if run:
            parts.append(str(run[0]) if len(run) == 1
                         else f"{run[0]}-{run[-1]}")
        run = [i]
    if run:
        parts.append(str(run[0]) if len(run) == 1 else f"{run[0]}-{run[-1]}")
    return ",".join(parts)


class KubernetesScheduler:
    """Kubernetes Jobs scheduler: the paper's K8s leg, symmetric with
    :class:`SlurmScheduler`.

    Each batch is submitted as ONE indexed Job (``completionMode:
    Indexed``, ``completions = parallelism = len(chunks)``): pod ``i``
    resolves its chunk path from a manifest file by
    ``$JOB_COMPLETION_INDEX`` and runs the exact same worker entrypoint as
    the SLURM array task. All cluster interaction is ``kubectl``
    shell-outs (``apply -f`` / ``get job -o json`` / ``delete job``)
    routed through ``runner`` — default real ``kubectl``, or
    :class:`MockKubectl` so CI exercises the full submit->poll->result
    path without a cluster.

    Shared-spool contract: the spool directory must be reachable inside
    worker pods at the SAME path the submitter uses (chunk-manifest
    entries are submitter paths). The generated manifest mounts ``volume``
    (default: a ``hostPath`` of the spool root — single-node clusters /
    kind; point it at an NFS or ReadWriteMany PVC source for a real
    cluster) at ``spool_mount`` (default: the spool root path itself).

    Cancel semantics: Kubernetes cannot cancel one completion index, so
    ``cancel`` deletes the Job only when it has a single completion (the
    re-queue path); a timed-out index of a multi-index Job keeps running
    and the re-queued attempt races it — the same speculative-retry
    semantics as ``HostPoolBackend``'s hung worker threads. ``reap``
    (called by the backend once a batch's results are collected) deletes
    the batch's Job objects so completed Jobs don't accumulate in the
    cluster the way completed ``job_*`` directories would in the spool.

    ``status_cache_ttl_s`` caches ``kubectl get job`` responses per Job:
    polling W handles of one Job costs one shell-out per TTL window
    instead of W per poll sweep (a real ``kubectl`` round-trip is
    ~50-100ms; at the backend's default 0.02s poll interval an uncached
    8-chunk job would hammer the API server with ~400 execs/s). Default:
    0.5s against real kubectl, disabled when a ``runner`` (in-process
    mock) is injected; pass an explicit value to override either.
    """

    name = "k8s"

    #: annotation carrying the chunk-manifest path; MockKubectl resolves
    #: the per-index worker invocations from it
    MANIFEST_ANNOTATION = "chambga.io/chunk-manifest"

    def __init__(self, *, namespace: str = "default",
                 image: str = "chambga-worker:latest",
                 kubectl: str = "kubectl",
                 python: str = "python",
                 spool_mount: Optional[str] = None,
                 volume: Optional[dict] = None,
                 env: Optional[dict] = None,
                 job_prefix: str = "chambga-eval",
                 active_deadline_s: Optional[float] = None,
                 status_cache_ttl_s: Optional[float] = None,
                 runner: Optional[Callable] = None):
        self.namespace = namespace
        self.image = image
        self.kubectl = kubectl
        self.python = python
        self.spool_mount = spool_mount
        self.volume = volume
        self.env = dict(env or {})
        self.job_prefix = job_prefix
        self.active_deadline_s = active_deadline_s
        if status_cache_ttl_s is None:           # see class docstring
            status_cache_ttl_s = 0.0 if runner is not None else 0.5
        self.status_cache_ttl_s = float(status_cache_ttl_s)
        self.runner = runner
        self._lock = threading.Lock()
        self._seq = 0
        # unique per process AND per scheduler instance: two backends in
        # one manager must not mint colliding Job names on a real cluster
        self._token = f"{os.getpid():x}-{id(self) & 0xffff:04x}"
        self._job_sizes: Dict[str, int] = {}
        self._cache: Dict[str, tuple] = {}

    # -- kubectl plumbing ----------------------------------------------
    def _run(self, args: List[str]):
        cmd = [self.kubectl, *args]
        if self.runner is not None:
            return self.runner(cmd)
        return subprocess.run(cmd, capture_output=True, text=True)

    # -- manifest generation -------------------------------------------
    def _job_manifest(self, name: str, chunk_manifest: str, n: int,
                      job_dir: str) -> dict:
        spool_root = os.path.dirname(os.path.abspath(job_dir))
        mount = self.spool_mount or spool_root
        volume = self.volume or {"hostPath": {"path": spool_root,
                                              "type": "Directory"}}
        # same resolve-by-index shape as the SLURM array script
        command = ["/bin/sh", "-c",
                   f'CHUNK=$(sed -n "$((JOB_COMPLETION_INDEX + 1))p" '
                   f'"{chunk_manifest}") && '
                   f'exec {self.python} -m repro_torch.runtime.batchq '
                   f'--worker "$CHUNK"']
        spec = {
            "completions": n,
            "parallelism": n,
            "completionMode": "Indexed",
            "backoffLimitPerIndex": 0,     # failures surface per index;
                                           # the backend owns retries
            "template": {"spec": {
                "restartPolicy": "Never",
                "volumes": [{"name": "spool", **volume}],
                "containers": [{
                    "name": "worker",
                    "image": self.image,
                    "command": command,
                    "env": [{"name": k, "value": str(v)}
                            for k, v in sorted(self.env.items())],
                    "volumeMounts": [{"name": "spool",
                                      "mountPath": mount}],
                }],
            }},
        }
        if self.active_deadline_s is not None:
            spec["activeDeadlineSeconds"] = int(self.active_deadline_s)
        return {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {
                "name": name,
                "namespace": self.namespace,
                "labels": {"app.kubernetes.io/name": "chambga-eval"},
                "annotations": {self.MANIFEST_ANNOTATION: chunk_manifest},
            },
            "spec": spec,
        }

    # -- Scheduler protocol --------------------------------------------
    def submit(self, chunk_paths: List[str], *, job_dir: str) -> List[str]:
        with self._lock:
            seq = self._seq
            self._seq += 1
        # RFC 1123 label: lowercase alphanumerics and '-'
        name = f"{self.job_prefix}-{self._token}-{seq:04d}".lower()
        chunk_manifest = os.path.join(job_dir, f"k8s_manifest_{seq:04d}.txt")
        # atomic: worker pods sed this manifest by $JOB_COMPLETION_INDEX
        # from the shared volume, racing the apply below
        atomic_write_text(chunk_manifest, "\n".join(chunk_paths) + "\n")
        spec_path = os.path.join(job_dir, f"k8s_job_{seq:04d}.json")
        atomic_write_json(spec_path,
                          self._job_manifest(name, chunk_manifest,
                                             len(chunk_paths), job_dir),
                          indent=2)
        out = self._run(["apply", "-f", spec_path, "-n", self.namespace])
        if out.returncode != 0:
            raise RuntimeError(
                f"kubectl apply failed (rc={out.returncode}): "
                f"{getattr(out, 'stderr', '') or getattr(out, 'stdout', '')}")
        with self._lock:
            self._job_sizes[name] = len(chunk_paths)
        return [f"{name}/{i}" for i in range(len(chunk_paths))]

    def _get_job(self, job: str) -> Optional[dict]:
        now = time.monotonic()
        if self.status_cache_ttl_s > 0:
            with self._lock:
                hit = self._cache.get(job)
            if hit is not None and now - hit[0] < self.status_cache_ttl_s:
                return hit[1]
        out = self._run(["get", "job", job, "-n", self.namespace,
                         "-o", "json"])
        obj: Optional[dict] = None
        if out.returncode == 0:
            try:
                obj = json.loads(out.stdout)
            except ValueError:
                obj = None
        if self.status_cache_ttl_s > 0:
            with self._lock:
                self._cache[job] = (now, obj)
        return obj

    def poll(self, handle: str) -> str:
        job, _, idx_s = handle.rpartition("/")
        idx = int(idx_s)
        obj = self._get_job(job)
        if obj is None:
            return "unknown"                    # deleted / never applied
        status = obj.get("status") or {}
        if idx in _parse_index_set(status.get("completedIndexes")):
            return "done"
        if idx in _parse_index_set(status.get("failedIndexes")):
            return "failed"
        for cond in status.get("conditions") or []:
            if cond.get("status") != "True":
                continue
            if cond.get("type") == "Complete":
                return "done"
            if cond.get("type") == "Failed":
                return "failed"                 # deadline / backoff blown
        # the Jobs API exposes no per-index running-vs-queued split:
        # report "running" as soon as any pod of the Job is active (a
        # conservatively early straggler clock), "pending" before that
        if int(status.get("active") or 0) > 0:
            return "running"
        return "pending"

    def cancel(self, handle: str) -> None:
        job, _, _ = handle.rpartition("/")
        with self._lock:
            single = self._job_sizes.get(job) == 1
        if single:                               # re-queue jobs only; a
            self._delete_job(job)                # multi-index Job keeps
                                                 # running (see class doc)

    def reap(self, handles: Iterable[str]) -> None:
        """Delete the Job objects behind ``handles`` (results are on the
        spool; the cluster-side Jobs are garbage once collected)."""
        jobs = {h.rpartition("/")[0] for h in handles}
        for job in sorted(jobs):
            with self._lock:
                known = job in self._job_sizes
            if known:
                self._delete_job(job)

    def _delete_job(self, job: str) -> None:
        self._run(["delete", "job", job, "-n", self.namespace,
                   "--ignore-not-found", "--wait=false"])
        with self._lock:
            self._job_sizes.pop(job, None)
            self._cache.pop(job, None)


class _KubectlResult:
    """Duck-typed ``subprocess.CompletedProcess`` for :class:`MockKubectl`."""

    def __init__(self, returncode: int, stdout: str = "", stderr: str = ""):
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr


class MockKubectl:
    """In-process ``kubectl`` stand-in (plugs into
    ``KubernetesScheduler(runner=...)``) so CI exercises command
    construction AND the full submit->poll->result path without a cluster
    — the K8s mirror of :class:`LocalMockScheduler`.

    ``apply -f`` loads the Job spec, resolves the chunk manifest from the
    ``chambga.io/chunk-manifest`` annotation, and starts one worker per
    completion index — a thread (fast conformance tests) or a real
    subprocess (slow e2e lane) running the exact array-task code path
    (:func:`run_worker`). ``get job -o json`` reports indexed-Job status
    (``active`` / ``completedIndexes`` / ``failedIndexes`` derived from
    the spool's result/fail files — the same observables a real control
    plane exposes). ``delete job`` kills and forgets. ``hang_substrings``
    simulates lost pods: a chunk whose filename matches is accepted but
    never started, so the backend's timeout fires and re-queues it.

    Every invocation is recorded in ``self.calls`` for command-
    construction assertions.
    """

    def __init__(self, mode: str = "thread",
                 hang_substrings: tuple = (),
                 python: Optional[str] = None):
        if mode not in ("subprocess", "thread"):
            raise ValueError(f"mode must be subprocess|thread: {mode}")
        self.mode = mode
        self.hang_substrings = tuple(hang_substrings)
        self.python = python or sys.executable
        self.calls: List[List[str]] = []
        self._jobs: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def __call__(self, cmd: List[str], **kwargs) -> _KubectlResult:
        self.calls.append(list(cmd))
        args = list(cmd[1:])                     # drop the kubectl binary
        try:
            verb = args[0]
            if verb == "apply":
                return self._apply(args[args.index("-f") + 1])
            if verb == "get" and args[1] == "job":
                return self._get(args[2])
            if verb == "delete" and args[1] == "job":
                return self._delete(args[2])
        except Exception:
            return _KubectlResult(1, "", traceback.format_exc())
        return _KubectlResult(1, "", f"MockKubectl: unsupported {cmd!r}")

    def _apply(self, spec_path: str) -> _KubectlResult:
        with open(spec_path) as f:
            spec = json.load(f)
        name = spec["metadata"]["name"]
        manifest = spec["metadata"]["annotations"][
            KubernetesScheduler.MANIFEST_ANNOTATION]
        with open(manifest) as f:
            chunks = [line for line in f.read().splitlines() if line]
        if len(chunks) != int(spec["spec"]["completions"]):
            return _KubectlResult(
                1, "", f"manifest lists {len(chunks)} chunks but "
                       f"completions={spec['spec']['completions']}")
        tasks = [_spawn_local_worker(p, self.mode, self.python,
                                     self.hang_substrings)
                 for p in chunks]
        with self._lock:
            self._jobs[name] = {"chunks": chunks, "tasks": tasks}
        return _KubectlResult(0, f"job.batch/{name} created\n")

    def _get(self, name: str) -> _KubectlResult:
        with self._lock:
            job = self._jobs.get(name)
        if job is None:
            return _KubectlResult(
                1, "", f'Error from server (NotFound): jobs.batch "{name}" '
                       f'not found\n')
        done, failed, active = [], [], 0
        for i, (path, task) in enumerate(zip(job["chunks"], job["tasks"])):
            if os.path.exists(result_path(path)):
                done.append(i)
            elif os.path.exists(fail_path(path)):
                failed.append(i)
            elif (isinstance(task, subprocess.Popen)
                    and task.poll() not in (None, 0)):
                failed.append(i)                 # died before any marker
            else:
                active += 1                      # running, or a lost pod
        status: dict = {
            "active": active,
            "succeeded": len(done),
            "failed": len(failed),
            "completedIndexes": _compress_index_set(done),
            "failedIndexes": _compress_index_set(failed),
        }
        if not active:
            status["conditions"] = [{
                "type": "Failed" if failed else "Complete",
                "status": "True",
            }]
        obj = {"apiVersion": "batch/v1", "kind": "Job",
               "metadata": {"name": name}, "status": status}
        return _KubectlResult(0, json.dumps(obj))

    def _delete(self, name: str) -> _KubectlResult:
        with self._lock:
            job = self._jobs.pop(name, None)
        if job is not None:
            for task in job["tasks"]:
                if isinstance(task, subprocess.Popen) and task.poll() is None:
                    task.kill()
        # kubectl delete --ignore-not-found exits 0 either way
        return _KubectlResult(0, f"job.batch \"{name}\" deleted\n")


# ---------------------------------------------------------------------------
# The backend
# ---------------------------------------------------------------------------

class SlurmArrayBackend(PureCallbackBridge):
    """``DispatchBackend`` over a batch scheduler — SLURM arrays,
    Kubernetes indexed Jobs, or local mocks, selected by the ``scheduler``
    object (the paper's K8s<->SLURM portability pair).

    fitness_fn: callable pickled into the spool for workers to load, OR
    fn_spec: ``"module:attr"`` import spec (preferred — numpy-only worker
    startup). One of the two is required. The backend itself bridges
    device genomes to the host exactly like ``HostPoolBackend``; only the
    execution substrate differs.

    Chunking: equal counts by default; when the broker dispatches with a
    cost model, chunks are sized by predicted per-genome cost
    (``chunk_sizing="cost"``) so array tasks finish together — the batch
    is re-ordered pricier-first host-side (contiguous cost quantiles of
    the broker's interleaved snake order would drag cheap riders into
    every expensive chunk) and results are scattered back before
    returning. ``min_chunk_cost_s`` folds chunks whose predicted cost is
    below the floor into their cheapest neighbor — a 1-genome chunk still
    pays a full pod/array-task startup, so sub-startup-cost chunks are
    merged instead of scheduled. ``chunk_sizing="equal"`` forces the
    legacy equal split.

    Per-chunk ``chunk_timeout_s`` (clocked from when the work item leaves
    the scheduler queue — PENDING time doesn't count) + re-queue of
    stragglers/failures up to ``max_retries`` via the shared
    ``run_chunks_retry`` loop. ``cost_ema`` receives the workers'
    measured wall times.

    Spool GC: once a job's results are collected, superseded
    ``chunk_*_tryT`` attempt files are deleted and completed ``job_*``
    directories are pruned down to the newest ``keep_jobs`` (the way the
    checkpointer prunes steps; ``keep_jobs=None`` disables). Only
    directories this backend created and finished are touched — foreign
    spool content and in-flight jobs (the pipelined epoch loop keeps
    several evaluates in flight) are never pruned. Schedulers exposing
    ``reap`` (Kubernetes) additionally get their cluster-side Job objects
    deleted as soon as a batch's results are collected.
    """

    name = "slurm-array"

    def __init__(self, fitness_fn: Optional[Callable] = None, *,
                 fn_spec: Optional[str] = None,
                 num_objectives: int = 1, num_workers: int = 4,
                 scheduler: Optional[Scheduler] = None,
                 spool_dir: Optional[str] = None,
                 chunk_timeout_s: Optional[float] = 300.0,
                 max_retries: int = 2,
                 poll_interval_s: float = 0.02,
                 cost_ema=None,
                 chunk_sizing: str = "cost",
                 min_chunk_cost_s: float = 0.0,
                 keep_jobs: Optional[int] = 4):
        if fitness_fn is None and not fn_spec:
            raise ValueError("need fitness_fn (pickled) or fn_spec "
                             "(module:attr import path)")
        if chunk_sizing not in ("cost", "equal"):
            raise ValueError(
                f"chunk_sizing must be cost|equal: {chunk_sizing}")
        self.fitness_fn = fitness_fn
        self.fn_spec = fn_spec
        self.num_objectives = num_objectives
        self.num_workers = max(1, num_workers)
        self.scheduler = scheduler or LocalMockScheduler()
        self._owns_spool = spool_dir is None
        self.spool_dir = spool_dir or tempfile.mkdtemp(
            prefix="chambga-spool-")
        os.makedirs(self.spool_dir, exist_ok=True)
        self.chunk_timeout_s = chunk_timeout_s
        self.max_retries = max_retries
        self.poll_interval_s = poll_interval_s
        self.cost_ema = cost_ema
        self.chunk_sizing = chunk_sizing
        self.min_chunk_cost_s = float(min_chunk_cost_s)
        self.keep_jobs = keep_jobs
        self.stats = {"jobs": 0, "retries": 0, "timeouts": 0,
                      "jobs_pruned": 0}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight = 0
        self._seq = 0
        self._closed = False
        self._done_jobs: List[str] = []

    def stats_snapshot(self) -> Dict[str, int]:
        """Consistent copy of the counters — every increment in this
        class runs under ``self._lock``, so read under it too."""
        with self._lock:
            return dict(self.stats)

    # -- spool helpers --------------------------------------------------
    def _new_job_dir(self) -> str:
        with self._lock:
            seq = self._seq
            self._seq += 1
            self.stats["jobs"] += 1
        job_dir = os.path.join(self.spool_dir, f"job_{seq:06d}")
        os.makedirs(job_dir)
        # atomic: workers (and external mq fleets via the legacy-payload
        # fallback) poll these by name — the pickle lands before the
        # payload that announces it
        if not self.fn_spec:
            atomic_pickle(os.path.join(job_dir, _FN_PKL), self.fitness_fn)
        atomic_write_json(os.path.join(job_dir, _PAYLOAD),
                          {"num_objectives": self.num_objectives,
                           "fn_spec": self.fn_spec})
        return job_dir

    # -- host-side evaluation ------------------------------------------
    def _host_eval(self, genomes: np.ndarray,
                   perm: Optional[np.ndarray] = None,
                   cost: Optional[np.ndarray] = None) -> np.ndarray:
        with self._cond:
            if self._closed:
                raise RuntimeError("SlurmArrayBackend used after close()")
            self._inflight += 1
        try:
            return self._host_eval_inner(genomes, perm, cost)
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def _host_eval_inner(self, genomes: np.ndarray,
                         perm: Optional[np.ndarray],
                         cost: Optional[np.ndarray] = None) -> np.ndarray:
        from repro_torch.core.broker import ChunkFailure, run_chunks_retry
        genomes = np.asarray(genomes)
        n = genomes.shape[0]
        w = min(self.num_workers, max(1, n))
        order = None
        if cost is not None and self.chunk_sizing == "cost" and w > 1:
            # shared cost-sized planner: drop sentinel pads, re-order
            # pricier-first, cut at predicted-cost quantiles, fold chunks
            # cheaper than min_chunk_cost_s into a neighbor (a 1-genome
            # chunk still pays a full pod/array-task startup)
            chunks, _sizes, order, perm = plan_cost_chunks(
                genomes, perm, cost, w,
                min_chunk_cost=self.min_chunk_cost_s)
        else:
            chunks = np.array_split(genomes, w)
        job_dir = self._new_job_dir()

        def write_chunk(i, chunk, attempt):
            path = chunk_path(job_dir, i, attempt)
            atomic_savez(path, genomes=np.asarray(chunk, np.float32))
            return path

        all_handles: List[str] = []

        def submit(i, chunk, attempt):
            # retry path: one fresh single-element work item
            path = write_chunk(i, chunk, attempt)
            (handle,) = self.scheduler.submit([path], job_dir=job_dir)
            all_handles.append(handle)
            return (path, handle, time.monotonic())

        # attempt 0 goes out as ONE array submission (a single
        # `sbatch --array=0-(W-1)` / `kubectl apply` round-trip, not W)
        paths0 = [write_chunk(i, c, 0) for i, c in enumerate(chunks)]
        handles0 = self.scheduler.submit(paths0, job_dir=job_dir)
        all_handles.extend(handles0)
        t0 = time.monotonic()
        tokens0 = [(p, h, t0) for p, h in zip(paths0, handles0)]
        m = _metrics.get_registry()
        if m.enabled:
            m.inc("batchq_jobs_total", backend=self.name)
            m.inc("batchq_chunks_submitted_total", float(len(chunks)),
                  backend=self.name)
            m.event("batchq_submit", backend=self.name,
                    job_dir=os.path.basename(job_dir),
                    chunks=len(chunks))

        def wait(i, token, timeout_s):
            path, handle, _t_submit = token
            res, fail = result_path(path), fail_path(path)
            t_clock = None          # starts when the work item leaves the
                                    # scheduler queue: PENDING time on a
                                    # busy partition is not straggling
            while True:
                if os.path.exists(res):
                    with np.load(res) as d:
                        fit = d["fitness"]
                        dur = float(d["duration"])
                    if fit.shape != (len(chunks[i]), self.num_objectives):
                        raise ChunkFailure(
                            f"chunk {i}: result shape {fit.shape} != "
                            f"({len(chunks[i])}, {self.num_objectives})")
                    mm = _metrics.get_registry()
                    if mm.enabled:
                        mm.inc("batchq_results_total",
                               backend=self.name)
                        mm.observe("batchq_chunk_duration_seconds", dur)
                    return np.asarray(fit, np.float32), dur
                if os.path.exists(fail):
                    with open(fail) as f:
                        raise ChunkFailure(
                            f"chunk {i} worker failed:\n{f.read()}")
                state = self.scheduler.poll(handle)
                if state == "failed":
                    raise ChunkFailure(
                        f"chunk {i}: scheduler reports failure with no "
                        f"result file ({path})")
                if state == "pending":
                    # still queued — and a chunk OBSERVED queued heals a
                    # latched clock: a transient poll failure ("unknown",
                    # e.g. a throttled kubectl) must not permanently start
                    # the straggler clock on work that is merely waiting
                    t_clock = None
                elif t_clock is None:
                    t_clock = time.monotonic()
                if (timeout_s is not None and t_clock is not None
                        and time.monotonic() - t_clock > timeout_s):
                    with self._lock:
                        self.stats["timeouts"] += 1
                    mm = _metrics.get_registry()
                    if mm.enabled:
                        mm.inc("batchq_timeouts_total",
                               backend=self.name)
                        mm.event("batchq_timeout", backend=self.name,
                                 chunk=i)
                    self.scheduler.cancel(handle)
                    raise TimeoutError(
                        f"chunk {i} straggled past {timeout_s}s "
                        f"(state={state})")
                time.sleep(self.poll_interval_s)

        def on_retry(i, attempt, exc):
            with self._lock:
                self.stats["retries"] += 1
            mm = _metrics.get_registry()
            if mm.enabled:
                mm.inc("batchq_retries_total", backend=self.name)
                mm.event("batchq_retry", backend=self.name, chunk=i,
                         attempt=attempt)

        try:
            outs = run_chunks_retry(chunks, submit, wait,
                                    timeout_s=self.chunk_timeout_s,
                                    max_retries=self.max_retries,
                                    on_retry=on_retry,
                                    initial_tokens=tokens0)
        finally:
            # results live on the spool; scheduler-side objects (K8s Jobs)
            # are garbage now, win or lose
            reap = getattr(self.scheduler, "reap", None)
            if reap is not None:
                try:
                    reap(tuple(all_handles))
                except Exception:
                    pass
        out = collect_chunk_results(outs, self.cost_ema, perm,
                                    [len(c) for c in chunks])
        self._finish_job(job_dir)
        if order is not None:
            out = scatter_chunk_results(out, order, n)
        return out

    # -- spool garbage collection --------------------------------------
    _CHUNK_RE = re.compile(r"chunk_(\d+)_try(\d+)\.npz")

    def _prune_attempts(self, job_dir: str) -> None:
        """Delete superseded attempt files: once some attempt of a chunk
        has a result, every other attempt's input/.fail/.result files are
        dead weight (a speculative straggler may have finished too — the
        highest result-bearing attempt is kept)."""
        try:
            entries = os.listdir(job_dir)
        except OSError:
            return
        best: Dict[int, int] = {}
        parsed = []
        for name in entries:
            m = self._CHUNK_RE.fullmatch(name)
            if m is None:
                continue
            idx, att = int(m.group(1)), int(m.group(2))
            parsed.append((name, idx, att))
            if os.path.exists(result_path(os.path.join(job_dir, name))):
                best[idx] = max(best.get(idx, -1), att)
        for name, idx, att in parsed:
            if idx in best and att != best[idx]:
                base = os.path.join(job_dir, name)
                for path in (base, result_path(base), fail_path(base)):
                    try:
                        os.remove(path)
                    except OSError:
                        pass

    def _finish_job(self, job_dir: str) -> None:
        """Completed-job epilogue: prune superseded attempts, then prune
        the oldest completed job dirs beyond ``keep_jobs`` (only dirs this
        backend created AND finished — in-flight pipelined evaluates and
        foreign spool content are never touched)."""
        self._prune_attempts(job_dir)
        if self.keep_jobs is None:
            return
        victims = []
        with self._lock:
            self._done_jobs.append(job_dir)
            while len(self._done_jobs) > max(0, int(self.keep_jobs)):
                victims.append(self._done_jobs.pop(0))
            self.stats["jobs_pruned"] += len(victims)
        if victims:
            import shutil
            for victim in victims:
                shutil.rmtree(victim, ignore_errors=True)

    def close(self, remove_spool: Optional[bool] = None):
        """Drain in-flight evaluations (another thread may still be
        polling the spool when the caller tears the backend down), then
        mark closed and optionally delete the spool (default: only when
        the backend created a temp spool
        itself)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            while self._inflight:
                self._cond.wait()
        if remove_spool is None:
            remove_spool = self._owns_spool
        if remove_spool:
            import shutil
            shutil.rmtree(self.spool_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Worker entrypoint:  python -m repro_torch.runtime.batchq --worker <chunk.npz>
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.runtime.batchq",
        description="Batch-queue array-task worker: evaluate one spooled "
                    "chunk and write its result file.")
    ap.add_argument("--worker", required=True, metavar="CHUNK_NPZ",
                    help="path to the spooled chunk file to evaluate")
    args = ap.parse_args(argv)
    return run_worker(args.worker)


if __name__ == "__main__":
    sys.exit(main())
