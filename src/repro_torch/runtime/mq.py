"""Persistent-worker message queue: the paper's central broker as a subsystem.

The port of the reference's ``runtime/mq.py``, on the same on-disk
protocol (task names, broker layout, npz payloads), so a port manager
and a reference fleet can serve each other. Workers are spawned as
``python -m repro_torch.runtime.mq --worker``; the manager bridges CUDA
genomes through ``PureCallbackBridge`` (a copy to the host and back).

CHAMB-GA's architectural core is "a central message broker coordinating
asynchronous manager-worker communication between microservices". The
batch-scheduled path (``repro_torch.runtime.batchq``) approximates it one batch
at a time — spool, submit, poll, collect — so every generation pays full
scheduler/pod startup per chunk and the learned cost model only sees
timings after a whole batch lands. This module is the queue itself: a
file-backed broker directory (the same shared-volume contract as the
batchq spool, so it runs unchanged on SLURM and Kubernetes) holding a task
queue and a result queue with **at-least-once delivery**, consumed by
**persistent workers** that amortize startup across chunks *and*
generations — and shared by **multiple concurrent GA runs** (parameter
sweeps, the meta-GA, multi-stage HVDC workflows), each a *tenant* with its
own run-scoped queue namespace and claim priority.

Broker directory layout (one directory per worker FLEET; any number of
concurrent runs)::

    <mq>/runs/                     # the multi-tenant run registry
        run-a.json                 #   priority + fitness import spec
        run-a.fn.pkl               #   pickled fitness (when no spec)
        run-a.RESOLVE_FAIL         #   per-run marker: fitness unresolvable
    <mq>/tasks/                    # READY queue: one .npz task per chunk
        rrun-a_j000007_c0003_t0_d0.npz  # run a, job 7, chunk 3,
                                        #   attempt 0, delivery 0
        zzzstop-1f40-0000.stop     #   poison STOP ticket (autoscaler
                                   #   scale-down; claimed only when idle)
    <mq>/claimed/                  # LEASED: tasks renamed here by workers
        rrun-a_j000007_c0003_t0_d0.npz
        rrun-a_j000007_c0003_t0_d0.npz.lease  # heartbeat (mtime renewed)
    <mq>/results/
        rrun-a_j000007_c0003_t0_d0.result.npz # fitness + duration (atomic)
        rrun-a_j000007_c0003_t0_d0.fail       # traceback marker on failure
    <mq>/fleet/                    # worker tickets (Scheduler-launched)
    <mq>/STOP                      # FLEET-WIDE shutdown sentinel

Queue contract (lease / heartbeat / multi-tenant semantics)
-----------------------------------------------------------
* **Run namespacing**: every task/claim/result name carries the run id of
  the GA run that enqueued it (``r<run>_j<job>_c<chunk>_t<attempt>_d<del>``),
  and every run registers itself in ``runs/<run>.json`` before enqueueing
  (priority integer + fitness payload). A run's manager only ever tracks,
  re-queues, times out, or garbage-collects names in ITS OWN namespace —
  two runs sharing a broker directory cannot touch each other's files.
* **Priority claims (work stealing across runs)**: :func:`claim_next` is
  a CROSS-RUN claim — among runs with ready tasks it serves the
  highest-priority run first (ties break on run id), oldest task within
  it. An idle worker therefore steals work from whichever run is loaded,
  and a contended fleet drains high-priority runs first.
* **Claim** is an atomic ``os.rename`` from ``tasks/`` into ``claimed/``
  — exactly one worker wins; losers see ``OSError`` and move on. The
  winner immediately writes a ``.lease`` file and renews its mtime every
  ``lease_s / 4`` from a heartbeat thread while evaluating.
* **Report**: results and failure markers are written atomically
  (tmp + ``os.replace``) into ``results/``; the worker then removes its
  claimed file and lease. Workers never talk to the manager directly —
  delivery is always via the shared filesystem, which is why the broker
  directory must be a volume shared between manager and workers (SLURM:
  the cluster FS; Kubernetes: a volume mounted at the same path in every
  worker pod), exactly like the batchq spool.
* **Liveness, not just timeouts**: the manager re-queues a claimed task
  whose lease has gone stale for ``lease_s`` (the worker died — renaming
  the claimed file back into ``tasks/`` under a bumped delivery suffix),
  replacing timeout-only straggler detection with heartbeat liveness.
  Lease re-queues do NOT consume the retry budget; ``chunk_timeout_s``
  (clocked from the first claim of the current attempt) remains the
  backstop for live-but-stuck workers and feeds the shared
  ``run_chunks_retry`` attempt budget, same as the batch backends.
* **At-least-once**: a stale-lease re-queue races the original worker
  (which may merely have been slow); every delivery of a chunk evaluates
  identical genomes, and the manager accepts the FIRST result from any
  delivery or attempt it ever issued. Duplicate results are garbage-
  collected with the job.
* **Per-run STOP / drain**: a finishing run deregisters itself from
  ``runs/`` and sweeps only its own queue files. The fleet-wide ``STOP``
  sentinel is raised only by whoever OWNS the workers (the pool/fleet
  object, or a backend that created its own temp directory) — one run
  finishing never kills a fleet other runs still use.
* **Poison STOP tickets (elastic scale-down)**: :class:`FleetAutoscaler`
  shrinks a fleet by dropping ``*.stop`` tickets into the task queue.
  Workers claim them only when NO real task is ready and exit at a chunk
  boundary — a shrinking fleet never abandons a claimed chunk
  mid-evaluation and never starves queued work. Scale-up rides the batchq
  ``Scheduler`` protocol's incremental submit (more ``*.worker.json``
  tickets) or spawns more local workers.

Enforced invariants (the protocol linter's checks, pointed at this
package's module names by ``tests/test_torch_imports.py``):

* **atomic-write** — every file this module publishes on a polled path
  goes through ``repro_torch.runtime.fsatomic`` (tmp sibling + fsync +
  ``os.replace``), so a poller never observes a torn file. The one
  deliberate exception is the mtime-only ``.lease`` heartbeat, marked
  ``# exception[atomic-write]`` in the function where the reference
  carries its ``lint: allow``; the test accepts a finding only in such
  a function.
* **worker-purity** — this module is a worker entrypoint: nothing in its
  module-scope import closure may import torch or other heavy deps at
  import time (that is what keeps persistent-worker startup short and
  why ``runtime/__init__`` exports lazily). Bridged torch imports live
  inside functions.
* **device boundary** — ``Broker.evaluate`` ->
  ``QueueBackend.eval_with_perm`` copies device genomes to the host in
  ``PureCallbackBridge``; the host-side queue machinery below the
  bridge is free to do IO.

Model-checked and race-checked
------------------------------
The reference's protocol model checker explores the queue contract above
over all interleavings of workers x chunks with crash injection
(exactly-one-claim-winner, no-lost-task, delivery bumps never burn the
retry budget, first-result-wins, GC isolation). Its counterexample
corpus replays step-locked against THIS module's functions, over both
transports (``tests/test_torch_proto_replay.py``), and the thread
sanitizer runs a dispatch scenario on this module's ``QueueBackend``.
The in-process shared state is guarded as in the reference:

* ``_PRIORITY_CACHE`` behind ``_PRIORITY_LOCK``;
* :class:`LocalWorkerPool` / :class:`MQWorkerFleet` member lists,
  ticket counters and ``_started`` behind each pool's ``_lock``
  (``stop`` swaps the member list out under the lock and joins outside
  it);
* :class:`FleetAutoscaler` tick bookkeeping behind ``_lock`` — lock
  order is autoscaler ``_lock`` → pool ``_lock`` via ``grow``;
* ``QueueBackend.stats`` increments under the queue lock, read through
  ``stats_snapshot()``.

Network transport (``repro_torch.runtime.netbroker``)
-----------------------------------------------------
The queue contract above is TRANSPORT-NEUTRAL: every broker file op the
manager performs is funneled through the ``QueueBackend._t_*`` seam
(enqueue / result & fail fetch / lease state / requeue / resolve-fail /
deregister / :func:`gc_sweep`), and the worker protocol steps are the
module functions (:func:`claim_next`, :func:`write_lease`,
:func:`publish_result`, :func:`publish_fail`, :func:`release_claim`,
:func:`clean_if_run_closed`, :func:`janitor_sweep`). The socket
transport (``python -m repro_torch.runtime.netbroker --serve``, manager side
``SocketQueueBackend``, ``ga_run --dispatch-backend mq-net``) keeps
this module as the single source of contract truth: its BrokerServer
executes these exact functions against a server-LOCAL broker directory
and exposes them as length-prefixed RPC frames, so managers and
workers need no shared volume — the deployment the paper's
"central message broker" microservice implies. ``_t_lease_state``
returns the lease age on the AUTHORITY's clock (file: local getmtime;
socket: computed server-side), so manager/worker clock skew can never
fake a stale lease. The file broker stays the zero-dependency fallback
and the conformance oracle: ``tests/test_torch_backend_conformance.py``
and the replay corpus run against BOTH transports.

Persistent workers (``python -m repro_torch.runtime.mq --worker --mq-dir D``)
are numpy-only like the batchq array task: they loop claim -> evaluate ->
report, resolving each run's fitness ONCE from the ``runs/`` registry
(cached per run), so interpreter startup and fitness resolution are paid
once per worker instead of once per chunk. :class:`LocalWorkerPool` runs
the same loop on threads (fast CI) or subprocesses (cluster stand-in),
with ``hang_substrings`` fault injection (a worker that claims a matching
task dies without reporting — exercising the lease path). On a real
cluster the fleet is launched ONCE as a long-lived SLURM array /
Kubernetes indexed Job via :class:`MQWorkerFleet`, which rides the
existing batchq ``Scheduler`` protocol: each array task / pod receives a
``*.worker.json`` ticket instead of a chunk, and the standard
``python -m repro_torch.runtime.batchq --worker`` entrypoint detects the ticket
and becomes a persistent queue worker.

:class:`QueueBackend` is the manager side — a ``DispatchBackend`` (via
``PureCallbackBridge``) that enqueues cost-sized chunks
(``hostbridge.plan_cost_chunks``: pad-dropping, pricier-first re-order,
``min_chunk_cost_s`` folding of sub-startup-cost chunks) and then
**streams** the result queue: each finished chunk's measured duration is
fed to ``CostEMA.observe`` the moment it lands — mid-flight, not at batch
end — so under long tails the next generation's dispatch already sees
sharpened estimates. It composes with ``Broker``'s padded cost-balanced
dispatch and the shared ``run_chunks_retry`` timeout/retry semantics
unchanged.

Exported metrics
----------------
Every site below publishes through the no-op seam in
:mod:`repro_torch.runtime.metrics` — install
``repro_torch.obs.MetricsRegistry`` via ``set_registry`` to turn them on;
disabled, each site costs one attribute check (``chip_smoke.py::
metrics_cost`` times an mq dispatch with the bus off and on).
Worker-side sites are stdlib-only, so the worker-purity closure is
unchanged.

* ``mq_claims_total{run}`` (counter), ``mq_claim_latency_seconds``
  (histogram) — per winning claim; latency is enqueue→claim from the
  task file's rename-preserved mtime.
* ``mq_tasks_completed_total{run}`` / ``mq_task_failures_total{run}``
  (counters), ``mq_worker_busy_seconds_total`` /
  ``mq_worker_idle_seconds_total`` (counters) — claim→publish spans
  and poll sleeps; their deltas are the fleet-utilization signal.
* ``mq_jobs_total{run}`` / ``mq_chunks_enqueued_total{run}`` /
  ``mq_results_streamed_total{run}`` / ``mq_lease_requeues_total{run}``
  / ``mq_retries_total{run}`` / ``mq_timeouts_total{run}`` (counters),
  ``mq_chunk_duration_seconds`` / ``mq_lease_age_seconds``
  (histograms) — manager-side job lifecycle.
* ``mq_cost_per_task_seconds{run}`` (gauge) — streaming EMA of
  duration/chunk-size; ``mq_ready_total`` / ``mq_leased_total`` /
  ``mq_worker_utilization`` / ``mq_outstanding_cost_seconds`` /
  ``autoscaler_size`` / ``autoscaler_desired`` (gauges),
  ``autoscaler_scale_{ups,downs}_total`` (counters) — published by
  :class:`FleetAutoscaler`, whose ``signal="cost"`` mode also READS
  its decision inputs from the same bus.
* events (JSONL via ``MetricsRegistry(events=EventLog(...))``):
  ``enqueue`` / ``claim`` / ``publish`` / ``fail`` / ``result`` /
  ``lease_requeue`` / ``retry`` / ``timeout`` / ``job_done`` /
  ``autoscale`` — ``repro_torch.obs.queue_depth_timeline`` replays queue
  depth over time from these alone.
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.hostbridge import (PureCallbackBridge,
                                         collect_chunk_results,
                                         plan_cost_chunks,
                                         scatter_chunk_results)
from repro_torch.runtime import metrics as _metrics
from repro_torch.runtime.batchq import _PAYLOAD, _SRC_ROOT, resolve_fn
from repro_torch.runtime.fsatomic import (TMP_SUFFIX, atomic_savez,
                                          atomic_write_bytes,
                                          atomic_write_json,
                                          atomic_write_text)

TASKS_DIR = "tasks"
CLAIMED_DIR = "claimed"
RESULTS_DIR = "results"
FLEET_DIR = "fleet"
RUNS_DIR = "runs"
STOP_NAME = "STOP"
RESOLVE_FAIL_SUFFIX = ".RESOLVE_FAIL"
LEASE_SUFFIX = ".lease"
TICKET_SUFFIX = ".worker.json"
POISON_SUFFIX = ".stop"
DEFAULT_PRIORITY = 0


# ---------------------------------------------------------------------------
# Queue file naming (run-scoped)
# ---------------------------------------------------------------------------

def sanitize_run_id(run_id: str) -> str:
    """Queue-safe run id: lowercase alphanumerics and ``-`` only — the id
    is embedded in task file names, where ``_`` separates fields. Any
    other character becomes ``-``; an id that sanitizes to nothing is an
    error."""
    rid = re.sub(r"[^a-z0-9-]+", "-", str(run_id).lower()).strip("-")
    if not rid:
        raise ValueError(f"run id sanitizes to nothing: {run_id!r}")
    return rid


def task_name(run_id: str, job: int, chunk: int, attempt: int,
              delivery: int) -> str:
    """``r<run>_j<job>_c<chunk>_t<attempt>_d<delivery>.npz`` — ``run``
    namespaces concurrent GA runs sharing one broker directory, attempt
    counts manager-side retries (failures / timeouts, via
    ``run_chunks_retry``), delivery counts stale-lease re-queues within an
    attempt."""
    return (f"r{run_id}_j{job:06d}_c{chunk:04d}_t{attempt}_d{delivery}.npz")


_TASK_RE = re.compile(r"r([a-z0-9-]+)_j(\d+)_c(\d+)_t(\d+)_d(\d+)\.npz")


def parse_task_name(name: str):
    """Inverse of :func:`task_name`: ``(run_id, job, chunk, attempt,
    delivery)``, or None for anything that is not a task name (foreign
    content, ``.tmp`` of an in-flight write, poison tickets)."""
    m = _TASK_RE.fullmatch(name)
    if m is None:
        return None
    run = m.group(1)
    return (run,) + tuple(int(x) for x in m.groups()[1:])


def result_name(name: str) -> str:
    """Basename of a task's result file — pure name arithmetic, shared
    with transports that have no broker directory of their own."""
    return name[:-len(".npz")] + ".result.npz"


def mq_result_path(mq_dir: str, name: str) -> str:
    return os.path.join(mq_dir, RESULTS_DIR, result_name(name))


def mq_fail_path(mq_dir: str, name: str) -> str:
    return os.path.join(mq_dir, RESULTS_DIR, name[:-len(".npz")] + ".fail")


def make_broker_dirs(mq_dir: str) -> None:
    for sub in (TASKS_DIR, CLAIMED_DIR, RESULTS_DIR, RUNS_DIR):
        os.makedirs(os.path.join(mq_dir, sub), exist_ok=True)


# ---------------------------------------------------------------------------
# Run registry (multi-tenancy: priorities + per-run fitness payloads)
# ---------------------------------------------------------------------------

def run_registry_path(mq_dir: str, run_id: str) -> str:
    return os.path.join(mq_dir, RUNS_DIR, run_id + ".json")


def run_pickle_path(mq_dir: str, run_id: str) -> str:
    return os.path.join(mq_dir, RUNS_DIR, run_id + ".fn.pkl")


def resolve_fail_path(mq_dir: str, run_id: str) -> str:
    return os.path.join(mq_dir, RUNS_DIR, run_id + RESOLVE_FAIL_SUFFIX)


def register_run(mq_dir: str, run_id: str, *, priority: int = 0,
                 num_objectives: int = 1, fn_spec: Optional[str] = None,
                 fitness_fn: Optional[Callable] = None) -> None:
    """Register a GA run with a (possibly shared) broker directory: its
    claim priority and fitness payload, written BEFORE any of the run's
    tasks are enqueued so a worker that claims one can always resolve the
    run's fitness. The pickle is written first and the registry file last,
    atomically — a polling worker never sees a run without its payload."""
    os.makedirs(os.path.join(mq_dir, RUNS_DIR), exist_ok=True)
    if not fn_spec and fitness_fn is not None:
        try:
            blob = pickle.dumps(fitness_fn)
        except Exception:
            # unpicklable callables still work with in-process thread
            # pools carrying an fn override; a registry-resolving worker
            # will surface a per-run RESOLVE_FAIL instead of hanging
            blob = None
        if blob is not None:
            atomic_write_bytes(run_pickle_path(mq_dir, run_id), blob)
    atomic_write_json(run_registry_path(mq_dir, run_id),
                      {"priority": int(priority),
                       "num_objectives": int(num_objectives),
                       "fn_spec": fn_spec})


def deregister_run(mq_dir: str, run_id: str) -> None:
    """Per-run STOP: drop the run from the registry (workers stop seeing
    its priority; its namespace is dead). Never touches the fleet-wide
    STOP sentinel — other runs keep the workers."""
    for path in (run_registry_path(mq_dir, run_id),
                 run_pickle_path(mq_dir, run_id),
                 resolve_fail_path(mq_dir, run_id)):
        try:
            os.remove(path)
        except OSError:
            pass


def registry_stamp(mq_dir: str, run_id: str):
    """Identity of a run's registry entry (mtime/size/inode), or None
    when unregistered. ``register_run`` replaces the file atomically, so
    a changed stamp means the run id was re-registered — workers use it
    to invalidate per-run fitness caches and bad-run skips."""
    try:
        st = os.stat(run_registry_path(mq_dir, run_id))
        return (st.st_mtime_ns, st.st_size, st.st_ino)
    except OSError:
        return None


#: per-process cache of parsed registry priorities keyed on the stamp —
#: claim_next runs in every worker's poll loop, and on a cluster FS the
#: scarce resource is metadata ops: one stat per ready run per claim
#: instead of open+read+parse
_PRIORITY_CACHE: Dict[str, tuple] = {}
#: guards _PRIORITY_CACHE — worker threads sharing a process (thread-mode
#: LocalWorkerPool, pipelined managers) all hit the cache from claim_next
_PRIORITY_LOCK = threading.Lock()


def run_priority(mq_dir: str, run_id: str) -> int:
    """Claim priority of a registered run (higher = claimed first);
    unregistered runs default to ``DEFAULT_PRIORITY``."""
    path = run_registry_path(mq_dir, run_id)
    stamp = registry_stamp(mq_dir, run_id)
    if stamp is None:
        return DEFAULT_PRIORITY
    with _PRIORITY_LOCK:
        hit = _PRIORITY_CACHE.get(path)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    try:
        with open(path) as f:
            prio = int(json.load(f).get("priority", DEFAULT_PRIORITY))
    except (OSError, ValueError):
        return DEFAULT_PRIORITY
    with _PRIORITY_LOCK:
        _PRIORITY_CACHE[path] = (stamp, prio)
    return prio


def resolve_run_fn(mq_dir: str, run_id: str) -> Callable:
    """Fitness callable for one registered run — import spec first,
    pickle fallback; directories populated by hand (no registry entry)
    fall back to the broker's legacy global ``payload.json``."""
    reg = run_registry_path(mq_dir, run_id)
    if os.path.exists(reg):
        with open(reg) as f:
            payload = json.load(f)
        spec = payload.get("fn_spec")
        if spec:
            mod, _, attr = spec.partition(":")
            return getattr(importlib.import_module(mod), attr)
        with open(run_pickle_path(mq_dir, run_id), "rb") as f:
            return pickle.load(f)
    if os.path.exists(os.path.join(mq_dir, _PAYLOAD)):
        return resolve_fn(mq_dir)
    raise FileNotFoundError(
        f"run {run_id!r} is not registered in {mq_dir}/runs/ and the "
        f"broker has no legacy payload.json")


# ---------------------------------------------------------------------------
# Worker side (numpy-only; this is what runs on the cluster)
# ---------------------------------------------------------------------------

class _Heartbeat:
    """Background thread renewing a lease file's mtime while evaluating.
    Stops silently if the lease vanishes (the manager gave up on us and
    re-queued — our eventual result is still accepted, at-least-once)."""

    def __init__(self, lease_path: str, interval_s: float):
        self._path = lease_path
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                os.utime(self._path, None)
            except OSError:
                return

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()


def claim_next(mq_dir: str, skip_runs=()) -> Optional[str]:
    """Cross-run claim of the next ready task by atomic rename into
    ``claimed/`` — exactly one winner per task.

    Multi-tenant order: among runs that currently have ready tasks, the
    highest-priority run (per its ``runs/`` registry entry; ties break on
    run id) is served first, oldest task within it — idle workers steal
    work from whichever run is loaded. ``skip_runs`` hides runs this
    worker cannot serve (e.g. after a fitness-resolution failure). Poison
    STOP tickets (``*.stop``, autoscaler scale-down) are claimed only when
    NO real task is ready, so a shrinking fleet never starves queued work.
    Returns the claimed NAME, or None when nothing was claimable (or every
    rename was lost to another worker — indistinguishable, try again)."""
    tasks = os.path.join(mq_dir, TASKS_DIR)
    try:
        names = sorted(os.listdir(tasks))
    except OSError:
        return None
    by_run: Dict[str, List[str]] = {}
    poison: List[str] = []
    for name in names:
        if name.endswith(POISON_SUFFIX):
            poison.append(name)
            continue
        if not name.endswith(".npz"):
            continue                             # .tmp of an in-flight write
        parsed = parse_task_name(name)
        run = parsed[0] if parsed else ""
        if run in skip_runs:
            continue
        by_run.setdefault(run, []).append(name)
    prio = {run: run_priority(mq_dir, run) for run in by_run}
    for run in sorted(by_run, key=lambda r: (-prio[r], r)):
        for name in by_run[run]:
            try:
                os.rename(os.path.join(tasks, name),
                          os.path.join(mq_dir, CLAIMED_DIR, name))
            except OSError:
                continue                         # another worker won
            m = _metrics.get_registry()
            if m.enabled:
                # rename preserves mtime, so the claimed file still
                # carries its enqueue time: claim latency for free
                try:
                    age = max(0.0, time.time() - os.path.getmtime(
                        os.path.join(mq_dir, CLAIMED_DIR, name)))
                except OSError:
                    age = 0.0
                m.inc("mq_claims_total", run=run)
                m.observe("mq_claim_latency_seconds", age)
                m.event("claim", task=name, run=run,
                        wait_s=round(age, 4))
            return name
    for name in poison:
        try:
            os.rename(os.path.join(tasks, name),
                      os.path.join(mq_dir, CLAIMED_DIR, name))
        except OSError:
            continue
        return name
    return None


def write_lease(mq_dir: str, name: str) -> str:
    """Write the claimed task's lease file (worker protocol step; the
    heartbeat thread then renews its mtime). Returns the lease path."""
    lease = os.path.join(mq_dir, CLAIMED_DIR, name) + LEASE_SUFFIX
    try:
        # exception[atomic-write], as the reference allows: lease is mtime-only
        # liveness: pollers read getmtime/existence, never the body, and the
        # heartbeat renews mtime in place — a rename here would race os.utime
        with open(lease, "w") as f:
            f.write(f"{os.getpid()}\n")
    except OSError:
        pass
    return lease


def publish_result(mq_dir: str, name: str, fit: np.ndarray,
                   duration: float) -> None:
    """Atomically publish one claimed task's result (worker protocol
    step): the manager's poller sees the whole file or nothing."""
    atomic_savez(mq_result_path(mq_dir, name), fitness=fit,
                  duration=np.float64(duration))


def publish_fail(mq_dir: str, name: str, tb: str) -> None:
    """Atomically publish a failure marker for one claimed task."""
    try:
        atomic_write_text(mq_fail_path(mq_dir, name), tb)
    except OSError:
        pass


def release_claim(mq_dir: str, name: str) -> None:
    """Drop the claim and lease after reporting (worker protocol step).
    Quiet: the manager may have re-queued the claim from under us."""
    claimed = os.path.join(mq_dir, CLAIMED_DIR, name)
    for path in (claimed, claimed + LEASE_SUFFIX):
        try:
            os.remove(path)
        except OSError:
            pass


def clean_if_run_closed(mq_dir: str, name: str) -> bool:
    """Tombstone for a late report: if ``name``'s run has deregistered
    (manager gone for good — nothing will ever accept the result and the
    run's final sweep already happened), remove our own result and fail
    files so a shared broker directory does not leak them forever.

    This is the fix for a model-checker counterexample: a superseded
    delivery that publishes AFTER its run's ``close()`` swept the
    namespace leaves an orphan nobody else may touch (other runs' sweeps
    are namespace-scoped by contract). Directories populated by hand
    (legacy ``payload.json``, no registry) are exempt — there is no
    registration to signal closure, and tests read results directly."""
    parsed = parse_task_name(name)
    run = parsed[0] if parsed else ""
    if registry_stamp(mq_dir, run) is not None:
        return False
    if os.path.exists(os.path.join(mq_dir, _PAYLOAD)):
        return False
    for path in (mq_result_path(mq_dir, name), mq_fail_path(mq_dir, name)):
        try:
            os.remove(path)
        except OSError:
            pass
    return True


def janitor_sweep(mq_dir: str, *, max_age_s: float) -> int:
    """Fleet-side garbage backstop for droppings no run-scoped sweep can
    reach, run from idle workers: (1) aged ``*.tmp`` siblings of writers
    that crashed mid-atomic-write, (2) aged orphan ``*.lease`` files
    whose claim is gone and whose heartbeat has stopped (a lease without
    its claim is always garbage: release removes both together and
    ``claim_next`` renames only the ``.npz``), (3) aged results/fails of
    DEREGISTERED runs (the crash-proof twin of
    :func:`clean_if_run_closed` — their publisher died before its own
    tombstone). The age guard keeps in-flight writes and actively
    heartbeated leases safe; registered runs' files are never touched,
    which is what makes ``keep_jobs=None`` (a run that stays registered)
    the durable GC opt-out. Returns the number of files removed."""
    removed = 0
    cutoff = time.time() - max_age_s
    legacy = os.path.exists(os.path.join(mq_dir, _PAYLOAD))
    live_stamp: Dict[str, bool] = {}
    for d in (TASKS_DIR, CLAIMED_DIR, RESULTS_DIR):
        try:
            names = os.listdir(os.path.join(mq_dir, d))
        except OSError:
            continue
        for name in names:
            path = os.path.join(mq_dir, d, name)
            garbage = False
            if name.endswith(TMP_SUFFIX):
                garbage = True
            elif d == CLAIMED_DIR and name.endswith(LEASE_SUFFIX):
                garbage = not os.path.exists(path[:-len(LEASE_SUFFIX)])
            elif d == RESULTS_DIR and not legacy:
                stem = name
                for suffix in (".result.npz", ".fail", ".npz"):
                    if stem.endswith(suffix):
                        stem = stem[:-len(suffix)] + ".npz"
                        break
                parsed = parse_task_name(stem)
                if parsed:
                    run = parsed[0]
                    if run not in live_stamp:
                        live_stamp[run] = (
                            registry_stamp(mq_dir, run) is not None)
                    garbage = not live_stamp[run]
            if not garbage:
                continue
            try:
                if os.path.getmtime(path) > cutoff:
                    continue
                os.remove(path)
                removed += 1
            except OSError:
                pass
    # torn tmp outside the queue dirs: a publisher crashed mid-write of
    # a registry entry (runs/), a fleet ticket (fleet/) or the STOP
    # sentinel (root). Same age guard; only *.tmp is ever eligible here
    # (fault-injection sweep in analysis/sanitize pins this path)
    for d in (RUNS_DIR, FLEET_DIR, ""):
        try:
            names = os.listdir(os.path.join(mq_dir, d))
        except OSError:
            continue
        for name in names:
            if not name.endswith(TMP_SUFFIX):
                continue
            path = os.path.join(mq_dir, d, name)
            try:
                if os.path.getmtime(path) > cutoff:
                    continue
                os.remove(path)
                removed += 1
            except OSError:
                pass
    return removed


def gc_sweep(mq_dir: str, run_id: str, active: set,
             keep_by_job: Dict[int, set]) -> None:
    """Run-scoped job sweep (manager protocol step): remove every queue
    file of ``run_id``'s non-active jobs that is not a retained winning
    result — stale tasks from superseded deliveries, claimed files +
    leases left by killed workers, and duplicate or late results from
    at-least-once races. RUN-AWARE: only names inside ``run_id``'s own
    namespace are eligible; another run's live queue in a shared broker
    directory is invisible. Files that don't parse as task names are
    foreign content and never touched. Shared by the file transport
    (:meth:`QueueBackend._gc_sweep`) and the socket broker's ``GC_SWEEP``
    op (``repro_torch.runtime.netbroker``)."""
    prefix = f"r{run_id}_"
    job_re = re.compile(r"j(\d{6})_")
    for d in (TASKS_DIR, CLAIMED_DIR, RESULTS_DIR):
        try:
            entries = os.listdir(os.path.join(mq_dir, d))
        except OSError:
            continue
        for name in entries:
            if not name.startswith(prefix):
                continue
            m = job_re.match(name[len(prefix):])
            if m is None:
                continue
            j = int(m.group(1))
            if j in active or name in keep_by_job.get(j, ()):
                continue
            try:
                os.remove(os.path.join(mq_dir, d, name))
            except OSError:
                pass


def process_task(mq_dir: str, name: str, fn: Callable, *,
                 heartbeat_s: float = 1.0, hang: bool = False) -> bool:
    """Evaluate one claimed task: lease -> heartbeat -> eval -> atomic
    result/fail -> release claim. ``hang=True`` simulates a worker killed
    mid-task (lease written once, never renewed, nothing reported) so the
    manager's stale-lease re-queue path can be exercised."""
    claimed = os.path.join(mq_dir, CLAIMED_DIR, name)
    lease = write_lease(mq_dir, name)
    if hang:
        return False
    hb = _Heartbeat(lease, heartbeat_s)
    hb.start()
    ok = False
    t_claim = time.perf_counter()
    try:
        genomes = np.load(claimed)["genomes"]
        t0 = time.perf_counter()
        fit = np.asarray(fn(genomes), np.float32).reshape(len(genomes), -1)
        duration = time.perf_counter() - t0
        publish_result(mq_dir, name, fit, duration)
        ok = True
    except Exception:
        tb = traceback.format_exc()
        publish_fail(mq_dir, name, tb)
        sys.stderr.write(tb)
    finally:
        hb.stop()
        release_claim(mq_dir, name)
    m = _metrics.get_registry()
    if m.enabled:
        parsed = parse_task_name(name)
        run = parsed[0] if parsed else ""
        busy = time.perf_counter() - t_claim
        # claim→publish span: the utilization numerator (idle time is
        # the worker loop's poll sleeps, counted separately)
        m.inc("mq_worker_busy_seconds_total", busy)
        if ok:
            m.inc("mq_tasks_completed_total", run=run)
            m.event("publish", task=name, run=run,
                    duration=round(busy, 6))
        else:
            m.inc("mq_task_failures_total", run=run)
            m.event("fail", task=name, run=run)
    return ok


def worker_loop(mq_dir: str, *, fn: Optional[Callable] = None,
                lease_s: float = 15.0, poll_s: float = 0.05,
                max_tasks: Optional[int] = None,
                idle_exit_s: Optional[float] = None,
                hang_substrings: tuple = ()) -> int:
    """Persistent worker body: claim -> evaluate -> report until the
    fleet-wide STOP sentinel appears (or ``max_tasks`` / ``idle_exit_s``
    triggers). The worker is MULTI-TENANT: each claimed task names its
    run, whose fitness is resolved once from the ``runs/`` registry and
    cached per run, keyed on the registry entry's identity — a REUSED run
    id (deregister + re-register with a different payload) invalidates
    the cache, so a persistent fleet never evaluates a new run with a
    previous run's fitness. ``fn`` overrides resolution for every run
    (in-process thread pools). A run whose fitness cannot be resolved
    gets a per-run RESOLVE_FAIL marker (its manager fails fast) and is
    skipped while its registration is unchanged; the worker keeps serving
    other runs — one tenant's typo never kills a shared fleet. Claiming
    a poison STOP ticket (autoscaler scale-down) exits AFTER the current
    chunk — at a chunk boundary, never mid-evaluation. Returns the number
    of tasks completed."""
    heartbeat_s = max(0.05, lease_s / 4.0)
    done = 0
    fns: Dict[str, tuple] = {}       # run -> (registry stamp, fitness)
    bad_runs: Dict[str, object] = {}  # run -> stamp when it failed
    idle_t0 = time.monotonic()
    janitor_t = time.monotonic()
    while True:
        if os.path.exists(os.path.join(mq_dir, STOP_NAME)):
            return done
        # a re-registered run id (stamp changed) gets a fresh chance: the
        # bad-spec skip and the fitness cache must not outlive the run
        # that created them on a persistent fleet
        for run in [r for r, s in list(bad_runs.items())
                    if registry_stamp(mq_dir, r) != s]:
            del bad_runs[run]
        name = claim_next(mq_dir, skip_runs=bad_runs)
        if name is None:
            if (idle_exit_s is not None
                    and time.monotonic() - idle_t0 > idle_exit_s):
                return done
            # idle workers double as the fleet's janitor: crashed
            # writers' tmp droppings, orphan leases, and dead runs'
            # late results have no run-scoped sweeper left (throttled
            # to one sweep per lease window; the age guard inside
            # keeps anything live untouched)
            if time.monotonic() - janitor_t > lease_s:
                janitor_t = time.monotonic()
                janitor_sweep(mq_dir, max_age_s=2.0 * lease_s)
            m = _metrics.get_registry()
            if m.enabled:
                m.inc("mq_worker_idle_seconds_total", poll_s)
            time.sleep(poll_s)
            continue
        if name.endswith(POISON_SUFFIX):
            try:
                os.remove(os.path.join(mq_dir, CLAIMED_DIR, name))
            except OSError:
                pass
            return done                          # scale-down: one worker out
        idle_t0 = time.monotonic()
        parsed = parse_task_name(name)
        run = parsed[0] if parsed else ""
        task_fn = fn
        if task_fn is None:
            stamp = registry_stamp(mq_dir, run)
            hit = fns.get(run)
            if hit is not None and hit[0] == stamp:
                task_fn = hit[1]
        if task_fn is None:
            try:
                task_fn = resolve_run_fn(mq_dir, run)
                fns[run] = (stamp, task_fn)
            except Exception:
                if (stamp is None
                        and not os.path.exists(
                            os.path.join(mq_dir, _PAYLOAD))):
                    # the run DEREGISTERED between our claim and the
                    # resolve (close() raced us): the task is a stray
                    # the final sweep missed, not a bad spec — drop the
                    # claim quietly; a RESOLVE_FAIL marker here would
                    # leak forever (no manager left to consume it)
                    bad_runs[run] = stamp
                    release_claim(mq_dir, name)
                    continue
                # cannot serve THIS run (bad import spec, unpicklable
                # callable): surface the traceback on a per-run marker so
                # its manager fails fast instead of waiting forever (the
                # straggler clock only starts at first claim), then keep
                # serving the other tenants
                tb = traceback.format_exc()
                try:
                    atomic_write_text(resolve_fail_path(mq_dir, run), tb)
                except OSError:
                    pass
                sys.stderr.write(tb)
                bad_runs[run] = stamp
                try:
                    os.remove(os.path.join(mq_dir, CLAIMED_DIR, name))
                except OSError:
                    pass
                continue
        hang = any(s in name for s in hang_substrings)
        process_task(mq_dir, name, task_fn, heartbeat_s=heartbeat_s,
                     hang=hang)
        if hang:
            return done                          # the simulated kill -9
        if fn is None:
            # late-report tombstone (registry-resolved runs only: an fn
            # override serves hand-made directories whose results are
            # read without a registration to signal liveness)
            clean_if_run_closed(mq_dir, name)
        done += 1
        if max_tasks is not None and done >= max_tasks:
            return done


def run_worker_ticket(ticket_path: str) -> int:
    """Entry for a Scheduler-launched fleet member: the batchq array-task
    entrypoint hands a ``*.worker.json`` ticket here and the work item
    becomes a persistent queue worker (see :class:`MQWorkerFleet`)."""
    try:
        with open(ticket_path) as f:
            cfg = json.load(f)
        worker_loop(cfg["mq_dir"],
                    lease_s=float(cfg.get("lease_s", 15.0)),
                    poll_s=float(cfg.get("poll_s", 0.05)),
                    max_tasks=cfg.get("max_tasks"),
                    idle_exit_s=cfg.get("idle_exit_s"),
                    hang_substrings=tuple(cfg.get("hang_substrings", ())))
        return 0
    except Exception:
        sys.stderr.write(traceback.format_exc())
        return 1


# ---------------------------------------------------------------------------
# Worker fleets
# ---------------------------------------------------------------------------

class LocalWorkerPool:
    """Local persistent-worker fleet: threads (fast, in-process — CI and
    conformance tests; ``fn`` may override payload resolution so tests can
    inject closures) or subprocesses (real numpy-only interpreters, the
    cluster stand-in). ``hang_substrings`` injects worker death: a worker
    claiming a matching task writes its lease once and dies, so the
    manager's stale-lease re-queue must recover the chunk.

    ``mq_dir`` may be bound later (``QueueBackend(worker_pool=...)`` binds
    its own broker directory before starting the pool). For a SHARED
    fleet, bind ``mq_dir`` up front and start the pool yourself; any
    number of ``QueueBackend`` runs may then point at the same directory
    with ``worker_pool=None``. ``grow(n)`` adds workers incrementally
    (:class:`FleetAutoscaler` scale-up)."""

    def __init__(self, num_workers: int = 4, mode: str = "thread", *,
                 mq_dir: Optional[str] = None, fn: Optional[Callable] = None,
                 lease_s: float = 15.0, poll_s: float = 0.01,
                 hang_substrings: tuple = (), python: Optional[str] = None):
        if mode not in ("thread", "subprocess"):
            raise ValueError(f"mode must be thread|subprocess: {mode}")
        self.num_workers = max(1, num_workers)
        self.mode = mode
        self.mq_dir = mq_dir
        self.fn = fn
        self.lease_s = lease_s
        self.poll_s = poll_s
        self.hang_substrings = tuple(hang_substrings)
        self.python = python or sys.executable
        self._members: list = []
        self._started = False
        # guards _members/num_workers/_started: grow() is called from the
        # autoscaler thread while the owner may start/stop/poll
        self._lock = threading.Lock()

    def _spawn_member(self):
        # caller holds self._lock
        if self.mode == "thread":
            t = threading.Thread(
                target=worker_loop, args=(self.mq_dir,),
                kwargs=dict(fn=self.fn, lease_s=self.lease_s,
                            poll_s=self.poll_s,
                            hang_substrings=self.hang_substrings),
                daemon=True)
            t.start()
            self._members.append(t)
        else:
            env = dict(os.environ)
            env["PYTHONPATH"] = _SRC_ROOT + (
                os.pathsep + env["PYTHONPATH"]
                if env.get("PYTHONPATH") else "")
            cmd = [self.python, "-m", "repro_torch.runtime.mq", "--worker",
                   "--mq-dir", self.mq_dir,
                   "--lease-s", str(self.lease_s),
                   "--poll-s", str(self.poll_s)]
            if self.hang_substrings:
                cmd += ["--hang-substrings",
                        ",".join(self.hang_substrings)]
            self._members.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL))

    def start(self):
        with self._lock:
            if self._started:
                return self
            if self.mq_dir is None:
                raise ValueError("LocalWorkerPool.start: mq_dir not bound")
            make_broker_dirs(self.mq_dir)
            for _ in range(self.num_workers):
                self._spawn_member()
            self._started = True
        return self

    def grow(self, n: int):
        """Incremental scale-up (:class:`FleetAutoscaler`): spawn ``n``
        more workers against the same broker directory."""
        n = max(0, int(n))
        with self._lock:
            self.num_workers += n
            if self._started:
                for _ in range(n):
                    self._spawn_member()
        return self

    def alive_workers(self) -> int:
        """Workers still running (threads alive / subprocesses not
        exited) — poison STOP tickets and the fleet-wide STOP reduce
        this as workers drain out."""
        with self._lock:
            members = list(self._members)
        alive = 0
        for m in members:
            if isinstance(m, threading.Thread):
                alive += m.is_alive()
            else:
                alive += m.poll() is None
        return alive

    def stop(self, timeout_s: float = 10.0):
        """Raise the STOP sentinel and collect the fleet. Threads that
        ignore the deadline are daemons (abandoned); subprocesses are
        killed."""
        with self._lock:
            if not self._started:
                return
            # swap out under the lock; join/wait OUTSIDE it so a slow
            # drain never blocks a concurrent grow()/alive_workers()
            members, self._members = self._members, []
            self._started = False
        try:
            atomic_write_text(os.path.join(self.mq_dir, STOP_NAME), "stop\n")
        except OSError:
            pass
        deadline = time.monotonic() + timeout_s
        for m in members:
            left = max(0.0, deadline - time.monotonic())
            if isinstance(m, threading.Thread):
                m.join(timeout=left)
            else:
                try:
                    m.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    m.kill()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False


class MQWorkerFleet:
    """Persistent fleet launched through the batchq ``Scheduler`` protocol
    — ONE long-lived SLURM array job / Kubernetes indexed Job for the
    whole GA run (or several runs sharing the directory), instead of one
    per batch. Each work item is handed a ``*.worker.json`` ticket
    (instead of a chunk); the standard array-task entrypoint
    (``python -m repro_torch.runtime.batchq --worker <ticket>``) detects the
    suffix and runs :func:`worker_loop` until STOP. ``grow(n)`` submits
    ``n`` more tickets through the SAME scheduler — the protocol's
    incremental submit, one more ``sbatch --array`` / ``kubectl apply``
    round-trip without touching workers already running
    (:class:`FleetAutoscaler` scale-up). The same shared-volume contract
    as the batch spool applies: ``mq_dir`` must be reachable at the same
    path inside every array task / pod."""

    def __init__(self, scheduler, num_workers: int, *,
                 mq_dir: Optional[str] = None, lease_s: float = 15.0,
                 poll_s: float = 0.05, idle_exit_s: Optional[float] = None):
        self.scheduler = scheduler
        self.num_workers = max(1, num_workers)
        self.mq_dir = mq_dir
        self.lease_s = lease_s
        self.poll_s = poll_s
        self.idle_exit_s = idle_exit_s
        self.handles: List[str] = []
        self._ticket_seq = 0
        self._started = False
        # guards handles/_ticket_seq/num_workers/_started: grow() runs on
        # the autoscaler thread concurrent with owner start/stop/poll
        self._lock = threading.Lock()

    def _submit_tickets(self, n: int):
        # caller holds self._lock
        fleet_dir = os.path.join(self.mq_dir, FLEET_DIR)
        os.makedirs(fleet_dir, exist_ok=True)
        tickets = []
        for _ in range(n):
            i = self._ticket_seq
            self._ticket_seq += 1
            path = os.path.join(fleet_dir, f"worker_{i:04d}{TICKET_SUFFIX}")
            atomic_write_text(path, json.dumps({
                "mq_dir": self.mq_dir, "lease_s": self.lease_s,
                "poll_s": self.poll_s, "idle_exit_s": self.idle_exit_s}))
            tickets.append(path)
        self.handles.extend(self.scheduler.submit(tickets,
                                                  job_dir=fleet_dir))

    def start(self):
        with self._lock:
            if self._started:
                return self
            if self.mq_dir is None:
                raise ValueError("MQWorkerFleet.start: mq_dir not bound")
            make_broker_dirs(self.mq_dir)
            self._submit_tickets(self.num_workers)
            self._started = True
        return self

    def grow(self, n: int):
        """Incremental scale-up through the unchanged ``Scheduler``
        protocol: one more submission carrying ``n`` fresh tickets."""
        n = max(0, int(n))
        with self._lock:
            self.num_workers += n
            if self._started and n:
                self._submit_tickets(n)
        return self

    def alive_workers(self) -> int:
        with self._lock:
            handles = list(self.handles)
        return sum(self.scheduler.poll(h) in ("pending", "running")
                   for h in handles)

    def stop(self, timeout_s: float = 10.0):
        """STOP the fleet, give it a grace period to drain off the queue,
        then cancel stragglers and reap scheduler objects."""
        with self._lock:
            if not self._started:
                return
            self._started = False
            handles = list(self.handles)
        try:
            atomic_write_text(os.path.join(self.mq_dir, STOP_NAME), "stop\n")
        except OSError:
            pass
        deadline = time.monotonic() + timeout_s
        pending = handles
        while pending and time.monotonic() < deadline:
            pending = [h for h in pending
                       if self.scheduler.poll(h) in ("pending", "running")]
            if pending:
                time.sleep(0.05)
        for h in pending:
            try:
                self.scheduler.cancel(h)
            except Exception:
                pass
        reap = getattr(self.scheduler, "reap", None)
        if reap is not None:
            try:
                reap(tuple(handles))
            except Exception:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False


# ---------------------------------------------------------------------------
# Elastic fleet autoscaling (ROADMAP "grow/shrink MQWorkerFleet from
# queue depth")
# ---------------------------------------------------------------------------

class FleetAutoscaler:
    """Manager-side elastic fleet controller: a background loop watches
    the broker directory's queue depth (ready tasks) and lease count
    (claimed, in evaluation) and resizes the worker pool between
    ``min_workers`` and ``max_workers``.

    * **Scale-up** rides the pool's incremental submit: ``pool.grow(n)``
      spawns more local workers (:class:`LocalWorkerPool`) or submits
      more ``*.worker.json`` tickets through the batchq ``Scheduler``
      protocol (:class:`MQWorkerFleet`) — one extra ``sbatch --array`` /
      ``kubectl apply`` round-trip; nothing already running is touched.
      Pending (unclaimed) poison tickets are revoked first: cancelling a
      scale-down that has not happened yet is cheaper than a launch.
    * **Scale-down** drops poison STOP tickets (``*.stop`` files) into
      the task queue. Workers claim them only when no real task is ready
      and exit at a CHUNK BOUNDARY — a shrinking fleet never abandons a
      claimed chunk mid-evaluation and never starves queued work.
    * ``cooldown_s`` rate-limits resize actions so a bursty queue does
      not thrash the scheduler; ``backlog_per_worker`` sets how much
      outstanding work (ready + leased tasks) justifies one worker.

    **Signals.** ``signal="depth"`` (default) scales on raw outstanding
    task count, as above. ``signal="cost"`` scales on PREDICTED
    OUTSTANDING COST instead: ``(ready + leased) × cost_per_task``
    seconds of work, provisioned so the backlog drains within
    ``cost_horizon_s`` — eight 10 ms tasks and eight 10 s tasks are the
    same depth but very different fleets. The per-task cost and the
    measured worker utilization (busy-seconds deltas from claim→publish
    spans) are read from the METRICS BUS — the same registry the
    exporters serve (``metrics=...``, or the process-wide seam in
    :mod:`repro_torch.runtime.metrics`) — so tests drive decisions purely
    through planted metrics, with no fleet and no broker directory
    (``pool=None`` skips actuation; decisions still land in ``size``/
    ``stats``/events). When the bus has no cost series yet,
    ``default_cost_s`` seeds the estimate; a saturated fleet
    (utilization ≥ ``util_high`` with work still queued) is grown even
    if the cost estimate lags.

    The autoscaler owns neither the pool nor the queue: ``stop()`` halts
    the control loop only (``QueueBackend.close`` stops it before the
    pool, so a dying manager never resizes a fleet it is abandoning).
    ``stats``: ``scale_ups`` / ``scale_downs`` / ``peak_workers`` /
    ``ticks``; ``size`` is the intended fleet size."""

    def __init__(self, pool=None, *, min_workers: int = 1,
                 max_workers: int = 8,
                 interval_s: float = 0.25, cooldown_s: float = 1.0,
                 backlog_per_worker: float = 1.0,
                 signal: str = "depth", metrics=None,
                 cost_horizon_s: float = 1.0,
                 default_cost_s: float = 0.1,
                 util_high: float = 0.85):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers: "
                f"{min_workers}:{max_workers}")
        if backlog_per_worker <= 0:
            raise ValueError(
                f"backlog_per_worker must be > 0: {backlog_per_worker}")
        if signal not in ("depth", "cost"):
            raise ValueError(f"signal must be depth|cost: {signal}")
        self.pool = pool
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.backlog_per_worker = float(backlog_per_worker)
        self.signal = signal
        self.metrics = metrics
        self.cost_horizon_s = float(cost_horizon_s)
        self.default_cost_s = float(default_cost_s)
        self.util_high = float(util_high)
        self.size = int(pool.num_workers) if pool is not None \
            else self.min_workers
        self.stats = {"scale_ups": 0, "scale_downs": 0,
                      "peak_workers": self.size, "ticks": 0}
        self.mq_dir: Optional[str] = None
        self._util_prev: tuple = (0.0, None)     # (busy_total, tick time)
        self._poisons: List[str] = []
        self._poison_seq = 0
        self._last_action: Optional[float] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards size/stats/_poisons/_poison_seq/_last_action: _tick runs
        # on the control thread while start() and readers run on the
        # manager thread
        self._lock = threading.Lock()

    def queue_state(self):
        """One directory scan: ``(ready, leased, pending_poison)``."""
        ready = leased = poison = 0
        try:
            for name in os.listdir(os.path.join(self.mq_dir, TASKS_DIR)):
                if name.endswith(POISON_SUFFIX):
                    poison += 1
                elif name.endswith(".npz"):
                    ready += 1
        except OSError:
            pass
        try:
            for name in os.listdir(os.path.join(self.mq_dir, CLAIMED_DIR)):
                if name.endswith(".npz"):
                    leased += 1
        except OSError:
            pass
        return ready, leased, poison

    def _utilization(self, reader, now: float, leased: int):
        """Busy fraction of the fleet over the last tick interval.
        Preference order: measured claim→publish busy-seconds deltas
        from the bus, a planted/published ``mq_worker_utilization``
        gauge, ``leased/size`` as the estimate of last resort. Caller
        holds ``self._lock`` (the registry lock is a leaf)."""
        if reader is not None \
                and reader.has_series("mq_worker_busy_seconds_total"):
            busy = reader.counter_total("mq_worker_busy_seconds_total")
            prev_busy, prev_t = self._util_prev
            self._util_prev = (busy, now)
            if prev_t is not None and now > prev_t:
                window = (now - prev_t) * max(1, self.size)
                return min(1.0, max(0.0, (busy - prev_busy) / window))
        if reader is not None:
            g = reader.agg_gauge("mq_worker_utilization", "mean")
            if g is not None:
                return float(g)
        if self.size > 0:
            return min(1.0, leased / float(self.size))
        return None

    def _cost_decision(self, m, reader, now: float, ready: int,
                       leased: int):
        """Cost-signal sizing (caller holds ``self._lock``): provision
        enough workers that the predicted outstanding cost drains
        within ``cost_horizon_s``."""
        cost = self.default_cost_s
        if reader is not None:
            r = reader.agg_gauge("mq_ready_total")
            lg = reader.agg_gauge("mq_leased_total")
            if r is not None:
                ready = int(r)
            if lg is not None:
                leased = int(lg)
            cost = reader.agg_gauge("mq_cost_per_task_seconds", "mean",
                                    self.default_cost_s)
        util = self._utilization(reader, now, leased)
        outstanding_s = (ready + leased) * max(float(cost), 1e-9)
        want = -(-outstanding_s // max(self.cost_horizon_s, 1e-9))
        desired = min(self.max_workers, max(self.min_workers, int(want)))
        if ready > 0 and util is not None and util >= self.util_high:
            # saturated fleet with work still queued: grow even when
            # the cost estimate lags reality (cold EMA, skewed tasks)
            desired = min(self.max_workers, max(desired, self.size + 1))
        if m.enabled:
            m.set_gauge("mq_outstanding_cost_seconds", outstanding_s)
            if util is not None:
                m.set_gauge("mq_worker_utilization", util)
        inputs = {"ready": ready, "leased": leased,
                  "cost_per_task": round(float(cost), 6),
                  "outstanding_s": round(outstanding_s, 6),
                  "utilization": None if util is None
                  else round(util, 4)}
        return desired, inputs

    def _tick(self, now: float) -> None:
        m = self.metrics if self.metrics is not None \
            else _metrics.get_registry()
        # cost-signal reads need the full registry interface; a bare
        # emission sink (or the null default) falls back to estimates
        reader = m if (m.enabled and hasattr(m, "agg_gauge")) else None
        ready = leased = 0
        if self.mq_dir is not None:
            ready, leased, _poison = self.queue_state()
            if m.enabled:
                m.set_gauge("mq_ready_total", float(ready))
                m.set_gauge("mq_leased_total", float(leased))
        # the whole decision runs under self._lock: size/stats/_poisons
        # are also read by the manager thread (stats_snapshot, start).
        # Lock order is autoscaler._lock -> pool._lock (via grow); the
        # pool never calls back into the autoscaler, so no cycle. The
        # registry's lock is a leaf: it never calls out.
        with self._lock:
            # reconcile the intended size with reality: a worker that
            # CRASHED (as opposed to retiring on a poison ticket, which
            # decremented size when issued) leaves size overstating the
            # fleet — without this, a drained-then-reloaded queue would
            # never re-grow past the ghosts and could starve on an empty
            # fleet
            alive_fn = getattr(self.pool, "alive_workers", None)
            if alive_fn is not None:
                try:
                    self.size = min(self.size, int(alive_fn()))
                except Exception:
                    pass                         # scheduler poll hiccup
            if self.signal == "cost":
                desired, inputs = self._cost_decision(
                    m, reader, now, ready, leased)
            else:
                outstanding = ready + leased
                want = -(-outstanding
                         // max(self.backlog_per_worker, 1e-9))
                desired = min(self.max_workers,
                              max(self.min_workers, int(want)))
                inputs = {"ready": ready, "leased": leased}
            self.stats["ticks"] += 1
            if m.enabled:
                m.set_gauge("autoscaler_size", float(self.size))
                m.set_gauge("autoscaler_desired", float(desired))
            if desired == self.size:
                return
            if (self._last_action is not None
                    and now - self._last_action < self.cooldown_s):
                return
            if desired > self.size:
                delta = desired - self.size
                # revoke pending poison first: an unclaimed .stop file
                # is a scale-down that has not happened yet
                revoked = 0
                while self._poisons and revoked < delta:
                    path = self._poisons.pop()
                    try:
                        os.remove(path)
                        revoked += 1
                    except OSError:
                        pass                     # already claimed: that
                                                 # worker really exited
                if delta - revoked > 0 and self.pool is not None:
                    self.pool.grow(delta - revoked)
                self.stats["scale_ups"] += 1
                if m.enabled:
                    m.inc("autoscaler_scale_ups_total")
            else:
                if self.mq_dir is not None:
                    for _ in range(self.size - desired):
                        path = os.path.join(
                            self.mq_dir, TASKS_DIR,
                            f"zzzstop-{os.getpid():x}-"
                            f"{self._poison_seq:04d}{POISON_SUFFIX}")
                        self._poison_seq += 1
                        try:
                            atomic_write_text(path, "stop\n")
                            self._poisons.append(path)
                        except OSError:
                            break
                self.stats["scale_downs"] += 1
                if m.enabled:
                    m.inc("autoscaler_scale_downs_total")
            if m.enabled:
                m.event("autoscale", signal=self.signal, size=self.size,
                        desired=desired, **inputs)
            self.size = desired
            self.stats["peak_workers"] = max(self.stats["peak_workers"],
                                             desired)
            self._last_action = now

    def _run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self._tick(time.monotonic())
            except OSError:
                pass                             # shared-FS hiccup: retry

    def start(self):
        if self._thread is not None:
            return self
        if self.mq_dir is None:
            self.mq_dir = getattr(self.pool, "mq_dir", None)
        if self.mq_dir is None and self.signal != "cost":
            # cost mode may run off the metrics bus alone (gauges
            # published by whoever scans); depth has nothing else
            raise ValueError(
                "FleetAutoscaler.start: pool has no mq_dir bound")
        with self._lock:
            if self.pool is not None:
                self.size = int(self.pool.num_workers)
            self.stats["peak_workers"] = max(self.stats["peak_workers"],
                                             self.size)
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stats_snapshot(self) -> Dict[str, int]:
        """Consistent copy of the counters (the control thread mutates
        ``stats`` under the same lock)."""
        with self._lock:
            return dict(self.stats)

    def stop(self):
        """Halt the control loop. The pool keeps its current size;
        un-claimed poison tickets remain and will retire idle workers."""
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False


# ---------------------------------------------------------------------------
# Manager side: the DispatchBackend
# ---------------------------------------------------------------------------

class _ChunkTrack:
    """Manager-side delivery state for one chunk of one job."""

    __slots__ = ("all_names", "latest", "delivery", "attempt", "t_exec",
                 "seen_wall", "done", "done_name", "failed_msg")

    def __init__(self):
        self.all_names: List[str] = []   # every name ever issued (accept
        self.latest = ""                 # a result from ANY of them)
        self.delivery = 0
        self.attempt = 0
        self.t_exec: Optional[float] = None   # first claim of this attempt
        self.seen_wall: Optional[float] = None
        self.done: Optional[tuple] = None
        self.done_name: Optional[str] = None
        self.failed_msg: Optional[str] = None

    def track(self, name: str):
        self.all_names.append(name)
        self.latest = name
        self.seen_wall = None

    def new_attempt(self, attempt: int):
        self.attempt = attempt
        self.delivery = 0
        self.t_exec = None
        self.failed_msg = None


class QueueBackend(PureCallbackBridge):
    """``DispatchBackend`` over the persistent-worker message queue.

    Each ``evaluate`` becomes one *job*: the (shuffled, padded) batch is
    chunked — cost-sized via the shared planner when the broker dispatches
    with a cost model (sentinel pads dropped, pricier-first re-order,
    ``min_chunk_cost_s`` folds sub-startup-cost chunks into their cheapest
    neighbor), equal counts otherwise — and every chunk is enqueued up
    front as a task file. The manager then *streams* the result queue:

    * a finished chunk's measured duration is fed to ``cost_ema.observe``
      the moment its result lands (mid-flight — ``stats["streamed"]``
      counts these), not when the whole batch completes;
    * a claimed task whose lease goes stale for ``lease_s`` is re-queued
      under a bumped delivery suffix (``stats["lease_requeues"]``) without
      touching the retry budget — dead workers are detected by liveness;
    * failures and ``chunk_timeout_s`` stragglers (clocked from the first
      claim of the current attempt; queue wait before that never counts —
      which also means a lower-priority run starved by a contended fleet
      is never mis-read as straggling) are re-queued as fresh attempts
      through the shared ``run_chunks_retry``, same semantics as the
      batch backends.

    Multi-tenancy: the backend registers its ``run_id`` (auto-generated
    unless given) and claim ``priority`` in the broker's ``runs/``
    registry, namespaces every task it enqueues, and only ever re-queues,
    times out, or garbage-collects its own names — any number of
    concurrent runs (each with its own ``QueueBackend``) can share one
    broker directory and one worker fleet, with idle workers stealing
    work from whichever run is loaded, highest priority first.

    Results are accepted from ANY delivery or attempt ever issued for a
    chunk (at-least-once; all deliveries carry identical genomes). On job
    completion everything but the winning result files is deleted, and
    completed jobs beyond ``keep_jobs`` are swept entirely — the broker
    directory stays bounded over arbitrarily long runs, stale leases of
    killed workers included, and the run-aware sweep never collects
    another run's live files.

    The workers are NOT owned by the backend by default: pass a
    ``worker_pool`` (:class:`LocalWorkerPool` or :class:`MQWorkerFleet`,
    started against this backend's ``mq_dir`` and stopped on ``close()``),
    or launch a fleet externally against the same directory — e.g. one
    shared pool serving several backends, which ``close()`` then leaves
    running (per-run STOP: the run deregisters; the fleet-wide STOP
    sentinel is only raised by the fleet's owner). ``autoscaler`` (a
    :class:`FleetAutoscaler` around the pool) is started with the backend
    and stopped on ``close()`` before the pool.
    """

    name = "mq"

    def _init_manager(self, fitness_fn: Optional[Callable], *,
                      fn_spec: Optional[str],
                      num_objectives: int, num_workers: int,
                      run_id: Optional[str], priority: int,
                      lease_s: float, chunk_timeout_s: Optional[float],
                      max_retries: int, poll_interval_s: float,
                      cost_ema, chunk_sizing: str, min_chunk_cost_s: float,
                      keep_jobs: Optional[int],
                      step_hook: Optional[Callable]) -> None:
        """Transport-neutral manager state — everything the streaming
        pump / retry / GC logic needs that is not a broker file op.
        Shared verbatim by the file transport (``__init__`` below) and
        the socket transport (``repro_torch.runtime.netbroker``)."""
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
        self.run_id = sanitize_run_id(
            run_id if run_id is not None
            else f"{os.getpid():x}-{os.urandom(3).hex()}")
        self.priority = int(priority)
        self.lease_s = float(lease_s)
        self.chunk_timeout_s = chunk_timeout_s
        self.max_retries = max_retries
        self.poll_interval_s = poll_interval_s
        self.cost_ema = cost_ema
        self.chunk_sizing = chunk_sizing
        self.min_chunk_cost_s = float(min_chunk_cost_s)
        self.keep_jobs = keep_jobs
        # step-barrier seam for the protocol replay harness (analysis/
        # proto/replay): called as step_hook("manager", "pump") at every
        # pump sweep so adversarial schedules from the model checker can
        # drive the REAL manager loop step-locked against real workers.
        # None (production) costs one attribute check per sweep.
        self._step_hook = step_hook
        self.stats = {"jobs": 0, "retries": 0, "timeouts": 0,
                      "lease_requeues": 0, "streamed": 0, "jobs_pruned": 0}
        # EMA of measured per-task cost (duration / chunk size), fed by
        # stream_result and published as the mq_cost_per_task_seconds
        # gauge the cost-signal autoscaler reads; guarded by _lock
        self._cost_per_task: Optional[float] = None
        #: _lock guards stats and all job-tracking state below; every
        #: ``stats[...] += 1`` in this class already sits inside it
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight = 0
        self._seq = 0
        self._closed = False
        self._done_jobs: List[int] = []
        self._active_jobs: set = set()
        self._job_winners: Dict[int, set] = {}

    def __init__(self, fitness_fn: Optional[Callable] = None, *,
                 fn_spec: Optional[str] = None,
                 num_objectives: int = 1, num_workers: int = 4,
                 mq_dir: Optional[str] = None,
                 run_id: Optional[str] = None,
                 priority: int = 0,
                 lease_s: float = 15.0,
                 chunk_timeout_s: Optional[float] = 300.0,
                 max_retries: int = 2,
                 poll_interval_s: float = 0.02,
                 cost_ema=None,
                 chunk_sizing: str = "cost",
                 min_chunk_cost_s: float = 0.0,
                 keep_jobs: Optional[int] = 4,
                 worker_pool=None,
                 autoscaler: Optional[FleetAutoscaler] = None,
                 step_hook: Optional[Callable] = None):
        self._init_manager(
            fitness_fn, fn_spec=fn_spec, num_objectives=num_objectives,
            num_workers=num_workers, run_id=run_id, priority=priority,
            lease_s=lease_s, chunk_timeout_s=chunk_timeout_s,
            max_retries=max_retries, poll_interval_s=poll_interval_s,
            cost_ema=cost_ema, chunk_sizing=chunk_sizing,
            min_chunk_cost_s=min_chunk_cost_s, keep_jobs=keep_jobs,
            step_hook=step_hook)
        self._owns_dir = mq_dir is None
        self.mq_dir = mq_dir or tempfile.mkdtemp(prefix="chambga-mq-")
        make_broker_dirs(self.mq_dir)
        # a reused directory may hold a previous invocation's sentinels;
        # the fleet-wide STOP is FLEET state: only an invocation that
        # owns workers (its own pool, or the whole temp dir) may clear
        # it — an externally-attaching run must not resurrect a fleet
        # its operator just shut down
        if self._owns_dir or worker_pool is not None:
            try:
                os.remove(os.path.join(self.mq_dir, STOP_NAME))
            except OSError:
                pass
        try:
            os.remove(resolve_fail_path(self.mq_dir, self.run_id))
        except OSError:
            pass
        register_run(self.mq_dir, self.run_id, priority=self.priority,
                     num_objectives=num_objectives, fn_spec=fn_spec,
                     fitness_fn=fitness_fn)
        self.worker_pool = worker_pool
        if worker_pool is not None:
            if getattr(worker_pool, "mq_dir", None) is None:
                worker_pool.mq_dir = self.mq_dir
            worker_pool.start()
        self.autoscaler = autoscaler
        if autoscaler is not None:
            if autoscaler.mq_dir is None:
                autoscaler.mq_dir = getattr(autoscaler.pool, "mq_dir",
                                            None) or self.mq_dir
            autoscaler.start()

    # -- queue paths ----------------------------------------------------
    @property
    def tasks_dir(self) -> str:
        return os.path.join(self.mq_dir, TASKS_DIR)

    @property
    def claimed_dir(self) -> str:
        return os.path.join(self.mq_dir, CLAIMED_DIR)

    @property
    def results_dir(self) -> str:
        return os.path.join(self.mq_dir, RESULTS_DIR)

    # -- transport seam -------------------------------------------------
    # Every broker file op the manager performs lives behind one of
    # these ``_t_*`` methods (plus ``_gc_sweep`` below). The socket
    # transport (``repro_torch.runtime.netbroker.SocketQueueBackend``)
    # overrides exactly this surface with RPCs to a BrokerServer; the
    # chunking / streaming pump / retry / GC logic is shared verbatim,
    # which is what keeps both transports on ONE queue contract.

    def _t_enqueue(self, name: str, chunk: np.ndarray) -> None:
        """Publish one ready task (atomic: a worker claim never sees a
        torn task file)."""
        atomic_savez(os.path.join(self.tasks_dir, name),
                     genomes=np.asarray(chunk, np.float32))

    def _t_result_fetch(self, name: str):
        """``(fitness, duration)`` of a landed result, else None. Only
        the exact result path is read — a crashed publisher's ``*.tmp``
        dropping is a different name and stays invisible."""
        res = mq_result_path(self.mq_dir, name)
        if not os.path.exists(res):
            return None
        with np.load(res) as d:
            return d["fitness"], float(d["duration"])

    def _t_fail_fetch(self, name: str) -> Optional[str]:
        """Traceback text of a failure marker, else None."""
        fp = mq_fail_path(self.mq_dir, name)
        if not os.path.exists(fp):
            return None
        with open(fp) as f:
            return f.read()

    def _t_lease_state(self, name: str):
        """``(claimed, age_s)`` of a task's claim, age on the lease
        AUTHORITY's clock: seconds since the last heartbeat, or None
        when the claim exists but no lease was written yet (the pump
        falls back to its own first-seen wall time). The file
        transport's authority clock is the local one; the socket
        transport computes the age server-side, so manager/worker clock
        skew can never fake a stale lease."""
        claimed = os.path.join(self.claimed_dir, name)
        if not os.path.exists(claimed):
            return False, None
        try:
            return True, time.time() - os.path.getmtime(
                claimed + LEASE_SUFFIX)
        except OSError:
            return True, None                    # claim seen, lease not yet

    def _t_requeue(self, old: str, new: str) -> bool:
        """Atomically move a stale claim back into the ready queue under
        its bumped-delivery name. False means the rename lost — the
        worker just finished, failed, or released it — and the sweep
        should move on."""
        claimed = os.path.join(self.claimed_dir, old)
        try:
            os.rename(claimed, os.path.join(self.tasks_dir, new))
        except OSError:
            return False
        try:
            os.remove(claimed + LEASE_SUFFIX)
        except OSError:
            pass
        return True

    def _t_resolve_fail_fetch(self) -> Optional[str]:
        """This run's fitness-unresolvable marker text, else None."""
        path = resolve_fail_path(self.mq_dir, self.run_id)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    def _t_deregister_run(self) -> None:
        deregister_run(self.mq_dir, self.run_id)

    # -- host-side evaluation ------------------------------------------
    def _host_eval(self, genomes: np.ndarray,
                   perm: Optional[np.ndarray] = None,
                   cost: Optional[np.ndarray] = None) -> np.ndarray:
        with self._cond:
            if self._closed:
                raise RuntimeError("QueueBackend used after close()")
            self._inflight += 1
        try:
            return self._host_eval_inner(genomes, perm, cost)
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def _host_eval_inner(self, genomes: np.ndarray,
                         perm: Optional[np.ndarray],
                         cost: Optional[np.ndarray]) -> np.ndarray:
        from repro_torch.core.broker import ChunkFailure, run_chunks_retry
        genomes = np.asarray(genomes)
        n = genomes.shape[0]
        w = min(self.num_workers, max(1, n))
        order = None
        if cost is not None and self.chunk_sizing == "cost" and w > 1:
            chunks, sizes, order, perm = plan_cost_chunks(
                genomes, perm, cost, w,
                min_chunk_cost=self.min_chunk_cost_s)
        else:
            chunks = np.array_split(genomes, w)
            sizes = [len(c) for c in chunks]
        with self._lock:
            job = self._seq
            self._seq += 1
            self.stats["jobs"] += 1
            self._active_jobs.add(job)
        perm_np = np.asarray(perm) if perm is not None else None
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        tracks = [_ChunkTrack() for _ in chunks]

        def enqueue(i, chunk, attempt, delivery) -> str:
            name = task_name(self.run_id, job, i, attempt, delivery)
            self._t_enqueue(name, chunk)
            return name

        def submit(i, chunk, attempt):
            tr = tracks[i]
            tr.new_attempt(attempt)
            tr.track(enqueue(i, chunk, attempt, 0))
            return attempt

        m = _metrics.get_registry()
        if m.enabled:
            # before the files land: replayed timelines must order the
            # enqueue ahead of the claims it enables
            m.inc("mq_jobs_total", run=self.run_id)
            m.inc("mq_chunks_enqueued_total", float(len(chunks)),
                  run=self.run_id)
            m.event("enqueue", run=self.run_id, job=job,
                    chunks=len(chunks), genomes=int(n))
        # the whole batch hits the queue up front — idle workers start
        # pulling immediately, in cost order (priciest chunks first)
        for i, chunk in enumerate(chunks):
            tracks[i].track(enqueue(i, chunk, 0, 0))

        def stream_result(i, tr, fit, dur):
            tr.done = (np.asarray(fit, np.float32), dur)
            m = _metrics.get_registry()
            if m.enabled:
                m.inc("mq_results_streamed_total", run=self.run_id)
                m.observe("mq_chunk_duration_seconds", dur)
                per = dur / max(1, int(sizes[i]))
                with self._lock:
                    prev = self._cost_per_task
                    self._cost_per_task = per if prev is None \
                        else 0.7 * prev + 0.3 * per
                    cpt = self._cost_per_task
                m.set_gauge("mq_cost_per_task_seconds", cpt,
                            run=self.run_id)
                m.event("result", run=self.run_id, job=job, chunk=i,
                        duration=round(dur, 6))
            if self.cost_ema is not None and perm_np is not None:
                # mid-flight EMA update: this chunk's slots learn NOW,
                # while other chunks of the same batch are still running
                self.cost_ema.observe(perm_np[offs[i]:offs[i + 1]],
                                      [int(sizes[i])], [dur])
                with self._lock:
                    self.stats["streamed"] += 1

        def pump():
            """One streaming sweep over every outstanding chunk: collect
            landed results (feeding the EMA immediately), surface failure
            markers, and re-queue stale leases."""
            if self._step_hook is not None:
                self._step_hook("manager", "pump")
            now_w = time.time()
            for i, tr in enumerate(tracks):
                if tr.done is not None or tr.failed_msg is not None:
                    continue
                for name in tr.all_names:
                    got = self._t_result_fetch(name)
                    if got is None:
                        continue
                    fit, dur = got
                    if fit.shape != (int(sizes[i]), self.num_objectives):
                        tr.failed_msg = (
                            f"result shape {fit.shape} != "
                            f"({int(sizes[i])}, {self.num_objectives})")
                        break
                    tr.done_name = name
                    stream_result(i, tr, fit, dur)
                    break
                if tr.done is not None or tr.failed_msg is not None:
                    continue
                # only the LATEST delivery's failure counts: an older
                # delivery that crashed after being re-queued is already
                # superseded by its replacement
                msg = self._t_fail_fetch(tr.latest)
                if msg is not None:
                    tr.failed_msg = msg
                    continue
                claimed, age = self._t_lease_state(tr.latest)
                if not claimed:
                    continue                     # still queued (or racing)
                if tr.t_exec is None:
                    tr.t_exec = time.monotonic()
                if tr.seen_wall is None:
                    tr.seen_wall = now_w
                if age is None:
                    age = now_w - tr.seen_wall   # claim seen, lease not yet
                if age > self.lease_s:
                    # dead worker: re-queue under a bumped delivery — the
                    # atomic rename means a worker that is merely slow
                    # either keeps the file (rename fails, we retry next
                    # sweep) or has already released it
                    old = tr.latest
                    new = task_name(self.run_id, job, i, tr.attempt,
                                    tr.delivery + 1)
                    if not self._t_requeue(old, new):
                        continue                 # it just finished/failed
                    tr.delivery += 1
                    tr.track(new)
                    with self._lock:
                        self.stats["lease_requeues"] += 1
                    m = _metrics.get_registry()
                    if m.enabled:
                        m.inc("mq_lease_requeues_total", run=self.run_id)
                        m.observe("mq_lease_age_seconds", age)
                        m.event("lease_requeue", run=self.run_id,
                                task=old, requeued_as=new,
                                age_s=round(age, 4))

        def wait(i, token, timeout_s):
            tr = tracks[i]
            while True:
                pump()
                if tr.done is not None:
                    return tr.done
                if tr.failed_msg is not None:
                    raise ChunkFailure(
                        f"chunk {i} worker failed:\n{tr.failed_msg}")
                unresolved = self._t_resolve_fail_fetch()
                if unresolved is not None:
                    # a worker could not resolve THIS run's fitness (bad
                    # import spec / unpicklable callable): the condition
                    # is permanent for the run, so fail fast instead of
                    # waiting on tasks the fleet will never serve
                    raise ChunkFailure(
                        "a worker failed to resolve the fitness "
                        f"(chunk {i} waiting):\n{unresolved}")
                if (timeout_s is not None and tr.t_exec is not None
                        and time.monotonic() - tr.t_exec > timeout_s):
                    with self._lock:
                        self.stats["timeouts"] += 1
                    m = _metrics.get_registry()
                    if m.enabled:
                        m.inc("mq_timeouts_total", run=self.run_id)
                        m.event("timeout", run=self.run_id, job=job,
                                chunk=i, delivery=tr.delivery)
                    raise TimeoutError(
                        f"chunk {i} straggled past {timeout_s}s "
                        f"(delivery {tr.delivery})")
                time.sleep(self.poll_interval_s)

        def on_retry(i, attempt, exc):
            with self._lock:
                self.stats["retries"] += 1
            m = _metrics.get_registry()
            if m.enabled:
                m.inc("mq_retries_total", run=self.run_id)
                m.event("retry", run=self.run_id, job=job, chunk=i,
                        attempt=attempt)

        try:
            outs = run_chunks_retry(chunks, submit, wait,
                                    timeout_s=self.chunk_timeout_s,
                                    max_retries=self.max_retries,
                                    on_retry=on_retry,
                                    initial_tokens=[0] * len(chunks))
        finally:
            self._finish_job(job, tracks)
        # durations were already streamed to the EMA as each chunk landed
        # — pass cost_ema=None so the epilogue doesn't observe them twice
        out = collect_chunk_results(outs, None, None, sizes)
        if order is not None:
            out = scatter_chunk_results(out, order, n)
        return out

    # -- broker-directory garbage collection ---------------------------
    def _finish_job(self, job: int, tracks: List[_ChunkTrack]) -> None:
        """Completed-job epilogue, win or lose: record the job's winning
        result files, evict whole jobs beyond ``keep_jobs``, then sweep.
        The sweep is global over THIS RUN's non-active jobs — so a
        duplicate result from an at-least-once race that lands AFTER its
        own job finished is still collected on the next job's epilogue,
        ``keep_jobs=None`` included (that setting retains winners forever,
        not garbage)."""
        winners = set()
        for tr in tracks:
            if tr.done_name:
                winners.add(result_name(tr.done_name))
        with self._lock:
            self._active_jobs.discard(job)
            self._job_winners[job] = winners
            self._done_jobs.append(job)
            if self.keep_jobs is not None:
                while len(self._done_jobs) > max(0, int(self.keep_jobs)):
                    self._job_winners.pop(self._done_jobs.pop(0), None)
                    self.stats["jobs_pruned"] += 1
            active = set(self._active_jobs)
            keep_by_job = {j: set(w) for j, w in self._job_winners.items()}
        self._gc_sweep(active, keep_by_job)
        m = _metrics.get_registry()
        if m.enabled:
            m.event("job_done", run=self.run_id, job=job)

    def _gc_sweep(self, active: set, keep_by_job: Dict[int, set]) -> None:
        """Run-scoped job sweep — see :func:`gc_sweep` (part of the
        transport seam: the socket backend forwards this to the broker
        server's ``GC_SWEEP`` op instead)."""
        gc_sweep(self.mq_dir, self.run_id, active, keep_by_job)

    def stats_snapshot(self) -> Dict[str, int]:
        """Consistent copy of the counters — every increment in this
        class runs under ``self._lock``, so read under it too."""
        with self._lock:
            return dict(self.stats)

    def close(self, remove_dir: Optional[bool] = None):
        """Drain in-flight evaluations (another thread may still be
        polling the queue), then tear down RUN-SCOPED state: stop the
        autoscaler, deregister this run from the ``runs/`` registry, and
        (unless ``keep_jobs=None``) sweep the run's whole namespace —
        retained winner results included — so a long-lived shared broker
        directory stays bounded across any number of finished runs.
        The fleet-wide STOP sentinel is raised only when this backend owns
        the workers (its own ``worker_pool``, which it stops) or the whole
        directory — closing one run of a SHARED fleet never kills the
        workers other runs still use. ``remove_dir`` deletes the broker
        directory (default: only when the backend created a temp dir
        itself)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            while self._inflight:
                self._cond.wait()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.keep_jobs is not None:
            # a finishing run leaves nothing behind in a shared broker
            # directory: the retained keep_jobs winners existed for this
            # manager alone, and no surviving run's sweep may touch a
            # foreign namespace. keep_jobs=None keeps winners forever by
            # contract — the explicit opt-out of GC — and therefore KEEPS
            # ITS REGISTRATION: deregistering is the protocol's "these
            # files are garbage" signal (worker tombstones and the idle
            # janitor both key on it), so a deregistered run's retained
            # winners would not survive a live fleet
            self._t_deregister_run()
            self._gc_sweep(set(), {})
        self._t_teardown(remove_dir)

    def _t_teardown(self, remove_dir: Optional[bool]) -> None:
        """Transport-specific tail of :meth:`close`: stop owned workers
        (raising the fleet-wide STOP) and reclaim owned broker storage."""
        if self.worker_pool is not None:
            self.worker_pool.stop()              # raises fleet-wide STOP
        elif self._owns_dir:
            try:
                atomic_write_text(os.path.join(self.mq_dir, STOP_NAME),
                             "stop\n")
            except OSError:
                pass
        if remove_dir is None:
            remove_dir = self._owns_dir
        if remove_dir:
            shutil.rmtree(self.mq_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Worker entrypoint:  python -m repro_torch.runtime.mq --worker --mq-dir DIR
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.runtime.mq",
        description="Persistent message-queue worker: claim -> evaluate "
                    "-> report until the broker raises STOP. Multi-tenant:"
                    " serves every registered run, highest priority "
                    "first.")
    ap.add_argument("--worker", action="store_true", required=True,
                    help="run the persistent worker loop")
    ap.add_argument("--mq-dir", required=True,
                    help="broker directory (shared volume)")
    ap.add_argument("--lease-s", type=float, default=15.0,
                    help="lease duration; heartbeats renew at lease/4")
    ap.add_argument("--poll-s", type=float, default=0.05,
                    help="idle queue poll interval")
    ap.add_argument("--max-tasks", type=int, default=None,
                    help="exit after N completed tasks")
    ap.add_argument("--idle-exit-s", type=float, default=None,
                    help="exit after this long with an empty queue")
    ap.add_argument("--hang-substrings", default="",
                    help="comma-separated fault injection: die (leaving a "
                         "stale lease) on tasks whose name matches")
    args = ap.parse_args(argv)
    hang = tuple(s for s in args.hang_substrings.split(",") if s)
    worker_loop(args.mq_dir, lease_s=args.lease_s, poll_s=args.poll_s,
                max_tasks=args.max_tasks, idle_exit_s=args.idle_exit_s,
                hang_substrings=hang)
    return 0


if __name__ == "__main__":
    sys.exit(main())
