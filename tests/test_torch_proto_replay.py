"""The reference's replay corpus against the PORT's queue runtime, on both
transports.

The model checker (``repro.analysis.proto``) explores the broker contract
over an abstraction; ``tests/test_proto_replay.py`` drives its worst
interleavings through the reference's real ``runtime/mq.py``
thread-by-thread with a step barrier. This file replays the same
schedules against ``repro_torch.runtime.mq`` and
``repro_torch.runtime.netbroker``: the manager is the port's
``QueueBackend`` / ``SocketQueueBackend`` (``step_hook`` seam), the file
transport's worker steps are the port's protocol functions, and the
socket transport's go through the port's ``BrokerClient`` (duck-typed into
``Replayer(client=...)``) to the port's ``BrokerServer``.

``Replayer`` imports ``repro.runtime.mq`` inside its methods; the
``port_mq`` fixture points that name at the port's module for each test,
and nothing in ``analysis/`` changes. One thread-sanitizer scenario (the
reference's ``mq-dispatch``, built from the port's ``QueueBackend``,
``LocalWorkerPool`` and ``CostEMA``) runs the same way and must be
race-clean.
"""
import os
import threading

import numpy as np
import pytest

import repro.runtime
from repro.analysis.proto import schedules as sched
from repro.analysis.proto.explorer import explore
from repro.analysis.proto.replay import Replayer, StepGate, to_replay_steps
from repro.analysis.proto.spec import SpecConfig
from repro.analysis.sanitize import scenarios as san
from repro.analysis.sanitize.instrument import track_attrs, track_dict, \
    track_list
from repro.analysis.sanitize.tsan import format_report
from repro_torch.fitness import hostsim
from repro_torch.runtime import mq as port_mq_module
from repro_torch.runtime.mq import (CLAIMED_DIR, RESULTS_DIR, TASKS_DIR,
                                    QueueBackend, result_name)
from repro_torch.runtime.netbroker import (BrokerClient, BrokerServer,
                                           SocketQueueBackend)

SPEC = "repro_torch.fitness.hostsim:sphere"

TRANSPORTS = ("file", "net")


@pytest.fixture(autouse=True)
def port_mq(monkeypatch):
    """Route the replayer's ``from repro.runtime import mq`` to the
    port's module for the test's duration."""
    monkeypatch.setattr(repro.runtime, "mq", port_mq_module, raising=False)
    from repro.runtime import mq
    assert mq is port_mq_module
    return port_mq_module


def _ra_files(mq_dir):
    out = []
    for d in (TASKS_DIR, CLAIMED_DIR, RESULTS_DIR):
        out += [f"{d}/{n}" for n in os.listdir(os.path.join(mq_dir, d))
                if n.startswith("ra_")]
    return sorted(out)


class _Run:
    """One gated manager evaluation: backend + manager thread + replayer.

    ``lease_s=60`` means a lease can only go stale through the
    schedule's explicit ``env.expire`` backdating — wall-clock time
    cannot perturb the interleaving, which is what makes replay
    deterministic. ``transport="net"`` swaps in a ``BrokerServer`` +
    ``SocketQueueBackend`` and reroutes every replay step through RPC
    frames; the assertions stay byte-for-byte the same."""

    def __init__(self, tmp_path, transport="file", n=4, num_workers=2,
                 **kw):
        self.gate = StepGate()
        self.transport = transport
        kw.setdefault("keep_jobs", 4)
        common = dict(fn_spec=SPEC, num_workers=num_workers, run_id="a",
                      lease_s=60.0, chunk_timeout_s=None, max_retries=0,
                      poll_interval_s=0.005, step_hook=self.gate.step)
        if transport == "file":
            self.mq_dir = str(tmp_path)
            self.server = self.probe = None
            self.qb = QueueBackend(mq_dir=self.mq_dir, **common, **kw)
            self.replayer = Replayer(self.mq_dir, hostsim.sphere,
                                     lease_s=60.0)
        else:
            self.server = BrokerServer().start()
            self.mq_dir = None
            self.qb = SocketQueueBackend(server=self.server, **common,
                                         **kw)
            self.probe = BrokerClient(self.server.addr)
            self.replayer = Replayer(None, hostsim.sphere, lease_s=60.0,
                                     client=self.probe)
        self.g = np.random.default_rng(0).uniform(
            -1, 1, (n, 3)).astype(np.float32)
        self.out = {}

        def manager():
            try:
                self.out["fit"] = self.qb._host_eval(self.g)
            except Exception as exc:          # surfaced by the test body
                self.out["exc"] = exc
            finally:
                self.gate.finish()

        self.thread = threading.Thread(target=manager, daemon=True)
        self.thread.start()

    def ra_files(self):
        """This run's files across the queue dirs — via listdir on the
        file broker, via the LIST debug op on the socket broker."""
        if self.transport == "file":
            return _ra_files(self.mq_dir)
        listing = self.probe.listdir()
        return sorted(f"{d}/{n}" for d in ("tasks", "claimed", "results")
                      for n in listing[d] if n.startswith("ra_"))

    def result_exists(self, task):
        return f"results/{result_name(task)}" in self.ra_files()

    def replay(self, steps):
        self.replayer.run(self.gate, steps)

    def finish(self):
        """Free-run the manager to completion and return its fitness."""
        self.gate.open()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive(), "manager never finished"
        if "exc" in self.out:
            raise self.out["exc"]
        return self.out["fit"]

    def shutdown(self):
        self.gate.open()
        self.qb.close()                       # idempotent
        if self.probe is not None:
            self.probe.close()
        if self.server is not None:
            self.server.stop()


@pytest.fixture(params=TRANSPORTS)
def make_run(request, tmp_path):
    runs = []

    def factory(n=4, num_workers=2, **kw):
        run = _Run(tmp_path, transport=request.param, n=n,
                   num_workers=num_workers, **kw)
        runs.append(run)
        return run

    yield factory
    for run in runs:
        run.shutdown()


def test_stale_lease_requeue_first_result_wins(make_run):
    """Delivery 1 answers a re-queued chunk; the superseded delivery 0
    then lands a CONFLICTING value. First-result-wins: the accepted
    fitness is delivery 1's, and the conflict is swept with the job."""
    run = make_run()
    run.replay(sched.stale_lease_requeue_conflicting_late_publish())
    fit = run.finish()
    assert np.array_equal(fit, hostsim.sphere(run.g))
    assert not np.any(fit >= 1e8), "conflicting superseded result accepted"
    assert run.qb.stats["lease_requeues"] == 1
    assert run.qb.stats["retries"] == 0, \
        "a lease re-queue burned the retry budget"
    run.qb.close()
    assert run.ra_files() == []


def test_crash_after_publish_result_accepted_orphan_reaped(make_run):
    """A worker killed between publish and release: the chunk is not
    lost (its published result is accepted) and the job epilogue GC
    reaps the dead worker's orphan claim + lease."""
    run = make_run()
    run.replay(sched.crash_after_publish_orphan_claim())
    fit = run.finish()
    assert np.array_equal(fit, hostsim.sphere(run.g))
    # the orphan claim/lease of job 0 are gone (non-active job sweep)
    assert not [p for p in run.ra_files() if p.startswith("claimed/")]
    run.qb.close()
    assert run.ra_files() == []


def test_torn_publish_never_read_and_janitor_reaps(make_run):
    """A publisher killed mid-atomic-write leaves only the torn ``*.tmp``
    sibling: the manager must never read it (delivery 1 answers the
    chunk instead) and the janitor reaps the aged dropping."""
    run = make_run()
    run.replay(sched.torn_publish_invisible_then_reaped())
    fit = run.finish()
    assert np.array_equal(fit, hostsim.sphere(run.g))
    assert run.qb.stats["lease_requeues"] == 1
    run.qb.close()
    leftovers = run.ra_files()
    assert not [p for p in leftovers if p.endswith(".tmp")], leftovers
    assert leftovers == []


def test_late_publish_after_close_tombstone_prevents_leak(make_run):
    """THE model-checker counterexample (no_tombstone variant): a
    superseded delivery publishes after ``close()`` already swept the
    run's namespace. Without ``clean_if_run_closed`` the result leaks
    forever in a shared broker dir; the tombstone removes it."""
    run = make_run()
    run.replay(sched.late_publish_after_close_prefix())
    fit = run.finish()
    assert np.array_equal(fit, hostsim.sphere(run.g))
    run.qb.close()
    assert run.ra_files() == []                  # close swept everything
    # ...and only now does the slow worker land its superseded result
    suffix = sched.late_publish_after_close_suffix()
    run.replayer.worker_step(*suffix[0])         # w0.publish
    assert run.result_exists(sched.tname(0)), \
        "setup: the late publish must land"
    for step in suffix[1:]:                      # w0.release, w0.tombstone
        run.replayer.worker_step(*step)
    assert run.ra_files() == [], \
        "late publish after close leaked past the tombstone"


def test_explorer_counterexample_translates_and_replays(make_run):
    """Close the loop LIVE: run the explorer on the pre-fix protocol
    (``no_tombstone``), translate its minimal counterexample schedule
    with ``to_replay_steps``, and replay it against the real (fixed)
    mq — the real protocol must survive the exact interleaving that
    broke the unfixed model."""
    cfg = SpecConfig(chunks=1, max_crashes=0, variant="no_tombstone")
    result = explore(cfg, max_depth=60, max_states=200_000)
    assert not result.ok, "seeded-bad variant must produce a counterexample"
    assert "leak" in result.violation
    labels = result.schedule
    # split the trace at the close: the gated prefix replays against the
    # live manager, the suffix is the post-close leak
    cut = labels.index("m.close_dereg")
    prefix = to_replay_steps(labels[:cut])
    suffix = to_replay_steps(labels[cut:])
    assert prefix and suffix, (prefix, suffix)
    run = make_run(n=4, num_workers=1)           # 1 chunk, like the model
    run.replay(prefix)
    fit = run.finish()
    assert np.array_equal(fit, hostsim.sphere(run.g))
    run.qb.close()
    for step in suffix:
        if step[0] == "manager":
            continue                             # manager is closed
        if step[0] == "env":
            run.replayer.env_step(step[1], step[2] if len(step) > 2
                                  else None)
        else:
            run.replayer.worker_step(*step)
    assert run.ra_files() == [], \
        "the explorer's leak schedule leaked against the real mq"


# ---------------------------------------------------------------------------
# thread sanitizer: the reference's mq-dispatch scenario on the port
# ---------------------------------------------------------------------------

def _torch_mq_dispatch(tracer):
    """``scenarios.mq_dispatch`` with the port's objects: manager + 2
    worker threads + streaming CostEMA, pump steered through the
    step_hook seam."""
    import shutil
    import tempfile

    from repro_torch.core.broker import CostEMA
    from repro_torch.runtime.mq import LocalWorkerPool

    mq_dir = tempfile.mkdtemp(prefix="san-torch-mq-")
    ema = CostEMA(alpha=0.5)
    track_attrs(ema, "CostEMA", tracer, ["updates"])
    pool = LocalWorkerPool(2, "thread", mq_dir=mq_dir, fn=san._fit,
                           lease_s=30.0, poll_s=0.001)
    be = QueueBackend(san._fit, num_workers=2, mq_dir=mq_dir, keep_jobs=0,
                      poll_interval_s=0.001, lease_s=30.0,
                      chunk_timeout_s=None, max_retries=0, cost_ema=ema,
                      worker_pool=pool, step_hook=tracer.step_hook)
    be.stats = track_dict(be.stats, "QueueBackend.stats", tracer)
    pool._members = track_list(pool._members, "LocalWorkerPool._members",
                               tracer)
    x = san._batch(8)
    ema.snapshot(8)                      # key the slot table
    out = be._host_eval(x, np.arange(8), np.ones(8, np.float32))
    assert np.array_equal(out, san._expect(x)), "mq dispatch result wrong"
    assert ema.updates > 0

    def cleanup():
        be.close()
        shutil.rmtree(mq_dir, ignore_errors=True)
    return cleanup


def test_sanitizer_mq_dispatch_race_clean(monkeypatch):
    monkeypatch.setitem(san.SCENARIOS, "torch-mq-dispatch",
                        san.Scenario(_torch_mq_dispatch, True,
                                     "port queue dispatch + CostEMA"))
    r = san.run_scenario("torch-mq-dispatch", seed=0, wall_s=45.0)
    assert r.error is None, r.error
    assert r.races == [], format_report(r.races)
    assert r.events > 0 and r.yields > 0
