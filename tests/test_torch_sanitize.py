"""The thread sanitizer's cost-model and host-pool scenarios with the port's
objects: ``repro.analysis.sanitize.scenarios``' ``costema`` and
``hostpool`` built with ``repro_torch``'s ``CostEMA`` and
``HostPoolBackend`` (registered for the run as
``tests/test_torch_proto_replay.py`` registers its mq-dispatch twin), and
one scenario of the port's own: observations held for a mesh's fold
(``CostEMA.defer``), two threads observing while a third takes and folds
them. Each must come out race-clean, with no observation lost.
"""
import threading

import numpy as np
import pytest

from repro.analysis.sanitize import scenarios as san
from repro.analysis.sanitize.instrument import track_attrs, track_dict
from repro.analysis.sanitize.tsan import format_report
# imported here, not inside a scenario: a first import of torch inside the
# instrumented context would give the interpreter's own locks the tracer's
from repro_torch.core.broker import CostEMA, HostPoolBackend

SLOTS = 8
OBSERVES = 4           # each of the two observer threads


def _observers(ema):
    """Two threads each observing OBSERVES times over all SLOTS slots in
    two chunks of four (``scenarios.costema``'s load)."""
    perm = np.arange(SLOTS)

    def observer(offset):
        for k in range(OBSERVES):
            ema.observe(perm, [4, 4], [1.0 + offset, 2.0 + k])

    return [threading.Thread(target=observer, args=(i,)) for i in range(2)]


def _torch_costema(tracer):
    """``scenarios.costema``: concurrent ``observe`` vs ``snapshot`` on
    the shared slot table."""
    ema = CostEMA(alpha=0.5)
    track_attrs(ema, "CostEMA", tracer, ["updates", "_est"])
    ema.snapshot(SLOTS)
    threads = _observers(ema)
    for t in threads:
        t.start()
    for _ in range(4):
        assert ema.snapshot(SLOTS).shape == (SLOTS,)
    for t in threads:
        t.join()
    assert ema.updates == 2 * OBSERVES, f"lost EMA updates: {ema.updates}"
    return lambda: None


def _torch_hostpool(tracer):
    """``scenarios.hostpool``: two concurrent ``_host_eval`` calls on one
    ``HostPoolBackend``, a flaky first batch driving the retry
    counter."""
    be = HostPoolBackend(san._flaky_fit, num_workers=2,
                         chunk_timeout_s=10.0, max_retries=3)
    be.stats = track_dict(be.stats, "HostPoolBackend.stats", tracer)
    track_attrs(be, "HostPoolBackend", tracer, ["_inflight"])
    san._arm_flaky(2)
    xs = [san._batch(6), san._batch(4)]
    outs = [None, None]

    def caller(i):
        outs[i] = be._host_eval(xs[i])

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        assert outs[i] is not None and np.allclose(
            outs[i], san._expect(xs[i])), f"hostpool result {i} wrong"
    return be.close


def _torch_costema_fold(tracer):
    """The port's own: a deferred table (a broker over several ranks)
    observed by two threads while a third takes the held observations
    and folds them; every observation is folded exactly once."""
    ema = CostEMA(alpha=0.5)
    ema.defer()
    track_attrs(ema, "CostEMA", tracer, ["updates", "_est", "_pending"])
    ema.snapshot(SLOTS)
    taken = []

    def folder():
        for _ in range(2 * OBSERVES):
            rows = ema.take()
            taken.append(len(rows))
            ema.fold([rows])

    threads = _observers(ema) + [threading.Thread(target=folder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = ema.take()                     # whatever landed after the last
    taken.append(len(rows))
    ema.fold([rows])
    assert sum(taken) == 2 * OBSERVES * SLOTS, f"rows lost: {taken}"
    assert ema.updates == 2 * OBSERVES, f"lost EMA updates: {ema.updates}"
    assert len(ema.take()) == 0
    return lambda: None


SCENARIOS = {
    "torch-costema": san.Scenario(_torch_costema, True,
                                  "port observe vs snapshot"),
    "torch-hostpool": san.Scenario(_torch_hostpool, False,
                                   "port pipelined evals on the pool"),
    "torch-costema-fold": san.Scenario(_torch_costema_fold, True,
                                       "port observe vs the mesh fold"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_scenario_race_clean(monkeypatch, name):
    monkeypatch.setitem(san.SCENARIOS, name, SCENARIOS[name])
    r = san.run_scenario(name, seed=0, wall_s=45.0)
    assert r.error is None, r.error
    assert r.races == [], format_report(r.races)
    assert r.events > 0
