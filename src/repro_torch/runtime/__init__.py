"""Runtime resilience and dispatch, ported from the reference's ``runtime``
package: straggler mitigation (``straggler``: speculative backup
evaluation), elasticity (``elastic``: repartition onto a resized fleet),
batch-scheduled (SLURM / Kubernetes array) dispatch and the
persistent-worker message queue.

Exports resolve lazily (PEP 562): the batch-queue worker entrypoint
(``python -m repro_torch.runtime.batchq --worker …``) imports this package on
startup, and eager re-exports would drag torch into every array task —
interpreter startup is on the critical path at cluster scale.
"""
import importlib

_EXPORTS = {
    "repartition_islands": "repro_torch.runtime.elastic",
    "backup_dispatch_eval": "repro_torch.runtime.straggler",
    "SlurmArrayBackend": "repro_torch.runtime.batchq",
    "SlurmScheduler": "repro_torch.runtime.batchq",
    "LocalMockScheduler": "repro_torch.runtime.batchq",
    "Scheduler": "repro_torch.runtime.batchq",
    "QueueBackend": "repro_torch.runtime.mq",
    "LocalWorkerPool": "repro_torch.runtime.mq",
    "MQWorkerFleet": "repro_torch.runtime.mq",
    "FleetAutoscaler": "repro_torch.runtime.mq",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
