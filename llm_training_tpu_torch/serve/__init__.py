"""Serving: continuous batching over a paged KV pool, and the router.

Counterpart of `llm_training_tpu/serve/`: the block pool and its
allocator (`paged_cache.py`), the request scheduler with deadlines and
load shedding (`scheduler.py`), the request journal (`journal.py`), the
continuous-batching engine over K4 (`engine.py`), and the health-aware
router over N `serve` replicas (`router.py`, the `route` command). The
engine loads on first access, as JAX's does, so the router and the
journal import without the model's modules.
"""

from llm_training_tpu_torch.serve.journal import RequestJournal, replay_journal
from llm_training_tpu_torch.serve.paged_cache import BlockAllocator, init_paged_pool
from llm_training_tpu_torch.serve.router import (
    ReplicaHandle,
    RoutedRequest,
    Router,
    fold_replica_journals,
    namespaced_id,
)
from llm_training_tpu_torch.serve.scheduler import (
    Scheduler,
    SchedulerConfig,
    ServeRequest,
)

__all__ = [
    "BlockAllocator",
    "ReplicaHandle",
    "RequestJournal",
    "RoutedRequest",
    "Router",
    "Scheduler",
    "SchedulerConfig",
    "ServeConfig",
    "ServeRequest",
    "ServingEngine",
    "fold_replica_journals",
    "init_paged_pool",
    "namespaced_id",
    "replay_journal",
]

_LAZY = {
    "ServeConfig": "llm_training_tpu_torch.serve.engine",
    "ServingEngine": "llm_training_tpu_torch.serve.engine",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
