"""Serving layer: batched PCC allocation decisions through pre-built
executables.

``AllocationService`` turns any registered ``PCCModel`` into an online
allocator behind the typed protocol (``repro_torch.api``):
``decide(AllocationRequest, DecisionContext) -> AllocationDecision`` runs
features -> scaled params -> decode -> allocation policy in one executable
call per (model, batch bucket) — a CUDA graph on the card — with
priced/unpriced, sharded/unsharded and observed/unobserved selected by
context fields. ``MicroBatcher`` queues single-job requests and drains them
through ``decide`` in padded batches. ``ShardedAllocationService`` serves
N replicas of one model behind the same protocol — shard-tagged rows are
stacked into (K, Bp) blocks and decided in one call — with
``ReplicaState`` keeping per-replica counters observable.

The streaming serving plane (``serve/plane.py``, ``serve/aot.py``) puts
this behind a continuously-warm hot path: ``warm_allocation_stack`` builds
the whole executable grid at startup (no builds under traffic), and
``ServingPlane`` drains a bounded ``Backlog`` of arrival events through
worker-owned micro-batchers with backpressure.
"""
from repro_torch.api.types import (
    AllocationDecision,
    AllocationRequest,
    DecisionContext,
    Provenance,
)
from repro_torch.serve.aot import (
    WarmupConfig,
    WarmupReport,
    warm_allocation_stack,
    warm_fabric,
    warm_service,
)
from repro_torch.serve.batching import (
    MicroBatcher,
    batch_bucket,
    node_bucket,
    pad_to,
    shard_positions,
)
from repro_torch.serve.plane import Backlog, ServingPlane
from repro_torch.serve.service import (
    AllocationService,
    ReplicaState,
    ShardedAllocationService,
)

__all__ = [
    "AllocationDecision",
    "AllocationRequest",
    "AllocationService",
    "Backlog",
    "DecisionContext",
    "MicroBatcher",
    "Provenance",
    "ReplicaState",
    "ServingPlane",
    "ShardedAllocationService",
    "WarmupConfig",
    "WarmupReport",
    "batch_bucket",
    "node_bucket",
    "pad_to",
    "shard_positions",
    "warm_allocation_stack",
    "warm_fabric",
    "warm_service",
]
