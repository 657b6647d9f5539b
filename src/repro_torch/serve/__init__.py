"""Serving: the ``AllocationService``, the sharded fabric and batching."""
from repro_torch.serve.batching import batch_bucket, node_bucket, pad_to
from repro_torch.serve.service import (AllocationService, ReplicaState,
                                       ShardedAllocationService)

__all__ = ["AllocationService", "ReplicaState", "ShardedAllocationService",
           "batch_bucket", "node_bucket", "pad_to"]
