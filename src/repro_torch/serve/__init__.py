"""Serving: the single-replica ``AllocationService`` and its batching."""
from repro_torch.serve.batching import batch_bucket, pad_to
from repro_torch.serve.service import AllocationService

__all__ = ["AllocationService", "batch_bucket", "pad_to"]
