"""``repro_torch.api`` — the typed allocation protocol and its facade.

    from repro_torch.api import Allocator, AllocatorConfig, AllocationRequest
    allocator = Allocator.from_config(AllocatorConfig(family="nn"))
    decision = allocator.decide(AllocationRequest(model_in=...,
                                                  observed_tokens=...))
"""
from repro_torch.api.allocator import Allocator, AllocatorConfig
from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext, Provenance)

__all__ = [
    "AllocationDecision",
    "AllocationRequest",
    "Allocator",
    "AllocatorConfig",
    "DecisionContext",
    "Provenance",
]
