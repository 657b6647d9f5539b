"""``repro_torch.api`` — the typed allocation protocol and its facade.

    from repro_torch.api import Allocator, AllocatorConfig, AllocationRequest
    allocator = Allocator.from_config(AllocatorConfig(family="nn"))
    decision = allocator.decide(AllocationRequest(model_in=...,
                                                  observed_tokens=...))

The protocol types import light (numpy only); the ``Allocator`` facade,
which pulls the pipeline, serve, cluster and launch stack, loads on first
attribute access, so the layers that import the types or the deprecation
helpers (``_compat``) never cycle back through the facade.
"""
from repro_torch.api._compat import reset_deprecation_warnings, warn_deprecated
from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext, Provenance)

__all__ = [
    "AllocationDecision",
    "AllocationRequest",
    "Allocator",
    "AllocatorConfig",
    "DecisionContext",
    "Provenance",
    "reset_deprecation_warnings",
    "warn_deprecated",
]


def __getattr__(name: str):
    if name in ("Allocator", "AllocatorConfig"):
        from repro_torch.api import allocator as _allocator
        return getattr(_allocator, name)
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
