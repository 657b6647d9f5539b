"""``Allocator``: the one user-facing object over the serving stack.

``Allocator.from_config(AllocatorConfig(...), device=...)`` builds, from one
declarative config, the training pipeline (``TasqPipeline``), the requested
model family via the ``build_model`` registry, the allocation policy via the
symmetric ``build_policy`` registry, and the ``AllocationService``; then
``decide()`` takes an ``AllocationRequest`` (+ optional ``DecisionContext``)
and returns an ``AllocationDecision``.

The reference routes ``decide`` through its ``AllocationFrontend`` (micro-
batcher + sharded fabric); this port's ``decide`` calls the single-replica
service directly. The sharded fabric (``n_shards > 1``), the router, the
frontend's queued serving, AOT warmup, model hot-swap, the cluster replay
and the observability plane are later slices of the port (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext)
from repro_torch.core.allocator import AllocationPolicy, build_policy
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.device import resolve_device
from repro_torch.serve.service import AllocationService

__all__ = ["Allocator", "AllocatorConfig"]

_FABRIC_LATER = ("the sharded serving fabric (n_shards > 1, "
                 "DecisionContext.shard_of) is a later slice of the port")


@dataclasses.dataclass(frozen=True)
class AllocatorConfig:
    """Declarative recipe for the serving stack.

    ``family``/``loss`` name the model through the ``build_model`` registry;
    ``policy`` (+ ``policy_overrides``) names the allocation policy through
    ``build_policy``.
    """
    family: str = "nn"                 # build_model registry key
    loss: str = "lf2"                  # lf1 | lf2 | lf3 (parameter heads)
    policy: str = "bounded_slowdown"   # build_policy registry key
    policy_overrides: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    n_shards: int = 1                  # replicas in the serving fabric
    pipeline: TasqConfig = TasqConfig()


class Allocator:
    """Facade over the trained pipeline and the allocation service."""

    def __init__(self, service: AllocationService, *,
                 pipeline: Optional[TasqPipeline] = None,
                 config: Optional[AllocatorConfig] = None):
        self.service = service
        self.pipeline = pipeline
        self.config = config

    @classmethod
    def from_config(cls, config: AllocatorConfig = AllocatorConfig(),
                    device: Union[str, torch.device, None] = None
                    ) -> "Allocator":
        """Build the stack: pipeline -> model (registry) -> policy
        (registry) -> service, all on ``device`` (default ``"cuda"``)."""
        dev = resolve_device(device)
        if config.n_shards != 1:
            raise NotImplementedError(_FABRIC_LATER)
        policy = build_policy(config.policy, **config.policy_overrides)
        pipeline = TasqPipeline(config.pipeline, device=dev).build()
        model = pipeline.train(config.family, loss=config.loss)
        service = AllocationService(model, policy, device=dev)
        return cls(service, pipeline=pipeline, config=config)

    @property
    def model(self):
        return self.service.model

    @property
    def policy(self) -> AllocationPolicy:
        return self.service.policy

    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """One typed entry point for every allocation decision."""
        if context is not None and context.shard_of is not None:
            raise NotImplementedError(_FABRIC_LATER)
        return self.service.decide(request, context)
