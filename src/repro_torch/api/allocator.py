"""``Allocator``: the one user-facing object over the serving stack.

``Allocator.from_config(AllocatorConfig(...), device=...)`` builds, from one
declarative config, the training pipeline (``TasqPipeline``), the requested
model family via the ``build_model`` registry, the allocation policy via the
symmetric ``build_policy`` registry, the ``AllocationService``, the K-shard
``ShardedAllocationService`` fabric and the consistent-hash ``Router``.
``decide()`` takes an ``AllocationRequest`` (+ optional ``DecisionContext``)
and returns an ``AllocationDecision``: through the fabric when the context
carries ``shard_of``, through the single-replica service otherwise.
``run_cluster`` replays a trace through the cluster simulator over this
allocator's fabric.

The reference's micro-batching frontend (``submit``/``step``/``run``), its
AOT warmup, ``run_streaming``, model hot-swap and the MLOps loop belong to
the serving-plane slice of the port (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext)
from repro_torch.core.allocator import AllocationPolicy, build_policy
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.device import resolve_device
from repro_torch.obs import Obs

__all__ = ["Allocator", "AllocatorConfig"]


@dataclasses.dataclass(frozen=True)
class AllocatorConfig:
    """Declarative recipe for the serving stack.

    ``family``/``loss`` name the model through the ``build_model`` registry;
    ``policy`` (+ ``policy_overrides``) names the allocation policy through
    ``build_policy``; the sharding/router fields size the fabric.
    """
    family: str = "nn"                 # build_model registry key
    loss: str = "lf2"                  # lf1 | lf2 | lf3 (parameter heads)
    policy: str = "bounded_slowdown"   # build_policy registry key
    policy_overrides: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    n_shards: int = 1                  # replicas in the serving fabric
    load_factor: float = 1.25          # router bounded-load factor
    router_vnodes: int = 64
    router_seed: int = 0
    pipeline: TasqConfig = TasqConfig()


class Allocator:
    """Facade over service + fabric + router.

    Build it from a config (trains the model) or wrap an already-trained
    service (``Allocator(service, n_shards=...)``).
    """

    def __init__(self, service, *, n_shards: int = 1,
                 load_factor: float = 1.25, router_vnodes: int = 64,
                 router_seed: int = 0,
                 pipeline: Optional[TasqPipeline] = None,
                 config: Optional[AllocatorConfig] = None,
                 obs: Optional[Obs] = None):
        # serve and cluster import api.types: import them here, not at the
        # top
        from repro_torch.cluster.router import Router
        from repro_torch.serve.service import ShardedAllocationService
        # one Obs bundle end to end: an explicit one is installed on the
        # service, so fabric, router and simulator observe into one place
        if obs is not None:
            service.obs = obs
        self.obs = service.obs
        self.service = service
        self.n_shards = int(n_shards)
        self.fabric = ShardedAllocationService(service, self.n_shards)
        self.router = Router(self.n_shards, n_vnodes=router_vnodes,
                             load_factor=load_factor, seed=router_seed,
                             obs=self.obs)
        self.pipeline = pipeline
        self.config = config

    @classmethod
    def from_config(cls, config: AllocatorConfig = AllocatorConfig(),
                    device: Union[str, torch.device, None] = None,
                    obs: Optional[Obs] = None) -> "Allocator":
        """Build the stack: pipeline -> model (registry) -> policy
        (registry) -> service -> fabric + router, all on ``device``
        (default ``"cuda"``)."""
        from repro_torch.serve.service import AllocationService
        dev = resolve_device(device)
        policy = build_policy(config.policy, **config.policy_overrides)
        pipeline = TasqPipeline(config.pipeline, device=dev).build()
        model = pipeline.train(config.family, loss=config.loss)
        service = AllocationService(model, policy, device=dev)
        return cls(service, n_shards=config.n_shards,
                   load_factor=config.load_factor,
                   router_vnodes=config.router_vnodes,
                   router_seed=config.router_seed, pipeline=pipeline,
                   config=config, obs=obs)

    @property
    def model(self):
        return self.service.model

    @property
    def policy(self) -> AllocationPolicy:
        return self.service.policy

    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """One typed entry point for every allocation decision: shard
        placement goes to the fabric, everything else to the service."""
        if context is not None and context.shard_of is not None:
            return self.fabric.decide(request, context)
        return self.service.decide(request, context)

    def place(self, template_id: np.ndarray) -> np.ndarray:
        """Home shard rank per template (consistent hashing) — ready to use
        as ``DecisionContext.shard_of``. Load-aware spill routing lives on
        ``self.router.route``."""
        return self.router.rank(self.router.home(np.asarray(template_id)))

    def run_cluster(self, trace, cluster_cfg=None, *,
                    admission: Optional[str] = None,
                    elastic: Optional[bool] = None,
                    pricing: Optional[str] = None,
                    n_shards: Optional[int] = None,
                    load_factor: Optional[float] = None,
                    mlops=None):
        """Replay a ``repro_torch.workloads.Trace`` through this
        allocator's service inside the cluster simulator
        (``repro_torch.cluster``) on the service's device.

        ``admission`` / ``elastic`` / ``pricing`` / ``n_shards`` /
        ``load_factor`` override the corresponding ``ClusterConfig`` fields.
        An explicit ``cluster_cfg`` is authoritative (its ``n_shards`` is
        honored as written); only when no config is passed does
        ``n_shards`` default to the allocator's own shard count."""
        from repro_torch.cluster import ClusterConfig, ClusterSimulator
        cfg = cluster_cfg or ClusterConfig()
        if n_shards is None and cluster_cfg is None:
            n_shards = self.n_shards
        overrides = {k: v for k, v in (("admission", admission),
                                       ("elastic", elastic),
                                       ("pricing", pricing),
                                       ("n_shards", n_shards),
                                       ("load_factor", load_factor))
                     if v is not None}
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        sim = ClusterSimulator(self.service, cfg, fabric=self.fabric,
                               obs=self.obs)
        return sim.run(trace, mlops=mlops)
