"""``Allocator``: the one user-facing object over the serving stack.

``Allocator.from_config(AllocatorConfig(...), device=...)`` builds, from one
declarative config, the training pipeline (``TasqPipeline``), the requested
model family via the ``build_model`` registry, the allocation policy via the
symmetric ``build_policy`` registry, the ``AllocationService``, the K-shard
``ShardedAllocationService`` fabric (through ``AllocationFrontend``, on the
``("shard",)`` mesh of ``launch.mesh.make_allocation_mesh`` when the
default process group holds one rank a shard) and the consistent-hash
``Router``.

Everything then flows through the typed protocol: ``decide()`` takes an
``AllocationRequest`` (+ optional ``DecisionContext``) and returns an
``AllocationDecision`` — through the fabric when the context carries
``shard_of``, through the single-replica service otherwise. ``submit`` /
``step`` / ``run`` micro-batch single-query requests; ``run_cluster`` and
``run_streaming`` replay a trace through the cluster simulator over this
allocator's fabric; ``warmup`` builds the executable grid before traffic
(CUDA graphs on the card, ``repro_torch.serve.aot``); ``swap_model`` hot-
swaps a retrained model in behind a warmed grid (the deploy half of the
MLOps loop, ``repro_torch.mlops``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Union

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
    max_batch: int = 256               # micro-batcher flush size
    load_factor: float = 1.25          # router bounded-load factor
    router_vnodes: int = 64
    router_seed: int = 0
    pipeline: TasqConfig = TasqConfig()
    # AOT serving plane: build the whole (bucket, priced, observed)
    # executable grid at build time so the hot path never builds (see
    # repro_torch.serve.aot). A warmup trace (from_config(...,
    # warmup_trace=...)) additionally pins the fused model executables for
    # that trace's featurized shapes.
    aot_warmup: bool = False


class Allocator:
    """Facade over service + fabric + router + frontend.

    Build it from a config (trains the model) or wrap an already-trained
    service (``Allocator(service, n_shards=...)``). ``decide`` dispatches on
    the context: ``shard_of`` set routes through the fabric, otherwise the
    single-replica service decides. ``mesh`` (a ``("shard",)`` mesh of
    ``n_shards`` ranks; by default ``make_allocation_mesh(n_shards)``, None
    without such a group) puts one shard on each rank, as the reference
    puts one on each device; ``self.mesh`` is the one in use.
    """

    def __init__(self, service, *, n_shards: int = 1, max_batch: int = 256,
                 mesh=None, load_factor: float = 1.25,
                 router_vnodes: int = 64, router_seed: int = 0,
                 pipeline: Optional[TasqPipeline] = None,
                 config: Optional[AllocatorConfig] = None,
                 obs: Optional[Obs] = None):
        # serve, cluster and launch import api.types: import them here,
        # not at the top
        from repro_torch.cluster.router import Router
        from repro_torch.launch.serve import AllocationFrontend
        # the frontend installs the bundle on the service, so fabric,
        # batcher, router and simulator all observe into the same place
        self.frontend = AllocationFrontend(service, max_batch=max_batch,
                                           n_shards=n_shards, mesh=mesh,
                                           obs=obs)
        self.obs = self.frontend.obs
        self.service = service
        self.fabric = self.frontend.fabric
        self.mesh = self.frontend.mesh
        self.n_shards = int(n_shards)
        self.router = Router(self.n_shards, n_vnodes=router_vnodes,
                             load_factor=load_factor, seed=router_seed,
                             obs=self.obs)
        self.pipeline = pipeline
        self.config = config
        self.warmup_report = None        # set by warmup()
        # model hot-swap state: the serving model's version (0 = the
        # from_config model; each swap_model bumps it) and the lock that
        # makes the repoint atomic against concurrent decide()/swap calls
        self.model_version = 0
        self.swap_reports: list = []
        self._swap_lock = threading.Lock()

    @classmethod
    def from_config(cls, config: AllocatorConfig = AllocatorConfig(),
                    device: Union[str, torch.device, None] = None,
                    obs: Optional[Obs] = None, warmup_trace=None,
                    warmup_config=None) -> "Allocator":
        """Build the stack: pipeline -> model (registry) -> policy
        (registry) -> service -> mesh + fabric + router, all on ``device``
        (default ``"cuda"``).

        With ``config.aot_warmup`` (or an explicit ``warmup_trace`` /
        ``warmup_config``), the executable grid is built before the
        allocator is returned: first-request latency is steady-state
        latency, and a replay of ``warmup_trace`` builds nothing
        (``stats["compiles"] == 0``)."""
        from repro_torch.serve.service import AllocationService
        dev = resolve_device(device)
        policy = build_policy(config.policy, **config.policy_overrides)
        pipeline = TasqPipeline(config.pipeline, device=dev).build()
        model = pipeline.train(config.family, loss=config.loss)
        service = AllocationService(model, policy, device=dev)
        alloc = cls(service, n_shards=config.n_shards,
                    max_batch=config.max_batch,
                    load_factor=config.load_factor,
                    router_vnodes=config.router_vnodes,
                    router_seed=config.router_seed, pipeline=pipeline,
                    config=config, obs=obs)
        if config.aot_warmup or warmup_trace is not None \
                or warmup_config is not None:
            alloc.warmup(trace=warmup_trace, config=warmup_config)
        return alloc

    # ------------------------------------------------------------- surface --
    @property
    def model(self):
        return self.service.model

    @property
    def policy(self) -> AllocationPolicy:
        return self.service.policy

    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """One typed entry point for every allocation decision (the
        frontend dispatches: shard placement -> fabric, else service)."""
        return self.frontend.decide(request, context)

    def place(self, template_id: np.ndarray) -> np.ndarray:
        """Home shard rank per template (consistent hashing) — ready to use
        as ``DecisionContext.shard_of``. Load-aware spill routing lives on
        ``self.router.route``."""
        return self.router.rank(self.router.home(np.asarray(template_id)))

    # ------------------------------------------------------ queued serving --
    def submit(self, request_id: int, model_in: Dict[str, np.ndarray],
               observed_tokens: Optional[int] = None) -> None:
        self.frontend.submit(request_id, model_in, observed_tokens)

    def step(self) -> Dict[int, int]:
        return self.frontend.step()

    def run(self, requests: Sequence[AllocationRequest]) -> Dict[int, int]:
        return self.frontend.run(requests)

    def run_cluster(self, trace, cluster_cfg=None, **overrides):
        """Replay a trace through the cluster simulator over this
        allocator's fabric (see ``AllocationFrontend.run_cluster``)."""
        return self.frontend.run_cluster(trace, cluster_cfg, **overrides)

    def run_streaming(self, trace, cluster_cfg=None, **overrides):
        """Event-driven replay through a bounded arrival backlog —
        decision-identical to ``run_cluster`` (see
        ``AllocationFrontend.run_streaming``)."""
        return self.frontend.run_streaming(trace, cluster_cfg, **overrides)

    # ------------------------------------------------------------- hot swap --
    def swap_model(self, bundle, *, jobs=None, warmup_config=None):
        """Zero-downtime model hot-swap (the deploy half of the MLOps
        loop). ``bundle`` is a ``repro_torch.mlops.ModelBundle`` (or a bare
        trained ``PCCModel``). Off the hot path, a brand-new service +
        K-shard fabric are built around the new model and the *entire*
        executable grid is warmed via ``warm_allocation_stack`` (pass
        ``jobs`` to also pin the fused model executables at the
        workload's featurized shapes); only then is the frontend
        atomically repointed, so the streaming plane never serves a cold
        or half-built model — post-swap decisions run with
        ``stats["compiles"] == 0``. In-flight micro-batches complete
        against the old service; the old replica's pinned executables are
        retired (``invalidate()``, counted as ``executables_retired``), and
        their CUDA graphs freed once those batches let go of them.
        Returns the warmup report (``cold_start_s`` is the swap's
        off-path warm cost)."""
        from repro_torch.serve.aot import WarmupConfig, warm_allocation_stack
        from repro_torch.serve.service import (AllocationService,
                                               ShardedAllocationService)
        model = getattr(bundle, "model", bundle)
        new_service = AllocationService(model, self.policy,
                                        device=self.service.device,
                                        obs=self.obs)
        new_fabric = ShardedAllocationService(new_service, self.n_shards,
                                              self.mesh)
        cfg = WarmupConfig() if warmup_config is None else warmup_config
        report = warm_allocation_stack(new_service, new_fabric, jobs=jobs,
                                       cfg=cfg, obs=self.obs)
        with self._swap_lock:
            old_service = self.service
            self.service = new_service
            self.frontend.service = new_service
            self.frontend.fabric = new_fabric
            self.frontend._batcher.service = new_service
            self.fabric = new_fabric
            self.model_version = int(getattr(bundle, "version",
                                             self.model_version + 1))
        retired = old_service.replica.invalidate()
        self.obs.metrics.counter("executables_retired").inc(retired)
        self.obs.metrics.counter("model_swaps").inc()
        if self.obs.recorder is not None:
            self.obs.recorder.model_version = self.model_version
        self.swap_reports.append(report)
        return report

    # ----------------------------------------------------------- AOT warmup --
    def warmup(self, trace=None, jobs=None, config=None):
        """Build and pin the serving stack's executable grid (see
        ``repro_torch.serve.aot``): the policy + priced grids of the
        service and the K-shard fabric at every batch bucket, plus — given
        a ``trace`` (or raw ``jobs``) — the fused model executables at that
        workload's featurized shapes. Returns (and stores as
        ``warmup_report``) a ``WarmupReport`` with the per-executable
        capture and warm cost."""
        from repro_torch.serve.aot import WarmupConfig, warm_allocation_stack
        if jobs is None and trace is not None:
            jobs = trace.jobs
        cfg = WarmupConfig() if config is None else config
        self.warmup_report = warm_allocation_stack(
            self.service, self.fabric, jobs=jobs, cfg=cfg, obs=self.obs)
        return self.warmup_report
