"""LM server: batched prefill + greedy decode over a closed request set.

The port of ``repro.launch.serve``'s LM server (``Request``,
``ServeConfig``, ``Server``). A batch of ``batch_size`` slots is filled
from the queue, prompts are left-padded with token 0 to ``prompt_len``
(no padding mask, as in the reference) and prefilled together, then one
decode step advances every slot, ``max(max_new_tokens) - 1`` times, and
each request keeps its first ``max_new_tokens`` tokens. Greedy: argmax,
the first maximum on ties, in both frameworks.

On the card (``device="cuda"``, the default) a prefill with
``attention_impl="pallas"`` runs kernel K4 once per layer. The generated
tokens stay on the device until the batch ends: one copy to the host per
batch, not per step. The decode cache is as long as the prompt, a fault
kept from the reference (``models/lm.py``): its ``ServeConfig.max_len``
(a cache capacity read nowhere) and ``greedy`` flag, and
``Request.generated`` (written nowhere), are left out.

``AllocationFrontend`` is the same request-queue pattern for the paper's
allocation decisions: single-query PCC allocation requests
(``repro_torch.api.AllocationRequest``) are micro-batched through a
``repro_torch.serve.AllocationService`` — padded/bucketed batches, one
executable call per (model, bucket) — mirroring how the LM server keeps
its decode shapes static. Columnar batches go straight through the typed
protocol, routed to the sharded fabric whenever the context carries shard
placement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext)
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.serve.batching import MicroBatcher
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["ServeConfig", "Server", "Request", "AllocationFrontend"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 4
    prompt_len: int = 64               # fixed prefill shape (left-padded)


class Server:
    """Slot-based batched server over a single model replica on one
    device; ``params`` must already lie on it."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, params,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.serve = serve
        self.params = params
        self.device = resolve_device(device)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    def _prefill_batch(self, prompts: np.ndarray):
        """prompts: (B, prompt_len) -> (next_token_logits, cache)."""
        return self._prefill(self.params, {
            "tokens": torch.from_numpy(prompts).to(self.device)})

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Serve a closed set of requests to completion. Returns
        {request_id: generated token ids}."""
        sc = self.serve
        queue = list(requests)
        out: Dict[int, List[int]] = {}

        while queue:
            batch = queue[:sc.batch_size]
            queue = queue[sc.batch_size:]
            prompts = np.zeros((sc.batch_size, sc.prompt_len), np.int32)
            for i, r in enumerate(batch):
                p = r.prompt[-sc.prompt_len:]
                prompts[i, -len(p):] = p      # left-pad

            logits, cache = self._prefill_batch(prompts)
            cur = torch.argmax(logits, -1).to(torch.int32)
            steps = [cur]
            for _ in range(max(max(r.max_new_tokens for r in batch) - 1, 0)):
                logits, cache = self._decode(
                    self.params, {"tokens": cur[:, None], "cache": cache})
                cur = torch.argmax(logits, -1).to(torch.int32)
                steps.append(cur)
            gen = torch.stack(steps, dim=1).cpu().numpy()
            del logits, cache     # before the next batch's prefill allocates

            for i, r in enumerate(batch):
                out[r.request_id] = [int(t) for t in gen[i, :r.max_new_tokens]]
        return out


class AllocationFrontend:
    """Request-queue endpoint for PCC token allocation.

    The allocation analogue of ``Server``: requests queue up, ``step()``
    drains them through the service's batched executables. Closed sets of
    requests go through ``run()`` like the LM server.

    ``n_shards > 1`` makes the frontend the sharded fabric's entry point:
    it wraps the service in a ``ShardedAllocationService``, which
    ``run_cluster`` threads into the sharded simulator. The reference also
    builds an allocation mesh here (one device per replica when the host
    has them) and takes a ``mesh`` argument; the port serves every replica
    from the service's one card, so there is no mesh to build or pass.
    """

    def __init__(self, service, max_batch: int = 256, n_shards: int = 1,
                 obs=None):
        from repro_torch.serve.service import ShardedAllocationService
        self.service = service
        # one Obs bundle end to end: an explicit one is installed on the
        # service so frontend, batcher, fabric, and simulator all share it
        if obs is not None:
            service.obs = obs
        self.obs = service.obs
        self.n_shards = int(n_shards)
        self.fabric = ShardedAllocationService(service, self.n_shards)
        self._batcher = MicroBatcher(service, max_batch=max_batch,
                                     obs=self.obs)

    @property
    def pending(self) -> int:
        return len(self._batcher)

    def submit(self, request_id: int, model_in: Dict[str, np.ndarray],
               observed_tokens: Optional[int] = None) -> None:
        self._batcher.submit(AllocationRequest(
            request_id=request_id, model_in=model_in,
            observed_tokens=observed_tokens))

    def step(self) -> Dict[int, int]:
        """Drain the queue: {request_id: allocated tokens}."""
        with self.obs.tracer.span("frontend.step", pending=self.pending):
            return self._batcher.flush()

    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """Synchronous protocol entry: a columnar request decided in one
        executable call — through the fabric when the context carries
        shard placement, the single-replica service otherwise."""
        if context is not None and context.shard_of is not None:
            return self.fabric.decide(request, context)
        return self.service.decide(request, context)

    def run(self, requests: Sequence[AllocationRequest]) -> Dict[int, int]:
        """Serve a closed set of allocation requests to completion."""
        out: Dict[int, int] = {}
        for r in requests:
            self._batcher.submit(r)
            if self.pending >= self._batcher.max_batch:
                out.update(self.step())
        out.update(self.step())
        return out

    def run_cluster(self, trace, cluster_cfg=None, *,
                    admission: Optional[str] = None,
                    elastic: Optional[bool] = None,
                    pricing: Optional[str] = None,
                    n_shards: Optional[int] = None,
                    load_factor: Optional[float] = None,
                    mlops=None):
        """Replay a ``repro_torch.workloads.Trace`` through this frontend's
        service inside the trace-driven cluster simulator
        (``repro_torch.cluster``) on the service's device, every allocation
        decision going through the sharded fabric's (K, Bp) executables.

        ``admission`` / ``elastic`` / ``pricing`` / ``n_shards`` /
        ``load_factor`` override the corresponding ``ClusterConfig`` fields
        without the caller building a config. An explicit ``cluster_cfg``
        is authoritative (its ``n_shards`` is honored as written); only
        when no config is passed does ``n_shards`` default to the
        frontend's own shard count. ``mlops`` (a
        ``repro_torch.mlops.MLOpsLoop``) attaches the drift-retraining loop
        to the replay."""
        sim = self._make_simulator(cluster_cfg, admission, elastic, pricing,
                                   n_shards, load_factor)
        return sim.run(trace, mlops=mlops)

    def run_streaming(self, trace, cluster_cfg=None, *,
                      admission: Optional[str] = None,
                      elastic: Optional[bool] = None,
                      pricing: Optional[str] = None,
                      n_shards: Optional[int] = None,
                      load_factor: Optional[float] = None,
                      backlog: int = 1024, chunk: int = 64,
                      mlops=None):
        """``run_cluster`` with the event-driven arrival path: a producer
        thread streams the trace through a bounded backlog (backpressure
        when decisions fall behind) and each epoch boundary drains every
        arrival at or before it by watermark. Decision-identical to
        ``run_cluster`` on the same trace; pair with
        ``repro_torch.serve.aot.warm_allocation_stack`` (or
        ``Allocator.from_config(aot_warmup=True)``) for a hot path that
        never builds an executable."""
        sim = self._make_simulator(cluster_cfg, admission, elastic, pricing,
                                   n_shards, load_factor)
        return sim.run_streaming(trace, backlog=backlog, chunk=chunk,
                                 mlops=mlops)

    def _make_simulator(self, cluster_cfg, admission, elastic, pricing,
                        n_shards, load_factor):
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
        return ClusterSimulator(self.service, cfg, fabric=self.fabric,
                                obs=self.obs)
