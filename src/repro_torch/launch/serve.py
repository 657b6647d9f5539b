"""LM server: batched prefill + greedy decode over a closed request set.

The port of ``repro.launch.serve``'s LM server (``Request``,
``ServeConfig``, ``Server``). A batch of ``batch_size`` slots is filled
from the queue, prompts are left-padded with token 0 to ``prompt_len``
(no padding mask, as in the reference, unless the config asks for one:
``mask_padding``, the hybrid_moe family, gets each row's pad count as
the batch's ``start``) and prefilled together, then one decode step
advances every slot, ``max(max_new_tokens) - 1`` times, and each request
keeps its first ``max_new_tokens`` tokens. Greedy: argmax, the first
maximum on ties, in both frameworks.

The VLM and encoder-decoder families take inputs besides tokens, which
the server does not make: it refuses them, and they are driven through
``train.steps.make_prefill_step`` / ``make_decode_step``.

On the card (``device="cuda"``, the default) a prefill with
``attention_impl="pallas"`` runs kernel K4 once per layer. With ``mesh``
(a ``DeviceMesh`` with the reference's ("data", "model") axes over the
default group) the parameters are laid out on it as
``model_api.shardings`` places them, each batch of prompts and of decoded
tokens is sharded as ``train.steps.shard_batch`` shards it, the steps are
``make_prefill_step(cfg, mesh)`` / ``make_decode_step(cfg, mesh)`` (K4
under ``local_map``), and every rank reads the full logits, so every rank
generates the same tokens. The generated
tokens stay on the device until the batch ends: one copy to the host per
batch, not per step. The decode cache is as long as the prompt unless
``ServeConfig.max_len`` (the reference's, which it reads nowhere) asks
for more: by default the reference's fault is kept (``models/lm.py``: a
decode past the prompt overwrites the cache's last slot); with
``max_len`` >= prompt + new tokens every generated token keeps its own
slot. The reference's ``greedy`` flag and ``Request.generated`` (written
nowhere) are left out.

Tracing (``obs``, recording): a batch is an ``lm.batch`` span (``batch``,
``prompt_len``, ``pad_tokens``) holding one ``lm.prefill`` and an
``lm.decode`` a step, each with the ``device_ms`` of CUDA events around
it, resolved after the batch's one copy to the host (no sync a step);
the hybrid_moe family's layer spans and MoE counters sit inside them
(``models/lm.py``). Counters: ``lm_prompt_tokens`` (real prompt tokens),
``lm_pad_tokens``, ``lm_generated_tokens`` (tokens the requests keep),
``lm_decode_steps``.

``AllocationFrontend`` is the same request-queue pattern for the paper's
allocation decisions: single-query PCC allocation requests
(``repro_torch.api.AllocationRequest``) are micro-batched through a
``repro_torch.serve.AllocationService`` — padded/bucketed batches, one
executable call per (model, bucket) — mirroring how the LM server keeps
its decode shapes static. Columnar batches go straight through the typed
protocol, routed to the sharded fabric whenever the context carries shard
placement; with K ranks in the default group (``torchrun`` with K ranks,
one a card) the fabric decides on the ``("shard",)`` mesh of
``launch.mesh.make_allocation_mesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext)
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model_api
from repro_torch.obs import NULL_OBS
from repro_torch.obs.device import DeviceTrace
from repro_torch.serve.batching import MicroBatcher
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     shard_batch, tree_leaves)

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
    max_len: Optional[int] = None      # decode cache positions (prompt_len)


class Server:
    """Slot-based batched server over a single model replica on one
    device, or laid out over ``mesh``; ``params`` must already lie on the
    device (full tensors, the same on every rank of a mesh, or DTensors on
    it already)."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, params,
                 device: Union[str, torch.device, None] = None, mesh=None,
                 obs=None):
        if cfg.family in ("vlm", "encdec"):
            # the reference's server feeds tokens only, and its prefill
            # then fails on the missing positions or frames
            raise ValueError(
                f"Server serves token prompts; the {cfg.family!r} family "
                "needs its own inputs (positions and patch_embeds, or "
                "frames): drive it through train.steps.make_prefill_step "
                "and make_decode_step")
        self.cfg = cfg
        self.serve = serve
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and not any(
                isinstance(t, DTensor) for t in tree_leaves(params)):
            params = model_api.distribute(
                params, model_api.shardings(cfg, mesh), mesh)
        self.params = params
        self.obs = NULL_OBS if obs is None else obs
        self._prefill = make_prefill_step(cfg, mesh)
        self._decode = make_decode_step(cfg, mesh)

    def _tokens(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            return {"tokens": tokens}
        return shard_batch({"tokens": tokens}, self.cfg, self.mesh)

    def _prefill_batch(self, prompts: np.ndarray, pads: np.ndarray, trace):
        """prompts: (B, prompt_len), pads: (B,) left-padding ->
        (next_token_logits, cache)."""
        batch = self._tokens(torch.from_numpy(prompts).to(self.device))
        if self.cfg.mask_padding:
            batch["start"] = torch.from_numpy(pads).to(self.device)
        kw = {} if self.serve.max_len is None else {
            "max_len": self.serve.max_len}
        if trace.recording:
            kw["trace"] = trace
        return self._prefill(self.params, batch, **kw)

    @staticmethod
    def _next(logits) -> torch.Tensor:
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        return torch.argmax(logits, -1).to(torch.int32)

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Serve a closed set of requests to completion. Returns
        {request_id: generated token ids}."""
        sc = self.serve
        queue = list(requests)
        out: Dict[int, List[int]] = {}
        tracer, metrics = self.obs.tracer, self.obs.metrics
        trace = DeviceTrace(self.obs, self.device)
        step_kw = {"trace": trace} if trace.recording else {}

        while queue:
            batch = queue[:sc.batch_size]
            queue = queue[sc.batch_size:]
            prompts = np.zeros((sc.batch_size, sc.prompt_len), np.int32)
            pads = np.full(sc.batch_size, sc.prompt_len, np.int32)
            for i, r in enumerate(batch):
                p = r.prompt[-sc.prompt_len:]
                prompts[i, -len(p):] = p      # left-pad
                pads[i] = sc.prompt_len - len(p)
            n_steps = max(max(r.max_new_tokens for r in batch) - 1, 0)

            with tracer.span("lm.batch", batch=sc.batch_size,
                             prompt_len=sc.prompt_len,
                             pad_tokens=int(pads.sum())):
                with trace.span("lm.prefill"):
                    logits, cache = self._prefill_batch(prompts, pads, trace)
                cur = self._next(logits)
                steps = [cur]
                for step in range(n_steps):
                    with trace.span("lm.decode", step=step):
                        logits, cache = self._decode(
                            self.params, {**self._tokens(cur[:, None]),
                                          "cache": cache}, **step_kw)
                    cur = self._next(logits)
                    steps.append(cur)
                gen = torch.stack(steps, dim=1).cpu().numpy()
                del logits, cache  # before the next batch's prefill allocates
            trace.flush()
            metrics.counter("lm_prompt_tokens").inc(
                int(sc.prompt_len * sc.batch_size - pads.sum()))
            metrics.counter("lm_pad_tokens").inc(int(pads.sum()))
            metrics.counter("lm_generated_tokens").inc(
                sum(min(r.max_new_tokens, gen.shape[1]) for r in batch))
            metrics.counter("lm_decode_steps").inc(n_steps)

            for i, r in enumerate(batch):
                out[r.request_id] = [int(t) for t in gen[i, :r.max_new_tokens]]
        return out


class AllocationFrontend:
    """Request-queue endpoint for PCC token allocation.

    The allocation analogue of ``Server``: requests queue up, ``step()``
    drains them through the service's batched executables. Closed sets of
    requests go through ``run()`` like the LM server.

    ``n_shards > 1`` makes the frontend the sharded fabric's entry point:
    it builds the allocation mesh (``launch.mesh.make_allocation_mesh``:
    one rank a replica when the default group holds exactly ``n_shards``
    ranks, else None) unless ``mesh`` is given, and wraps the service in a
    ``ShardedAllocationService`` over it, which ``run_cluster`` threads
    into the sharded simulator. Without a mesh every replica is decided
    on the service's device.
    """

    def __init__(self, service, max_batch: int = 256, n_shards: int = 1,
                 mesh=None, obs=None):
        from repro_torch.launch.mesh import make_allocation_mesh
        from repro_torch.serve.service import ShardedAllocationService
        self.service = service
        # one Obs bundle end to end: an explicit one is installed on the
        # service so frontend, batcher, fabric, and simulator all share it
        if obs is not None:
            service.obs = obs
        self.obs = service.obs
        self.n_shards = int(n_shards)
        self.mesh = make_allocation_mesh(n_shards) if mesh is None else mesh
        self.fabric = ShardedAllocationService(service, self.n_shards,
                                               self.mesh)
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
        mesh = self.mesh if cfg.n_shards == self.n_shards else None
        return ClusterSimulator(self.service, cfg, fabric=self.fabric,
                                obs=self.obs, mesh=mesh)
