"""AllocationService: features to token decisions on one device.

The deploy/allocate stage of the paper (§2.2) as an online service: a
trained ``PCCModel`` plus an ``AllocationPolicy`` become a batch function

    model inputs (B, ...) -> scaled z -> PCCScaler.decode -> (a, b)
                          -> choose_tokens_torch -> tokens (B,)

run on the device with one copy in and one copy out. The decode runs in
float32, its (a, b) are cast to float64, and the policy runs in float64 —
in that order, as the reference's fused executable does — so the tokens are
the numpy ``choose_tokens`` oracle's on the same decoded parameters (up to
``pow``'s last bit; see ``core/allocator.py``). Host-only models (GBDT)
predict (a, b) on the host and share the device policy stage.

The one entry point is ``decide(AllocationRequest, DecisionContext) ->
AllocationDecision``: the history path (request carries ``a``/``b``), the
model path (request carries ``model_in``) and the priced path (context
carries ``price``). Batches beyond ``MAX_BATCH`` are served in chunks, and
each chunk is padded to a power-of-two bucket.

``ShardedAllocationService`` puts K replicas of one trained model behind
the same protocol: ``DecisionContext.shard_of`` tags each row with a shard
rank. The reference stacks the rows into a (K, Bp) block and maps the
per-shard stage over it with ``vmap``/``shard_map``; every step of that
stage is element-wise in the rows, so here the whole flat batch runs
through the single-replica code once, and each row's decision is the one
a single-shard service fed that shard's partition gives.

Counters. ``stats`` counts decision-stage calls and the queries they
decided (``calls``, ``queries``), per service and per fabric replica, as
the reference's ``ReplicaState`` does. PyTorch runs eagerly, so there are
no compiled executables and no ``compiles`` counter. Every ``decide``
opens a ``service.decide`` / ``fabric.decide`` span on the ``obs`` bundle
and records its latency in the ``decision_latency_s`` histogram.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext, Provenance)
from repro_torch.core.allocator import (AllocationPolicy, choose_tokens_torch,
                                        choose_tokens_priced_torch)
from repro_torch.device import resolve_device
from repro_torch.obs import NULL_OBS, Obs
from repro_torch.serve.batching import batch_bucket, pad_to

__all__ = ["AllocationService", "ReplicaState", "ShardedAllocationService"]


class ReplicaState:
    """Decision counters of one model replica: ``calls`` (decision-stage
    invocations) and ``queries`` (rows decided). A plain service owns one;
    the sharded fabric owns one per shard."""

    __slots__ = ("stats",)

    def __init__(self):
        self.stats: Dict[str, int] = {"calls": 0, "queries": 0}

    def count(self, calls: int = 0, queries: int = 0) -> None:
        self.stats["calls"] += calls
        self.stats["queries"] += queries


def _dispatch(engine, span_name: str, request: AllocationRequest,
              ctx: DecisionContext,
              decide_params: Callable, decide_fused: Callable,
              **span_attrs) -> AllocationDecision:
    """The one ``decide()`` dispatch, shared by the single-replica service
    and the sharded fabric (which differ only in the stages passed in),
    under the observability plane: one span per decide, its latency into
    ``decision_latency_s``, and the decide counters."""
    o = engine.obs
    B = request.batch_size()
    with o.tracer.span(span_name, B=B,
                       path="history" if request.a is not None else "model",
                       priced=ctx.price is not None, **span_attrs):
        t0 = o.tracer.clock()
        obs = request.observed_tokens if ctx.observed else None
        if request.a is not None or request.b is not None:
            if request.a is None or request.b is None:
                raise ValueError("AllocationRequest needs both a and b for "
                                 "the policy-only path")
            if request.model_in:
                raise ValueError("ambiguous AllocationRequest: set model_in "
                                 "or (a, b), not both")
            d = decide_params(request.a, request.b, ctx.price, obs)
        elif not request.model_in:
            raise ValueError("AllocationRequest needs model_in or (a, b)")
        elif not engine.model.supports_fused:
            # host models (GBDT): host (a, b) prediction + device policy
            ref = (obs if obs is not None
                   else np.full(B, engine.policy.max_tokens, np.int64))
            a, b = engine.model.predict_params_batch(request.model_in,
                                                     np.asarray(ref))
            d = dataclasses.replace(
                decide_params(a, b, ctx.price, obs),
                provenance=np.full(B, Provenance.MODEL, np.int8))
        else:
            d = decide_fused(request.model_in, obs)
            if ctx.price is not None:
                # priced re-decide on the decoded parameters, as the
                # reference
                d = dataclasses.replace(
                    decide_params(d.a, d.b, ctx.price, obs),
                    provenance=np.full(B, Provenance.MODEL, np.int8))
        dt = o.tracer.clock() - t0
    o.metrics.histogram("decision_latency_s").record(dt)
    o.metrics.counter("decide_calls").inc()
    o.metrics.counter("decide_queries").inc(len(d))
    return d


class AllocationService:
    """Batched allocation decisions for one trained PCCModel."""

    # largest single batch; bigger requests are served in chunks
    MAX_BATCH = 4096
    # smallest padded batch
    BATCH_FLOOR = 8

    def __init__(self, model, policy: Optional[AllocationPolicy] = None,
                 device: Union[str, torch.device, None] = None,
                 obs: Optional[Obs] = None):
        self.device = resolve_device(device)
        if model.supports_fused and model.device != self.device:
            raise ValueError(f"model lives on {model.device}, service on "
                             f"{self.device}")
        self.model = model
        self.policy = AllocationPolicy() if policy is None else policy
        self.replica = ReplicaState()
        self.obs = NULL_OBS if obs is None else obs

    @property
    def stats(self) -> Dict[str, int]:
        return self.replica.stats

    def replica_stats(self) -> List[Dict[str, int]]:
        """Decision counters of the one replica, as a one-shard list."""
        return [dict(self.replica.stats)]

    def _chunks(self, B: int) -> List[slice]:
        return [slice(i, min(i + self.MAX_BATCH, B))
                for i in range(0, B, self.MAX_BATCH)]

    def _tensor(self, x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                             dtype)

    # ------------------------------------------------------------ protocol --
    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """A typed request + context in, a typed decision out:

          * ``request.a/b`` set      -> policy-only history path;
          * ``request.model_in`` set -> model path (host models predict
            (a, b) on the host and share the device policy);
          * ``context.price``        -> the priced policy twin;
          * ``context.observed``     -> honor ``request.observed_tokens``.
        """
        ctx = DecisionContext() if context is None else context
        if ctx.shard_of is not None:
            raise ValueError(
                "AllocationService is single-replica; shard placement "
                "(DecisionContext.shard_of) needs a ShardedAllocationService "
                "or an Allocator")
        B = request.batch_size()
        if B > self.MAX_BATCH:
            return AllocationDecision.concat(
                self.decide(request.narrow(s), ctx.narrow(s))
                for s in self._chunks(B))
        return _dispatch(self, "service.decide", request, ctx,
                         self._decide_params, self._decide_fused)

    def _decide_params(self, a: np.ndarray, b: np.ndarray,
                       price: Optional[np.ndarray],
                       obs: Optional[np.ndarray]) -> AllocationDecision:
        self.replica.count(calls=1, queries=int(np.asarray(a).shape[0]))
        return self._decide_params_rows(a, b, price, obs)

    def _decide_fused(self, model_in: Dict[str, np.ndarray],
                      obs: Optional[np.ndarray]) -> AllocationDecision:
        self.replica.count(
            calls=1, queries=int(next(iter(model_in.values())).shape[0]))
        return self._decide_fused_rows(model_in, obs)

    @torch.inference_mode()
    def _decide_params_rows(self, a: np.ndarray, b: np.ndarray,
                            price: Optional[np.ndarray],
                            obs: Optional[np.ndarray]) -> AllocationDecision:
        """The policy stage on (B,) known parameters; counts nothing."""
        a = np.asarray(a)
        B = a.shape[0]
        Bp = batch_bucket(B, self.BATCH_FLOOR)
        a64 = self._tensor(pad_to(np.asarray(a, np.float64), Bp), torch.float64)
        b64 = self._tensor(pad_to(np.asarray(b, np.float64), Bp), torch.float64)
        obs_t = (None if obs is None else
                 self._tensor(pad_to(np.asarray(obs, np.int64), Bp),
                              torch.int64))
        if price is None:
            toks = choose_tokens_torch(a64, b64, self.policy, obs_t)
            price_out = np.ones(B, np.float64)
        else:
            p64 = np.ones(Bp, np.float64)      # neutral price on padded rows
            p64[:B] = np.asarray(price, np.float64)
            toks = choose_tokens_priced_torch(
                a64, b64, self.policy, self._tensor(p64, torch.float64), obs_t)
            price_out = np.asarray(price, np.float64)
        rt = b64 * toks.to(torch.float64) ** a64
        toks, rt = toks[:B].cpu().numpy(), rt[:B].cpu().numpy()
        return AllocationDecision(
            tokens=toks, runtime=rt, a=a, b=np.asarray(b),
            cost=toks.astype(np.float64) * rt, price=price_out,
            shard=np.zeros(B, np.int64),
            provenance=np.full(B, Provenance.HISTORY, np.int8))

    @torch.inference_mode()
    def _decide_fused_rows(self, model_in: Dict[str, np.ndarray],
                           obs: Optional[np.ndarray]) -> AllocationDecision:
        """Model + policy stages on (B, ...) raw inputs; counts nothing."""
        B = next(iter(model_in.values())).shape[0]
        Bp = batch_bucket(B, self.BATCH_FLOOR)
        inputs = {k: self._tensor(pad_to(np.asarray(v), Bp), torch.float32)
                  for k, v in model_in.items()}
        # zero-padded observed rows are harmless: the bisection degenerates
        # and their outputs are sliced off below
        obs_t = (None if obs is None else
                 self._tensor(pad_to(np.asarray(obs, np.int64), Bp),
                              torch.int64))
        z = self.model.serve_apply(inputs)
        a, b = self.model.scaler.decode(z)                 # float32
        a64, b64 = a.to(torch.float64), b.to(torch.float64)
        toks = choose_tokens_torch(a64, b64, self.policy, obs_t)
        rt = b64 * toks.to(torch.float64) ** a64
        out = torch.stack([toks.to(torch.float64), rt, a64, b64])[:, :B]
        toks, rt, a, b = out.cpu().numpy()                 # one copy out
        toks = toks.astype(np.int64)
        return AllocationDecision(
            tokens=toks, runtime=rt, a=a.astype(np.float32),
            b=b.astype(np.float32), cost=toks.astype(np.float64) * rt,
            price=np.ones(B, np.float64), shard=np.zeros(B, np.int64),
            provenance=np.full(B, Provenance.MODEL, np.int8))


class ShardedAllocationService:
    """K replicas of one trained model behind a single batched API.

    Wraps an ``AllocationService`` and serves the same ``decide`` protocol
    for shard-tagged traffic: ``DecisionContext.shard_of`` carries a shard
    rank in [0, K) per row (None places everything on shard 0). One pass
    of the wrapped service's decision stages decides every replica's rows
    at once (see the module docstring for why that is the per-shard math);
    results come back in input order.

    Fabric-level counters accrue into the wrapped service's ``stats`` (one
    call per stage invocation, as the reference's one compiled (K, Bp)
    call); per-replica traffic lands in ``replicas[k].stats`` (one call
    per stage invocation that decided rows of shard k).
    """

    def __init__(self, service: AllocationService, n_shards: int = 1):
        assert n_shards >= 1
        self.service = service
        self.model = service.model
        self.policy = service.policy
        self.n_shards = int(n_shards)
        self.replicas = [ReplicaState() for _ in range(n_shards)]

    @property
    def stats(self) -> Dict[str, int]:
        return self.service.stats

    @property
    def obs(self) -> Obs:
        # one Obs bundle per service; the fabric shares its wrapped
        # service's so single-shard and fabric traffic land in one place
        return self.service.obs

    @obs.setter
    def obs(self, value: Obs) -> None:
        self.service.obs = value

    def replica_stats(self) -> List[Dict[str, int]]:
        """Per-shard decision counters, shard-rank order."""
        return [dict(r.stats) for r in self.replicas]

    def _count(self, shard_of: np.ndarray) -> None:
        counts = np.bincount(shard_of, minlength=self.n_shards)
        for k, r in enumerate(self.replicas):
            if counts[k]:
                r.count(calls=1, queries=int(counts[k]))
        self.service.replica.count(calls=1, queries=int(shard_of.size))

    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """The fabric's ``decide``: the single-shard protocol, with
        ``context.shard_of`` placing each row on a replica."""
        ctx = DecisionContext() if context is None else context
        B = request.batch_size()
        if ctx.shard_of is None:
            ctx = dataclasses.replace(ctx, shard_of=np.zeros(B, np.int64))
        if B > self.service.MAX_BATCH:
            return AllocationDecision.concat(
                self.decide(request.narrow(s), ctx.narrow(s))
                for s in self.service._chunks(B))
        shard_of = np.asarray(ctx.shard_of, np.int64)
        if shard_of.size and (shard_of.min() < 0
                              or shard_of.max() >= self.n_shards):
            raise ValueError(f"shard_of outside [0, {self.n_shards})")
        return _dispatch(
            self, "fabric.decide", request, ctx,
            lambda a, b, price, obs: self._decide_params(shard_of, a, b,
                                                         price, obs),
            lambda model_in, obs: self._decide_fused(shard_of, model_in,
                                                     obs),
            K=self.n_shards)

    def _decide_params(self, shard_of, a, b, price, obs
                       ) -> AllocationDecision:
        self._count(shard_of)
        d = self.service._decide_params_rows(a, b, price, obs)
        return dataclasses.replace(d, shard=shard_of)

    def _decide_fused(self, shard_of, model_in, obs) -> AllocationDecision:
        self._count(shard_of)
        d = self.service._decide_fused_rows(model_in, obs)
        return dataclasses.replace(d, shard=shard_of)
