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
each chunk is padded to a power-of-two bucket. This is the single-replica
service; the reference's sharded fabric is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext, Provenance)
from repro_torch.core.allocator import (AllocationPolicy, choose_tokens_torch,
                                        choose_tokens_priced_torch)
from repro_torch.device import resolve_device
from repro_torch.serve.batching import batch_bucket, pad_to

__all__ = ["AllocationService"]


class AllocationService:
    """Batched allocation decisions for one trained PCCModel."""

    # largest single batch; bigger requests are served in chunks
    MAX_BATCH = 4096
    # smallest padded batch
    BATCH_FLOOR = 8

    def __init__(self, model, policy: Optional[AllocationPolicy] = None,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        if model.supports_fused and model.device != self.device:
            raise ValueError(f"model lives on {model.device}, service on "
                             f"{self.device}")
        self.model = model
        self.policy = AllocationPolicy() if policy is None else policy

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
            raise NotImplementedError(
                "shard placement (DecisionContext.shard_of) needs the "
                "sharded serving fabric, which is not ported yet")
        B = request.batch_size()
        if B > self.MAX_BATCH:
            return AllocationDecision.concat(
                self.decide(request.narrow(s), ctx.narrow(s))
                for s in self._chunks(B))
        obs = request.observed_tokens if ctx.observed else None
        if request.a is not None or request.b is not None:
            if request.a is None or request.b is None:
                raise ValueError("AllocationRequest needs both a and b for "
                                 "the policy-only path")
            if request.model_in:
                raise ValueError("ambiguous AllocationRequest: set model_in "
                                 "or (a, b), not both")
            return self._decide_params(request.a, request.b, ctx.price, obs)
        if not request.model_in:
            raise ValueError("AllocationRequest needs model_in or (a, b)")
        if not self.model.supports_fused:
            # host models (GBDT): host (a, b) prediction + device policy
            ref = (obs if obs is not None
                   else np.full(B, self.policy.max_tokens, np.int64))
            a, b = self.model.predict_params_batch(request.model_in,
                                                   np.asarray(ref))
            return dataclasses.replace(
                self._decide_params(a, b, ctx.price, obs),
                provenance=np.full(B, Provenance.MODEL, np.int8))
        d = self._decide_fused(request.model_in, obs)
        if ctx.price is not None:
            # priced re-decide on the decoded parameters, as the reference
            d = dataclasses.replace(
                self._decide_params(d.a, d.b, ctx.price, obs),
                provenance=np.full(B, Provenance.MODEL, np.int8))
        return d

    @torch.inference_mode()
    def _decide_params(self, a: np.ndarray, b: np.ndarray,
                       price: Optional[np.ndarray],
                       obs: Optional[np.ndarray]) -> AllocationDecision:
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
    def _decide_fused(self, model_in: Dict[str, np.ndarray],
                      obs: Optional[np.ndarray]) -> AllocationDecision:
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
