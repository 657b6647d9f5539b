"""The typed allocation protocol: ``AllocationRequest -> AllocationDecision``.

  * ``AllocationRequest`` carries *what to decide for* — raw model inputs
    and/or known PCC parameters, the observed-run token cap, and workload
    identity (template id, SLA class, deadline);
  * ``DecisionContext`` carries *how to decide* — the per-query price
    vector, the shard placement, and the observed-mode switch;
  * ``AllocationDecision`` carries *what was decided* — tokens, predicted
    runtime and cost, the decoded PCC parameters, the executing shard, the
    price paid, and decision provenance (cold model vs exact history).

Plain dataclasses of numpy arrays (the reference registers them as jax
pytrees; the port has no use for that). A request is **columnar**: array
fields are (B,)-leading batch arrays.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional

import numpy as np

__all__ = ["AllocationRequest", "AllocationDecision", "DecisionContext",
           "Provenance"]


class Provenance(enum.IntEnum):
    """Where a decision's PCC parameters came from."""
    MODEL = 0      # cold path: the learned model's features -> (a, b)
    HISTORY = 1    # exact-history path: (a, b) supplied with the request


@dataclasses.dataclass
class AllocationRequest:
    """One allocation query (scalar fields) or a columnar batch of them.

    Exactly one of ``model_in`` (raw model inputs, the fused cold path) or
    ``(a, b)`` (known PCC parameters, the policy-only history path) must be
    set. ``observed_tokens`` caps the search range at the query's observed
    run (``DecisionContext.observed`` switches whether it is honored).
    ``template_id`` / ``sla`` / ``deadline_s`` / ``preempted`` are workload
    identity carried for schedulers; the decision ignores them.
    """
    request_id: int = -1
    model_in: Optional[Dict[str, np.ndarray]] = None
    observed_tokens: Optional[np.ndarray] = None
    a: Optional[np.ndarray] = None
    b: Optional[np.ndarray] = None
    template_id: Optional[np.ndarray] = None
    sla: Optional[np.ndarray] = None
    deadline_s: Optional[np.ndarray] = None
    preempted: Optional[np.ndarray] = None

    @classmethod
    def from_dataset(cls, model, ds, use_observed: bool = True
                     ) -> "AllocationRequest":
        """Columnar request for every job in a TasqDataset, through the
        model's own ``batch_inputs`` view of it."""
        obs = (np.asarray(ds.observed_alloc, np.int64) if use_observed
               else None)
        return cls(model_in=model.batch_inputs(ds), observed_tokens=obs)

    @classmethod
    def from_params(cls, a: np.ndarray, b: np.ndarray,
                    observed_tokens: Optional[np.ndarray] = None
                    ) -> "AllocationRequest":
        """Columnar policy-only request from known PCC parameters."""
        return cls(a=a, b=b, observed_tokens=observed_tokens)

    def batch_size(self) -> int:
        for x in (self.a, self.b):
            if x is not None:
                return int(np.asarray(x).shape[0])
        if self.model_in:
            return int(next(iter(self.model_in.values())).shape[0])
        raise ValueError("empty AllocationRequest: set model_in or (a, b)")

    def narrow(self, idx) -> "AllocationRequest":
        """Row-slice every batch field (chunking helper)."""
        pick = lambda x: None if x is None else np.asarray(x)[idx]
        return dataclasses.replace(
            self,
            model_in=(None if self.model_in is None
                      else {k: np.asarray(v)[idx]
                            for k, v in self.model_in.items()}),
            observed_tokens=pick(self.observed_tokens),
            a=pick(self.a), b=pick(self.b),
            template_id=pick(self.template_id), sla=pick(self.sla),
            deadline_s=pick(self.deadline_s),
            preempted=pick(self.preempted))


@dataclasses.dataclass
class DecisionContext:
    """How to decide.

    ``price``    — (B,) multiplicative per-query prices (None == unpriced);
    ``shard_of`` — (B,) executing shard ranks (the sharded fabric is not
                   ported yet; the service rejects it);
    ``observed`` — honor ``request.observed_tokens`` as the search cap.
    """
    price: Optional[np.ndarray] = None
    shard_of: Optional[np.ndarray] = None
    observed: bool = True

    def narrow(self, idx) -> "DecisionContext":
        pick = lambda x: None if x is None else np.asarray(x)[idx]
        return dataclasses.replace(self, price=pick(self.price),
                                   shard_of=pick(self.shard_of))


@dataclasses.dataclass
class AllocationDecision:
    """What was decided, per query: the serving layer's one output type."""
    tokens: np.ndarray        # (B,) int64 token allocations
    runtime: np.ndarray       # (B,) predicted runtime at the chosen tokens
    a: np.ndarray             # (B,) decoded / supplied PCC exponent
    b: np.ndarray             # (B,) decoded / supplied PCC coefficient
    cost: np.ndarray          # (B,) predicted token-seconds = tokens*runtime
    price: np.ndarray         # (B,) price applied (1.0 where unpriced)
    shard: np.ndarray         # (B,) executing shard rank (0 unsharded)
    provenance: np.ndarray    # (B,) int8 Provenance codes

    def __len__(self) -> int:
        return int(self.tokens.shape[0])

    @staticmethod
    def concat(parts) -> "AllocationDecision":
        parts = list(parts)
        return AllocationDecision(*(np.concatenate(
            [getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(AllocationDecision)))
