"""Decision flight recorder: sampled request->decision provenance to JSONL.

Every ``decide()`` call can deposit full ``AllocationRequest ->
AllocationDecision`` provenance rows — per query: provenance (MODEL vs
HISTORY), tokens, predicted runtime/cost, price paid, executing shard,
the decoded PCC parameters — at a configurable sampling rate, for offline
audit (and, per the ROADMAP, as the provenance stream the drift-retraining
and autoscaling loops will trigger on).

Sampling is deterministic and *independent* of every simulation RNG: a
splitmix64 hash of the recorder's own monotonically increasing row counter
(seeded) thresholds each row, so attaching a recorder never perturbs a
seeded replay (the tracing-on/off identity test covers this plane too),
and the same run records the same rows every time.

Rows accumulate in memory (bounded by ``max_rows``) and stream to a JSONL
path when one is given; ``close()``/context-exit flushes.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs._hash import splitmix64

__all__ = ["FlightRecorder"]

_PROVENANCE_NAMES = {0: "MODEL", 1: "HISTORY"}


class FlightRecorder:
    """Samples per-query decision provenance into memory and/or JSONL."""

    def __init__(self, path: Optional[str] = None, sample_rate: float = 0.01,
                 seed: int = 0, max_rows: int = 100_000):
        assert 0.0 <= sample_rate <= 1.0, sample_rate
        self.path = path
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.max_rows = int(max_rows)
        self.n_seen = 0                    # queries offered
        self.n_recorded = 0                # queries sampled in
        # MLOps provenance: which model version decided each row and the
        # drift score at decision time. ``Allocator.swap_model`` bumps the
        # version; ``DriftMonitor`` stamps the score.
        self.model_version = 0
        self.drift_score = 0.0
        self._rows: List[Dict] = []
        self._fh = None
        # hash(counter ^ seed) < threshold <=> sampled; uint64 threshold
        self._threshold = np.uint64(
            min(int(self.sample_rate * 2.0 ** 64), 2 ** 64 - 1))

    # ------------------------------------------------------------- sampling --
    def _sample_mask(self, n: int) -> np.ndarray:
        idx = np.arange(self.n_seen, self.n_seen + n, dtype=np.uint64)
        self.n_seen += n
        if self.sample_rate >= 1.0:
            return np.ones(n, bool)
        if self.sample_rate <= 0.0:
            return np.zeros(n, bool)
        h = splitmix64(idx ^ np.uint64(self.seed))
        return h < self._threshold

    def record(self, request, decision, context=None, *,
               now: Optional[float] = None,
               spilled: Optional[np.ndarray] = None) -> int:
        """Offer one columnar request/decision pair; returns rows kept."""
        n = len(decision)
        mask = self._sample_mask(n)
        if not mask.any():
            return 0
        col = lambda x: None if x is None else np.asarray(x)[mask]
        tokens = col(decision.tokens)
        kept = int(tokens.size)
        rows_idx = np.nonzero(mask)[0]
        obs = col(request.observed_tokens)
        tid = col(request.template_id)
        sla = col(request.sla)
        dl = col(request.deadline_s)
        pre = col(getattr(request, "preempted", None))
        shard = col(decision.shard)
        prov = col(decision.provenance)
        price = col(decision.price)
        rt = col(decision.runtime)
        cost = col(decision.cost)
        a = col(decision.a)
        b = col(decision.b)
        sp = col(spilled)
        for j in range(kept):
            row = {
                "seq": int(self.n_seen - n + rows_idx[j]),
                "tokens": int(tokens[j]),
                "runtime_s": float(rt[j]),
                "cost_token_s": float(cost[j]),
                "price": float(price[j]),
                "shard": int(shard[j]),
                "provenance": _PROVENANCE_NAMES.get(int(prov[j]),
                                                    int(prov[j])),
                "a": float(a[j]),
                "b": float(b[j]),
                "model_version": int(self.model_version),
                "drift_score": float(self.drift_score),
            }
            if now is not None:
                row["t_s"] = float(now)
            if obs is not None:
                row["observed_tokens"] = int(obs[j])
            if tid is not None:
                row["template_id"] = int(tid[j])
            if sla is not None:
                row["sla"] = int(sla[j])
            if dl is not None:
                row["deadline_s"] = float(dl[j])
            if sp is not None:
                row["spilled"] = bool(sp[j])
            if pre is not None:
                row["preempted"] = bool(pre[j])
            self._write(row)
        self.n_recorded += kept
        return kept

    # -------------------------------------------------------------- output --
    def _write(self, row: Dict) -> None:
        if len(self._rows) < self.max_rows:
            self._rows.append(row)
        if self.path is not None:
            if self._fh is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "w")
            self._fh.write(json.dumps(row) + "\n")

    def rows(self) -> List[Dict]:
        return list(self._rows)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
