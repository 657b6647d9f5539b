"""ClusterMetrics — cost / utilization / slowdown / SLA accounting.

Per-query records (append-only column lists, finalized into numpy arrays)
plus per-epoch samples of queue depth and pool occupancy. ``report()``
aggregates the headline numbers; ``error_series()`` exposes the
model-vs-history allocation error over trace time, the quantity the online
refinement loop is supposed to drive toward zero as traffic repeats.

Scheduler-layer accounting (PR 3): completions carry an accrued
``cost_token_s`` (exact under lease resizing, == tokens * runtime without
it), the decision-time ``price``, and the ``slack_s`` left at finish;
``record_resizes`` accumulates shrink/grow counts and reclaimed/granted
tokens; ``report()`` adds per-class cost and slack aggregates and
``slack_histogram()`` exposes the finish-slack distribution.

Fabric-layer accounting (PR 4): completions carry the executing ``shard``
rank and whether the query was ``spilled`` off its home shard; epoch
samples carry the (K,) per-shard pool occupancy. With ``n_shards > 1``,
``report()`` adds per-shard utilization columns, the ``spill_rate``, and
``shard_imbalance`` (mean over busy epochs of the max/mean occupancy ratio
— 1.0 is a perfectly balanced fabric).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ClusterMetrics"]


@dataclasses.dataclass
class _Columns:
    """Per-completed-query columns (parallel lists)."""
    arrival_s: List[float] = dataclasses.field(default_factory=list)
    start_s: List[float] = dataclasses.field(default_factory=list)
    finish_s: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    default_tokens: List[int] = dataclasses.field(default_factory=list)
    runtime_s: List[int] = dataclasses.field(default_factory=list)
    ideal_runtime_s: List[int] = dataclasses.field(default_factory=list)
    sla: List[int] = dataclasses.field(default_factory=list)
    tenant: List[int] = dataclasses.field(default_factory=list)
    cache_hit: List[bool] = dataclasses.field(default_factory=list)
    repeat: List[bool] = dataclasses.field(default_factory=list)
    alloc_error: List[float] = dataclasses.field(default_factory=list)
    cost_token_s: List[float] = dataclasses.field(default_factory=list)
    price: List[float] = dataclasses.field(default_factory=list)
    slack_s: List[float] = dataclasses.field(default_factory=list)
    shard: List[int] = dataclasses.field(default_factory=list)
    spilled: List[bool] = dataclasses.field(default_factory=list)


class ClusterMetrics:
    """Collects per-query and per-epoch statistics for one simulation run."""

    def __init__(self, capacity: int,
                 sla_limits: Optional[np.ndarray] = None,
                 n_shards: int = 1,
                 capacity_per_shard: Optional[int] = None):
        self.capacity = capacity
        self.n_shards = int(n_shards)
        self.capacity_per_shard = (capacity // self.n_shards
                                   if capacity_per_shard is None
                                   else int(capacity_per_shard))
        self.sla_limits = (None if sla_limits is None
                           else np.asarray(sla_limits, np.float64))
        self._q = _Columns()
        self._epoch_t: List[float] = []
        self._epoch_queue_depth: List[int] = []
        self._epoch_in_use: List[int] = []
        self._epoch_in_use_shard: List[np.ndarray] = []
        self._epoch_alloc_err: List[float] = []
        self.n_rejected = 0
        self.n_shrunk = 0
        self.n_grown = 0
        self.tokens_reclaimed = 0
        self.tokens_granted = 0
        self.n_preempted = 0
        self.tokens_preempted = 0
        self.n_certain_miss = 0

    # ----------------------------------------------------------- recording --
    def record_resizes(self, *, shrunk: int = 0, grown: int = 0,
                       reclaimed: int = 0, granted: int = 0) -> None:
        """Accumulate one epoch's lease-resize activity."""
        self.n_shrunk += int(shrunk)
        self.n_grown += int(grown)
        self.tokens_reclaimed += int(reclaimed)
        self.tokens_granted += int(granted)

    def record_preemptions(self, *, count: int = 0, tokens: int = 0) -> None:
        """Accumulate one epoch's preemption activity (leases checkpointed
        back into the queue and the tokens that reclaimed)."""
        self.n_preempted += int(count)
        self.tokens_preempted += int(tokens)

    def record_certain_miss(self, count: int) -> None:
        """Count deadline-floor requests whose slack was already gone —
        violations the scheduler flags (and declines to fund with
        performance-optimal tokens) rather than over-allocates."""
        self.n_certain_miss += int(count)

    def record_completions(self, *, arrival_s, start_s, finish_s, tokens,
                           default_tokens, runtime_s, ideal_runtime_s, sla,
                           tenant, cache_hit, repeat, alloc_error,
                           cost_token_s=None, price=None,
                           slack_s=None, shard=None, spilled=None) -> None:
        """Append a batch of completed queries (parallel arrays).

        ``cost_token_s`` defaults to tokens * runtime (exact when leases are
        never resized); ``price`` defaults to 1 (fixed pricing); ``slack_s``
        defaults to +inf (no deadline); ``shard`` (executing shard rank)
        defaults to 0 and ``spilled`` to False (single-rack).
        """
        c = self._q
        n = np.asarray(arrival_s).size
        if cost_token_s is None:
            cost_token_s = (np.asarray(tokens, np.float64)
                            * np.asarray(runtime_s, np.float64))
        if price is None:
            price = np.ones(n)
        if slack_s is None:
            slack_s = np.full(n, np.inf)
        if shard is None:
            shard = np.zeros(n, np.int64)
        if spilled is None:
            spilled = np.zeros(n, bool)
        c.shard.extend(np.asarray(shard, np.int64).tolist())
        c.spilled.extend(np.asarray(spilled, bool).tolist())
        c.cost_token_s.extend(np.asarray(cost_token_s, np.float64).tolist())
        c.price.extend(np.asarray(price, np.float64).tolist())
        c.slack_s.extend(np.asarray(slack_s, np.float64).tolist())
        c.arrival_s.extend(np.asarray(arrival_s, np.float64).tolist())
        c.start_s.extend(np.asarray(start_s, np.float64).tolist())
        c.finish_s.extend(np.asarray(finish_s, np.float64).tolist())
        c.tokens.extend(np.asarray(tokens, np.int64).tolist())
        c.default_tokens.extend(np.asarray(default_tokens, np.int64).tolist())
        c.runtime_s.extend(np.asarray(runtime_s, np.int64).tolist())
        c.ideal_runtime_s.extend(np.asarray(ideal_runtime_s, np.int64).tolist())
        c.sla.extend(np.asarray(sla, np.int64).tolist())
        c.tenant.extend(np.asarray(tenant, np.int64).tolist())
        c.cache_hit.extend(np.asarray(cache_hit, bool).tolist())
        c.repeat.extend(np.asarray(repeat, bool).tolist())
        c.alloc_error.extend(np.asarray(alloc_error, np.float64).tolist())

    def sample_epoch(self, now: float, queue_depth: int, in_use: int,
                     epoch_alloc_errors: np.ndarray,
                     in_use_shard: Optional[np.ndarray] = None) -> None:
        self._epoch_t.append(float(now))
        self._epoch_queue_depth.append(int(queue_depth))
        self._epoch_in_use.append(int(in_use))
        if in_use_shard is not None:
            self._epoch_in_use_shard.append(
                np.asarray(in_use_shard, np.int64).copy())
        errs = np.asarray(epoch_alloc_errors, np.float64)
        self._epoch_alloc_err.append(float(np.mean(errs)) if errs.size
                                     else np.nan)

    # ----------------------------------------------------------- reporting --
    def _cols(self) -> Dict[str, np.ndarray]:
        c = self._q
        return {f.name: np.asarray(getattr(c, f.name))
                for f in dataclasses.fields(c)}

    def slowdowns(self) -> np.ndarray:
        """(finish - arrival) / ideal runtime — queueing wait included."""
        d = self._cols()
        if d["arrival_s"].size == 0:
            return np.zeros(0)
        return ((d["finish_s"] - d["arrival_s"])
                / np.maximum(d["ideal_runtime_s"], 1))

    def error_series(self) -> Tuple[np.ndarray, np.ndarray]:
        """(epoch end times, mean allocation error of that epoch's decisions).

        Epochs with no decisions carry NaN; with repeat-heavy traffic and the
        cache enabled the series converges toward zero as history accrues.
        """
        return (np.asarray(self._epoch_t),
                np.asarray(self._epoch_alloc_err))

    def slack_histogram(self, bins: int = 20) -> Tuple[np.ndarray, np.ndarray]:
        """(bin edges, counts) over finite finish slacks — negative bins are
        deadline misses, the area the scheduler is trying to shrink."""
        s = np.asarray(self._q.slack_s, np.float64)
        s = s[np.isfinite(s)]
        if s.size == 0:
            return np.zeros(bins + 1), np.zeros(bins, np.int64)
        counts, edges = np.histogram(s, bins=bins)
        return edges, counts

    def report(self) -> Dict[str, float]:
        d = self._cols()
        n = int(d["arrival_s"].size)
        if n == 0:
            return {"n_completed": 0}
        makespan = float(np.max(d["finish_s"]))
        cost = float(np.sum(d["cost_token_s"]))
        default_cost = float(np.sum(d["default_tokens"]
                                    * d["ideal_runtime_s"]))
        slow = self.slowdowns()
        out = {
            "n_completed": n,
            "n_rejected": int(self.n_rejected),
            "makespan_s": round(makespan, 1),
            "cost_token_s": round(cost, 1),
            "default_cost_token_s": round(default_cost, 1),
            "cost_saving_frac": round(1.0 - cost / max(default_cost, 1e-9), 4),
            "utilization": round(cost / max(self.capacity * makespan, 1e-9), 4),
            "p50_slowdown": round(float(np.percentile(slow, 50)), 3),
            "p99_slowdown": round(float(np.percentile(slow, 99)), 3),
            "mean_queue_depth": round(float(np.mean(self._epoch_queue_depth))
                                      if self._epoch_queue_depth else 0.0, 2),
            "peak_queue_depth": int(np.max(self._epoch_queue_depth)
                                    if self._epoch_queue_depth else 0),
            "cache_hit_rate": round(float(np.mean(d["cache_hit"])), 4),
            "repeat_frac": round(float(np.mean(d["repeat"])), 4),
            "alloc_error_mean": round(float(np.mean(d["alloc_error"])), 4),
        }
        wait = d["start_s"] - d["arrival_s"]
        out["mean_wait_s"] = round(float(np.mean(wait)), 2)
        out["mean_price"] = round(float(np.mean(d["price"])), 4)
        if self.n_shrunk or self.n_grown:
            out["resize_shrinks"] = self.n_shrunk
            out["resize_grows"] = self.n_grown
            out["tokens_reclaimed"] = self.tokens_reclaimed
            out["tokens_granted"] = self.tokens_granted
        if self.n_preempted:
            out["preemptions"] = self.n_preempted
            out["preempted_tokens_reclaimed"] = self.tokens_preempted
        if self.n_certain_miss:
            out["certain_deadline_miss"] = self.n_certain_miss
        slack = d["slack_s"]
        finite = np.isfinite(slack)
        if np.any(finite):
            out["mean_slack_s"] = round(float(np.mean(slack[finite])), 2)
            out["p10_slack_s"] = round(
                float(np.percentile(slack[finite], 10)), 2)
            out["deadline_miss_rate"] = round(
                float(np.mean(slack[finite] < 0)), 4)
        if self.sla_limits is not None:
            limits = self.sla_limits[d["sla"]]
            viol = slow > limits
            out["sla_violation_rate"] = round(float(np.mean(viol)), 4)
            for cls in np.unique(d["sla"]):
                m = d["sla"] == cls
                out[f"sla_violation_rate_class{int(cls)}"] = round(
                    float(np.mean(viol[m])), 4)
                out[f"mean_wait_s_class{int(cls)}"] = round(
                    float(np.mean(wait[m])), 2)
                out[f"p99_wait_s_class{int(cls)}"] = round(
                    float(np.percentile(wait[m], 99)), 2)
                out[f"cost_token_s_class{int(cls)}"] = round(
                    float(np.sum(d["cost_token_s"][m])), 1)
                out[f"mean_price_class{int(cls)}"] = round(
                    float(np.mean(d["price"][m])), 4)
        # the tentpole comparison: exact-history path vs cold-model path
        for name, mask in (("cache", d["cache_hit"]),
                           ("model", ~d["cache_hit"]),
                           ("model_repeat", d["repeat"] & ~d["cache_hit"]),
                           ("cache_repeat", d["repeat"] & d["cache_hit"])):
            if np.any(mask):
                out[f"alloc_error_{name}"] = round(
                    float(np.mean(d["alloc_error"][mask])), 4)
        if self.n_shards > 1:
            out.update(self.shard_report(d, makespan))
        return out

    def shard_report(self, d: Optional[Dict[str, np.ndarray]] = None,
                     makespan: Optional[float] = None) -> Dict[str, float]:
        """Fabric columns: per-shard utilization, spill rate, imbalance."""
        d = self._cols() if d is None else d
        if makespan is None:
            makespan = (float(np.max(d["finish_s"])) if d["finish_s"].size
                        else 0.0)
        out: Dict[str, float] = {
            "n_spilled": int(np.sum(d["spilled"])),
            "spill_rate": round(float(np.mean(d["spilled"]))
                                if d["spilled"].size else 0.0, 4),
        }
        denom = max(self.capacity_per_shard * makespan, 1e-9)
        for k in range(self.n_shards):
            m = d["shard"] == k
            out[f"utilization_shard{k}"] = round(
                float(np.sum(d["cost_token_s"][m])) / denom, 4)
        if self._epoch_in_use_shard:
            occ = np.asarray(self._epoch_in_use_shard, np.float64)  # (E, K)
            busy = occ.sum(axis=1) > 0
            if np.any(busy):
                occ = occ[busy]
                out["shard_imbalance"] = round(float(np.mean(
                    occ.max(axis=1) / np.maximum(occ.mean(axis=1), 1e-9))), 3)
        return out
