"""Deadline-aware elastic scheduling: admission orderings + price signal.

``SchedulerPolicy`` turns the pending queue (a columnar ``QueueView``) into
an admission order; the simulator admits the longest prefix that fits the
free pool. Five implementations:

  * ``fifo``      — arrival order;
  * ``priority``  — SLA-class priority, then arrival (PR 2's default);
  * ``edf``       — earliest-deadline-first over *SLA slack*: deadline minus
    the query's predicted completion (now + AREPAS runtime at its currently
    affordable, possibly priced-down allocation). Urgency therefore reflects
    both the SLA class and how much repricing stretched the runtime, rather
    than a static class rank;
  * ``edf_aging`` — EDF over *aged* slack: every second spent waiting earns
    ``aging_rate`` seconds of slack credit, so a long-slack batch query that
    keeps losing to fresh interactive arrivals eventually outranks them —
    bounded starvation without giving up slack ordering for urgent work;
  * ``drf``       — dominant-resource fairness across tenants: queries of
    the tenant with the smallest dominant share of the pool (max of its
    token share and its lease-slot share) are admitted first, aged slack
    breaking ties within a tenant. The same policy selects preemption
    victims — the most-over-share tenant's *youngest* lease — via
    ``victims``, which the simulator consults when preemption is enabled.

``PriceSignal`` is the per-SLA-class multiplicative price: it rises with the
class's share of pool capacity (leased + queued demand), so the allocator
slides pressured classes down their PCCs toward the cost-optimal point
(``choose_tokens_priced``) instead of buying performance-optimal tokens at
peak contention — the "flexible SLAs and prices" knob of Bian et al. Every
ordering is a single ``np.lexsort`` over the queue columns and the signal is
one ``bincount`` per epoch: no per-query Python anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Tuple, Type

import numpy as np

__all__ = ["QueueView", "LeaseView", "SchedulerPolicy", "FifoPolicy",
           "PriorityPolicy", "EdfPolicy", "EdfAgingPolicy", "DrfPolicy",
           "make_policy", "register_scheduler_policy",
           "PriceSignal", "deadline_floor", "SCHEDULER_POLICIES"]


@dataclasses.dataclass(frozen=True)
class QueueView:
    """Columnar snapshot of the pending queue at one admission step.

    The first four columns are always populated; ``now`` rides along for
    aging policies, and the tenant columns are only materialized when the
    active policy declares ``needs_shares`` (they cost one ``bincount``
    over the live lease table per shard per epoch).
    """
    ids: np.ndarray          # (Q,) query ids
    arrival_s: np.ndarray    # (Q,) arrival times
    priority: np.ndarray     # (Q,) SLA-class priority (lower = more urgent)
    slack_s: np.ndarray      # (Q,) deadline - (now + predicted runtime)
    now: float = 0.0         # admission-step sim time (aging baseline)
    tenant: Optional[np.ndarray] = None        # (Q,) tenant ids
    tenant_share: Optional[np.ndarray] = None  # (T,) dominant share/tenant

    def __len__(self) -> int:
        return int(self.ids.size)


@dataclasses.dataclass(frozen=True)
class LeaseView:
    """Columnar snapshot of one shard's live leases at a preemption step."""
    ids: np.ndarray          # (L,) query ids
    tokens: np.ndarray       # (L,) leased tokens
    start_s: np.ndarray      # (L,) lease start (latest (re)admission)
    tenant: np.ndarray       # (L,) tenant ids
    share: np.ndarray        # (L,) dominant share of the lease's tenant

    def __len__(self) -> int:
        return int(self.ids.size)


class SchedulerPolicy(Protocol):
    """Admission ordering: a permutation of the queue, most-urgent first."""
    name: str

    def order(self, queue: QueueView) -> np.ndarray:
        """Return indices that sort ``queue`` into admission order."""
        ...


SCHEDULER_POLICIES: Dict[str, Type] = {}


def register_scheduler_policy(cls):
    """Class decorator: expose a ``SchedulerPolicy`` to ``make_policy`` by
    its ``name`` — the admission analogue of ``register_model`` /
    ``register_policy``, so new orderings (fairness weights, starvation
    aging) plug in without touching the simulator."""
    SCHEDULER_POLICIES[cls.name] = cls
    return cls


@register_scheduler_policy
class FifoPolicy:
    name = "fifo"

    def order(self, queue: QueueView) -> np.ndarray:
        return np.argsort(queue.arrival_s, kind="stable")


@register_scheduler_policy
class PriorityPolicy:
    name = "priority"

    def order(self, queue: QueueView) -> np.ndarray:
        return np.lexsort((queue.arrival_s, queue.priority))


@register_scheduler_policy
class EdfPolicy:
    """EDF over SLA slack: strictly smaller slack is always admitted first;
    arrival time (then id) breaks ties, so simultaneous arrivals with equal
    slack keep a deterministic order."""
    name = "edf"

    def order(self, queue: QueueView) -> np.ndarray:
        return np.lexsort((queue.ids, queue.arrival_s, queue.slack_s))


@register_scheduler_policy
class EdfAgingPolicy:
    """EDF over aged slack: ``slack - aging_rate * wait``.

    Plain EDF starves long-slack batch work under sustained interactive
    load — fresh tight-slack arrivals always outrank it, and since
    everyone's slack shrinks 1:1 with sim time, waiting never improves a
    query's *relative* position. Aging credits each second of queue wait
    with ``aging_rate`` seconds of slack, so a waiting query gains on fresh
    arrivals at that rate and its wait is bounded by ``slack_gap /
    aging_rate`` instead of unbounded.
    """
    name = "edf_aging"
    aging_rate = 0.5

    def aged_slack(self, queue: QueueView) -> np.ndarray:
        return (queue.slack_s
                - self.aging_rate * (queue.now - queue.arrival_s))

    def order(self, queue: QueueView) -> np.ndarray:
        return np.lexsort((queue.ids, queue.arrival_s,
                           self.aged_slack(queue)))


@register_scheduler_policy
class DrfPolicy(EdfAgingPolicy):
    """Dominant-resource fairness across tenants, aged EDF within a tenant.

    A tenant's dominant share is the larger of its token share and its
    lease-slot share of the shard (the two resources a lease consumes).
    Admission orders queries by their tenant's dominant share ascending —
    the classic DRF step: offer the next slot to the least-served tenant —
    with aged SLA slack (then arrival, then id) breaking ties, so one
    tenant's burst cannot lock the pool however cheap its queries price.

    The same weights pick preemption victims: ``victims`` orders live
    leases most-over-share tenant first and, within a tenant, youngest
    lease first (the least banked work to checkpoint — preempting the
    oldest lease would forfeit the most progress-seconds per token
    reclaimed).
    """
    name = "drf"
    needs_shares = True

    def order(self, queue: QueueView) -> np.ndarray:
        assert queue.tenant is not None and queue.tenant_share is not None, \
            "drf ordering needs the tenant columns (QueueView.tenant/_share)"
        share = queue.tenant_share[queue.tenant]
        return np.lexsort((queue.ids, queue.arrival_s,
                           self.aged_slack(queue), share))

    def victims(self, leases: LeaseView) -> np.ndarray:
        """Preemption order over live leases: descending tenant dominant
        share, youngest lease (latest start) first within a tenant."""
        return np.lexsort((leases.ids, -leases.start_s, -leases.share))


def make_policy(name: str) -> SchedulerPolicy:
    assert name in SCHEDULER_POLICIES, \
        f"unknown scheduler policy {name!r}; have {sorted(SCHEDULER_POLICIES)}"
    return SCHEDULER_POLICIES[name]()


@dataclasses.dataclass(frozen=True)
class PriceSignal:
    """Per-SLA-class multiplicative price from pool contention.

    ``price_c = 1 + min(gamma * (leased_c + queued_c) / capacity, cap - 1)``
    — linear in the class's demand share, with 1.0 (the neutral price:
    decisions are bitwise the unpriced policy) at zero demand and a hard
    ceiling at ``cap`` (unbounded prices push queries to one-token leases
    whose AREPAS runtime is the whole skyline area — days of simulated
    wall-clock for no extra saving, cost is already at its floor there).
    Queued demand is included so the signal leads the burst instead of
    trailing the lease table.

    The signal is shard-local: each rack prices its own contention. Demand
    arrays take any leading shape — ``(C,)`` for one pool, ``(K, C)`` for
    the sharded fabric — and the whole fabric's prices come out of one
    vectorized call per epoch.
    """
    n_classes: int
    gamma: float = 4.0
    cap: float = 16.0

    def prices(self, leased_by_class: np.ndarray, capacity: int,
               queued_by_class: Optional[np.ndarray] = None) -> np.ndarray:
        demand = np.asarray(leased_by_class, np.float64)
        if queued_by_class is not None:
            demand = demand + np.asarray(queued_by_class, np.float64)
        assert demand.shape[-1] == self.n_classes, demand.shape
        return 1.0 + np.minimum(self.gamma * demand / max(capacity, 1),
                                self.cap - 1.0)


def deadline_floor(a: np.ndarray, b: np.ndarray, slack_s: np.ndarray,
                   cap: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Smallest allocation whose *predicted* runtime fits the slack.

    For the power law ``rt = b * A^a`` (a < 0), ``rt <= slack`` iff
    ``A >= (slack / b) ** (1 / a)``. This is the repricing guard: however
    high the price, a query is never priced into a *savable* deadline miss
    — the floor is capped at ``cap`` (the performance-optimal ask / current
    lease), past which no allocation would save the deadline anyway.

    Returns ``(floor, certain_miss)``. ``certain_miss`` flags non-positive
    slack: the deadline has already passed, so no allocation saves it and
    the floor is 1 (no constraint — the priced cost-optimal ask stands).
    Flooring those queries at ``cap`` instead — which a naive clamp of the
    slack to a tiny positive value silently does — buys maximum-price
    performance-optimal tokens for a violation that already happened; the
    caller should count the miss, not fund it.
    """
    a = np.minimum(np.asarray(a, np.float64), -1e-4)
    b = np.maximum(np.asarray(b, np.float64), 1e-9)
    slack = np.asarray(slack_s, np.float64)
    certain_miss = ~(slack > 0)            # passed deadline (NaN counts too)
    slack = np.maximum(slack, 1e-9)
    with np.errstate(over="ignore"):
        floor = np.ceil((slack / b) ** (1.0 / a))
    floor = np.where(np.isfinite(floor), floor, np.inf)
    floor = np.where(certain_miss, 1.0, floor)
    return (np.minimum(np.maximum(floor, 1), cap).astype(np.int64),
            certain_miss)
