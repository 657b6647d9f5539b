"""Cluster layer: trace-driven multi-tenant simulation over a sharded
serving fabric with online PCC refinement, on the card.

``ClusterSimulator`` replays a ``repro_torch.workloads.Trace`` (bursty
arrivals, Zipf-repeated queries, per-tenant SLA classes) through a batched
``ShardedAllocationService`` against K finite token-pool shards
(``PoolShards``) with per-shard admission control and pluggable queueing
(``scheduler``: fifo / priority / EDF over SLA slack, starvation-aged EDF,
and DRF tenant fairness), elastic lease resizing, checkpoint-and-requeue
preemption of over-share tenants' leases, and a per-(shard, SLA-class)
price signal. A consistent-hash ``Router`` pins each query template to a
home shard, whose ``ShardedPCCCache`` holds its exact PCC (the paper's
"past observed" path). ``ClusterMetrics`` tracks cost, utilization,
slowdown, SLA violations and the fabric columns.

``FusedReplay`` is the mechanical counterpart: it replays a streamed trace
with pre-decided allocations through the fused epoch kernel (K2) — one
launch per epoch over the device-resident lease tables — to measure the
fabric's throughput ceiling (events/sec + a ``KernelRoofline`` row).

The scheduler, router and metrics are numpy, copied from the reference;
the pool, cache, simulator and replay keep their tables on the device and
run kernels K1, K2 and K3 there.
"""
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.pcc_cache import PCCCache, ShardedPCCCache
from repro_torch.cluster.pool import PoolShards, TokenPool
from repro_torch.cluster.replay import FusedReplay, ReplayConfig, ReplayReport
from repro_torch.cluster.router import Router
from repro_torch.cluster.scheduler import (
    DrfPolicy,
    EdfAgingPolicy,
    EdfPolicy,
    FifoPolicy,
    LeaseView,
    PriceSignal,
    PriorityPolicy,
    QueueView,
    SchedulerPolicy,
    make_policy,
)
from repro_torch.cluster.simulator import (ClusterConfig, ClusterReport,
                                           ClusterSimulator, StreamingArrivals)

__all__ = [
    "ClusterConfig",
    "ClusterMetrics",
    "ClusterReport",
    "ClusterSimulator",
    "DrfPolicy",
    "EdfAgingPolicy",
    "EdfPolicy",
    "FifoPolicy",
    "FusedReplay",
    "LeaseView",
    "PCCCache",
    "PoolShards",
    "PriceSignal",
    "PriorityPolicy",
    "QueueView",
    "ReplayConfig",
    "ReplayReport",
    "Router",
    "SchedulerPolicy",
    "ShardedPCCCache",
    "StreamingArrivals",
    "TokenPool",
    "make_policy",
]
