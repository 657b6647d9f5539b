"""Trace-driven cluster simulator (discrete-event, epoch-batched, sharded).

Replays a multi-tenant ``Trace`` through a sharded serving fabric: K racks,
each with its own slice of the token pool (``PoolShards``), its own PCC
cache shard (``ShardedPCCCache``), its own admission queue and per-SLA-class
price signal, behind one ``ShardedAllocationService``. A consistent-hash
``Router`` pins every query template to a home shard — so repeat traffic
keeps hitting the shard whose cache already holds its exact PCC — and
spills to the better of two hash choices only when the home rack is
saturated. A single pool is the K=1 run of the same loop.

The inner step stays vectorized over event batches:

  * allocation decisions for the whole epoch — every shard's arrivals —
    go through the fabric's one (K, Bp) executable call: the learned model
    for cold queries, the policy-only twin for queries whose exact PCC is
    already cached at their home shard, the priced twin under elastic
    pricing (per-shard, per-class prices from one vectorized signal call);
  * true runtimes at the chosen allocation come from one AREPAS call
    (kernel K1 on the card) over rows of the trace's skylines, which stay
    resident on the device for the whole run: only (B,) vectors go in;
  * pool accounting / cross-shard lease expiry / cross-shard lease resizing
    are torch updates of the stacked (K, L) lease tables on the device;
  * admission is a vectorized prefix-sum over each shard's policy-ordered
    queue — no per-query Python in the hot loop.

Elastic mode adds lease resizing per rack: when a shard's queued demand
exceeds its free pool, its running leases are shrunk to their current
priced decision (remaining work re-simulated through AREPAS); when a shard
is idle, tokens flow back to its deadline-risk leases. Cost is accrued
exactly across resizes (token-seconds actually leased).

Preemption (``ClusterConfig(preemption=True)``) goes one step further when
shrinking is not enough: running leases of tenants whose dominant share
(DRF over tokens and lease slots) exceeds their fair share are
checkpointed — work-done fraction banked through the same AREPAS
accounting — their tokens released, and the remainders re-queued as fresh
``AllocationRequest``s with ``preempted`` provenance, re-routed with the
preempting rack draining so they can migrate to a less loaded shard.
Token-seconds stay exactly accrued across preempt/resume, and seeded
no-preemption replays are decision-identical to runs without the feature.

Completed queries feed the online refinement loop of their *home* shard's
cache — the paper's "past observed" path — so repeat traffic progressively
bypasses the model wherever it lands, and per-shard utilization, spill
rate, and imbalance land in ``ClusterMetrics``.

``ClusterConfig(fused=True)`` runs admission as one launch of kernel K2 per
epoch on the pool's resident tables, and each elastic shrink or queued
re-price event as one launch of kernel K3 (decision + AREPAS + reprice);
the reports equal the unfused loop's.

An epoch calls one method a phase of ``ClusterSimulator``, in this order,
over one run state (``_Run``) that ``cluster.setup`` builds: ``_complete``,
``_price``, ``_arrive``, ``_shrink``, ``_reprice``, ``_preempt``,
``_admit``, ``_grow``. Tracing: on a recording ``obs``, a run is a
``cluster.setup`` span, one ``cluster.epoch`` span an epoch, each cut into
a span a phase (``cluster.complete`` & co.) that holds the inner spans
(``scheduler.expire``, ``router.route``, ``fabric.decide``,
``cluster_resize_step``, ``cluster_epoch_step``, ``scheduler.admit``,
``scheduler.preempt``), and a ``cluster.report`` span; every host-to-card
sync of the run (K1's and K3's read-backs, the skyline pool's upload, and
those of the pool, the cache and the decides) is counted in
``device_syncs.<site>``, its blocked seconds in ``device_wait_s.<site>``.
Inside ``cluster.setup``, a ``cluster.featurize`` span holds the
featurization of the trace's whole template pool (attributes ``family``,
``jobs`` and ``n_max``, the padded node count of a graph model's inputs, 0
for a vector model's); the model-path decides of the arrive phase count
their rows, operators and adjacency work (``model_rows`` & co.,
``serve/service.py``).

``run_streaming`` feeds the same loop through ``StreamingArrivals``, a
producer thread and a bounded backlog, and decides exactly as ``run``.
``mlops=`` (a ``repro_torch.mlops.MLOpsLoop``) closes the drift-retraining
loop: completions feed its detectors, and a swap repoints the replay at
the freshly warmed service and fabric, folding the retired service's
counters into the report.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.types import AllocationRequest, DecisionContext
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.pcc_cache import HostStage, ShardedPCCCache
from repro_torch.cluster.pool import PoolShards
from repro_torch.cluster.router import Router
from repro_torch.cluster.scheduler import (LeaseView, PriceSignal,
                                           QueueView, deadline_floor,
                                           make_policy)
from repro_torch.core.dataset import ragged_skylines
from repro_torch.core.featurize import batch_graphs, batch_job_features
from repro_torch.kernels.cluster_step import EPOCH_STEP_SUPPORTS_PREEMPTION
from repro_torch.kernels.cluster_step import (RESIZE_ROWS, pack_resize,
                                              unpack_resize)
from repro_torch.kernels.ops import arepas_runtimes, cluster_resize_step
from repro_torch.obs import NULL_OBS, Obs
from repro_torch.serve.service import ShardedAllocationService
from repro_torch.workloads.generator import Trace

__all__ = ["ClusterConfig", "ClusterReport", "ClusterSimulator",
           "StreamingArrivals"]


# ------------------------------------------------------------ arrival sources --
# The epoch loop consumes arrivals through a three-method source protocol:
#   next_arrival() -> earliest undelivered arrival time (None if none left),
#   take_until(now) -> event ids with arrival <= now, arrival order,
#   exhausted()    -> no further events will ever be delivered.
# ``_TraceArrivals`` reads the whole arrival column directly (the classic
# epoch-batched replay); ``StreamingArrivals`` delivers the same events
# through a producer thread and a bounded backlog (the serving-plane shape).
# Both sources hand the epoch loop identical (ids, arrival) prefixes at every
# epoch boundary, so the decision stream is bitwise-identical by
# construction — threading changes *when* events become visible, never
# *which* events an epoch sees.

class _TraceArrivals:
    """Arrival source over a fully materialized (sorted) arrival column."""

    def __init__(self, arrival: np.ndarray):
        self.arrival = arrival
        self.n = int(arrival.size)
        self.next_ev = 0

    def next_arrival(self) -> Optional[float]:
        return (float(self.arrival[self.next_ev])
                if self.next_ev < self.n else None)

    def take_until(self, now: float) -> np.ndarray:
        hi = int(np.searchsorted(self.arrival, now, side="right"))
        ids = np.arange(self.next_ev, hi)
        self.next_ev = hi
        return ids

    def exhausted(self) -> bool:
        return self.next_ev >= self.n


class StreamingArrivals:
    """Event-driven arrival source: a producer thread feeds arrival chunks
    through a bounded ``repro_torch.serve.plane.Backlog``.

    The epoch loop drains by *watermark*: arrivals are monotone, so events with
    arrival <= now are provably all delivered once an event beyond ``now``
    (or exhaustion) has been seen — ``take_until`` pulls chunks exactly
    until then and holds the overshoot for the next epoch. A full backlog
    blocks the producer (backpressure), never drops events; the depth gauge
    and saturation counter come with the Backlog.
    """

    def __init__(self, arrival: np.ndarray, backlog: int = 1024,
                 chunk: int = 64, obs: Optional[Obs] = None):
        from repro_torch.serve.plane import Backlog
        self.n = int(arrival.size)
        self.chunk = max(int(chunk), 1)
        self.backlog = Backlog(max(1, int(backlog) // self.chunk), obs=obs)
        self._held_ids = np.zeros(0, np.int64)
        self._held_arr = np.zeros(0, np.float64)
        self._done = False
        self._thread = threading.Thread(
            target=self._produce, args=(np.asarray(arrival, np.float64),),
            name="streaming-arrivals", daemon=True)
        self._thread.start()

    def _produce(self, arrival: np.ndarray) -> None:
        for lo in range(0, self.n, self.chunk):
            hi = min(lo + self.chunk, self.n)
            self.backlog.put((np.arange(lo, hi), arrival[lo:hi]))
        self.backlog.put(None)           # exhaustion sentinel

    def _pull(self) -> None:
        """Blocking-consume one chunk (or the sentinel) into the held
        buffer."""
        item = self.backlog.get()
        if item is None:
            self._done = True
            return
        ids, arr = item
        self._held_ids = np.concatenate([self._held_ids, ids])
        self._held_arr = np.concatenate([self._held_arr, arr])

    def _fill(self) -> None:
        while not self._held_ids.size and not self._done:
            self._pull()

    def next_arrival(self) -> Optional[float]:
        self._fill()
        return float(self._held_arr[0]) if self._held_ids.size else None

    def exhausted(self) -> bool:
        self._fill()
        return self._done and not self._held_ids.size

    def take_until(self, now: float) -> np.ndarray:
        while not self._done and (not self._held_arr.size
                                  or self._held_arr[-1] <= now):
            self._pull()
        k = int(np.searchsorted(self._held_arr, now, side="right"))
        ids, self._held_ids = self._held_ids[:k], self._held_ids[k:]
        self._held_arr = self._held_arr[k:]
        return ids

    def join(self) -> None:
        self._thread.join()


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    capacity: int = 8192          # fabric-wide token capacity (split over K)
    epoch_s: float = 15.0         # decision-batching window
    max_leases: int = 8192
    use_cache: bool = True        # online PCC refinement + cache-hit path
    admission: str = "priority"   # scheduler policy: "fifo" | "priority" |
                                  # "edf" | "edf_aging" | "drf"
    max_queue: int = 100_000      # admission control: reject beyond this
    # elastic: resize running leases under pressure / idleness. Shrink
    # targets come from the contention PriceSignal even when ``pricing``
    # is "fixed" (that signal *is* the reclaim mechanism), but admission
    # decisions and the reported per-query prices stay neutral then.
    elastic: bool = False
    pricing: str = "fixed"        # "fixed" | "elastic" per-SLA-class price
    price_gamma: float = 16.0     # price slope vs class demand share
    price_cap: float = 16.0       # ceiling on the per-class price
    # sharded fabric: K racks, each owning capacity/K tokens, routed by
    # template-consistent hashing with power-of-two spill under saturation
    n_shards: int = 1
    load_factor: float = 1.25     # router bounded-load factor
    spill_threshold: float = 1.0  # home-load fraction that allows spilling
    router_vnodes: int = 64
    router_seed: int = 0
    # fused epoch kernels (kernels/cluster_step.py): admission runs as one
    # expire->release->admit->scatter launch (K2) on the pool's
    # device-resident lease tables, and each elastic shrink / queued
    # re-price event is one fused decision+AREPAS+reprice launch (K3).
    # Decision-identical to the unfused loop; only the decision-call
    # accounting in service_stats/replica_stats differs.
    fused: bool = False
    # preemption: when a shard's queued demand still exceeds its free pool
    # after elastic shrink, checkpoint running leases of over-share tenants
    # (work-done fraction banked via the same AREPAS accounting resizes
    # use), release their tokens, and re-queue each remainder as a fresh
    # AllocationRequest with ``preempted`` provenance — re-routed by the
    # Router with the preempting rack marked draining, so remainders can
    # land on a less loaded shard. Requires a victim-selecting admission
    # policy (``admission="drf"``).
    preemption: bool = False
    preempt_over_share: float = 1.5   # victim tenants: dominant share over
                                      # this multiple of the 1/T fair share
    preempt_max_per_query: int = 1    # re-preemption cap (anti-thrash: a
                                      # once-resumed lease runs to the end)


@dataclasses.dataclass
class ClusterReport:
    metrics: Dict[str, float]
    n_events: int
    n_epochs: int
    wall_s: float
    events_per_s: float
    cache_stats: Dict[str, int]
    service_stats: Dict[str, int]
    error_series: Tuple[np.ndarray, np.ndarray]
    alloc_errors: np.ndarray          # (n_events,) per-decision error
    cache_hits: np.ndarray            # (n_events,) decision used the cache
    repeats: np.ndarray               # (n_events,) query seen earlier
    replica_stats: Optional[List[Dict[str, int]]] = None  # per-shard traffic

    def summary(self) -> str:
        m = self.metrics
        s = (f"{self.n_events} queries in {self.n_epochs} epochs "
             f"({self.events_per_s:.0f} ev/s wall) | "
             f"util {m.get('utilization', 0):.2f} "
             f"p50/p99 slowdown {m.get('p50_slowdown', 0):.2f}/"
             f"{m.get('p99_slowdown', 0):.2f} | "
             f"SLA viol {m.get('sla_violation_rate', 0):.1%} | "
             f"cost saving {m.get('cost_saving_frac', 0):.1%} | "
             f"cache hit {m.get('cache_hit_rate', 0):.1%}")
        if "spill_rate" in m:
            s += f" | spill {m['spill_rate']:.1%}"
        return s


class _Run:
    """One replay's state, handed to every phase: the trace's columns and
    the per-query state (``*_q``), by query id; the per-shard queues; the
    epoch's clock, lease snapshots and prices. ``ClusterSimulator._setup``
    adds the template pool's columns, the lease ``pool``, the ``metrics``,
    the arrival ``source`` and the counter baselines."""

    def __init__(self, trace: Trace, cfg: ClusterConfig, mlops):
        self.t_wall = time.time()     # the report's wall clock starts
        self.mlops = mlops
        self.cap_shard = cfg.capacity // cfg.n_shards
        self.n = n = len(trace)
        cols = trace.arrays()
        self.arrival = cols["arrival_s"]
        self.jb_all = cols["job_index"]
        self.sla_all = cols["sla"]
        self.tenant_all = cols["tenant"]
        self.deadline_all = cols["deadline_s"]
        self.repeat_all = trace.repeat_mask()
        self.n_classes = len(trace.sla_classes)
        self.priorities = np.array([c.priority for c in trace.sla_classes])
        self.n_tenants = int(self.tenant_all.max()) + 1 if n else 1
        self.defaults = np.array([j.default_tokens for j in trace.jobs],
                                 np.int64)
        self.priced = cfg.pricing == "elastic"
        self.signal = PriceSignal(self.n_classes, cfg.price_gamma,
                                  cfg.price_cap)

        # per-query state, indexed by query id
        self.tok_q = np.zeros(n, np.int64)      # currently leased tokens
        self.perf_q = np.zeros(n, np.int64)     # performance-optimal ask
        self.rt_q = np.zeros(n, np.int64)       # current total-runtime est.
        self.a_q = np.zeros(n, np.float64)      # decision-time PCC params
        self.b_q = np.zeros(n, np.float64)
        self.price_q = np.ones(n, np.float64)   # price paid at decision time
        self.err_q = np.zeros(n, np.float64)
        self.hit_q = np.zeros(n, bool)
        self.start_q = np.zeros(n, np.float64)
        self.end_q = np.zeros(n, np.float64)
        self.cost_q = np.zeros(n, np.float64)   # token-seconds pre-resize
        self.mark_q = np.zeros(n, np.float64)   # last lease-change time
        self.done_q = np.zeros(n, np.float64)   # work done at last change
        self.shard_q = np.zeros(n, np.int64)    # executing shard rank
        self.spill_q = np.zeros(n, bool)        # routed off the home shard
        # preemption provenance: a checkpointed remainder keeps its banked
        # work fraction while queued and restores it at re-admission
        self.resume_done_q = np.zeros(n, np.float64)
        self.preempt_q = np.zeros(n, bool)      # queued as a remainder now
        self.preempt_time_q = np.zeros(n, np.float64)
        self.preempt_count_q = np.zeros(n, np.int64)

        # per-shard pending queues (columnar): query ids in arrival order
        self.queues: List[np.ndarray] = [np.zeros(0, np.int64)
                                         for _ in range(cfg.n_shards)]
        # counters of services an mlops swap retired mid-run, folded in so
        # the report covers the whole replay, not the last model's share
        self.acc_service: Dict[str, int] = {}
        self.acc_replica = [{} for _ in range(cfg.n_shards)]
        self.now = 0.0
        self.n_epochs = 0
        # the price phase's pool.active of every shard and (K, classes)
        # prices; None where no phase reads them
        self.act: Optional[List[Tuple[np.ndarray, ...]]] = None
        self.prices: Optional[np.ndarray] = None


class ClusterSimulator:
    """Discrete-event simulation of one trace against one trained service,
    replicated across ``cfg.n_shards`` racks.

    ``mesh`` (a ``("shard",)`` mesh of ``cfg.n_shards`` ranks) puts the
    fabric's decisions on one rank a shard when no matching ``fabric`` is
    given. The rest of the run — the pool and K2, the PCC cache and K1, the
    elastic resize and K3 — stays unsharded on each rank's device, as the
    reference keeps them off its mesh, so every rank replays the same run
    and reads the same report."""

    def __init__(self, service, cfg: ClusterConfig = ClusterConfig(),
                 fabric: Optional[ShardedAllocationService] = None,
                 obs: Optional[Obs] = None, mesh=None):
        assert cfg.pricing in ("fixed", "elastic"), cfg.pricing
        assert cfg.capacity % cfg.n_shards == 0, \
            (cfg.capacity, cfg.n_shards)
        self.service = service
        self.cfg = cfg
        # default to the service's bundle so Allocator-wired observability
        # follows the simulator without re-plumbing
        self.obs = obs if obs is not None else getattr(service, "obs",
                                                       NULL_OBS)
        self.policy = make_policy(cfg.admission)
        # fused admission lags preemption: the epoch kernel has no preempt
        # phase yet (kernels/cluster_step.py advertises the gap), so a
        # preemptive run falls back — loudly — to the unfused admission
        # loop while elastic resize/re-price events stay fused
        self._fused_admission = cfg.fused
        if cfg.preemption:
            assert hasattr(self.policy, "victims"), (
                "preemption needs a victim-selecting policy (e.g. "
                f"admission='drf'); {cfg.admission!r} has no victims()")
            if cfg.fused and not EPOCH_STEP_SUPPORTS_PREEMPTION:
                warnings.warn(
                    "ClusterConfig(fused=True, preemption=True): the fused "
                    "epoch kernel has no preempt phase; admission falls "
                    "back to the unfused loop (elastic resize stays fused)",
                    RuntimeWarning, stacklevel=2)
                self._fused_admission = False
        self.router = Router(cfg.n_shards, n_vnodes=cfg.router_vnodes,
                             load_factor=cfg.load_factor,
                             spill_threshold=cfg.spill_threshold,
                             seed=cfg.router_seed, obs=self.obs)
        # reuse a caller-built fabric (e.g. the Allocator's) when its shard
        # count matches; otherwise build one over the given mesh
        if fabric is not None and fabric.n_shards == cfg.n_shards \
                and fabric.service is service:
            self.fabric = fabric
        else:
            self.fabric = ShardedAllocationService(service, cfg.n_shards,
                                                   mesh)
        # everything the run keeps on a device lives on the service's
        self.device = service.device
        # the refits' upload stage, shared by the caches of every run()
        self._refit_stage = HostStage(self.device)
        # rebuilt per run(): cache keys are trace-local unique-query indices
        self.cache = ShardedPCCCache(cfg.n_shards, device=self.device,
                                     obs=self.obs, stage=self._refit_stage)
        self._sky = self._lens = None     # the run's resident skyline pool
        self._stage = None                # K3's input staging buffer

    # ---------------------------------------------------------- precompute --
    def _pool_inputs(self, trace: Trace) -> Dict[str, np.ndarray]:
        """Model inputs for every unique query, gatherable by job index."""
        if self.service.model.family == "gnn":
            gf, ga, gm = batch_graphs(trace.jobs)
            return {"features": gf, "adj": ga, "mask": gm}
        return {"features": batch_job_features(trace.jobs)}

    def _skyline_pool(self, trace: Trace
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Put the run's resident skyline pool on the device and return
        every template's valid seconds (int32), peak (int64) and area
        (float64) from the host. The skylines stay on the device for the
        whole run, where AREPAS calls read their rows by (B,) unique-query
        index: a (U, Smax) int32 pool, each row its skyline's seconds then
        zeros, scattered on the device from the seconds uploaded one
        skyline after another."""
        values, offsets = ragged_skylines(trace.skylines)
        lens = np.diff(offsets).astype(np.int32)
        U, smax, total = len(lens), int(lens.max()), int(offsets[-1])
        peaks = np.zeros(U, np.int64)
        areas = np.zeros(U, np.float64)
        full = lens > 0
        if total:
            # reduceat reads one second of an empty skyline: skip those
            at = offsets[:-1][full]
            peaks[full] = np.maximum.reduceat(values, at)
            areas[full] = np.add.reduceat(values, at, dtype=np.float64)
        with self.obs.device_wait("skylines", 2):
            d_values = torch.from_numpy(values).to(self.device)
            self._lens = torch.from_numpy(lens).to(self.device)
        self.obs.metrics.counter("setup_upload_bytes").inc(
            values.nbytes + lens.nbytes)
        # each second's flat place in the pool: its row's start there less
        # its row's start in ``values``, plus its own place in ``values``
        d_lens = self._lens.long()
        shift = (torch.arange(U, device=self.device) * smax
                 - (torch.cumsum(d_lens, 0) - d_lens))
        dest = torch.repeat_interleave(shift, d_lens, output_size=total)
        dest += torch.arange(total, device=self.device)
        self._sky = torch.zeros((U, smax), dtype=torch.int32,
                                device=self.device)
        self._sky.view(-1)[dest] = d_values
        return lens, peaks, areas

    def _rows(self, jb: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(jb, np.int64)).to(self.device)

    def _true_runtimes(self, jb: np.ndarray,
                       tokens: np.ndarray) -> np.ndarray:
        """Batched AREPAS (kernel K1 on the card): runtime of each query
        (unique-query index ``jb``) at its chosen allocation, read from the
        resident skyline pool."""
        allocs = np.maximum(np.asarray(tokens, np.int64), 1).astype(np.int32)
        with self.obs.device_wait("k1.in", 2):
            d_allocs = torch.from_numpy(allocs[:, None]).to(self.device)
            rows = self._rows(jb)
        rt = arepas_runtimes(self._sky, self._lens, d_allocs, rows=rows)
        with self.obs.device_wait("k1.out"):
            rt = rt.cpu().numpy()[:, 0]
        return np.maximum(rt.astype(np.int64), 1)

    # ----------------------------------------------------------------- run --
    def run(self, trace: Trace, *, mlops=None) -> ClusterReport:
        """Epoch-batched replay: the whole arrival column drives the loop.

        ``mlops`` (a ``repro_torch.mlops.MLOpsLoop``) closes the
        drift-retraining loop: every completion batch feeds its detectors
        and training buffer, and when the trigger policy fires the loop
        refits, warms and hot-swaps a new model — the replay then
        continues against the swapped-in service/fabric with zero hot-path
        builds."""
        return self._run(trace, _TraceArrivals, mlops=mlops)

    def run_streaming(self, trace: Trace, *, backlog: int = 1024,
                      chunk: int = 64, mlops=None) -> ClusterReport:
        """Event-driven replay: arrivals are fed one chunk at a time by a
        producer thread through a bounded backlog (the serving-plane
        admission shape), and each epoch drains every event at or before
        its boundary by watermark. Decision-identical to ``run`` on the
        same trace — the two differ only in how events become visible.
        ``mlops`` attaches the drift-retraining loop (see ``run``)."""
        return self._run(trace, lambda arrival: StreamingArrivals(
            arrival, backlog=backlog, chunk=chunk, obs=self.obs),
            mlops=mlops)

    def _run(self, trace: Trace, make_source, mlops=None) -> ClusterReport:
        with self.obs.tracer.phases() as stage:
            return self._replay(trace, make_source, mlops, stage)

    def _replay(self, trace: Trace, make_source, mlops,
                stage) -> ClusterReport:
        """The replay behind ``run`` and ``run_streaming``: ``stage`` opens
        its ``cluster.setup`` and ``cluster.report`` spans, and each epoch
        is a ``cluster.epoch`` span cut into a span a phase (none for a
        phase the configuration turns off)."""
        stage("cluster.setup")
        run = self._setup(trace, make_source, mlops)
        stage.close()
        cfg, o, tr = self.cfg, self.obs, self.obs.tracer
        # local work is checked before the source so a streaming source's
        # (blocking) exhausted() is only consulted when the fabric would
        # otherwise go idle — exactly when waiting on the producer is right
        while any(q.size for q in run.queues) or run.pool.n_active \
                or not run.source.exhausted():
            with tr.span("cluster.epoch"), tr.phases() as phase:
                # advance: one epoch, or jump an idle gap to the next event
                targets = []
                na = run.source.next_arrival()
                if na is not None:
                    targets.append(na)
                if run.pool.n_active:
                    targets.append(run.pool.next_expiry())
                run.now = max(run.now + cfg.epoch_s,
                              min(targets) if targets else run.now)
                run.n_epochs += 1

                phase("cluster.complete")
                self._complete(run)
                phase("cluster.price")
                self._price(run)
                phase("cluster.arrive")
                ids = self._arrive(run)
                if cfg.elastic:
                    phase("cluster.shrink")
                    self._shrink(run)
                if run.priced and any(q.size for q in run.queues):
                    phase("cluster.reprice")
                    self._reprice(run)
                if cfg.preemption:
                    phase("cluster.preempt")
                    self._preempt(run)
                phase("cluster.admit")
                self._admit(run)
                if cfg.elastic:
                    phase("cluster.grow")
                    self._grow(run)
                phase.close()

                epoch_errs = run.err_q[ids] if ids.size else np.zeros(0)
                qd = int(sum(q.size for q in run.queues))
                in_use = run.pool.in_use
                run.metrics.sample_epoch(run.now, qd, int(in_use.sum()),
                                         epoch_errs, in_use_shard=in_use)
                if tr.enabled:   # per-shard counter lanes for Perfetto
                    tr.sample("pool_in_use",
                              **{f"shard{k}": int(in_use[k])
                                 for k in range(cfg.n_shards)})
                    tr.sample("queue_depth",
                              **{f"shard{k}": int(run.queues[k].size)
                                 for k in range(cfg.n_shards)})
                    tr.point("epoch", t_sim=run.now, arrived=int(ids.size))
                g = o.metrics.gauge("queue_depth_peak")
                g.set(max(g.value, qd))

        stage("cluster.report")
        return self._report(run)

    def _setup(self, trace: Trace, make_source, mlops) -> _Run:
        """The run's state: the trace's columns, the template pool's model
        inputs and skylines (resident on the device), the exact-history
        oracle, an empty lease pool and the arrival source."""
        cfg, o, tr = self.cfg, self.obs, self.obs.tracer
        K = cfg.n_shards
        if mlops is not None:
            assert mlops.allocator.service is self.service, \
                "mlops loop must wrap the allocator driving this simulator"
            assert mlops.allocator.n_shards == K, \
                "mlops allocator fabric must match ClusterConfig.n_shards"
            mlops.begin_run(trace)
        # keys are indices into *this* trace's pool
        self.cache = ShardedPCCCache(K, device=self.device, obs=o,
                                     stage=self._refit_stage)
        run = _Run(trace, cfg, mlops)
        # the fabric (and its wrapped service) may be shared across runs —
        # Allocator reuse, shared test fixtures — so report both counter
        # families as this run's delta, not the lifetime totals
        run.replica_stats0 = self.fabric.replica_stats()
        run.service_stats0 = dict(self.service.stats)
        # install this run's bundle on the (possibly shared) service so
        # fabric.decide spans/latency land with the simulator's records
        run.prev_obs, self.service.obs = self.service.obs, o

        U = len(trace.jobs)
        with tr.span("cluster.featurize", family=self.service.model.family,
                     jobs=U) as sp:
            run.model_pool = self._pool_inputs(trace)
            if sp is not None:
                sp.attrs["n_max"] = (int(run.model_pool["mask"].shape[-1])
                                     if "mask" in run.model_pool else 0)
        run.lens, run.peaks, run.areas = self._skyline_pool(trace)
        # home shard rank of every template: the consistent-hash assignment
        # that pins a recurring script to one cache shard for the whole run
        run.home_u = self.router.rank(self.router.home(np.arange(U)))

        # exact-history oracle: the decision the policy makes from the true
        # per-query PCC (what a fully warmed cache converges to)
        oracle_cache = ShardedPCCCache(K, device=self.device, obs=o,
                                       stage=self._refit_stage)
        a_ex, b_ex = oracle_cache.refine_batch(
            run.home_u, np.arange(U), self._sky, self._lens, run.defaults,
            run.peaks, rows=np.arange(U), areas=run.areas)
        run.oracle = np.minimum(
            self.service.decide(AllocationRequest(
                a=a_ex, b=b_ex, observed_tokens=run.defaults)).tokens,
            run.cap_shard).astype(np.int64)

        run.pool = PoolShards(run.cap_shard, K, cfg.max_leases,
                              device=self.device, obs=o)
        run.metrics = ClusterMetrics(
            cfg.capacity,
            np.array([c.slowdown_limit for c in trace.sla_classes]),
            n_shards=K, capacity_per_shard=run.cap_shard)
        run.source = make_source(run.arrival)
        return run

    def _report(self, run: _Run) -> ClusterReport:
        """Close the run and report its metrics and counter deltas."""
        wall = time.time() - run.t_wall
        if hasattr(run.source, "join"):  # streaming: producer has sent all
            run.source.join()
        self.service.obs = run.prev_obs
        self._sky = self._lens = None
        o = self.obs
        o.metrics.counter("epochs").inc(run.n_epochs)
        o.metrics.counter("rejected").inc(int(run.metrics.n_rejected))
        report = run.metrics.report()
        # replay rate: queries fully processed (completed or rejected) / wall
        n_processed = report.get("n_completed", 0) + report.get("n_rejected", 0)
        service_delta, replica_delta = self._stats_delta(run)
        return ClusterReport(
            metrics=report, n_events=run.n, n_epochs=run.n_epochs,
            wall_s=round(wall, 3),
            events_per_s=round(n_processed / max(wall, 1e-9), 1),
            cache_stats=dict(self.cache.stats),
            service_stats=service_delta,
            error_series=run.metrics.error_series(),
            alloc_errors=run.err_q, cache_hits=run.hit_q,
            repeats=run.repeat_all, replica_stats=replica_delta)

    def _stats_delta(self, run: _Run
                     ) -> Tuple[Dict[str, int], List[Dict[str, int]]]:
        """The service's and each replica's counters since the run's
        baselines, plus those folded in from services retired mid-run."""
        def fold(stats, base, acc):
            d = {k: v - base.get(k, 0) for k, v in stats.items()}
            for k, v in acc.items():
                d[k] = d.get(k, 0) + v
            return d
        return (fold(self.service.stats, run.service_stats0, run.acc_service),
                [fold(*c) for c in zip(self.fabric.replica_stats(),
                                       run.replica_stats0, run.acc_replica)])

    # -------------------------------------------------------------- phases --
    def _complete(self, run: _Run) -> None:
        """Lease expiry (one kernel over every shard) -> completions ->
        refinement into each template's *home* cache shard; the completion
        batch feeds an attached mlops loop."""
        o, tr, now = self.obs, self.obs.tracer, run.now
        with tr.span("scheduler.expire"):
            done_sh, done_ids, _ = run.pool.expire(now)
        if not done_ids.size:
            return
        tr.point("lease.complete", n=int(done_ids.size), t_sim=now)
        o.metrics.counter("completed").inc(int(done_ids.size))
        jb = run.jb_all[done_ids]
        fin = run.end_q[done_ids]
        start = run.start_q[done_ids]
        tok = run.tok_q[done_ids]
        run.metrics.record_completions(
            arrival_s=run.arrival[done_ids], start_s=start,
            finish_s=fin, tokens=tok,
            default_tokens=run.defaults[jb],
            runtime_s=np.round(fin - start).astype(np.int64),
            ideal_runtime_s=run.lens[jb], sla=run.sla_all[done_ids],
            tenant=run.tenant_all[done_ids],
            cache_hit=run.hit_q[done_ids],
            repeat=run.repeat_all[done_ids],
            alloc_error=run.err_q[done_ids],
            cost_token_s=(run.cost_q[done_ids]
                          + tok * (fin - run.mark_q[done_ids])),
            price=run.price_q[done_ids],
            slack_s=run.deadline_all[done_ids] - fin,
            shard=done_sh, spilled=run.spill_q[done_ids])
        if self.cfg.use_cache:
            fresh = np.unique(jb[self.cache.missing(run.home_u[jb], jb)])
            if fresh.size:
                self.cache.refine_batch(
                    run.home_u[fresh], fresh, self._sky, self._lens,
                    run.defaults[fresh], run.peaks[fresh], rows=fresh,
                    areas=run.areas[fresh])
        if run.mlops is None:
            return
        # feed the drift-retraining loop this completion batch:
        # decision-time predicted runtime vs realized runtime, plus the
        # completed queries' feature view
        pred = run.b_q[done_ids] * np.maximum(tok, 1).astype(np.float64) \
            ** run.a_q[done_ids]
        feats = np.stack(
            [np.log1p(run.areas[jb]),
             np.log1p(run.peaks[jb].astype(np.float64)),
             np.log1p(run.defaults[jb].astype(np.float64)),
             np.log1p(run.lens[jb].astype(np.float64))], axis=1)
        if run.mlops.on_completions(
                now=now, job_index=jb, features=feats, predicted_s=pred,
                actual_s=fin - start, model_mask=~run.hit_q[done_ids]):
            self._swap(run)

    def _swap(self, run: _Run) -> None:
        """The mlops loop swapped in a freshly-warmed stack: fold the
        retired service's counters into the run's accumulators, re-point,
        re-baseline, and demote cache curves refined under the old
        model."""
        run.acc_service, run.acc_replica = self._stats_delta(run)
        self.service.obs = run.prev_obs     # retire cleanly
        self.service = run.mlops.allocator.service
        self.fabric = run.mlops.allocator.fabric
        run.prev_obs, self.service.obs = self.service.obs, self.obs
        run.service_stats0 = dict(self.service.stats)
        run.replica_stats0 = self.fabric.replica_stats()
        self.cache.bump_model_version(run.mlops.allocator.model_version)

    def _price(self, run: _Run) -> None:
        """Per-(shard, SLA-class) price signal from leased + queued demand
        — one vectorized call over the whole fabric (the lease-table
        snapshots are only needed on elastic paths)."""
        run.act = run.prices = None
        if not (run.priced or self.cfg.elastic):
            return
        run.act = [run.pool.active(k) for k in range(self.cfg.n_shards)]
        leased_cls = np.stack([
            np.bincount(run.sla_all[ids], weights=tok,
                        minlength=run.n_classes) for ids, tok, _ in run.act])
        queued_cls = np.stack([
            np.bincount(run.sla_all[q], weights=run.tok_q[q],
                        minlength=run.n_classes) for q in run.queues])
        run.prices = run.signal.prices(leased_cls, run.cap_shard, queued_cls)

    def _arrive(self, run: _Run) -> np.ndarray:
        """Arrivals in this epoch -> routing -> one fabric-wide batch of
        allocation decisions. Returns the arrived query ids."""
        o, now = self.obs, run.now
        ids = run.source.take_until(now)
        total_queued = int(sum(q.size for q in run.queues))
        if ids.size and total_queued + ids.size > self.cfg.max_queue:
            keep = max(self.cfg.max_queue - total_queued, 0)
            run.metrics.n_rejected += ids.size - keep
            ids = ids[:keep]
        if not ids.size:
            return ids
        jb = run.jb_all[ids]
        obs = run.defaults[jb]
        exec_r = self._route(run, ids)
        tokens = np.zeros(ids.size, np.int64)
        a_dec = np.zeros(ids.size, np.float64)
        b_dec = np.zeros(ids.size, np.float64)
        if self.cfg.use_cache:
            hit, a_c, b_c = self.cache.lookup(run.home_u[jb], jb,
                                              areas=run.areas[jb])
        else:
            hit = np.zeros(ids.size, bool)
        o.metrics.counter("cache_hit").inc(int(hit.sum()))
        o.metrics.counter("cache_miss").inc(int(ids.size) - int(hit.sum()))
        if np.any(hit):      # exact-history path: policy twin only
            tokens[hit] = self.fabric.decide(
                AllocationRequest(a=a_c[hit], b=b_c[hit],
                                  observed_tokens=obs[hit]),
                DecisionContext(shard_of=exec_r[hit])).tokens
            a_dec[hit] = a_c[hit]
            b_dec[hit] = b_c[hit]
        miss = ~hit
        if np.any(miss):     # cold path: fused model+policy kernel
            model_in = {k: v[jb[miss]] for k, v in run.model_pool.items()}
            res = self.fabric.decide(
                AllocationRequest(model_in=model_in,
                                  observed_tokens=obs[miss]),
                DecisionContext(shard_of=exec_r[miss]))
            tokens[miss] = res.tokens
            a_dec[miss] = res.a
            b_dec[miss] = res.b
        perf = np.minimum(tokens, run.cap_shard)
        if run.priced:   # re-price the whole epoch batch at once
            p = run.prices[exec_r, run.sla_all[ids]]
            floor = self._deadline_floor(run, a_dec, b_dec,
                                         run.deadline_all[ids] - now, perf)
            tokens = self._priced_decide(
                run, AllocationRequest(a=a_dec, b=b_dec,
                                       observed_tokens=obs),
                p, exec_r, floor)
            run.price_q[ids] = p
        else:
            tokens = perf
        run.tok_q[ids] = tokens
        o.metrics.histogram("price_at_decision", lo=1e-3,
                            hi=1e3).record_many(run.price_q[ids])
        run.perf_q[ids] = perf
        run.a_q[ids] = a_dec
        run.b_q[ids] = b_dec
        run.hit_q[ids] = hit
        run.err_q[ids] = (np.abs(perf - run.oracle[jb])
                          / np.maximum(run.oracle[jb], 1))
        run.rt_q[ids] = self._true_runtimes(jb, tokens)
        return ids

    def _shrink(self, run: _Run) -> None:
        """Elastic shrink: shards whose queued demand exceeds their free
        pool reclaim from running leases — one priced re-decision and one
        cross-shard resize for all of them."""
        now = run.now
        rows_ids, rows_sh = [], []
        for k in range(self.cfg.n_shards):
            act_ids = run.act[k][0]
            if act_ids.size and run.queues[k].size \
                    and int(np.sum(run.tok_q[run.queues[k]])) \
                    > run.pool.free[k]:
                rows_ids.append(act_ids)
                rows_sh.append(np.full(act_ids.size, k, np.int64))
        if not rows_ids:
            return
        cand = np.concatenate(rows_ids)
        cand_sh = np.concatenate(rows_sh)
        cand_tok = run.tok_q[cand]
        # deadline guard: the shrunk lease's predicted *total* runtime must
        # keep the remaining work inside the slack
        done = self._work_done(run, cand)
        rt_budget = (run.deadline_all[cand] - now) / (1.0 - done)
        # re-price running leases at current contention; shrink those whose
        # priced ask fell below their lease
        tgt, sel, rt_new, new_end = self._redecide(
            run, cand, cand_sh, run.prices[cand_sh, run.sla_all[cand]],
            rt_budget, cand_tok, done)
        if not np.any(sel):
            return
        sids, new_tok = cand[sel], tgt[sel]
        self._apply_resize(
            run, cand_sh[sel], sids, new_tok,
            None if rt_new is None else (rt_new[sel], new_end[sel]))
        run.metrics.record_resizes(
            shrunk=sids.size, reclaimed=int(np.sum(cand_tok[sel] - new_tok)))
        self.obs.tracer.point("lease.resize", t_sim=now,
                              shrunk=int(sids.size))
        self.obs.metrics.counter("leases_shrunk").inc(int(sids.size))
        if run.priced:   # fixed pricing reports neutral prices
            run.price_q[sids] = run.prices[cand_sh[sel], run.sla_all[sids]]

    def _reprice(self, run: _Run) -> None:
        """Re-price stale queued decisions: a query that decided at a
        burst-peak (or calm-trough) price keeps neither its starved nor its
        oversized ask once the class price moves materially — re-decide
        tokens and runtime for the changed subset so EDF slack and
        admission see current prices."""
        all_q = np.concatenate([q for q in run.queues if q.size])
        pq = run.prices[run.shard_q[all_q], run.sla_all[all_q]]
        moved = np.abs(pq - run.price_q[all_q]) > 0.25 * run.price_q[all_q]
        if not np.any(moved):
            return
        rq, p = all_q[moved], pq[moved]
        # queued: nothing done yet, the lease fields are unused
        toks, _, rts, _ = self._redecide(
            run, rq, run.shard_q[rq], p, run.deadline_all[rq] - run.now,
            run.perf_q[rq], np.zeros(rq.size))
        if rts is None:
            rts = self._true_runtimes(run.jb_all[rq], toks)
        run.tok_q[rq] = toks
        run.rt_q[rq] = rts
        run.price_q[rq] = p

    def _preempt(self, run: _Run) -> None:
        """Preemption: a shard whose queued demand still exceeds its free
        pool after elastic shrink checkpoints running leases of over-share
        tenants. Victim order comes from the policy's victims() (DRF:
        most-over-share tenant's youngest lease first); the minimal prefix
        covering the shortfall is preempted. Each victim's work-done
        fraction is banked (same AREPAS accounting as resizes), its tokens
        released, and the remainder re-decided under a fresh
        DecisionContext and re-routed with the preempting rack marked
        draining — cross-shard migration when a second hash choice is less
        loaded."""
        cfg, o, tr, now = self.cfg, self.obs, self.obs.tracer, run.now
        vic_ids_l, vic_sh_l = [], []
        for k in range(cfg.n_shards):
            if not run.queues[k].size:
                continue
            need = (int(np.sum(run.tok_q[run.queues[k]]))
                    - int(run.pool.free[k]))
            if need <= 0:
                continue
            act_ids, act_tok, act_end = run.pool.active(k)
            if not act_ids.size:
                continue
            shares = self._tenant_shares(run, act_ids, act_tok)
            over = shares > cfg.preempt_over_share / run.n_tenants
            v_ten = run.tenant_all[act_ids]
            elig_v = (over[v_ten]
                      & ((act_end - now) > cfg.epoch_s)
                      & (run.preempt_count_q[act_ids]
                         < cfg.preempt_max_per_query))
            if not np.any(elig_v):
                continue
            view = LeaseView(
                ids=act_ids[elig_v], tokens=act_tok[elig_v],
                start_s=run.mark_q[act_ids[elig_v]],
                tenant=v_ten[elig_v], share=shares[v_ten[elig_v]])
            order = self.policy.victims(view)
            cum = np.cumsum(view.tokens[order])
            j = min(int(np.searchsorted(cum, need)) + 1, order.size)
            pick = order[:j]
            vic_ids_l.append(view.ids[pick])
            vic_sh_l.append(np.full(pick.size, k, np.int64))
        if not vic_ids_l:
            return
        vids = np.concatenate(vic_ids_l)
        vsh = np.concatenate(vic_sh_l)
        with tr.span("scheduler.preempt", n=int(vids.size)):
            done = self._work_done(run, vids)
            freed = run.pool.preempt_batch(vsh, vids)
        # checkpoint: accrue the leased segment's cost, bank the work
        # fraction, stamp provenance
        run.cost_q[vids] += run.tok_q[vids] * (now - run.mark_q[vids])
        run.done_q[vids] = done
        run.mark_q[vids] = now
        run.resume_done_q[vids] = done
        run.preempt_q[vids] = True
        run.preempt_time_q[vids] = now
        run.preempt_count_q[vids] += 1
        n_freed = int(freed.sum())
        run.metrics.record_preemptions(count=vids.size, tokens=n_freed)
        tr.point("lease.preempt", n=int(vids.size), t_sim=now)
        o.metrics.counter("preemptions_total").inc(int(vids.size))
        o.metrics.counter("preempted_tokens_reclaimed").inc(n_freed)
        # re-route the remainders with post-release load and the preempting
        # shards draining, then re-decide tokens for the remaining work
        # under the target shard's price
        drain = np.zeros(cfg.n_shards, bool)
        drain[np.unique(vsh)] = True
        exec_r = self._route(run, vids, drain=drain)
        jb = run.jb_all[vids]
        req = AllocationRequest(
            a=run.a_q[vids], b=run.b_q[vids],
            observed_tokens=run.defaults[jb], sla=run.sla_all[vids],
            deadline_s=run.deadline_all[vids],
            preempted=np.ones(vids.size, bool))
        if run.priced:
            p = run.prices[exec_r, run.sla_all[vids]]
            # the floor budgets the *remaining* slack against the remaining
            # work fraction
            floor = self._deadline_floor(
                run, req.a, req.b,
                (run.deadline_all[vids] - now) / (1.0 - done),
                run.perf_q[vids])
            toks = self._priced_decide(run, req, p, exec_r, floor)
            run.price_q[vids] = p
        else:
            toks = np.minimum(self.fabric.decide(
                req, DecisionContext(shard_of=exec_r)).tokens, run.cap_shard)
        run.tok_q[vids] = toks
        run.rt_q[vids] = self._true_runtimes(jb, toks)

    def _admit(self, run: _Run) -> None:
        """Admission: per shard, a vectorized prefix over its policy-ordered
        queue. Fused admission packs every eligible shard's ordered queue
        head into one (K, Q) matrix and runs the whole fabric's admission +
        lease scatter as a single kernel launch (K2) on the pool's resident
        device tables; the eligibility gate (non-empty queue AND free
        tokens) matches the host loop exactly — an ineligible shard's queue
        is *not* reordered this epoch, which later lexsorts observe."""
        cfg, o, tr, now = self.cfg, self.obs, self.obs.tracer, run.now
        K = cfg.n_shards
        elig = [k for k in range(K)
                if run.queues[k].size and run.pool.free[k] > 0]
        needs_shares = getattr(self.policy, "needs_shares", False)
        for k in elig:
            q_ids = run.queues[k]
            # a queued remainder's slack budgets only the work it has left,
            # not a from-scratch run
            rt_eff = self._runtime_left(run, q_ids)
            extra: Dict = {}
            if needs_shares:
                act_ids_k, act_tok_k, _ = run.pool.active(k)
                shares = self._tenant_shares(run, act_ids_k, act_tok_k)
                extra = dict(tenant=run.tenant_all[q_ids],
                             tenant_share=shares)
            view = QueueView(
                ids=q_ids, arrival_s=run.arrival[q_ids],
                priority=run.priorities[run.sla_all[q_ids]],
                slack_s=run.deadline_all[q_ids] - (now + rt_eff),
                now=now, **extra)
            run.queues[k] = q_ids[self.policy.order(view)]
        n_granted = 0
        if self._fused_admission and elig:
            # an admitted prefix holds >= 1 token per query, so no prefix
            # extends past cap_shard entries — bound Q by it
            Qp = min(max(run.queues[k].size for k in elig), run.cap_shard)
            q_ids_m = np.full((K, Qp), -1, np.int64)
            q_tok_m = np.zeros((K, Qp), np.int64)
            q_end_m = np.zeros((K, Qp), np.float64)
            for k in elig:
                q = run.queues[k][:Qp]
                q_ids_m[k, :q.size] = q
                q_tok_m[k, :q.size] = run.tok_q[q]
                q_end_m[k, :q.size] = now + run.rt_q[q]
            # pool.admit_epoch reads the kernel outputs back to host, so the
            # span closes at device completion, not dispatch
            with tr.span("cluster_epoch_step", fused=True, Q=int(Qp)):
                n_adm = run.pool.admit_epoch(now, q_ids_m, q_tok_m, q_end_m)
            for k in elig:
                j = int(n_adm[k])
                if j:
                    self._grant(run, k, j)
                    n_granted += j
        else:
            with tr.span("scheduler.admit", shards=len(elig)):
                for k in elig:
                    fits = (np.cumsum(run.tok_q[run.queues[k]])
                            <= run.pool.free[k])
                    j = int(np.searchsorted(~fits, True))  # the True prefix
                    if j:
                        adm = self._grant(run, k, j)
                        run.pool.acquire_batch(k, adm, run.tok_q[adm],
                                               run.end_q[adm])
                        n_granted += j
        if n_granted:
            tr.point("lease.grant", n=n_granted, t_sim=now)
            o.metrics.counter("admitted").inc(n_granted)

    def _grow(self, run: _Run) -> None:
        """Elastic grow: a shard with an empty queue and idle tokens feeds
        running leases projected to miss their deadline (growing anything
        else buys runtime nobody asked for at a strictly higher cost),
        most-at-risk first — the resizes of every shard land in one
        cross-shard kernel."""
        now = run.now
        g_sh, g_ids, g_tok = [], [], []
        for k in range(self.cfg.n_shards):
            if run.queues[k].size or run.pool.free[k] <= 0:
                continue
            act_ids, act_tok, act_end = run.pool.active(k)
            want = run.perf_q[act_ids] - act_tok
            cand = ((want > 0) & ((act_end - now) > self.cfg.epoch_s)
                    & (act_end > run.deadline_all[act_ids]))
            if not np.any(cand):
                continue
            cids, cwant = act_ids[cand], want[cand]
            order = np.argsort(run.deadline_all[cids] - act_end[cand],
                               kind="stable")
            cids, cwant = cids[order], cwant[order]
            fits = np.cumsum(cwant) <= run.pool.free[k]
            j = int(np.searchsorted(~fits, True))
            if j:
                g_sh.append(np.full(j, k, np.int64))
                g_ids.append(cids[:j])
                g_tok.append(run.tok_q[cids[:j]] + cwant[:j])
        if not g_ids:
            return
        gids = np.concatenate(g_ids)
        new_tok = np.concatenate(g_tok)
        granted = int(np.sum(new_tok - run.tok_q[gids]))
        self._apply_resize(run, np.concatenate(g_sh), gids, new_tok)
        run.metrics.record_resizes(grown=gids.size, granted=granted)
        self.obs.tracer.point("lease.resize", t_sim=now, grown=int(gids.size))
        self.obs.metrics.counter("leases_grown").inc(int(gids.size))

    # ------------------------------------------------ decisions they share --
    def _route(self, run: _Run, ids: np.ndarray,
               drain: Optional[np.ndarray] = None) -> np.ndarray:
        """Place queries ``ids`` and queue them there (the caller sets their
        tokens and runtimes): home-consistent hashing; a saturated home
        rack (projected demand over capacity) or a ``drain``ed one spills
        to the less loaded of two choices — cross-shard spill is the
        exception, cache affinity the rule. Returns their shard ranks."""
        queued = np.array([int(np.sum(run.tok_q[q])) for q in run.queues],
                          np.float64)
        load = (run.pool.in_use + queued) / run.cap_shard
        exec_sh, spilled = self.router.route(run.jb_all[ids], load,
                                             drain=drain)
        exec_r = self.router.rank(exec_sh)
        run.shard_q[ids] = exec_r
        run.spill_q[ids] = spilled
        for k in np.unique(exec_r):
            run.queues[k] = np.concatenate([run.queues[k], ids[exec_r == k]])
        return exec_r

    @staticmethod
    def _deadline_floor(run: _Run, a: np.ndarray, b: np.ndarray,
                        rt_budget: np.ndarray, perf: np.ndarray
                        ) -> np.ndarray:
        """Least tokens whose predicted runtime fits ``rt_budget``, at most
        the performance ask ``perf`` (past it nothing helps). A certain
        miss — non-positive slack — is counted, not floored at the cap."""
        floor, miss = deadline_floor(a, b, rt_budget, perf)
        nm = int(np.count_nonzero(miss))
        if nm:
            run.metrics.record_certain_miss(nm)
        return floor

    def _priced_decide(self, run: _Run, req: AllocationRequest,
                       price: np.ndarray, shard_of: np.ndarray,
                       floor: np.ndarray) -> np.ndarray:
        """Tokens of one priced fabric decision, capped at a shard's
        capacity and floored so no query is priced into a predicted
        deadline miss."""
        tokens = np.minimum(self.fabric.decide(
            req, DecisionContext(price=price, shard_of=shard_of)).tokens,
            run.cap_shard)
        return np.maximum(tokens, floor)

    def _redecide(self, run: _Run, qids: np.ndarray, shard_of: np.ndarray,
                  price: np.ndarray, rt_budget: np.ndarray,
                  perf: np.ndarray, done: np.ndarray):
        """Priced re-decision of leased or queued queries ``qids`` with
        ``done`` of their work behind them, floored at the deadline: one
        launch of K3 (decision + AREPAS + reprice) when fused, a priced
        fabric decide otherwise. Returns (tokens, shrink selection,
        runtime, new end); the last two are None off K3, where the caller
        runs K1 on the rows it keeps."""
        floor = self._deadline_floor(run, run.a_q[qids], run.b_q[qids],
                                     rt_budget, perf)
        jb = run.jb_all[qids]
        cur_tok, cur_end = run.tok_q[qids], run.end_q[qids]
        if self.cfg.fused:
            return self._fused_resize(
                run.a_q[qids], run.b_q[qids], price, run.defaults[jb], floor,
                done, cur_tok, cur_end, jb, run.now, run.cap_shard)
        tgt = self._priced_decide(
            run, AllocationRequest(a=run.a_q[qids], b=run.b_q[qids],
                                   observed_tokens=run.defaults[jb]),
            price, shard_of, floor)
        sel = (tgt < cur_tok) & ((cur_end - run.now) > self.cfg.epoch_s)
        return tgt, sel, None, None

    def _grant(self, run: _Run, k: int, j: int) -> np.ndarray:
        """Start the first ``j`` queries of shard ``k``'s queue at ``now``
        and take them off it. Returns their ids."""
        now = run.now
        adm = run.queues[k][:j]
        run.queues[k] = run.queues[k][j:]
        # a resumed remainder keeps its original start and banked work; its
        # new lease runs only the remaining fraction
        res = run.preempt_q[adm]
        run.start_q[adm[~res]] = now
        run.done_q[adm] = np.where(res, run.resume_done_q[adm], 0.0)
        run.mark_q[adm] = now
        run.end_q[adm] = now + self._runtime_left(run, adm)
        if np.any(res):
            self.obs.metrics.histogram(
                "requeue_wait_sim_s", lo=1e-3,
                hi=1e6).record_many(now - run.preempt_time_q[adm[res]])
            run.preempt_q[adm] = False
        self.obs.metrics.histogram(
            "admission_wait_sim_s", lo=1e-3,
            hi=1e6).record_many(now - run.arrival[adm])
        return adm

    @staticmethod
    def _runtime_left(run: _Run, ids: np.ndarray) -> np.ndarray:
        """Runtime queued queries ``ids`` need once admitted: their whole
        estimate, or a preempted remainder's share of it left."""
        rt = run.rt_q[ids].astype(np.float64)
        res = run.preempt_q[ids]
        if np.any(res):
            rt[res] = np.maximum(
                np.round(rt[res] * (1.0 - run.resume_done_q[ids[res]])), 1.0)
        return rt

    # -------------------------------------------------------------- resize --
    @staticmethod
    def _work_done(run: _Run, qids: np.ndarray) -> np.ndarray:
        """Work fraction completed by ``now``: the fraction banked at the
        last lease change plus the segment since, run at the *current*
        allocation's rate (1 / rt_q of the total work per second). Correct
        across any number of resizes — a wall-clock fraction of the mixed
        schedule would mis-credit every segment before the last change."""
        return np.clip(run.done_q[qids]
                       + (run.now - run.mark_q[qids])
                       / np.maximum(run.rt_q[qids], 1),
                       0.0, 0.999)

    def _tenant_shares(self, run: _Run, ids: np.ndarray,
                       toks: np.ndarray) -> np.ndarray:
        """(T,) dominant share per tenant on one shard holding leases
        ``ids`` of ``toks`` tokens: the larger of its token share (of the
        shard's capacity) and its lease-slot share (of the lease table) —
        the DRF dominant resource over this fabric's two constrained
        resources."""
        tenants = run.tenant_all[ids]
        tok_share = (np.bincount(tenants, weights=toks,
                                 minlength=run.n_tenants)
                     / max(run.cap_shard, 1))
        slot_share = (np.bincount(tenants,
                                  minlength=run.n_tenants).astype(np.float64)
                      / max(self.cfg.max_leases, 1))
        return np.maximum(tok_share, slot_share)

    def _fused_resize(self, a: np.ndarray, b: np.ndarray, price: np.ndarray,
                      obs: np.ndarray, floor: np.ndarray, done: np.ndarray,
                      cand_tok: np.ndarray, cand_end: np.ndarray,
                      jb: np.ndarray, now: float, cap_shard: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        """One fused launch (kernel K3 on the card) for a batch of
        resize/re-price candidates: priced allocation decision + deadline
        floor + AREPAS re-simulation + lease repricing, reading each
        candidate's skyline (unique-query index ``jb``) from the resident
        pool. Decisions and end times equal the unfused decide / floor /
        ``_true_runtimes`` cascade. Returns numpy (tgt, sel, rt, new_end),
        each (C,)."""
        C = int(a.shape[0])
        stage = self._resize_stage(C)
        pack_resize(a, b, price, obs, floor, done, cand_tok, cand_end, jb,
                    out=stage.numpy())
        # outputs are read back inside the span, so it closes at device
        # completion
        with self.obs.tracer.span("cluster_resize_step", C=C):
            out = cluster_resize_step(
                stage.to(self.device, non_blocking=True), self._sky,
                self._lens, float(now), self.cfg.epoch_s,
                policy=self.service.policy, cap=cap_shard)
            with self.obs.device_wait("k3.out"):
                out = out.cpu()
            return tuple(t.numpy() for t in unpack_resize(out))

    def _resize_stage(self, C: int) -> torch.Tensor:
        """A (9, C) float64 host view of K3's input staging buffer, pinned
        where the run's device is a card (one copy in a call, which the
        previous call's read-back has finished with), grown as needed."""
        need = len(RESIZE_ROWS) * C
        buf = self._stage
        if buf is None or buf.numel() < need:
            buf = self._stage = torch.empty(
                max(need, 2 * (0 if buf is None else buf.numel())),
                dtype=torch.float64,
                pin_memory=torch.device(self.device).type == "cuda")
        return buf[:need].view(len(RESIZE_ROWS), C)

    def _apply_resize(self, run: _Run, shard_of: np.ndarray,
                      qids: np.ndarray, new_tok: np.ndarray,
                      k3: Optional[Tuple[np.ndarray, np.ndarray]] = None
                      ) -> None:
        """Resize running leases (possibly spanning shards): AREPAS-
        resimulate each job at its new allocation, carry the completed work
        fraction over, accrue the cost of the lease segment that just
        ended, and scatter the new (tokens, end) into the stacked lease
        tables in one cross-shard write. ``k3`` accepts the fused kernel's
        already-computed (runtime, end) of these rows (equal to the
        recomputation here)."""
        now = run.now
        done = self._work_done(run, qids)
        if k3 is None:
            rt_new = self._true_runtimes(run.jb_all[qids], new_tok)
            new_end = now + np.maximum(np.round(rt_new * (1.0 - done)), 1.0)
        else:
            rt_new, new_end = k3
        run.cost_q[qids] += run.tok_q[qids] * (now - run.mark_q[qids])
        run.done_q[qids] = done
        run.mark_q[qids] = now
        run.tok_q[qids] = new_tok
        run.rt_q[qids] = rt_new
        run.end_q[qids] = new_end
        run.pool.resize_batch(shard_of, qids, new_tok, new_end)
