"""Trace-driven cluster simulator (discrete-event, epoch-batched, sharded).

Replays a multi-tenant ``Trace`` through a sharded serving fabric: K racks,
each with its own slice of the token pool (``PoolShards``), its own PCC
cache shard (``ShardedPCCCache``), its own admission queue and per-SLA-class
price signal, behind one ``ShardedAllocationService``. A consistent-hash
``Router`` pins every query template to a home shard — so repeat traffic
keeps hitting the shard whose cache already holds its exact PCC — and
spills to the better of two hash choices only when the home rack is
saturated. The single-pool simulator of PR 2/3 is exactly the K=1 run of
this loop, not a separate code path.

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

Tracing: on a recording ``obs``, a run is a ``cluster.setup`` span, one
``cluster.epoch`` span an epoch, each cut into phase spans (complete,
price, arrive, shrink, reprice, preempt, admit, grow) that hold the
older spans (``scheduler.expire``, ``router.route``, ``fabric.decide``,
``cluster_resize_step``, ``cluster_epoch_step``, ``scheduler.admit``),
and a ``cluster.report`` span; every host-to-card sync of the run (K1's
and K3's read-backs, the skyline pool's upload, and those of the pool,
the cache and the decides) is counted in ``device_syncs.<site>``, its
blocked seconds in ``device_wait_s.<site>``. Inside ``cluster.setup``, a
``cluster.featurize`` span holds the featurization of the trace's whole
template pool (attributes ``family``, ``jobs`` and ``n_max``, the padded
node count of a graph model's inputs, 0 for a vector model's); the
model-path decides of the arrive phase count their rows, operators and
adjacency work (``model_rows`` & co., ``serve/service.py``).

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
from repro_torch.cluster.pcc_cache import ShardedPCCCache
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
        # rebuilt per run(): cache keys are trace-local unique-query indices
        self.cache = ShardedPCCCache(cfg.n_shards, device=self.device,
                                     obs=self.obs)
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
        """The replay behind ``run`` and ``run_streaming``: its set-up, its
        epochs and its report are spans (``cluster.setup``,
        ``cluster.epoch``, ``cluster.report``), each epoch cut into phase
        spans (``cluster.complete``, ``cluster.price``, ``cluster.arrive``,
        ``cluster.shrink``, ``cluster.reprice``, ``cluster.preempt``,
        ``cluster.admit``, ``cluster.grow``; a phase the configuration
        turns off has none). ``stage`` opens the run-level spans."""
        stage("cluster.setup")
        cfg = self.cfg
        K = cfg.n_shards
        cap_shard = cfg.capacity // K
        # keys are indices into *this* trace's pool
        self.cache = ShardedPCCCache(K, device=self.device, obs=self.obs)
        # the fabric (and its wrapped service) may be shared across runs —
        # Allocator reuse, shared test fixtures — so report both counter
        # families as this run's delta, not the lifetime totals
        replica_stats0 = self.fabric.replica_stats()
        service_stats0 = dict(self.service.stats)
        o, tr = self.obs, self.obs.tracer
        # install this run's bundle on the (possibly shared) service so
        # fabric.decide spans/latency land with the simulator's records
        prev_obs, self.service.obs = self.service.obs, o
        # hot-swap stats accounting: counters of services retired mid-run
        # fold into these accumulators so the report still covers the whole
        # replay, not just the last model's share of it
        acc_service: Dict[str, int] = {}
        acc_replica: List[Dict[str, int]] = [dict() for _ in range(K)]
        if mlops is not None:
            assert mlops.allocator.service is self.service, \
                "mlops loop must wrap the allocator driving this simulator"
            assert mlops.allocator.n_shards == K, \
                "mlops allocator fabric must match ClusterConfig.n_shards"
            mlops.begin_run(trace)
        t_wall = time.time()
        n = len(trace)
        cols = trace.arrays()
        arrival = cols["arrival_s"]
        jb_all = cols["job_index"]
        sla_all = cols["sla"]
        tenant_all = cols["tenant"]
        deadline_all = cols["deadline_s"]
        repeat_all = trace.repeat_mask()
        n_classes = len(trace.sla_classes)
        priorities = np.array([c.priority for c in trace.sla_classes])
        sla_limits = np.array([c.slowdown_limit for c in trace.sla_classes])
        priced = cfg.pricing == "elastic"
        signal = PriceSignal(n_classes, cfg.price_gamma, cfg.price_cap)

        # unique-query pool tensors
        U = len(trace.jobs)
        defaults = np.array([j.default_tokens for j in trace.jobs], np.int64)
        with tr.span("cluster.featurize", family=self.service.model.family,
                     jobs=U) as sp:
            model_pool = self._pool_inputs(trace)
            if sp is not None:
                sp.attrs["n_max"] = (int(model_pool["mask"].shape[-1])
                                     if "mask" in model_pool else 0)
        lens, peaks, areas = self._skyline_pool(trace)
        # home shard rank of every template: the consistent-hash assignment
        # that pins a recurring script to one cache shard for the whole run
        home_u = self.router.rank(self.router.home(np.arange(U)))

        # exact-history oracle: the decision the policy makes from the true
        # per-query PCC (what a fully warmed cache converges to)
        oracle_cache = ShardedPCCCache(K, device=self.device, obs=o)
        a_ex, b_ex = oracle_cache.refine_batch(
            home_u, np.arange(U), self._sky, self._lens, defaults, peaks,
            rows=np.arange(U), areas=areas)
        oracle = np.minimum(
            self.service.decide(AllocationRequest(
                a=a_ex, b=b_ex, observed_tokens=defaults)).tokens,
            cap_shard).astype(np.int64)

        # per-query state, indexed by query id
        tok_q = np.zeros(n, np.int64)      # currently leased tokens
        perf_q = np.zeros(n, np.int64)     # performance-optimal (unpriced) ask
        rt_q = np.zeros(n, np.int64)       # current total-runtime estimate
        a_q = np.zeros(n, np.float64)      # decision-time PCC params
        b_q = np.zeros(n, np.float64)
        price_q = np.ones(n, np.float64)   # price paid at decision time
        err_q = np.zeros(n, np.float64)
        hit_q = np.zeros(n, bool)
        start_q = np.zeros(n, np.float64)
        end_q = np.zeros(n, np.float64)
        cost_q = np.zeros(n, np.float64)   # token-seconds accrued pre-resize
        mark_q = np.zeros(n, np.float64)   # last lease-change timestamp
        done_q = np.zeros(n, np.float64)   # work fraction done at last change
        shard_q = np.zeros(n, np.int64)    # executing shard rank
        spill_q = np.zeros(n, bool)        # routed off the home shard
        # preemption provenance: a checkpointed remainder keeps its banked
        # work fraction while queued and restores it at re-admission
        resume_done_q = np.zeros(n, np.float64)
        preempt_q = np.zeros(n, bool)      # queued as a remainder right now
        preempt_time_q = np.zeros(n, np.float64)
        preempt_count_q = np.zeros(n, np.int64)
        n_tenants = int(tenant_all.max()) + 1 if n else 1

        pool = PoolShards(cap_shard, K, cfg.max_leases, device=self.device,
                          obs=o)
        metrics = ClusterMetrics(cfg.capacity, sla_limits, n_shards=K,
                                 capacity_per_shard=cap_shard)
        # per-shard pending queues (columnar): query ids in arrival order
        queues: List[np.ndarray] = [np.zeros(0, np.int64) for _ in range(K)]
        source = make_source(arrival)
        now = 0.0
        n_epochs = 0
        stage.close()

        def queued_tokens() -> np.ndarray:
            return np.array([int(np.sum(tok_q[q])) for q in queues],
                            np.float64)

        def count_certain_miss(miss: np.ndarray) -> None:
            nm = int(np.count_nonzero(miss))
            if nm:
                metrics.record_certain_miss(nm)

        # local work is checked before the source so a streaming source's
        # (blocking) exhausted() is only consulted when the fabric would
        # otherwise go idle — exactly when waiting on the producer is right
        while any(q.size for q in queues) or pool.n_active \
                or not source.exhausted():
            with tr.span("cluster.epoch"), tr.phases() as phase:
                # advance: one epoch, or jump an idle gap to the next event
                targets = []
                na = source.next_arrival()
                if na is not None:
                    targets.append(na)
                if pool.n_active:
                    targets.append(pool.next_expiry())
                now = max(now + cfg.epoch_s, min(targets) if targets else now)
                n_epochs += 1

                phase("cluster.complete")
                # 1. lease expiry (one kernel over every shard) -> completions
                #    -> refinement into each template's *home* cache shard
                with tr.span("scheduler.expire"):
                    done_sh, done_ids, _ = pool.expire(now)
                if done_ids.size:
                    tr.point("lease.complete", n=int(done_ids.size), t_sim=now)
                    o.metrics.counter("completed").inc(int(done_ids.size))
                    jb = jb_all[done_ids]
                    fin = end_q[done_ids]
                    metrics.record_completions(
                        arrival_s=arrival[done_ids], start_s=start_q[done_ids],
                        finish_s=fin, tokens=tok_q[done_ids],
                        default_tokens=defaults[jb],
                        runtime_s=np.round(fin - start_q[done_ids]).astype(
                            np.int64),
                        ideal_runtime_s=lens[jb], sla=sla_all[done_ids],
                        tenant=tenant_all[done_ids],
                        cache_hit=hit_q[done_ids],
                        repeat=repeat_all[done_ids],
                        alloc_error=err_q[done_ids],
                        cost_token_s=(cost_q[done_ids] + tok_q[done_ids]
                                      * (fin - mark_q[done_ids])),
                        price=price_q[done_ids],
                        slack_s=deadline_all[done_ids] - fin,
                        shard=done_sh, spilled=spill_q[done_ids])
                    if cfg.use_cache:
                        fresh = np.unique(
                            jb[self.cache.missing(home_u[jb], jb)])
                        if fresh.size:
                            self.cache.refine_batch(
                                home_u[fresh], fresh, self._sky, self._lens,
                                defaults[fresh], peaks[fresh], rows=fresh,
                                areas=areas[fresh])
                    if mlops is not None:
                        # feed the drift-retraining loop this completion batch:
                        # decision-time predicted runtime vs realized runtime,
                        # plus the completed queries' feature view
                        pred = b_q[done_ids] * np.maximum(
                            tok_q[done_ids], 1).astype(np.float64) \
                            ** a_q[done_ids]
                        feats = np.stack(
                            [np.log1p(areas[jb]),
                             np.log1p(peaks[jb].astype(np.float64)),
                             np.log1p(defaults[jb].astype(np.float64)),
                             np.log1p(lens[jb].astype(np.float64))], axis=1)
                        swapped = mlops.on_completions(
                            now=now, job_index=jb, features=feats,
                            predicted_s=pred, actual_s=fin - start_q[done_ids],
                            model_mask=~hit_q[done_ids])
                        if swapped:
                            # the allocator swapped in a freshly-warmed stack:
                            # fold the retired service's counters into the
                            # accumulators, re-point, re-baseline, and demote
                            # cache curves refined under the old model
                            for k2, v in self.service.stats.items():
                                acc_service[k2] = (acc_service.get(k2, 0) + v
                                                   - service_stats0.get(k2, 0))
                            for acc, r, r0 in zip(acc_replica,
                                                  self.fabric.replica_stats(),
                                                  replica_stats0):
                                for k2 in r:
                                    acc[k2] = (acc.get(k2, 0) + r[k2]
                                               - r0.get(k2, 0))
                            self.service.obs = prev_obs     # retire cleanly
                            self.service = mlops.allocator.service
                            self.fabric = mlops.allocator.fabric
                            prev_obs, self.service.obs = self.service.obs, o
                            service_stats0 = dict(self.service.stats)
                            replica_stats0 = self.fabric.replica_stats()
                            self.cache.bump_model_version(
                                mlops.allocator.model_version)

                phase("cluster.price")
                # 2. per-(shard, SLA-class) price signal from leased + queued
                #    demand — one vectorized call over the whole fabric (the
                #    lease-table snapshots are only needed on elastic paths)
                if priced or cfg.elastic:
                    act = [pool.active(k) for k in range(K)]
                    leased_cls = np.stack([
                        np.bincount(sla_all[act[k][0]], weights=act[k][1],
                                    minlength=n_classes) for k in range(K)])
                    queued_cls = np.stack([
                        np.bincount(sla_all[queues[k]],
                                    weights=tok_q[queues[k]],
                                    minlength=n_classes) for k in range(K)])
                    prices = signal.prices(leased_cls, cap_shard, queued_cls)
                else:
                    act, prices = None, None

                phase("cluster.arrive")
                # 3. arrivals in this epoch -> routing -> one fabric-wide batch
                #    of allocation decisions
                ids = source.take_until(now)
                total_queued = int(sum(q.size for q in queues))
                if ids.size and total_queued + ids.size > cfg.max_queue:
                    keep = max(cfg.max_queue - total_queued, 0)
                    metrics.n_rejected += ids.size - keep
                    ids = ids[:keep]
                if ids.size:
                    jb = jb_all[ids]
                    obs = defaults[jb]
                    # placement: home-consistent hashing; a saturated home
                    # rack (projected demand over capacity) spills to the
                    # less loaded of two choices — cross-shard spill is the
                    # exception, cache affinity the rule
                    load = (pool.in_use + queued_tokens()) / cap_shard
                    exec_sh, spilled = self.router.route(jb, load)
                    exec_r = self.router.rank(exec_sh)
                    shard_q[ids] = exec_r
                    spill_q[ids] = spilled
                    tokens = np.zeros(ids.size, np.int64)
                    a_dec = np.zeros(ids.size, np.float64)
                    b_dec = np.zeros(ids.size, np.float64)
                    if cfg.use_cache:
                        hit, a_c, b_c = self.cache.lookup(home_u[jb], jb,
                                                          areas=areas[jb])
                    else:
                        hit = np.zeros(ids.size, bool)
                    o.metrics.counter("cache_hit").inc(int(hit.sum()))
                    o.metrics.counter("cache_miss").inc(
                        int(ids.size) - int(hit.sum()))
                    if np.any(hit):      # exact-history path: policy twin only
                        tokens[hit] = self.fabric.decide(
                            AllocationRequest(a=a_c[hit], b=b_c[hit],
                                              observed_tokens=obs[hit]),
                            DecisionContext(shard_of=exec_r[hit])).tokens
                        a_dec[hit] = a_c[hit]
                        b_dec[hit] = b_c[hit]
                    miss = ~hit
                    if np.any(miss):     # cold path: fused model+policy kernel
                        model_in = {k: v[jb[miss]]
                                    for k, v in model_pool.items()}
                        res = self.fabric.decide(
                            AllocationRequest(model_in=model_in,
                                              observed_tokens=obs[miss]),
                            DecisionContext(shard_of=exec_r[miss]))
                        tokens[miss] = res.tokens
                        a_dec[miss] = res.a
                        b_dec[miss] = res.b
                    perf = np.minimum(tokens, cap_shard)
                    if priced:   # re-price the whole epoch batch at once,
                        p = prices[exec_r, sla_all[ids]]
                        tokens = np.minimum(self.fabric.decide(
                            AllocationRequest(a=a_dec, b=b_dec,
                                              observed_tokens=obs),
                            DecisionContext(price=p, shard_of=exec_r)
                            ).tokens, cap_shard)
                        # ... floored so no query is priced into a
                        # predicted deadline miss (past the performance ask
                        # nothing helps; a certain miss — non-positive slack
                        # — is counted, not silently floored at the cap)
                        flo, c_miss = deadline_floor(a_dec, b_dec,
                                                     deadline_all[ids] - now,
                                                     perf)
                        count_certain_miss(c_miss)
                        tokens = np.maximum(tokens, flo)
                        price_q[ids] = p
                    else:
                        tokens = perf
                    tok_q[ids] = tokens
                    o.metrics.histogram(
                        "price_at_decision", lo=1e-3,
                        hi=1e3).record_many(price_q[ids])
                    perf_q[ids] = perf
                    a_q[ids] = a_dec
                    b_q[ids] = b_dec
                    hit_q[ids] = hit
                    err_q[ids] = (np.abs(perf - oracle[jb])
                                  / np.maximum(oracle[jb], 1))
                    rt_q[ids] = self._true_runtimes(jb, tokens)
                    for k in np.unique(exec_r):
                        queues[k] = np.concatenate([queues[k],
                                                    ids[exec_r == k]])

                # 4. elastic shrink: shards whose queued demand exceeds their
                #    free pool reclaim from running leases — one priced
                #    fabric call and one cross-shard resize kernel for all
                #    of them
                if cfg.elastic:
                    phase("cluster.shrink")
                    rows_ids, rows_sh = [], []
                    for k in range(K):
                        act_ids = act[k][0]
                        if act_ids.size and queues[k].size \
                                and int(np.sum(tok_q[queues[k]])) \
                                > pool.free[k]:
                            rows_ids.append(act_ids)
                            rows_sh.append(np.full(act_ids.size, k, np.int64))
                    if rows_ids:
                        cand = np.concatenate(rows_ids)
                        cand_sh = np.concatenate(rows_sh)
                        cand_tok = tok_q[cand]
                        cand_end = end_q[cand]
                        # deadline guard: the shrunk lease's predicted *total*
                        # runtime must keep the remaining work inside the slack
                        done = self._work_done(cand, now, done_q, mark_q, rt_q)
                        rt_budget = ((deadline_all[cand] - now) / (1.0 - done))
                        floor, c_miss = deadline_floor(a_q[cand], b_q[cand],
                                                       rt_budget, cand_tok)
                        count_certain_miss(c_miss)
                        cand_p = prices[cand_sh, sla_all[cand]]
                        rt_new = new_end = None
                        if cfg.fused:
                            # one launch: priced re-decide + AREPAS + reprice
                            jb = jb_all[cand]
                            tgt, sel, rt_new, new_end = self._fused_resize(
                                a_q[cand], b_q[cand], cand_p, defaults[jb],
                                floor, done, cand_tok, cand_end, jb, now,
                                cap_shard)
                        else:
                            # re-price running leases at current contention;
                            # shrink those whose priced ask fell below their
                            # lease
                            tgt = np.minimum(self.fabric.decide(
                                AllocationRequest(
                                    a=a_q[cand], b=b_q[cand],
                                    observed_tokens=defaults[jb_all[cand]]),
                                DecisionContext(price=cand_p,
                                                shard_of=cand_sh)).tokens,
                                cap_shard)
                            tgt = np.maximum(tgt, floor)
                            sel = ((tgt < cand_tok)
                                   & ((cand_end - now) > cfg.epoch_s))
                        if np.any(sel):
                            sids = cand[sel]
                            new_tok = tgt[sel]
                            self._apply_resize(
                                cand_sh[sel], sids, new_tok, now,
                                jb_all, tok_q, rt_q, start_q, end_q, cost_q,
                                mark_q, done_q, pool,
                                rt_new=None if rt_new is None else rt_new[sel],
                                new_end=None if new_end is None
                                else new_end[sel])
                            metrics.record_resizes(
                                shrunk=sids.size,
                                reclaimed=int(np.sum(cand_tok[sel] - new_tok)))
                            tr.point("lease.resize", t_sim=now,
                                     shrunk=int(sids.size))
                            o.metrics.counter("leases_shrunk").inc(
                                int(sids.size))
                            if priced:   # fixed pricing reports neutral prices
                                price_q[sids] = prices[cand_sh[sel],
                                                       sla_all[sids]]

                # 5. re-price stale queued decisions: a query that decided at a
                #    burst-peak (or calm-trough) price keeps neither its
                #    starved nor its oversized ask once the class price moves
                #    materially — re-decide tokens and runtime for the
                #    changed subset so EDF slack and admission see current
                #    prices
                if priced and any(q.size for q in queues):
                    phase("cluster.reprice")
                    all_q = np.concatenate([q for q in queues if q.size])
                    pq = prices[shard_q[all_q], sla_all[all_q]]
                    moved = np.abs(pq - price_q[all_q]) > 0.25 * price_q[all_q]
                    if np.any(moved):
                        rq = all_q[moved]
                        p = pq[moved]
                        jb = jb_all[rq]
                        floor, c_miss = deadline_floor(a_q[rq], b_q[rq],
                                                       deadline_all[rq] - now,
                                                       perf_q[rq])
                        count_certain_miss(c_miss)
                        if cfg.fused:
                            # queued: nothing done yet, lease fields unused
                            toks, _, rts, _ = self._fused_resize(
                                a_q[rq], b_q[rq], p, defaults[jb], floor,
                                np.zeros(rq.size), tok_q[rq], end_q[rq],
                                jb, now, cap_shard)
                        else:
                            toks = np.minimum(self.fabric.decide(
                                AllocationRequest(
                                    a=a_q[rq], b=b_q[rq],
                                    observed_tokens=defaults[jb_all[rq]]),
                                DecisionContext(price=p, shard_of=shard_q[rq])
                                ).tokens, cap_shard)
                            toks = np.maximum(toks, floor)
                            rts = self._true_runtimes(jb, toks)
                        tok_q[rq] = toks
                        rt_q[rq] = rts
                        price_q[rq] = p

                # 5.5 preemption: a shard whose queued demand still exceeds its
                #     free pool after elastic shrink checkpoints running leases
                #     of over-share tenants. Victim order comes from the
                #     policy's victims() (DRF: most-over-share tenant's
                #     youngest lease first); the minimal prefix covering the
                #     shortfall is preempted. Each victim's work-done fraction
                #     is banked (same AREPAS accounting as resizes), its tokens
                #     released, and the remainder re-decided under a fresh
                #     DecisionContext and re-routed with the preempting rack
                #     marked draining — cross-shard migration when a second
                #     hash choice is less loaded.
                if cfg.preemption:
                    phase("cluster.preempt")
                    vic_ids_l: List[np.ndarray] = []
                    vic_sh_l: List[np.ndarray] = []
                    for k in range(K):
                        if not queues[k].size:
                            continue
                        need = (int(np.sum(tok_q[queues[k]]))
                                - int(pool.free[k]))
                        if need <= 0:
                            continue
                        act_ids, act_tok, act_end = pool.active(k)
                        if not act_ids.size:
                            continue
                        shares = self._tenant_shares(
                            tenant_all[act_ids], act_tok, cap_shard,
                            cfg.max_leases, n_tenants)
                        over = shares > cfg.preempt_over_share / n_tenants
                        v_ten = tenant_all[act_ids]
                        elig_v = (over[v_ten]
                                  & ((act_end - now) > cfg.epoch_s)
                                  & (preempt_count_q[act_ids]
                                     < cfg.preempt_max_per_query))
                        if not np.any(elig_v):
                            continue
                        view = LeaseView(
                            ids=act_ids[elig_v], tokens=act_tok[elig_v],
                            start_s=mark_q[act_ids[elig_v]],
                            tenant=v_ten[elig_v],
                            share=shares[v_ten[elig_v]])
                        order = self.policy.victims(view)
                        cum = np.cumsum(view.tokens[order])
                        j = min(int(np.searchsorted(cum, need)) + 1,
                                order.size)
                        pick = order[:j]
                        vic_ids_l.append(view.ids[pick])
                        vic_sh_l.append(np.full(pick.size, k, np.int64))
                    if vic_ids_l:
                        vids = np.concatenate(vic_ids_l)
                        vsh = np.concatenate(vic_sh_l)
                        with tr.span("scheduler.preempt", n=int(vids.size)):
                            done = self._work_done(vids, now, done_q, mark_q,
                                                   rt_q)
                            freed = pool.preempt_batch(vsh, vids)
                        # checkpoint: accrue the leased segment's cost, bank
                        # the work fraction, stamp provenance
                        cost_q[vids] += tok_q[vids] * (now - mark_q[vids])
                        done_q[vids] = done
                        mark_q[vids] = now
                        resume_done_q[vids] = done
                        preempt_q[vids] = True
                        preempt_time_q[vids] = now
                        preempt_count_q[vids] += 1
                        n_freed = int(freed.sum())
                        metrics.record_preemptions(count=vids.size,
                                                   tokens=n_freed)
                        tr.point("lease.preempt", n=int(vids.size), t_sim=now)
                        o.metrics.counter("preemptions_total").inc(
                            int(vids.size))
                        o.metrics.counter("preempted_tokens_reclaimed").inc(
                            n_freed)
                        # re-route the remainders with post-release load and
                        # the preempting shards draining, then re-decide
                        # tokens for the remaining work under the target
                        # shard's price
                        load = (pool.in_use + queued_tokens()) / cap_shard
                        drain = np.zeros(K, bool)
                        drain[np.unique(vsh)] = True
                        jb = jb_all[vids]
                        exec_sh, spilled = self.router.route(jb, load,
                                                             drain=drain)
                        exec_r = self.router.rank(exec_sh)
                        shard_q[vids] = exec_r
                        spill_q[vids] = spilled
                        req = AllocationRequest(
                            a=a_q[vids], b=b_q[vids],
                            observed_tokens=defaults[jb],
                            sla=sla_all[vids], deadline_s=deadline_all[vids],
                            preempted=np.ones(vids.size, bool))
                        if priced:
                            p = prices[exec_r, sla_all[vids]]
                            toks = np.minimum(self.fabric.decide(
                                req, DecisionContext(price=p, shard_of=exec_r)
                                ).tokens, cap_shard)
                            # the floor budgets the *remaining* slack against
                            # the remaining work fraction
                            rt_budget = ((deadline_all[vids] - now)
                                         / (1.0 - done))
                            floor, c_miss = deadline_floor(
                                a_q[vids], b_q[vids], rt_budget, perf_q[vids])
                            count_certain_miss(c_miss)
                            toks = np.maximum(toks, floor)
                            price_q[vids] = p
                        else:
                            toks = np.minimum(self.fabric.decide(
                                req, DecisionContext(shard_of=exec_r)).tokens,
                                cap_shard)
                        tok_q[vids] = toks
                        rt_q[vids] = self._true_runtimes(jb, toks)
                        for k in np.unique(exec_r):
                            queues[k] = np.concatenate(
                                [queues[k], vids[exec_r == k]])

                # 6. admission: per shard, a vectorized prefix over its
                #    policy-ordered queue. Fused mode packs every eligible
                #    shard's ordered queue head into one (K, Q) matrix and runs
                #    the whole fabric's admission + lease scatter as a single
                #    kernel launch on the pool's resident device tables; the
                #    eligibility gate (non-empty queue AND free tokens) matches
                #    the unfused loop exactly — an ineligible shard's queue
                #    is *not* reordered this epoch, which later lexsorts
                #    observe.
                phase("cluster.admit")
                elig = [k for k in range(K)
                        if queues[k].size and pool.free[k] > 0]
                needs_shares = getattr(self.policy, "needs_shares", False)
                for k in elig:
                    q_ids = queues[k]
                    rt_eff = rt_q[q_ids].astype(np.float64)
                    if cfg.preemption:
                        # a queued remainder's slack budgets only the work it
                        # has left, not a from-scratch run
                        res = preempt_q[q_ids]
                        rt_eff = np.where(
                            res,
                            np.maximum(np.round(
                                rt_eff * (1.0 - resume_done_q[q_ids])), 1.0),
                            rt_eff)
                    extra: Dict = {}
                    if needs_shares:
                        act_ids_k, act_tok_k, _ = pool.active(k)
                        shares = self._tenant_shares(
                            tenant_all[act_ids_k], act_tok_k, cap_shard,
                            cfg.max_leases, n_tenants)
                        extra = dict(tenant=tenant_all[q_ids],
                                     tenant_share=shares)
                    view = QueueView(
                        ids=q_ids, arrival_s=arrival[q_ids],
                        priority=priorities[sla_all[q_ids]],
                        slack_s=deadline_all[q_ids] - (now + rt_eff),
                        now=now, **extra)
                    queues[k] = q_ids[self.policy.order(view)]
                n_granted = 0
                if self._fused_admission and elig:
                    # an admitted prefix holds >= 1 token per query, so no
                    # prefix extends past cap_shard entries — bound Q by it
                    Qp = min(max(queues[k].size for k in elig), cap_shard)
                    q_ids_m = np.full((K, Qp), -1, np.int64)
                    q_tok_m = np.zeros((K, Qp), np.int64)
                    q_end_m = np.zeros((K, Qp), np.float64)
                    for k in elig:
                        q = queues[k][:Qp]
                        q_ids_m[k, :q.size] = q
                        q_tok_m[k, :q.size] = tok_q[q]
                        q_end_m[k, :q.size] = now + rt_q[q]
                    # pool.admit_epoch reads the kernel outputs back to host,
                    # so the span closes at device completion, not dispatch
                    with tr.span("cluster_epoch_step", fused=True, Q=int(Qp)):
                        n_adm = pool.admit_epoch(now, q_ids_m, q_tok_m,
                                                 q_end_m)
                    for k in elig:
                        j = int(n_adm[k])
                        if j:
                            adm = queues[k][:j]
                            start_q[adm] = now
                            mark_q[adm] = now
                            done_q[adm] = 0.0
                            end_q[adm] = now + rt_q[adm]
                            o.metrics.histogram(
                                "admission_wait_sim_s",
                                lo=1e-3,
                                hi=1e6).record_many(now - arrival[adm])
                            n_granted += j
                        queues[k] = queues[k][j:]
                else:
                    with tr.span("scheduler.admit", shards=len(elig)):
                        for k in elig:
                            q_ids = queues[k]
                            fits = np.cumsum(tok_q[q_ids]) <= pool.free[k]
                            # the True prefix
                            j = int(np.searchsorted(~fits, True))
                            if j:
                                adm = q_ids[:j]
                                if cfg.preemption:
                                    # a resumed remainder keeps its original
                                    # start and banked work; its new lease runs
                                    # only the remaining fraction
                                    res = preempt_q[adm]
                                    start_q[adm[~res]] = now
                                    done_adm = np.where(
                                        res, resume_done_q[adm], 0.0)
                                    done_q[adm] = done_adm
                                    end_q[adm] = now + np.where(
                                        res,
                                        np.maximum(np.round(
                                            rt_q[adm] * (1.0 - done_adm)),
                                            1.0),
                                        rt_q[adm].astype(np.float64))
                                    if np.any(res):
                                        o.metrics.histogram(
                                            "requeue_wait_sim_s", lo=1e-3,
                                            hi=1e6).record_many(
                                            now - preempt_time_q[adm[res]])
                                        preempt_q[adm] = False
                                else:
                                    start_q[adm] = now
                                    done_q[adm] = 0.0
                                    end_q[adm] = now + rt_q[adm]
                                mark_q[adm] = now
                                pool.acquire_batch(k, adm, tok_q[adm],
                                                   end_q[adm])
                                o.metrics.histogram(
                                    "admission_wait_sim_s", lo=1e-3,
                                    hi=1e6).record_many(now - arrival[adm])
                                n_granted += j
                            queues[k] = q_ids[j:]
                if n_granted:
                    tr.point("lease.grant", n=n_granted, t_sim=now)
                    o.metrics.counter("admitted").inc(n_granted)

                # 7. elastic grow: a shard with an empty queue and idle tokens
                #    feeds running leases projected to miss their deadline
                #    (growing anything else buys runtime nobody asked for at a
                #    strictly higher cost), most-at-risk first — the resizes
                #    of every shard land in one cross-shard kernel
                if cfg.elastic:
                    phase("cluster.grow")
                    g_sh, g_ids, g_tok = [], [], []
                    for k in range(K):
                        if queues[k].size or pool.free[k] <= 0:
                            continue
                        act_ids, act_tok, act_end = pool.active(k)
                        want = perf_q[act_ids] - act_tok
                        cand = ((want > 0) & ((act_end - now) > cfg.epoch_s)
                                & (act_end > deadline_all[act_ids]))
                        if not np.any(cand):
                            continue
                        cids, cwant = act_ids[cand], want[cand]
                        order = np.argsort(deadline_all[cids] - act_end[cand],
                                           kind="stable")
                        cids, cwant = cids[order], cwant[order]
                        fits = np.cumsum(cwant) <= pool.free[k]
                        j = int(np.searchsorted(~fits, True))
                        if j:
                            g_sh.append(np.full(j, k, np.int64))
                            g_ids.append(cids[:j])
                            g_tok.append(tok_q[cids[:j]] + cwant[:j])
                    if g_ids:
                        gids = np.concatenate(g_ids)
                        new_tok = np.concatenate(g_tok)
                        granted = int(np.sum(new_tok - tok_q[gids]))
                        self._apply_resize(np.concatenate(g_sh), gids, new_tok,
                                           now, jb_all, tok_q, rt_q,
                                           start_q, end_q, cost_q, mark_q,
                                           done_q, pool)
                        metrics.record_resizes(grown=gids.size,
                                               granted=granted)
                        tr.point("lease.resize", t_sim=now,
                                 grown=int(gids.size))
                        o.metrics.counter("leases_grown").inc(int(gids.size))

                phase.close()
                epoch_errs = err_q[ids] if ids.size else np.zeros(0)
                qd = int(sum(q.size for q in queues))
                metrics.sample_epoch(now, qd, int(pool.in_use.sum()),
                                     epoch_errs, in_use_shard=pool.in_use)
                if tr.enabled:   # per-shard counter lanes for Perfetto
                    tr.sample("pool_in_use",
                              **{f"shard{k}": int(pool.in_use[k])
                                 for k in range(K)})
                    tr.sample("queue_depth",
                              **{f"shard{k}": int(queues[k].size)
                                 for k in range(K)})
                    tr.point("epoch", t_sim=now, arrived=int(ids.size))
                g = o.metrics.gauge("queue_depth_peak")
                g.set(max(g.value, qd))

        stage("cluster.report")
        wall = time.time() - t_wall
        if hasattr(source, "join"):      # streaming: producer has sent all
            source.join()
        self.service.obs = prev_obs
        self._sky = self._lens = None
        o.metrics.counter("epochs").inc(n_epochs)
        o.metrics.counter("rejected").inc(int(metrics.n_rejected))
        report = metrics.report()
        # replay rate: queries fully processed (completed or rejected) / wall
        n_processed = report.get("n_completed", 0) + report.get("n_rejected", 0)
        service_delta = {k: v - service_stats0.get(k, 0)
                         for k, v in self.service.stats.items()}
        for k2, v in acc_service.items():
            service_delta[k2] = service_delta.get(k2, 0) + v
        replica_delta = []
        for acc, r, r0 in zip(acc_replica, self.fabric.replica_stats(),
                              replica_stats0):
            d = {k: r[k] - r0.get(k, 0) for k in r}
            for k2, v in acc.items():
                d[k2] = d.get(k2, 0) + v
            replica_delta.append(d)
        return ClusterReport(
            metrics=report, n_events=n, n_epochs=n_epochs,
            wall_s=round(wall, 3),
            events_per_s=round(n_processed / max(wall, 1e-9), 1),
            cache_stats=dict(self.cache.stats),
            service_stats=service_delta,
            error_series=metrics.error_series(),
            alloc_errors=err_q, cache_hits=hit_q, repeats=repeat_all,
            replica_stats=replica_delta)

    # -------------------------------------------------------------- resize --
    @staticmethod
    def _work_done(qids: np.ndarray, now: float, done_q: np.ndarray,
                   mark_q: np.ndarray, rt_q: np.ndarray) -> np.ndarray:
        """Work fraction completed by ``now``: the fraction banked at the
        last lease change plus the segment since, run at the *current*
        allocation's rate (1 / rt_q of the total work per second). Correct
        across any number of resizes — a wall-clock fraction of the mixed
        schedule would mis-credit every segment before the last change."""
        return np.clip(done_q[qids]
                       + (now - mark_q[qids]) / np.maximum(rt_q[qids], 1),
                       0.0, 0.999)

    @staticmethod
    def _tenant_shares(tenants: np.ndarray, toks: np.ndarray,
                       cap_shard: int, max_leases: int,
                       n_tenants: int) -> np.ndarray:
        """(T,) dominant share per tenant on one shard: the larger of its
        token share (of the shard's capacity) and its lease-slot share (of
        the lease table) — the DRF dominant resource over this fabric's two
        constrained resources."""
        tok_share = (np.bincount(tenants, weights=toks,
                                 minlength=n_tenants)
                     / max(cap_shard, 1))
        slot_share = (np.bincount(tenants,
                                  minlength=n_tenants).astype(np.float64)
                      / max(max_leases, 1))
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

    def _apply_resize(self, shard_of: np.ndarray, qids: np.ndarray,
                      new_tok: np.ndarray, now: float, jb_all: np.ndarray,
                      tok_q: np.ndarray, rt_q: np.ndarray,
                      start_q: np.ndarray, end_q: np.ndarray,
                      cost_q: np.ndarray, mark_q: np.ndarray,
                      done_q: np.ndarray, pool: PoolShards,
                      rt_new: Optional[np.ndarray] = None,
                      new_end: Optional[np.ndarray] = None) -> None:
        """Resize running leases (possibly spanning shards): AREPAS-
        resimulate each job at its new allocation, carry the completed work
        fraction over, accrue the cost of the lease segment that just
        ended, and scatter the new (tokens, end) into the stacked lease
        tables in one cross-shard write. ``rt_new``/``new_end`` accept the
        fused kernel's already-computed values (equal to the recomputation
        here)."""
        jb = jb_all[qids]
        if rt_new is None:
            rt_new = self._true_runtimes(jb, new_tok)
        done = self._work_done(qids, now, done_q, mark_q, rt_q)
        if new_end is None:
            remaining = np.maximum(np.round(rt_new * (1.0 - done)), 1.0)
            new_end = now + remaining
        cost_q[qids] += tok_q[qids] * (now - mark_q[qids])
        done_q[qids] = done
        mark_q[qids] = now
        tok_q[qids] = new_tok
        rt_q[qids] = rt_new
        end_q[qids] = new_end
        pool.resize_batch(shard_of, qids, new_tok, new_end)
