"""Ahead-of-time built decision executables: warm before traffic.

The lazy serving path builds each (engine, shape-bucket) decision
executable on first request — on the card a CUDA-graph capture, tens of
milliseconds that would land on a live query's tail latency. This module
moves every one of those builds to startup: enumerate the (engine,
batch-bucket, priced, observed) grid the stack can serve, build each
executable (capture its graph), warm it with one dummy invocation so
first-touch costs are paid too, and pin the result into
``ReplicaState.compiled`` at the exact key the lazy path would have
used — the hot path then finds every key present and never builds
(``stats["compiles"] == 0``).

The executables are built by the *same* cells the lazy path uses
(``AllocationService._policy_cell`` & co., over the module-level
factories ``make_policy_decide`` & co. in ``serve/service.py``), so AOT and
lazy decisions are bitwise-identical by construction.

Warmup cost is first-class: each executable's capture/warm split is
recorded (``decision_cold_start_s`` histogram, one ``aot.compile`` point
each, an ``aot.warmup`` span per pass) and the totals surface in
``WarmupReport`` (``cold_start_s``, ``n_precompiled``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.featurize import batch_graphs, batch_job_features
from repro_torch.obs import NULL_OBS, Obs
from repro_torch.serve.service import (AllocationService,
                                       ShardedAllocationService)

__all__ = ["WarmupConfig", "WarmupReport", "ExecutableRecord",
           "batch_buckets", "model_pool_inputs", "model_input_template",
           "warm_service", "warm_fabric", "warm_allocation_stack"]


def batch_buckets(floor: int = 8, cap: int = 4096) -> Tuple[int, ...]:
    """The power-of-two batch buckets in [floor, cap] — every padded batch
    dimension ``batch_bucket`` can produce (requests beyond ``cap`` are
    chunked by the service, so the grid is closed)."""
    out, p = [], max(int(floor), 1)
    while p <= cap:
        out.append(p)
        p *= 2
    return tuple(out)


def model_pool_inputs(model, jobs) -> Dict[str, np.ndarray]:
    """Model inputs for a set of unique queries, gatherable by job index —
    the same pool construction the cluster simulator serves decisions
    from, so shapes/dtypes derived here match the replay exactly."""
    if model.family == "gnn":
        gf, ga, gm = batch_graphs(jobs)
        return {"features": gf, "adj": ga, "mask": gm}
    return {"features": batch_job_features(jobs)}


def model_input_template(model, jobs) -> Dict[str, Tuple[Tuple[int, ...],
                                                         np.dtype]]:
    """Per-input (shape-sans-batch, dtype) template for fused executables,
    derived from the real featurization of ``jobs`` (for GNNs this fixes
    the pool-wide node dimension the trace will serve with)."""
    pool = model_pool_inputs(model, jobs)
    return {k: (tuple(v.shape[1:]), v.dtype) for k, v in pool.items()}


@dataclasses.dataclass(frozen=True)
class WarmupConfig:
    """What to pre-build.

    The default grid covers everything the protocol can dispatch with
    observed-mode on (every cluster/plane path passes observed tokens);
    ``observed=(True, False)`` doubles the grid for stacks that also serve
    hint-free traffic. ``buckets`` overrides the power-of-two enumeration
    (floor..max_bucket) with an explicit set. The reference's ``donate``
    switch (XLA buffer donation) has no counterpart: a CUDA graph's static
    buffers are reused by construction.
    """
    max_bucket: int = 4096               # == AllocationService.MAX_BATCH
    buckets: Optional[Tuple[int, ...]] = None
    observed: Tuple[bool, ...] = (True,)
    priced: bool = True                  # include the priced policy twins
    fused: bool = True                   # include fused model executables
    warm: bool = True                    # one dummy invocation per exec

    def bucket_set(self, floor: int) -> Tuple[int, ...]:
        return (self.buckets if self.buckets is not None
                else batch_buckets(floor, self.max_bucket))


@dataclasses.dataclass
class ExecutableRecord:
    kind: str                            # policy|priced|fused|sharded_*
    bucket: int                          # padded batch dimension
    capture_s: float                     # build (CUDA-graph capture)
    warm_s: float                        # one dummy invocation

    @property
    def total_s(self) -> float:
        return self.capture_s + self.warm_s


@dataclasses.dataclass
class WarmupReport:
    """What a warmup pass built, and what it cost."""
    n_precompiled: int = 0               # executables pinned by this pass
    n_already_cached: int = 0            # keys that were already present
    cold_start_s: float = 0.0            # wall clock of the whole pass
    capture_s: float = 0.0
    warm_s: float = 0.0
    records: List[ExecutableRecord] = dataclasses.field(default_factory=list)

    def add(self, rec: ExecutableRecord) -> None:
        self.n_precompiled += 1
        self.capture_s += rec.capture_s
        self.warm_s += rec.warm_s
        self.records.append(rec)

    def merge(self, other: "WarmupReport") -> "WarmupReport":
        self.n_precompiled += other.n_precompiled
        self.n_already_cached += other.n_already_cached
        self.cold_start_s += other.cold_start_s
        self.capture_s += other.capture_s
        self.warm_s += other.warm_s
        self.records.extend(other.records)
        return self

    def to_json(self) -> Dict:
        by_kind: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            agg = by_kind.setdefault(
                r.kind, {"n": 0, "capture_s": 0.0, "warm_s": 0.0})
            agg["n"] += 1
            agg["capture_s"] = round(agg["capture_s"] + r.capture_s, 4)
            agg["warm_s"] = round(agg["warm_s"] + r.warm_s, 4)
        return {"n_precompiled": self.n_precompiled,
                "n_already_cached": self.n_already_cached,
                "cold_start_s": round(self.cold_start_s, 4),
                "capture_s": round(self.capture_s, 4),
                "warm_s": round(self.warm_s, 4),
                "by_kind": by_kind}


def _build(build, cfg: WarmupConfig, obs: Obs, kind: str, bucket: int):
    """Build one executable (+ one warm call on zeros), timed."""
    t0 = time.perf_counter()
    fn = build()
    t1 = time.perf_counter()
    if cfg.warm:
        fn(*fn.zeros())                  # returns host arrays: complete
    rec = ExecutableRecord(kind=kind, bucket=bucket, capture_s=t1 - t0,
                           warm_s=time.perf_counter() - t1)
    obs.metrics.histogram("decision_cold_start_s").record(rec.total_s)
    obs.tracer.point("aot.compile", kind=kind, bucket=bucket,
                     compile_ms=round(rec.capture_s * 1e3, 1))
    return fn, rec


def _warm_cells(replica, cells, cfg: WarmupConfig, obs: Obs,
                rep: WarmupReport) -> None:
    for kind, Bp, (key, build) in cells:
        if key in replica.compiled:
            rep.n_already_cached += 1
            continue
        fn, rec = _build(build, cfg, obs, kind, Bp)
        replica.install(key, fn)
        rep.add(rec)


def warm_service(service: AllocationService,
                 template: Optional[Dict] = None,
                 cfg: WarmupConfig = WarmupConfig(),
                 obs: Optional[Obs] = None) -> WarmupReport:
    """Pre-build the single-replica grid: the policy and priced-policy
    executables at every batch bucket, plus — given an input ``template``
    from ``model_input_template`` — the fused model+policy executables.
    Host-only models (GBDT) need no fused cells: they share the device
    policy stage."""
    o = service.obs if obs is None else obs
    rep = WarmupReport()
    t_wall = time.perf_counter()
    fused_ok = cfg.fused and service.model.supports_fused and template
    with o.tracer.span("aot.warmup", scope="service"):
        for Bp in cfg.bucket_set(service.batch_floor):
            for wo in cfg.observed:
                cells = [("policy", Bp, service._policy_cell(Bp, wo))]
                if cfg.priced:
                    cells.append(("priced", Bp, service._priced_cell(Bp, wo)))
                if fused_ok:
                    cells.append(("fused", Bp, service._fused_cell(
                        {k: (Bp,) + shape
                         for k, (shape, _) in template.items()}, wo)))
                _warm_cells(service.replica, cells, cfg, o, rep)
    rep.cold_start_s = time.perf_counter() - t_wall
    return rep


def warm_fabric(fabric: ShardedAllocationService,
                template: Optional[Dict] = None,
                cfg: WarmupConfig = WarmupConfig(),
                obs: Optional[Obs] = None) -> WarmupReport:
    """Pre-build the sharded fabric's (K, Bp) grid: the per-shard policy
    stage (priced and unpriced twins) and — with a ``template`` — the
    sharded fused executables. The fabric always passes price/observed as
    stacked arrays."""
    o = fabric.obs if obs is None else obs
    K = fabric.n_shards
    svc = fabric.service
    rep = WarmupReport()
    t_wall = time.perf_counter()
    fused_ok = cfg.fused and fabric.model.supports_fused and template
    priced_opts = (False, True) if cfg.priced else (False,)
    with o.tracer.span("aot.warmup", scope="fabric", K=K):
        for Bp in cfg.bucket_set(svc.batch_floor):
            for wo in cfg.observed:
                cells = [(f"sharded_policy[{'priced' if pr else 'plain'}]",
                          Bp, fabric._sharded_policy_cell(Bp, wo, pr))
                         for pr in priced_opts]
                if fused_ok:
                    cells.append(("sharded_fused", Bp,
                                  fabric._sharded_fused_cell(
                                      {k: (K, Bp) + shape for k, (shape, _)
                                       in template.items()}, wo)))
                _warm_cells(svc.replica, cells, cfg, o, rep)
    rep.cold_start_s = time.perf_counter() - t_wall
    return rep


def warm_allocation_stack(service: AllocationService,
                          fabric: Optional[ShardedAllocationService] = None,
                          *, jobs=None, cfg: WarmupConfig = WarmupConfig(),
                          obs: Optional[Obs] = None) -> WarmupReport:
    """Warm a whole serving stack before traffic: the single-replica grid
    plus (when a fabric is passed) the sharded (K, Bp) grid. ``jobs`` — a
    sequence of ``Job`` plans (e.g. ``trace.jobs``) — derives the fused
    input template via the real featurization path, which for GNNs pins
    the trace's pool-wide node dimension; without it only the
    (model-independent) policy stages are warmed and fused shapes build
    lazily on first miss."""
    o = (service.obs if obs is None else obs) or NULL_OBS
    template = (model_input_template(service.model, jobs)
                if jobs is not None and service.model.supports_fused
                else None)
    rep = warm_service(service, template=template, cfg=cfg, obs=o)
    if fabric is not None:
        rep.merge(warm_fabric(fabric, template=template, cfg=cfg, obs=o))
    o.metrics.counter("aot_precompiled").inc(rep.n_precompiled)
    o.metrics.gauge("aot_cold_start_s").set(round(rep.cold_start_s, 4))
    return rep
