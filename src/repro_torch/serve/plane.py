"""ServingPlane: a continuously-warm, event-driven allocation hot path.

The epoch loops decide in synchronous batches; a deployed allocation
service sits in front of a request stream. ``ServingPlane`` is that
serving side:

  * a bounded ``Backlog`` between admission and decision — when decisions
    fall behind arrivals the queue fills and ``submit`` *blocks the
    producer* (backpressure) instead of growing an unbounded buffer;
  * worker threads draining the backlog, each owning a ``MicroBatcher``
    (signature grouping + padded buckets) so a drained chunk is decided in
    one executable call per shape group;
  * AOT warmup on ``start()``: the executable grid the plane can dispatch
    (buckets up to ``batch_bucket(max_batch)``, observed and hint-free,
    priced twins, fused model cells when warm jobs are provided) is
    built (captured as CUDA graphs on the card) and pinned before the
    first request, so the hot path never builds (``repro_torch.serve.aot``).

Thread-safety note: one ``MicroBatcher`` is *per worker* — the batcher
itself is single-threaded by design; concurrency lives in the backlog, in
``ReplicaState``'s locked cache/counters and in its replay lock, which
serialises the replica's graph replays (they share static buffers and one
memory pool). Submissions return ``concurrent.futures.Future`` objects
resolving to the allocated tokens; a batch whose decide raises fails its
futures with that exception and the worker keeps serving.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.types import AllocationRequest
from repro_torch.obs import NULL_OBS, Obs
from repro_torch.serve.aot import (WarmupConfig, WarmupReport,
                                   warm_allocation_stack)
from repro_torch.serve.batching import MicroBatcher, batch_bucket

__all__ = ["Backlog", "ServingPlane"]


class Backlog:
    """Bounded admission queue with backpressure accounting.

    A full backlog blocks the producing ``put`` until a worker drains a
    slot — arrivals beyond service capacity slow the producer down rather
    than accumulate without bound. Every saturation event is counted
    (``backlog_saturations``) and the depth is exported as a gauge
    (``backlog_depth``) on both enqueue and dequeue, so a saturated plane
    is visible in the metrics, not just in producer latency.
    """

    def __init__(self, capacity: int = 1024, obs: Optional[Obs] = None):
        assert capacity >= 1
        self.capacity = int(capacity)
        self.obs = NULL_OBS if obs is None else obs
        self._q: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        self._saturations = 0

    def __len__(self) -> int:
        return self._q.qsize()

    @property
    def saturations(self) -> int:
        """Times a ``put`` found the queue full (producer backpressured)."""
        return self._saturations

    def put(self, item, block: bool = True) -> None:
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self._saturations += 1
            self.obs.metrics.counter("backlog_saturations").inc()
            if not block:
                raise
            self._q.put(item)            # backpressure: block the producer
        self.obs.metrics.gauge("backlog_depth").set(self._q.qsize())

    def get(self, timeout: Optional[float] = None):
        item = self._q.get(timeout=timeout)
        self.obs.metrics.gauge("backlog_depth").set(self._q.qsize())
        return item

    def get_nowait(self):
        item = self._q.get_nowait()
        self.obs.metrics.gauge("backlog_depth").set(self._q.qsize())
        return item


class ServingPlane:
    """Continuous serving loop: backlog -> worker threads -> executables.

    ``service`` is an ``AllocationService`` or ``ShardedAllocationService``
    (the micro-batcher speaks the same ``decide`` protocol to both).
    ``start()`` AOT-warms the executable grid and spawns the workers;
    ``submit`` enqueues one single-query request and returns a ``Future``
    resolving to the allocated tokens. ``pin_workers=True`` pins worker
    ``i`` to CPU ``i % n_cpus`` (best-effort, Linux only) so decision
    threads don't migrate under load.
    """

    #: how long an idle worker sleeps in ``Backlog.get`` before re-checking
    #: the stop flag — bounds shutdown latency, invisible under traffic
    IDLE_POLL_S = 0.02

    def __init__(self, service, *, n_workers: int = 1, backlog: int = 1024,
                 max_batch: int = 64, node_cap: Optional[int] = None,
                 pin_workers: bool = False, obs: Optional[Obs] = None):
        assert n_workers >= 1
        self.service = service
        self.obs = service.obs if obs is None else obs
        self.n_workers = int(n_workers)
        self.max_batch = int(max_batch)
        self.node_cap = node_cap
        self.pin_workers = bool(pin_workers)
        self.backlog = Backlog(backlog, obs=self.obs)
        self.warmup_report: Optional[WarmupReport] = None
        self._ids = itertools.count()
        self._id_lock = threading.Lock()
        self._stopping = threading.Event()
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------- lifecycle --
    def start(self, warm_jobs=None,
              warmup: Optional[WarmupConfig] = None) -> "ServingPlane":
        """AOT-warm the plane's executable grid, then spawn the workers.

        ``warm_jobs`` (e.g. ``trace.jobs``) derives the fused-model input
        template; without it only the policy-stage grid is warmed and
        fused shapes build lazily on first miss. ``warmup=None`` builds
        the default grid: buckets up to this plane's largest batch, both
        observed modes (the micro-batcher emits either, depending on
        whether any queued request carries a hint).
        """
        if self._threads:
            raise RuntimeError("ServingPlane already started")
        cfg = warmup if warmup is not None else WarmupConfig(
            max_bucket=batch_bucket(self.max_batch), observed=(True, False))
        fabric = getattr(self.service, "service", None)
        if fabric is not None:            # a sharded fabric was passed
            self.warmup_report = warm_allocation_stack(
                self.service.service, self.service, jobs=warm_jobs, cfg=cfg,
                obs=self.obs)
        else:
            self.warmup_report = warm_allocation_stack(
                self.service, None, jobs=warm_jobs, cfg=cfg, obs=self.obs)
        self._stopping.clear()
        for i in range(self.n_workers):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name=f"serving-plane-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def swap_service(self, service) -> None:
        """Atomically repoint the plane at an already-warmed service (model
        hot-swap). Worker micro-batchers pick the new service up before
        their next batch; batches already flushing complete against the
        old one, so in-flight futures are never dropped."""
        self.service = service

    def stop(self) -> None:
        """Drain-and-stop: workers finish everything already admitted (the
        backlog empties) before exiting."""
        self._stopping.set()
        for t in self._threads:
            t.join()
        self._threads = []

    def __enter__(self) -> "ServingPlane":
        if not self._threads:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- admission --
    def submit(self, model_in: Dict[str, np.ndarray],
               observed_tokens: Optional[int] = None,
               block: bool = True) -> "Future[int]":
        """Admit one single-query allocation request.

        Returns a future resolving to the allocated tokens. When the
        backlog is full, ``block=True`` (default) applies backpressure —
        the call blocks until a slot frees; ``block=False`` raises
        ``queue.Full`` so callers can shed load instead.
        """
        if not self._threads:
            raise RuntimeError("ServingPlane not started")
        with self._id_lock:
            rid = next(self._ids)
        fut: "Future[int]" = Future()
        req = AllocationRequest(request_id=rid, model_in=model_in,
                                observed_tokens=observed_tokens)
        self.backlog.put((req, fut), block=block)
        return fut

    def decide(self, model_in: Dict[str, np.ndarray],
               observed_tokens: Optional[int] = None,
               timeout: Optional[float] = None) -> int:
        """Synchronous single-query convenience over ``submit``."""
        return self.submit(model_in, observed_tokens).result(timeout=timeout)

    # --------------------------------------------------------------- workers --
    def _pin(self, idx: int) -> None:
        if not self.pin_workers or not hasattr(os, "sched_setaffinity"):
            return
        try:
            cpus = sorted(os.sched_getaffinity(0))
            os.sched_setaffinity(0, {cpus[idx % len(cpus)]})
        except OSError:                   # best-effort: never fail serving
            pass

    def _worker(self, idx: int) -> None:
        self._pin(idx)
        batcher = MicroBatcher(self.service, max_batch=self.max_batch,
                               obs=self.obs, node_cap=self.node_cap)
        futures: Dict[int, Future] = {}
        while True:
            try:
                item = self.backlog.get(timeout=self.IDLE_POLL_S)
            except queue.Empty:
                if self._stopping.is_set():
                    return
                continue
            # hot-swap pickup: a new batch decides on the plane's current
            # service; the batch already flushing finished on the old one
            if batcher.service is not self.service:
                batcher.service = self.service
            req, fut = item
            batcher.submit(req)
            futures[req.request_id] = fut
            # opportunistically drain without blocking: whatever is already
            # queued rides in this batch, up to the batcher's chunk size
            while len(batcher) < self.max_batch:
                try:
                    req, fut = self.backlog.get_nowait()
                except queue.Empty:
                    break
                batcher.submit(req)
                futures[req.request_id] = fut
            self._flush(batcher, futures)

    def _flush(self, batcher: MicroBatcher, futures: Dict[int, Future]
               ) -> None:
        try:
            results = batcher.flush()
        except BaseException as e:        # fail the batch, keep serving
            for fut in futures.values():
                fut.set_exception(e)
            futures.clear()
            return
        for rid, toks in results.items():
            futures.pop(rid).set_result(toks)
