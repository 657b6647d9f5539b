"""Observability: spans, metrics, Perfetto export, provenance, device fences.

One ``Obs`` bundle threads through every serving layer (service, batcher,
frontend, serving plane, router, simulator, fused replay, MLOps loop).
Every seam calls into it unconditionally (``tracer.span/point/sample``,
``metrics.counter/histogram/gauge``, ``tracer.enabled``); ``NULL_OBS``, the
default everywhere, resolves each call to a shared no-op, so an untraced
run pays one attribute lookup per seam and decides exactly as a traced one.

  * ``tracer``   — span tracer with an injectable clock and a ring buffer
    (``obs/trace.py``, copied from the reference);
  * ``metrics``  — counters, gauges and log-bucketed histograms that merge
    across shards (``obs/metrics.py``, copied);
  * ``recorder`` — sampled ``AllocationRequest -> AllocationDecision``
    provenance rows to JSONL (``obs/flight.py``, copied);
  * ``profile_dir`` — where ``device_profile`` writes a ``torch.profiler``
    trace of the device, or None.

The serving plane adds its own instruments: ``aot.warmup`` spans with one
``aot.compile`` point per pinned executable, the ``decision_cold_start_s``
histogram (capture + warm cost of each executable), ``aot_precompiled`` /
``aot_cold_start_s`` stack totals, the ``backlog_depth`` gauge and
``backlog_saturations`` counter, and the per-thread split of decide
latency into ``decision_compile_s`` (a call that built an executable) and
``decision_latency_s`` (a call that found it).

``fence(x)`` waits for the card to finish the work queued before it, so a
span around a kernel launch closes at device completion, not at dispatch;
``write_trace(path, obs.tracer.records())`` writes a Perfetto trace
(``obs/export.py``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.export import (device_profile, fence, trace_events,
                                    write_trace)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (NULL_METRICS, Counter, Gauge, Histogram,
                                     MetricsRegistry, NullMetrics)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Record, Tracer

__all__ = ["Counter", "FlightRecorder", "Gauge", "Histogram",
           "MetricsRegistry", "NULL_METRICS", "NULL_OBS", "NullMetrics",
           "NullTracer", "Obs", "Record", "Tracer", "device_profile",
           "fence", "trace_events", "write_trace"]


class Obs:
    """The bundle every instrumented layer holds: tracer + metrics +
    flight recorder (+ an optional device-profile directory). Omitted
    pieces resolve to their no-op twins, so instrumentation never
    branches."""

    __slots__ = ("tracer", "metrics", "recorder", "profile_dir")

    def __init__(self, tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 profile_dir: Optional[str] = None):
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = NULL_METRICS if metrics is None else metrics
        self.recorder = recorder
        self.profile_dir = profile_dir

    @classmethod
    def enabled(cls, clock=None, capacity: int = 65536,
                recorder: Optional[FlightRecorder] = None,
                profile_dir: Optional[str] = None) -> "Obs":
        """A fully recording bundle (the one-liner for scripts and tests)."""
        import time
        tr = Tracer(clock=clock or time.perf_counter, capacity=capacity)
        return cls(tracer=tr, metrics=MetricsRegistry(), recorder=recorder,
                   profile_dir=profile_dir)

    @property
    def is_null(self) -> bool:
        return (self.tracer is NULL_TRACER and self.metrics is NULL_METRICS
                and self.recorder is None)


NULL_OBS = Obs()
