"""Observability for the cluster plane: spans, metrics, device fences.

One ``Obs`` bundle threads through the serving service, the sharded
fabric, the router, the cluster simulator and the fused replay. Every seam
calls into it unconditionally (``tracer.span/point/sample``,
``metrics.counter/histogram/gauge``, ``tracer.enabled``); ``NULL_OBS``, the
default everywhere, resolves each call to a shared no-op, so an untraced
run pays one attribute lookup per seam and decides exactly as a traced one.

  * ``tracer``  — span tracer with an injectable clock and a ring buffer
    (``obs/trace.py``, copied from the reference);
  * ``metrics`` — counters, gauges and log-bucketed histograms that merge
    across shards (``obs/metrics.py``, copied);
  * ``profile_dir`` — where ``device_profile`` writes a ``torch.profiler``
    trace of the device, or None.

``fence(x)`` waits for the card to finish the work queued before it, so a
span around a kernel launch closes at device completion, not at dispatch.
The reference's flight recorder and Perfetto export belong to the
serving-plane slice and are not here yet.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from repro_torch.obs.metrics import (NULL_METRICS, Counter, Gauge, Histogram,
                                     MetricsRegistry, NullMetrics)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Record, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_METRICS",
           "NULL_OBS", "NullMetrics", "NullTracer", "Obs", "Record", "Tracer",
           "device_profile", "fence"]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def fence(x):
    """Wait until the card has finished the work queued before this call
    on every CUDA device that holds a tensor of ``x`` (a no-op for CPU
    tensors, which are complete when returned); returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


@contextlib.contextmanager
def device_profile(log_dir: Optional[str]):
    """Trace the host and the card with ``torch.profiler`` while the block
    runs and write a Chrome trace to ``<log_dir>/device_trace.json``;
    ``None`` (or an empty string) runs the block untraced."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "device_trace.json"))


class Obs:
    """The bundle every instrumented layer holds: tracer + metrics (+ an
    optional device-profile directory). Omitted pieces resolve to their
    no-op twins, so instrumentation never branches."""

    __slots__ = ("tracer", "metrics", "profile_dir")

    def __init__(self, tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 profile_dir: Optional[str] = None):
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = NULL_METRICS if metrics is None else metrics
        self.profile_dir = profile_dir


NULL_OBS = Obs()
