"""Perfetto / Chrome ``trace_event`` export of the tracer's ring buffer,
and the device-side helpers.

``trace_events`` maps ``Record`` rows to the Trace Event JSON format both
the Perfetto UI (ui.perfetto.dev) and ``chrome://tracing`` load natively:

  * spans    -> ``"ph": "X"`` complete events (``ts`` + ``dur`` in µs),
  * points   -> ``"ph": "i"`` instant events,
  * counters -> ``"ph": "C"`` counter samples — one series per key in the
    record's values dict, which is how the fused replay's per-shard pool
    occupancy renders as a per-shard timeline;
  * each used track additionally gets a ``"ph": "M"`` thread_name metadata
    row, so lanes read "shard 3", not "tid 4".

Events are sorted by ``ts`` within each (pid, tid) lane. ``write_trace``
wraps them in the ``{"traceEvents": [...]}`` envelope. Both are copied
from the reference.

Device-side helpers: ``fence(x)`` waits for the card to finish the work
queued before it (put a kernel launch's outputs through it *inside* its
span, so the span closes at device completion, not at dispatch); and
``device_profile(dir)`` traces the host and the card with
``torch.profiler`` while a block runs.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.obs.trace import Record

__all__ = ["device_profile", "fence", "trace_events", "write_trace"]

_PH = {"span": "X", "point": "i", "counter": "C"}


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


def _json_safe(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def trace_events(records: Iterable[Record], pid: int = 0,
                 track_names: Optional[Dict[int, str]] = None,
                 time_offset_s: Optional[float] = None) -> List[Dict]:
    """Trace Event rows from tracer records, ts-sorted within each lane.

    ``ts`` is microseconds relative to the earliest record (or to
    ``time_offset_s``), so traces from fake clocks and perf counters both
    start near zero.
    """
    recs = sorted(records, key=lambda r: (r.track, r.t0, r.t1))
    if not recs:
        return []
    t0 = (min(r.t0 for r in recs) if time_offset_s is None
          else float(time_offset_s))
    us = lambda t: round((t - t0) * 1e6, 3)
    events: List[Dict] = []
    used_tracks = sorted({r.track for r in recs})
    names = track_names or {}
    for track in used_tracks:
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": track,
            "ts": 0,
            "args": {"name": names.get(track, f"track {track}")},
        })
    for r in recs:
        if r.kind == "counter":
            events.append({
                "ph": "C", "name": r.name, "pid": pid, "tid": r.track,
                "ts": us(r.t0),
                "args": {k: _json_safe(v) for k, v in r.attrs.items()},
            })
        elif r.kind == "point":
            events.append({
                "ph": "i", "name": r.name, "pid": pid, "tid": r.track,
                "ts": us(r.t0), "s": "t",
                "args": {k: _json_safe(v) for k, v in r.attrs.items()},
            })
        else:
            events.append({
                "ph": "X", "name": r.name, "pid": pid, "tid": r.track,
                "ts": us(r.t0), "dur": max(us(r.t1) - us(r.t0), 0.0),
                "args": {k: _json_safe(v) for k, v in r.attrs.items()},
            })
    return events


def write_trace(path: str, records: Iterable[Record], pid: int = 0,
                track_names: Optional[Dict[int, str]] = None) -> int:
    """Write the Perfetto-loadable envelope; returns the event count."""
    events = trace_events(records, pid=pid, track_names=track_names)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)
