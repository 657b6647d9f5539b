"""Device time and device counters for spans that must not sync the host.

``DeviceTrace(obs, device)`` opens ``obs.tracer`` spans that also record a
CUDA event at their start and end on the current stream, and keeps
counters as 0-d int64 tensors on the card that device code adds to. Both
are read by ``flush()``, which the caller makes once it has synchronized
anyway (a served batch's one copy of its tokens to the host): each span
gets its ``device_ms``, and each counter's value is added to the
``obs.metrics`` counter of its name and set back to 0, in one copy. So
tracing adds no sync to a step. Without a recording tracer, or off the
card, ``span`` is the tracer's own span (no events) and ``counter``
returns None, so the traced code computes nothing for it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["DeviceTrace"]


class _DeviceSpan:
    __slots__ = ("_trace", "_ctx", "_rec", "_e0")

    def __init__(self, trace: "DeviceTrace", ctx):
        self._trace = trace
        self._ctx = ctx

    def __enter__(self):
        self._rec = self._ctx.__enter__()
        self._e0 = torch.cuda.Event(enable_timing=True)
        self._e0.record()
        return self._rec

    def __exit__(self, *exc) -> bool:
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        self._trace._pending.append((self._rec, self._e0, e1))
        return self._ctx.__exit__(*exc)


class DeviceTrace:
    """Spans with CUDA-event device time and on-card counters (above)."""

    def __init__(self, obs, device):
        self.obs = obs
        self.recording = bool(obs.tracer.enabled)
        self.timed = self.recording and torch.device(device).type == "cuda"
        self.device = torch.device(device)
        self._pending: List[Tuple[object, torch.cuda.Event,
                                  torch.cuda.Event]] = []
        self._counters: Dict[str, torch.Tensor] = {}

    def span(self, name: str, **attrs):
        ctx = self.obs.tracer.span(name, **attrs)
        return _DeviceSpan(self, ctx) if self.timed else ctx

    def counter(self, name: str) -> Optional[torch.Tensor]:
        """The 0-d int64 tensor on the device that counts ``name`` until
        the next ``flush``, or None where nothing records."""
        if not self.recording:
            return None
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = torch.zeros(
                (), dtype=torch.int64, device=self.device)
        return c

    def flush(self) -> None:
        """After a synchronize: ``device_ms`` onto each span closed since
        the last flush, and the counters into ``obs.metrics``."""
        for rec, e0, e1 in self._pending:
            rec.attrs["device_ms"] = e0.elapsed_time(e1)
        self._pending.clear()
        if self._counters:
            names = list(self._counters)
            values = torch.stack([self._counters[n] for n in names]).tolist()
            for n, v in zip(names, values):
                self.obs.metrics.counter(n).inc(int(v))
                self._counters[n].zero_()
