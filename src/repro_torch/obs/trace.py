"""Span tracer: request-lifecycle timing with near-zero disabled overhead.

The serving plane is instrumented *always* — every seam calls
``obs.tracer.span(...)`` unconditionally — and the cost is decided by which
tracer is installed:

  * ``Tracer`` records ``Record`` rows (spans, instant points, counter
    samples) into a fixed-size ring buffer. The clock is injectable, so
    drivers and tests can run the whole plane on simulated time and get
    deterministic span timings; nesting is tracked with an explicit stack,
    so every span knows its parent and depth without thread-local magic.
  * ``NullTracer`` is the disabled twin: ``span()`` hands back one shared
    context manager whose ``__enter__``/``__exit__`` do nothing and
    allocate nothing — the instrumented hot paths pay one attribute lookup
    and one no-op call, which the ``obs_overhead`` benchmark gates at ~0%.

Records are plain host-side rows; nothing here touches the device,
or the decision kernels, which is what keeps a traced replay
decision-identical to an untraced one (tests/test_obs.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

__all__ = ["NULL_TRACER", "NullTracer", "Record", "Tracer"]


@dataclasses.dataclass(slots=True)
class Record:
    """One ring-buffer row: a completed span, an instant point, or a
    counter sample (``kind`` in {"span", "point", "counter"})."""
    kind: str
    name: str
    t0: float                 # clock seconds (span start / event time)
    t1: float                 # span end; == t0 for points and counters
    track: int                # export lane (shard rank, 0 = host/control)
    depth: int                # nesting depth at record time (spans)
    attrs: Dict               # span attributes / counter values


class _SpanCtx:
    """Context manager for one live span; ``__enter__`` returns the
    ``Record`` so callers can attach attributes discovered mid-span."""

    __slots__ = ("_tracer", "_rec")

    def __init__(self, tracer: "Tracer", rec: Record):
        self._tracer = tracer
        self._rec = rec

    def __enter__(self) -> Record:
        return self._rec

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        rec = self._rec
        rec.t1 = tr.clock()
        tr._stack.pop()
        tr._append(rec)
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullCtx()


class Tracer:
    """Recording tracer: fixed-capacity ring buffer + injectable clock."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 65536):
        assert capacity >= 1
        self.clock = clock
        self.capacity = int(capacity)
        self.dropped = 0                     # rows evicted by the ring
        self._ring: List[Record] = []
        self._at = 0                         # next write slot once full
        self._stack: List[Record] = []       # open spans (nesting)
        self._seq = 0                        # rows ever appended

    # ------------------------------------------------------------ recording --
    def _append(self, rec: Record) -> None:
        if len(self._ring) < self.capacity:
            self._ring.append(rec)
        else:
            self._ring[self._at] = rec
            self._at = (self._at + 1) % self.capacity
            self.dropped += 1
        self._seq += 1

    def span(self, name: str, track: int = 0, **attrs) -> _SpanCtx:
        """Open a span; closes (and records) when the ``with`` exits."""
        rec = Record("span", name, self.clock(), 0.0, track,
                     len(self._stack), attrs)
        self._stack.append(rec)
        return _SpanCtx(self, rec)

    def point(self, name: str, track: int = 0, **attrs) -> None:
        """Record an instant event (lease grant, expiry, completion...)."""
        t = self.clock()
        self._append(Record("point", name, t, t, track,
                            len(self._stack), attrs))

    def sample(self, name: str, track: int = 0, **values) -> None:
        """Record a counter sample (pool occupancy, queue depth...);
        ``values`` become the per-series counter values in the export."""
        t = self.clock()
        self._append(Record("counter", name, t, t, track,
                            len(self._stack), values))

    # ------------------------------------------------------------- reading --
    def records(self) -> List[Record]:
        """Completed rows, oldest first (ring order restored)."""
        return self._ring[self._at:] + self._ring[:self._at]

    def spans(self) -> List[Record]:
        return [r for r in self.records() if r.kind == "span"]

    def clear(self) -> None:
        self._ring = []
        self._at = 0
        self.dropped = 0
        self._stack = []


class NullTracer:
    """The disabled plane: every call is a no-op, nothing allocates."""

    enabled = False
    clock = staticmethod(time.perf_counter)
    dropped = 0

    def span(self, name: str, track: int = 0, **attrs) -> _NullCtx:
        return _NULL_CTX

    def point(self, name: str, track: int = 0, **attrs) -> None:
        pass

    def sample(self, name: str, track: int = 0, **values) -> None:
        pass

    def records(self) -> List[Record]:
        return []

    def spans(self) -> List[Record]:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()
