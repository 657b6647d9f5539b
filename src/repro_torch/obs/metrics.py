"""Metrics registry: counters, gauges, and log-bucketed latency histograms.

The histogram is the load-bearing piece: decision latency has a 5-decade
dynamic range (cached policy call vs first-request jit compile), so buckets
are geometric — ``edges[i] = lo * growth**i`` with ``growth = 2**(1/4)``
(~19% relative resolution per bucket, ~186 buckets across 1e-7..1e4 s).
Recording is one ``searchsorted`` per batch; the counts array is the whole
state, so histograms from the K shard registries **merge by adding
counts** — merged percentiles are *identical* to the percentiles of the
whole population histogrammed in one place (same counts, same cumsum; the
property tests/test_obs.py pins).

Percentiles are read from the bucket upper edge where the cumulative count
crosses, i.e. a <=19% overestimate bounded by bucket resolution — the
right trade for p99/p999 SLO gates, which want "no worse than" semantics.

``MetricsRegistry.snapshot()`` is JSON-ready (written next to
``results/benchmarks.json`` by the benchmark harness); ``NULL_METRICS``
is the no-op twin the disabled plane installs.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_METRICS", "NullMetrics"]

_GROWTH = 2.0 ** 0.25


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> None:
        self.value += other.value

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def merge(self, other: "Gauge") -> None:
        self.value = max(self.value, other.value)   # peak across shards

    def snapshot(self):
        return self.value


class Histogram:
    """Log-bucketed histogram; state is one int64 counts array."""

    __slots__ = ("name", "lo", "hi", "edges", "counts", "n", "total",
                 "vmin", "vmax")

    def __init__(self, name: str, lo: float = 1e-7, hi: float = 1e4):
        assert 0 < lo < hi
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        n_buckets = int(math.ceil(math.log(hi / lo) / math.log(_GROWTH)))
        # bucket i covers (edges[i-1], edges[i]]; under/overflow get the
        # outermost buckets so no sample is ever lost
        self.edges = lo * _GROWTH ** np.arange(1, n_buckets + 1)
        self.counts = np.zeros(n_buckets, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        self.record_many(np.asarray([value], np.float64))

    def record_many(self, values: np.ndarray) -> None:
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        idx = np.clip(np.searchsorted(self.edges, v, side="left"),
                      0, self.counts.size - 1)
        np.add.at(self.counts, idx, 1)
        self.n += int(v.size)
        self.total += float(v.sum())
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))

    def merge(self, other: "Histogram") -> None:
        # full edge-geometry equality, not just size/lo: two histograms with
        # the same bucket count and lower bound but different growth factors
        # (or hi) would otherwise merge silently, adding counts bucket-by-
        # bucket across *different* value ranges and corrupting percentiles
        assert self.counts.size == other.counts.size \
            and self.lo == other.lo and self.hi == other.hi \
            and np.array_equal(self.edges, other.edges), \
            (self.name, "bucket-geometry mismatch",
             (self.lo, self.hi, self.counts.size),
             (other.lo, other.hi, other.counts.size))
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket where the cumulative count crosses the
        q-th percentile — exact to bucket resolution, never an underestimate
        beyond it (the conservative direction for SLO gates)."""
        if self.n == 0:
            return math.nan
        rank = max(int(math.ceil(q / 100.0 * self.n)), 1)
        i = int(np.searchsorted(np.cumsum(self.counts), rank))
        return float(self.edges[min(i, self.edges.size - 1)])

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else math.nan

    def snapshot(self) -> Dict:
        return {
            "count": self.n,
            "sum": round(self.total, 9),
            "min": None if self.n == 0 else self.vmin,
            "max": None if self.n == 0 else self.vmax,
            "mean": None if self.n == 0 else self.mean,
            "p50": None if self.n == 0 else self.percentile(50),
            "p99": None if self.n == 0 else self.percentile(99),
            "p999": None if self.n == 0 else self.percentile(99.9),
        }


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    One registry per shard (or per run); ``merge`` folds the K shard
    registries into a fabric-wide view — histograms add counts, counters
    add values, gauges keep the peak.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        assert isinstance(m, cls), (name, type(m), cls)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str, lo: float = 1e-7,
                  hi: float = 1e4) -> Histogram:
        return self._get(Histogram, name, lo=lo, hi=hi)

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for name, m in other._metrics.items():
            mine = self._metrics.get(name)
            if mine is None:
                mine = (Histogram(name, m.lo, m.hi)
                        if isinstance(m, Histogram) else type(m)(name))
                self._metrics[name] = mine
            mine.merge(m)
        return self

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready {name: value-or-histogram-summary} map."""
        return {name: self._metrics[name].snapshot()
                for name in self.names()}

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)


class _NullInstrument:
    __slots__ = ()
    value = 0
    n = 0
    mean = math.nan

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, value: float) -> None:
        pass

    def record_many(self, values) -> None:
        pass

    def percentile(self, q: float) -> float:
        return math.nan

    def snapshot(self):
        return None


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    """Disabled twin: every accessor hands back one shared no-op."""

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, lo: float = 1e-7,
                  hi: float = 1e4) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def merge(self, other) -> "NullMetrics":
        return self

    def names(self) -> List[str]:
        return []

    def snapshot(self) -> Dict:
        return {}

    def save(self, path: str) -> None:
        pass


NULL_METRICS = NullMetrics()
