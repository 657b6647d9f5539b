"""A cell's traffic from its parameters and the run's seed.

``make_trace`` runs the frozen ``TraceGenerator`` (Markov-modulated
Poisson arrivals, Zipf repeats over a pool of query templates, SLA
classes) with the cell's parameters. For an open-loop cell the arrivals
are read as wall-clock seconds from the window's start; for a cluster
cell they are the trace's own time. ``to_program`` hands a trace to the
port in the port's own types.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from tasq_bench.traffic.generator import Trace, TraceGenerator

__all__ = ["sub_seed", "make_trace", "to_program"]

_GENERATOR_KEYS = ("n_unique", "n_tenants", "zipf_exponent", "rate_qps",
                   "burst_factor", "p_burst", "p_calm", "max_skyline_s")


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    state = np.random.SeedSequence([int(seed) % (2 ** 64), stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_trace(params: Dict, seed: int, n_events: int) -> Trace:
    """The cell's trace: drawn from the run's seed, or, where the cell
    fixes ``trace_seed``, that one trace whatever the run's seed (the
    run's seed then draws the model and the checked sample)."""
    kw = {k: params[k] for k in _GENERATOR_KEYS if k in params}
    s = params.get("trace_seed")
    return TraceGenerator(seed=sub_seed(seed, 1) if s is None else int(s),
                          **kw).generate(n_events)


def _convert(obj, module):
    """A frozen-copy dataclass as the same-named dataclass of ``module``."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(module, type(obj).__name__)
        return cls(**{f.name: _convert(getattr(obj, f.name), module)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [_convert(x, module) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_convert(x, module) for x in obj)
    return obj


def to_program(trace: Trace, n_events: int = None):
    """``trace`` (its first ``n_events`` events) as a
    ``repro_torch.workloads.Trace``."""
    from repro_torch.workloads import generator as prog
    events = trace.events if n_events is None else trace.events[:n_events]
    return prog.Trace(events=_convert(events, prog),
                      jobs=_convert(trace.jobs, prog),
                      skylines=list(trace.skylines),
                      sla_classes=_convert(trace.sla_classes, prog),
                      seed=trace.seed)
