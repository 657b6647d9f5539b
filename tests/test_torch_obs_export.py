"""The observability plane's export and provenance pieces, port against
reference on the CPU: ``FlightRecorder`` rows (and their JSONL) and
``trace_events`` / ``write_trace`` output equal the reference's for the
same records, and the port's serving stack feeds both as the reference's
does. ``repro.obs`` and ``repro.api.types`` import without the
reference's ``enable_x64`` alias, so both sides run in this process.
"""
import json

import numpy as np
import pytest

from repro.api import types as ref_types
from repro import obs as ref_obs
from repro_torch import obs
from repro_torch.api import (AllocationDecision, AllocationRequest,
                             Allocator, DecisionContext, Provenance)
from repro_torch.api import types as port_types
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.serve import AllocationService


def _clock():
    t = [0.0]

    def tick():
        t[0] += 0.00125
        return t[0]
    return tick


def _drive_tracer(pkg):
    tr = pkg.Tracer(clock=_clock(), capacity=64)
    with tr.span("service.decide", B=8, path="model") as sp:
        tr.point("frontend.submit", id=3)
        with tr.span("fabric.decide", track=2, K=4):
            tr.sample("pool_in_use", track=1, shard0=5, shard1=7)
        sp.attrs["compiled"] = True
    tr.point("epoch", t_sim=15.0, arrived=np.int64(4))
    tr.sample("queue_depth", shard0=1)
    with tr.span("aot.warmup", scope="service", obj=object()):
        pass
    return tr


def test_trace_events_equal_reference():
    mine, theirs = _drive_tracer(obs), _drive_tracer(ref_obs)
    strip = lambda evs: [{k: v for k, v in e.items()
                          if not (k == "args" and "obj" in v)} for e in evs]
    got = obs.trace_events(mine.records(), pid=2,
                           track_names={1: "shard 0"})
    want = ref_obs.trace_events(theirs.records(), pid=2,
                                track_names={1: "shard 0"})
    assert strip(got) == strip(want)
    assert len(got) == len(want) > 6
    assert obs.trace_events([]) == ref_obs.trace_events([]) == []
    got0 = obs.trace_events(mine.records(), time_offset_s=0.0)
    want0 = ref_obs.trace_events(theirs.records(), time_offset_s=0.0)
    assert strip(got0) == strip(want0)


def test_write_trace_equals_reference(tmp_path):
    mine, theirs = _drive_tracer(obs), _drive_tracer(ref_obs)
    n = obs.write_trace(str(tmp_path / "a" / "port.json"), mine.records())
    m = ref_obs.write_trace(str(tmp_path / "b" / "ref.json"),
                            theirs.records())
    assert n == m
    got = json.loads((tmp_path / "a" / "port.json").read_text())
    want = json.loads((tmp_path / "b" / "ref.json").read_text())
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    assert len(got["traceEvents"]) == len(want["traceEvents"]) == n
    for g, w in zip(got["traceEvents"], want["traceEvents"]):
        if "obj" in w.get("args", {}):
            g["args"].pop("obj"), w["args"].pop("obj")
        assert g == w


def _pairs(mod_types, seed):
    """A few columnar request/decision/context triples of one package."""
    rng = np.random.RandomState(seed)
    out = []
    for B in (5, 1, 17, 40):
        req = mod_types.AllocationRequest(
            a=-rng.uniform(0.1, 2, B), b=rng.uniform(10, 900, B),
            observed_tokens=rng.randint(1, 500, B),
            template_id=rng.randint(0, 30, B), sla=rng.randint(0, 3, B),
            deadline_s=rng.uniform(100, 900, B),
            preempted=rng.rand(B) < 0.2)
        toks = rng.randint(1, 500, B).astype(np.int64)
        rt = rng.uniform(1, 1e3, B)
        dec = mod_types.AllocationDecision(
            tokens=toks, runtime=rt, a=req.a, b=req.b,
            cost=toks * rt, price=rng.choice([1.0, 1.5], B),
            shard=rng.randint(0, 4, B),
            provenance=rng.randint(0, 2, B).astype(np.int8))
        ctx = mod_types.DecisionContext(price=dec.price)
        out.append((req, dec, ctx, rng.rand(B) < 0.5))
    return out


@pytest.mark.parametrize("rate", [1.0, 0.3, 0.0])
def test_flight_recorder_rows_equal_reference(tmp_path, rate):
    recs = []
    for pkg, types_mod, name in ((obs, port_types, "port"),
                                 (ref_obs, ref_types, "ref")):
        path = tmp_path / name / "decisions.jsonl"
        fr = pkg.FlightRecorder(str(path), sample_rate=rate, seed=11,
                                max_rows=50)
        fr.model_version = 2
        fr.drift_score = 0.5
        kept = []
        for i, (req, dec, ctx, sp) in enumerate(
                _pairs(types_mod, 4)):
            kept.append(fr.record(req, dec, ctx, now=8.0 * i,
                                  spilled=sp if i % 2 else None))
        fr.close()
        text = path.read_text() if path.exists() else ""
        recs.append((kept, fr.rows(), fr.n_seen, fr.n_recorded, text))
    assert recs[0] == recs[1]
    if rate == 1.0:
        assert recs[0][3] == 63 and len(recs[0][1]) == 50


def test_obs_bundle_surface_equals_reference():
    for pkg in (obs, ref_obs):
        assert pkg.NULL_OBS.is_null and pkg.Obs().recorder is None
        o = pkg.Obs.enabled(clock=_clock(), capacity=8,
                            recorder=pkg.FlightRecorder(sample_rate=1.0))
        assert not o.is_null and o.recorder is not None
        assert o.tracer.capacity == 8
    assert obs.Obs.__slots__ == ref_obs.Obs.__slots__


def test_decide_feeds_the_recorder_spans_and_latency_split():
    """A service decide lands one ``service.decide`` span (its
    ``compiled`` attribute true only where the call built an executable),
    its latency in ``decision_compile_s`` then ``decision_latency_s``, and
    one recorder row per sampled query carrying the decision."""
    o = obs.Obs.enabled(recorder=obs.FlightRecorder(sample_rate=1.0,
                                                    seed=3))

    class _Host:                       # a host model: (a, b) given
        family, supports_fused, device = "host", False, None

    svc = AllocationService(_Host(), AllocationPolicy(max_slowdown=0.05),
                            device="cpu", obs=o)
    rng = np.random.RandomState(0)
    req = AllocationRequest(a=-rng.uniform(0.2, 1.5, 12),
                            b=rng.uniform(50, 500, 12),
                            observed_tokens=rng.randint(8, 400, 12))
    d1 = svc.decide(req, DecisionContext(price=np.full(12, 1.5)))
    d2 = svc.decide(req, DecisionContext(price=np.full(12, 1.5)))
    np.testing.assert_array_equal(d1.tokens, d2.tokens)
    spans = [r for r in o.tracer.spans() if r.name == "service.decide"]
    assert [s.attrs["compiled"] for s in spans] == [True, False]
    assert o.metrics.histogram("decision_compile_s").n == 1
    assert o.metrics.histogram("decision_latency_s").n == 1
    rows = o.recorder.rows()
    assert len(rows) == 24
    assert [r["tokens"] for r in rows[:12]] == d1.tokens.tolist()
    assert {r["provenance"] for r in rows} == {"HISTORY"}
    assert all(r["price"] == 1.5 for r in rows)
    assert svc.stats["compiles"] == 1 and svc.stats["calls"] == 2
    assert isinstance(d1, AllocationDecision)
    assert int(Provenance.HISTORY) == 1
    alloc = Allocator(svc, n_shards=2)
    alloc.decide(req, DecisionContext(shard_of=np.arange(12) % 2))
    assert [r.name for r in o.tracer.spans()][-1] == "fabric.decide"
    assert {r["shard"] for r in o.recorder.rows()[24:]} == {0, 1}
