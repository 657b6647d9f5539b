"""Cluster control traced from inside the port, on the CPU.

One small ``run_cluster`` pass under ``Obs.enabled()``, in the benchmark's
configuration (EDF, elastic resize and pricing, fused K2 / K3, 4 shards)
and in an unfused, preempting one: a ``cluster.epoch`` span an epoch,
every other span inside a ``cluster.setup``, ``cluster.epoch`` or
``cluster.report`` span (the pool's ``cluster.featurize`` is one level
down, in the set-up), nothing inside the admission spans, the
``device_syncs.*`` counters equal to the syncs that the launches and
decides it made imply, and a report equal to an untraced pass's. Under a
``torch.profiler`` every span is also a profiler range; with none running
no range is entered. The tracer keeps one open-span stack a thread.
"""
import json
import threading
import types
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.api import Allocator
from repro_torch.cluster import ClusterConfig
from repro_torch.cluster import pcc_cache as cache_mod
from repro_torch.cluster import pool as pool_mod
from repro_torch.cluster import simulator as sim_mod
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.featurize import Standardizer, batch_job_features
from repro_torch.core.models import build_model
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.obs import Obs, Tracer
from repro_torch.serve import AllocationService
from repro_torch.serve.aot import model_pool_inputs
from repro_torch.workloads import TraceGenerator

CONFIGS = {
    "fused": ClusterConfig(capacity=2048, epoch_s=4.0, n_shards=4,
                           admission="edf", elastic=True, pricing="elastic",
                           fused=True),
    "preempt": ClusterConfig(capacity=1024, epoch_s=4.0, n_shards=2,
                             admission="drf", elastic=True,
                             pricing="elastic", preemption=True),
}
ADMISSION = ("cluster_epoch_step", "scheduler.admit")


def _model(trace):
    """A seeded, untrained NN model on the CPU over the trace's jobs."""
    g = torch.Generator().manual_seed(3)
    pool = model_pool_inputs(types.SimpleNamespace(family="nn"), trace.jobs)
    module = MLP(pool["features"].shape[1], (32, 16), generator=g)
    return build_model("nn", device="cpu").load(
        module, scaler=PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5),
        std=Standardizer(batch_job_features(trace.jobs)))


def _pass(model, trace, cfg, obs=None):
    """One ``run_cluster`` pass of a fresh service and allocator on
    ``obs``."""
    svc = AllocationService(model, AllocationPolicy(max_slowdown=0.05),
                            device="cpu", obs=obs)
    return Allocator(svc, n_shards=cfg.n_shards, obs=obs).run_cluster(
        trace, cfg)


@pytest.fixture(scope="module")
def trace():
    return TraceGenerator(seed=7, n_unique=30, rate_qps=1.0).generate(320)


@pytest.fixture(scope="module")
def model(trace):
    return _model(trace)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, model, trace):
    """An untraced and a traced pass of one configuration, with the calls
    that the traced one made at each sync site counted."""
    cfg = CONFIGS[request.param]
    untraced = _pass(model, trace, cfg)
    calls = Counter()
    mp = pytest.MonkeyPatch()

    def counting(mod, name, key):
        orig = getattr(mod, name)

        def wrapper(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        mp.setattr(mod, name, wrapper)

    counting(sim_mod, "arepas_runtimes", "k1")
    counting(cache_mod, "arepas_runtimes", "refit")
    counting(pool_mod, "cluster_epoch_step", "k2")
    counting(sim_mod, "cluster_resize_step", "k3")
    counting(pool_mod, "_scatter_tables", "scatter")
    obs = Obs.enabled(capacity=1 << 20)
    try:
        traced = _pass(model, trace, cfg, obs)
    finally:
        mp.undo()
    return types.SimpleNamespace(cfg=cfg, untraced=untraced, traced=traced,
                                 obs=obs, calls=calls)


def test_report_equals_an_untraced_pass(runs):
    a, b = runs.untraced, runs.traced
    assert a.metrics == b.metrics
    assert a.n_epochs == b.n_epochs
    np.testing.assert_array_equal(a.alloc_errors, b.alloc_errors)
    np.testing.assert_array_equal(a.cache_hits, b.cache_hits)
    assert a.service_stats == b.service_stats


def test_an_epoch_span_an_epoch_and_every_span_inside_a_top_span(runs):
    spans = runs.obs.tracer.spans()
    counters = runs.obs.metrics.snapshot()
    epochs = [s for s in spans if s.name == "cluster.epoch"]
    assert len(epochs) == counters["epochs"] == runs.traced.n_epochs > 0
    top = [s for s in spans if s.depth == 0]
    assert Counter(s.name for s in top) == Counter(
        {"cluster.setup": 1, "cluster.epoch": len(epochs),
         "cluster.report": 1})
    starts = sorted((s.t0, s.t1) for s in top)
    for s in spans:
        if s.depth == 0:
            continue
        assert any(t0 <= s.t0 and s.t1 <= t1 for t0, t1 in starts), s
    phases = Counter(s.name for s in spans if s.depth == 1
                     and s.name.startswith("cluster."))
    want = {"cluster.complete", "cluster.price", "cluster.arrive",
            "cluster.shrink", "cluster.admit", "cluster.grow"}
    if runs.cfg.preemption:
        want.add("cluster.preempt")
    assert want <= set(phases) <= want | {"cluster.reprice",
                                          "cluster.featurize"}
    for name in want:
        assert phases[name] == len(epochs), name
    # the host loop's own spans sit below a phase, as before
    for s in spans:
        if s.name in ("scheduler.expire", "router.route", "fabric.decide",
                      "cluster_resize_step") + ADMISSION:
            assert s.depth == 2, s


def test_nothing_inside_the_admission_spans(runs):
    spans = runs.obs.tracer.spans()
    admits = [s for s in spans if s.name in ADMISSION]
    assert admits
    for a in admits:
        inside = [s for s in spans if s.depth > a.depth
                  and a.t0 <= s.t0 and s.t1 <= a.t1]
        assert not inside, (a, inside)


def test_sync_counter_equals_the_syncs_of_the_launches(runs):
    c = runs.obs.metrics.snapshot()
    n = runs.calls
    syncs = {k[len("device_syncs."):]: v for k, v in c.items()
             if k.startswith("device_syncs.")}
    want = {"skylines": 2, "pool.tables": 2,
            "decide": runs.traced.service_stats["calls"],
            "k1.in": 2 * n["k1"], "k1.out": n["k1"],
            "refit.out": n["refit"],
            "k2.in": 3 * n["k2"], "k2.out": 2 * n["k2"],
            "k3.out": n["k3"], "pool.scatter": 3 * n["scatter"]}
    assert syncs == {k: v for k, v in want.items() if v}
    assert runs.cfg.fused == bool(n["k2"] and n["k3"])
    waits = {k[len("device_wait_s."):] for k in c
             if k.startswith("device_wait_s.")}
    assert waits == set(syncs)
    assert all(c["device_wait_s." + k] >= 0.0 for k in waits)


def test_profiler_ranges_carry_every_span_name(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    trace = TraceGenerator(seed=5, n_unique=12, rate_qps=1.0).generate(60)
    obs = Obs.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _pass(_model(trace), trace, CONFIGS["fused"], obs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = Counter(e["name"] for e in events
                     if e.get("cat") == "user_annotation")
    spans = Counter(s.name for s in obs.tracer.spans())
    assert spans and all(ranges[k] == v for k, v in spans.items())


def test_no_profiler_range_without_a_profiler(model, trace, monkeypatch):
    entered = []
    orig = torch.autograd.profiler.record_function

    def counting(*a, **k):
        entered.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    obs = Obs.enabled()
    _pass(model, trace, CONFIGS["fused"], obs)
    assert obs.tracer.spans() and entered == []


def test_each_thread_keeps_its_own_span_stack():
    """Two threads open and close spans in lock step; each records the
    depths of its own nesting, as it would alone."""
    tr = Tracer()
    steps = [threading.Barrier(2) for _ in range(4)]

    def work(tag):
        with tr.span(f"{tag}.outer"):
            steps[0].wait()
            with tr.span(f"{tag}.inner"):
                steps[1].wait()
                tr.point(f"{tag}.point")
                steps[2].wait()
            steps[3].wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    depth = {r.name: r.depth for r in tr.records()}
    assert depth == {"a.outer": 0, "a.inner": 1, "a.point": 2,
                     "b.outer": 0, "b.inner": 1, "b.point": 2}


def test_a_span_closes_its_own_record():
    """A span that closes while a later one is still open takes its own
    record off the stack, not the last one pushed."""
    tr = Tracer()
    first = tr.span("first")
    first.__enter__()
    second = tr.span("second")
    second.__enter__()
    first.__exit__(None, None, None)
    with tr.span("third"):
        pass
    second.__exit__(None, None, None)
    depth = {r.name: r.depth for r in tr.spans()}
    assert depth == {"first": 0, "second": 1, "third": 1}
    with tr.span("fourth"):
        pass
    assert tr.spans()[-1].depth == 0
