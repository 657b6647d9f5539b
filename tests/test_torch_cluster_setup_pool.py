"""The resident skyline pool that a cluster pass's set-up builds, on the
CPU.

The set-up uploads every skyline's seconds one after another and
scatters them on the device into a (U, Smax) int32 pool. That pool, the
valid lengths, peaks and areas equal the padded host construction the
pool was once built by (written out here), for skylines of unequal
length: one of a single second, one at Smax, and, where the pool is
built alone, one of none. ``setup_upload_bytes`` counts the bytes
uploaded, 4 a second and 4 a template. Nothing is kept between runs: one
simulator over trace A, then B, then A again reports on each trace what
a fresh simulator reports.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.cluster import ClusterConfig
from repro_torch.cluster.simulator import ClusterSimulator
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.featurize import Standardizer, batch_job_features
from repro_torch.core.models import build_model
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.obs import Obs
from repro_torch.serve import AllocationService
from repro_torch.workloads import TraceGenerator

CFG = ClusterConfig(capacity=2048, epoch_s=4.0, n_shards=4, admission="edf",
                    elastic=True, pricing="elastic", fused=True)


def _padded(skylines):
    """The pool as the set-up built it on the host before: a float32
    (U, Smax) array filled a template at a time, its row maxima and sums,
    then cast to int32."""
    U, smax = len(skylines), max(len(s) for s in skylines)
    sky = np.zeros((U, smax), np.float32)
    lens = np.zeros(U, np.int32)
    for u, s in enumerate(skylines):
        sky[u, :len(s)] = s
        lens[u] = len(s)
    return (sky.astype(np.int32), lens, sky.max(axis=1).astype(np.int64),
            sky.sum(axis=1, dtype=np.float64))


def _trace(seed, n_unique, n_events):
    """A trace whose first template runs for one second."""
    tr = TraceGenerator(seed=seed, n_unique=n_unique,
                        rate_qps=1.0).generate(n_events)
    skylines = list(tr.skylines)
    skylines[0] = np.array([3], skylines[0].dtype)
    return dataclasses.replace(tr, skylines=skylines)


@pytest.fixture(scope="module")
def trace_a():
    return _trace(7, 30, 120)


@pytest.fixture(scope="module")
def trace_b():
    return _trace(19, 24, 100)


@pytest.fixture(scope="module")
def service(trace_a):
    """A seeded, untrained NN model's service on the CPU."""
    module = MLP(batch_job_features(trace_a.jobs).shape[1], (32, 16),
                 generator=torch.Generator().manual_seed(3))
    model = build_model("nn", device="cpu").load(
        module, scaler=PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5),
        std=Standardizer(batch_job_features(trace_a.jobs)))
    return AllocationService(model, AllocationPolicy(max_slowdown=0.05),
                             device="cpu")


def _assert_pool(sky, lens, peaks, areas, skylines):
    want = _padded(skylines)
    got = (sky.cpu().numpy(), lens, peaks, areas)
    for g, w, name in zip(got, want, ("pool", "lens", "peaks", "areas")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_pool_of_a_pass_equals_the_padded_construction(service, trace_a):
    lengths = [len(s) for s in trace_a.skylines]
    assert min(lengths) == 1 and lengths.count(max(lengths)) == 1
    seen = []
    build = ClusterSimulator._skyline_pool

    def spy(self, trace):
        out = build(self, trace)
        seen.append((self._sky.clone(), self._lens.cpu().numpy()) + out)
        return out
    obs = Obs.enabled(capacity=1 << 20)
    mp = pytest.MonkeyPatch()
    mp.setattr(ClusterSimulator, "_skyline_pool", spy)
    try:
        ClusterSimulator(service, CFG, obs=obs).run(trace_a)
    finally:
        mp.undo()
    (sky, d_lens, lens, peaks, areas), = seen
    np.testing.assert_array_equal(d_lens, lens)
    _assert_pool(sky, lens, peaks, areas, trace_a.skylines)
    c = obs.metrics.snapshot()
    assert c["setup_upload_bytes"] == (4 * int(lens.sum())
                                       + 4 * len(trace_a.jobs))
    assert c["device_syncs.skylines"] == 2


def test_pool_with_an_empty_skyline(service, trace_a):
    skylines = list(trace_a.skylines)
    skylines[1] = skylines[1][:0]
    skylines[-1] = skylines[-1][:0]
    sim = ClusterSimulator(service, CFG)
    lens, peaks, areas = sim._skyline_pool(types.SimpleNamespace(
        skylines=skylines))
    _assert_pool(sim._sky, lens, peaks, areas, skylines)
    assert peaks[1] == peaks[-1] == 0 and areas[1] == areas[-1] == 0.0


def test_upload_is_not_counted_without_metrics(service, trace_a):
    sim = ClusterSimulator(service, CFG)
    sim._skyline_pool(trace_a)
    assert sim.obs.metrics.names() == []


def _same_report(a, b):
    assert a.metrics == b.metrics
    assert a.n_epochs == b.n_epochs
    np.testing.assert_array_equal(a.alloc_errors, b.alloc_errors)
    np.testing.assert_array_equal(a.cache_hits, b.cache_hits)
    # builds depend on what the shared service built before, not on the run
    assert ({k: v for k, v in a.service_stats.items() if k != "compiles"}
            == {k: v for k, v in b.service_stats.items() if k != "compiles"})


def test_a_simulator_keeps_no_pool_between_runs(service, trace_a, trace_b):
    assert len(trace_a.jobs) != len(trace_b.jobs)
    sim = ClusterSimulator(service, CFG)
    reports = [sim.run(t) for t in (trace_a, trace_b, trace_a)]
    assert sim._sky is None and sim._lens is None
    fresh = [ClusterSimulator(service, CFG).run(t)
             for t in (trace_a, trace_b)]
    for got, want in zip(reports, fresh + fresh[:1]):
        _same_report(got, want)
