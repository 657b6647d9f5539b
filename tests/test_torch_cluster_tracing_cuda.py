"""Cluster control traced from inside the port, on the card.

A warmed pass of ``run_cluster`` in the benchmark's configuration (EDF,
elastic resize and pricing, fused K2 / K3, 4 shards) run under
``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing CUDA
operation it makes warns inside a wait that ``Obs.device_wait`` counts,
and no wait warns more often than it counts, so the ``device_syncs.*``
counters are exhaustive; a resident-pool refit opens exactly one sync,
its read-back, and returns the CPU refit's curves bitwise. Every traced
``fabric.decide`` span carries the device time of its graph replays,
above 0 and within its host duration.
An untraced pass creates no CUDA event and enters no profiler range, and
reports as a traced one. Under ``torch.profiler`` every span is a range
of the device trace.

Needs an NVIDIA card: marked ``cuda``, and each test decides inside itself
whether a card is present, so it skips on CPU-only hosts. Run on the card
with ``python -m pytest -m cuda tests/test_torch_cluster_tracing_cuda.py``.
"""
import json
import traceback
import types
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import repro_torch.obs as obs_mod
from repro_torch.api import Allocator
from repro_torch.cluster import ClusterConfig, pcc_cache
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.featurize import Standardizer, batch_job_features
from repro_torch.core.models import build_model
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.serve import AllocationService
from repro_torch.serve.aot import model_pool_inputs
from repro_torch.workloads import TraceGenerator

CFG = ClusterConfig(capacity=2048, epoch_s=4.0, n_shards=4, admission="edf",
                    elastic=True, pricing="elastic", fused=True)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _warmed(obs=None):
    """A seeded, untrained NN model on the card behind a warmed 4-shard
    allocator on ``obs``, one pass already run (every kernel built), and
    the trace."""
    trace = TraceGenerator(seed=7, n_unique=30, rate_qps=1.0).generate(500)
    g = torch.Generator().manual_seed(3)
    pool = model_pool_inputs(types.SimpleNamespace(family="nn"), trace.jobs)
    module = MLP(pool["features"].shape[1], (32, 16), generator=g)
    model = build_model("nn", device="cuda").load(
        module, scaler=PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5),
        std=Standardizer(batch_job_features(trace.jobs)))
    svc = AllocationService(model, AllocationPolicy(max_slowdown=0.05),
                            device="cuda", obs=obs)
    alloc = Allocator(svc, n_shards=CFG.n_shards, obs=obs)
    alloc.warmup(trace=trace)
    alloc.run_cluster(trace, CFG)
    torch.cuda.synchronize()
    return alloc, trace


@pytest.mark.cuda
def test_sync_counter_is_exhaustive(monkeypatch):
    _need_card()
    obs = Obs.enabled(capacity=1 << 20)
    alloc, trace = _warmed(obs)
    obs.metrics = MetricsRegistry()
    seen, marks, waits = [], [], []     # warnings with their call sites
    enter, leave = obs_mod._DeviceWait.__enter__, obs_mod._DeviceWait.__exit__

    def counted_enter(self):
        marks.append(len(seen))
        return enter(self)

    def counted_exit(self, *exc):
        waits.append((marks.pop(), len(seen), self._n))
        return leave(self, *exc)

    monkeypatch.setattr(obs_mod._DeviceWait, "__enter__", counted_enter)
    monkeypatch.setattr(obs_mod._DeviceWait, "__exit__", counted_exit)

    def note(message, category, filename, lineno, file=None, line=None):
        # the innermost frames that made the call
        site = [f"{f.filename.split('/')[-1]}:{f.lineno}"
                for f in traceback.extract_stack()[:-1]
                if not f.filename.endswith("warnings.py")][-4:]
        seen.append((str(message), site))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            alloc.run_cluster(trace, CFG)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own note that it is a prototype is no sync
    syncs = [i for i, (msg, _) in enumerate(seen)
             if "called a synchronizing CUDA operation" in msg]
    assert syncs, "set_sync_debug_mode('warn') gave no warning"
    covered = set()
    for lo, hi, n in waits:
        inside = [i for i in syncs if lo <= i < hi]
        assert len(inside) <= n, (lo, hi, n, [seen[i][1] for i in inside])
        covered.update(inside)
    outside = Counter(" < ".join(reversed(seen[i][1])) for i in syncs
                      if i not in covered)
    assert not outside, outside
    counted = sum(v for k, v in obs.metrics.snapshot().items()
                  if k.startswith("device_syncs."))
    assert len(syncs) <= counted


@pytest.mark.cuda
def test_decide_spans_carry_their_device_time():
    _need_card()
    obs = Obs.enabled(capacity=1 << 20)
    alloc, trace = _warmed(obs)
    obs.tracer.clear()
    alloc.run_cluster(trace, CFG)
    decides = [s for s in obs.tracer.spans() if s.name == "fabric.decide"]
    assert decides
    for s in decides:
        ms = s.attrs["device_ms"]
        assert 0.0 < ms <= 1e3 * (s.t1 - s.t0), (ms, s.t1 - s.t0)


@pytest.mark.cuda
def test_untraced_pass_makes_no_event_and_no_range(monkeypatch):
    _need_card()
    traced_alloc, trace = _warmed(Obs.enabled(capacity=1 << 20))
    want = traced_alloc.run_cluster(trace, CFG)
    alloc, _ = _warmed()
    made = []
    real_event = torch.cuda.Event
    real_range = torch.autograd.profiler.record_function

    class CountedEvent(real_event):
        def __new__(cls, *a, **k):
            made.append("event")
            return real_event.__new__(cls, *a, **k)

    def counted_range(*a, **k):
        made.append("range")
        return real_range(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counted_range)
    got = alloc.run_cluster(trace, CFG)
    assert made == []
    assert got.metrics == want.metrics and got.n_epochs == want.n_epochs
    np.testing.assert_array_equal(got.alloc_errors, want.alloc_errors)


@pytest.mark.cuda
def test_profiled_pass_has_a_range_for_every_span(tmp_path):
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    obs = Obs.enabled(capacity=1 << 20)
    alloc, trace = _warmed(obs)
    obs.tracer.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        alloc.run_cluster(trace, CFG)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = Counter(e["name"] for e in events
                     if e.get("cat") == "user_annotation")
    spans = Counter(s.name for s in obs.tracer.spans())
    assert spans and all(ranges[k] == v for k, v in spans.items())
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_resident_refit_is_one_counted_sync_and_equals_the_cpu(monkeypatch):
    """A resident-pool refit on the card returns the CPU refit's (a, b)
    bitwise, opens exactly one sync, the one ``refit.out`` counts, and
    hands K1 fresh ``rows`` and ``allocs`` tensors every call."""
    _need_card()
    trace = TraceGenerator(seed=7, n_unique=30, rate_qps=1.0).generate(60)
    U = len(trace.jobs)
    lens = np.array([len(s) for s in trace.skylines], np.int32)
    sky = np.zeros((U, int(lens.max())), np.int32)
    for u, s in enumerate(trace.skylines):
        sky[u, :len(s)] = s
    area = sky.sum(axis=1, dtype=np.float64)
    obs_tok = np.array([j.default_tokens for j in trace.jobs], np.int64)
    peaks = sky.max(axis=1).astype(np.int64)
    obs = Obs.enabled()
    card = pcc_cache.PCCCache(device="cuda", obs=obs)
    cpu = pcc_cache.PCCCache(device="cpu")
    d_sky, d_lens = torch.from_numpy(sky).cuda(), torch.from_numpy(lens).cuda()
    handed = []
    k1 = pcc_cache.arepas_runtimes

    def spy(skylines, valid_lens, allocs, rows=None):
        handed.append((allocs, rows))
        return k1(skylines, valid_lens, allocs, rows=rows)

    monkeypatch.setattr(pcc_cache, "arepas_runtimes", spy)

    def refit(cache, rows, pool, pool_lens):
        return cache.refine_batch(rows, pool, pool_lens, obs_tok[rows],
                                  peaks[rows], rows=rows, areas=area[rows])

    refit(card, np.arange(U), d_sky, d_lens)       # builds K1
    torch.cuda.synchronize()
    obs.metrics = MetricsRegistry()
    batches = [np.array([3, 1, 4]), np.array([1, 5, 9, 2, 6])]
    for rows in batches:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = refit(card, rows, d_sky, d_lens)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in seen
                 if "called a synchronizing CUDA operation" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in syncs]
        want = refit(cpu, rows, torch.from_numpy(sky), torch.from_numpy(lens))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    counts = {k: v for k, v in obs.metrics.snapshot().items()
              if k.startswith("device_syncs.")}
    assert counts == {"device_syncs.refit.out": len(batches)}
    (a1, r1), (a2, r2) = handed[-len(batches):]
    assert a1.is_cuda and r1.is_cuda
    assert a1.data_ptr() != a2.data_ptr() and r1.data_ptr() != r2.data_ptr()
