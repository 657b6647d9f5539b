"""The serving plane's CUDA-graph executables on the card.

Every decision stage the service can dispatch (policy, priced, fused, and
the fabric's sharded twins) is captured as a CUDA graph per padded shape;
a replay must give the eager stage's outputs on the same inputs bitwise,
at every batch bucket in both observed modes. A stage that syncs with the
host cannot be captured and must raise. ``invalidate()`` must free the
retired graphs' memory. The warmed two-worker plane and a warmed
streaming replay must build nothing on the hot path.

Needs an NVIDIA card: marked ``cuda``, and each test decides inside itself
whether a card is present, so it skips on CPU-only hosts. Run on the card
with ``python -m pytest -m cuda tests/test_torch_serving_cuda.py``.
"""
import gc
import types

import numpy as np
import pytest
import torch

from repro_torch.api import AllocationRequest, Allocator
from repro_torch.cluster import ClusterConfig
from repro_torch.core.allocator import AllocationPolicy, choose_tokens_torch
from repro_torch.core.featurize import Standardizer, batch_job_features
from repro_torch.core.models import build_model
from repro_torch.core.models.gnn import GNN, GNNConfig
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.serve import (AllocationService, ServingPlane, WarmupConfig,
                               warm_allocation_stack)
from repro_torch.serve.aot import batch_buckets, model_pool_inputs
from repro_torch.serve.batching import batch_bucket, pad_to
from repro_torch.serve.service import (DecisionExecutable, ReplicaState,
                                       ShardedAllocationService)
from repro_torch.workloads import TraceGenerator

POLICY = AllocationPolicy(max_slowdown=0.05)
SCALER = PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _trace():
    return TraceGenerator(seed=7, n_unique=30, rate_qps=4.0).generate(600)


def _model(family, trace):
    """A seeded, untrained network of ``family`` on the card, and the
    trace's pool of its inputs."""
    g = torch.Generator().manual_seed(3)
    pool = model_pool_inputs(types.SimpleNamespace(family=family),
                             trace.jobs)
    std = Standardizer(batch_job_features(trace.jobs))
    if family == "nn":
        module = MLP(pool["features"].shape[1], (32, 16), generator=g)
    else:
        module = GNN(pool["features"].shape[-1], GNNConfig(), generator=g)
    return build_model(family, device="cuda").load(module, scaler=SCALER,
                                                   std=std), pool


def _host_args(exe, rng, pool):
    """Random host inputs matching an executable's specs: parameters in
    the policy's range, observed caps, prices, and model inputs drawn from
    the trace's pool."""
    def one(spec, i):
        if spec is None:
            return None
        if isinstance(spec, dict):                       # model inputs
            k0 = next(iter(spec))
            shape = spec[k0][0]
            lead = shape[:len(shape) - (pool[k0].ndim - 1)]
            rows = rng.randint(0, len(pool[k0]), int(np.prod(lead)))
            return {k: pool[k][rows].reshape(spec[k][0]) for k in spec}
        shape, dtype = spec
        if dtype == torch.int64:
            return rng.randint(1, 5000, shape).astype(np.int64)
        if i == 0:                                       # a
            return -rng.uniform(0.05, 2.5, shape)
        if i == 1:                                       # b
            return rng.uniform(1.0, 1e5, shape)
        return rng.choice([1.0, 1.25, 3.0], shape)       # price
    return [one(s, i) for i, s in enumerate(exe.specs)]


def _eager_on_card(exe, args):
    def to_dev(x, spec):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: to_dev(v, spec[k]) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x)).to("cuda", spec[1])
    with torch.inference_mode():
        outs = exe.stage(*[to_dev(x, s) for x, s in zip(args, exe.specs)])
    return [o.cpu().numpy() for o in outs]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["nn", "gnn"])
def test_graph_replays_equal_eager_at_every_bucket(family):
    _need_card()
    trace = _trace()
    model, pool = _model(family, trace)
    svc = AllocationService(model, POLICY, device="cuda")
    fabric = ShardedAllocationService(svc, 4)
    tpl = {k: v.shape[1:] for k, v in pool.items()}
    rng = np.random.RandomState(0)
    buckets = batch_buckets(8, 4096 if family == "nn" else 256)
    for Bp in buckets:
        for wo in (True, False):
            cells = [svc._policy_cell(Bp, wo), svc._priced_cell(Bp, wo),
                     svc._fused_cell({k: (Bp,) + s for k, s in tpl.items()},
                                     wo),
                     fabric._sharded_policy_cell(Bp, wo, False),
                     fabric._sharded_policy_cell(Bp, wo, True)]
            if Bp <= 1024:
                cells.append(fabric._sharded_fused_cell(
                    {k: (4, Bp) + s for k, s in tpl.items()}, wo))
            for key, build in cells:
                exe = build()
                assert exe.graph is not None
                for _ in range(2):                 # replays reuse buffers
                    args = _host_args(exe, rng, pool)
                    got = exe(*args)
                    want = _eager_on_card(exe, args)
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype, key[0]
                        np.testing.assert_array_equal(g, w,
                                                      err_msg=str(key[:3]))


@pytest.mark.cuda
def test_warmed_service_decides_as_eager_and_builds_nothing():
    """Through ``decide``, chunking included: a warmed grid serves the
    model path at every bucket with zero builds, and its parameters and
    tokens equal the eager network and policy on the card."""
    _need_card()
    trace = _trace()
    model, pool = _model("nn", trace)
    svc = AllocationService(model, POLICY, device="cuda")
    rep = warm_allocation_stack(svc, jobs=trace.jobs, cfg=WarmupConfig(
        observed=(True, False)))
    assert rep.n_precompiled == len(batch_buckets()) * 2 * 3
    rng = np.random.RandomState(1)
    U = len(trace.jobs)
    dflt = np.array([j.default_tokens for j in trace.jobs], np.int64)

    def eager(jb):
        # the network and policy on the same padded rows as the service
        Bp = batch_bucket(jb.size)
        x = {k: pad_to(v[jb], Bp) for k, v in pool.items()}
        with torch.inference_mode():
            a, b = model.scaler.decode(model.serve_apply(model.to_device(x)))
            toks = choose_tokens_torch(
                a.double(), b.double(), POLICY,
                torch.from_numpy(pad_to(dflt[jb], Bp)).cuda())
        return [t[:jb.size].cpu().numpy() for t in (a, b, toks)]

    for B in (1, 8, 100, 256, 1000, 4096, 5000):
        jb = rng.randint(0, U, B)
        d = svc.decide(AllocationRequest(
            model_in={k: v[jb] for k, v in pool.items()},
            observed_tokens=dflt[jb]))
        parts = [eager(jb[i:i + 4096]) for i in range(0, B, 4096)]
        for got, j in ((d.a, 0), (d.b, 1), (d.tokens, 2)):
            np.testing.assert_array_equal(
                got, np.concatenate([p[j] for p in parts]), err_msg=str(B))
    assert svc.stats["compiles"] == 0


@pytest.mark.cuda
def test_capture_of_a_host_sync_raises():
    _need_card()

    def syncing(a, b, observed):
        n = int((a < 0).sum().item())                # a host round trip
        return a * n, b

    with pytest.raises(RuntimeError):
        DecisionExecutable(syncing, (((64,), torch.float64),
                                     ((64,), torch.float64), None),
                           torch.device("cuda"), ReplicaState())
    torch.cuda.synchronize()
    assert torch.ones(4, device="cuda").sum().item() == 4.0


@pytest.mark.cuda
def test_invalidate_frees_the_graphs_memory():
    _need_card()
    trace = _trace()
    model, _ = _model("nn", trace)
    svc = AllocationService(model, POLICY, device="cuda")
    fabric = ShardedAllocationService(svc, 4)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rep = warm_allocation_stack(svc, fabric, jobs=trace.jobs,
                                cfg=WarmupConfig(observed=(True, False)))
    torch.cuda.synchronize()
    warmed = torch.cuda.memory_allocated()
    assert rep.n_precompiled == len(batch_buckets()) * 2 * 6
    assert warmed > before
    assert svc.replica.invalidate() == rep.n_precompiled
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    assert after - before <= (warmed - before) // 100, (before, warmed, after)


@pytest.mark.cuda
def test_plane_and_streaming_on_the_card_build_nothing():
    _need_card()
    trace = _trace()
    model, pool = _model("nn", trace)
    svc = AllocationService(model, POLICY, device="cuda")
    plane = ServingPlane(svc, n_workers=2, max_batch=32, backlog=64)
    plane.start(warm_jobs=trace.jobs)
    U = len(trace.jobs)
    jb = np.arange(600) % U
    try:
        futs = [plane.submit({k: v[j] for k, v in pool.items()}, 300)
                for j in jb]
        got = np.array([f.result(timeout=120) for f in futs])
    finally:
        plane.stop()
    assert svc.stats["compiles"] == 0
    want = svc.decide(AllocationRequest(
        model_in={k: v[jb] for k, v in pool.items()},
        observed_tokens=np.full(jb.size, 300, np.int64)))
    np.testing.assert_array_equal(got, want.tokens)

    alloc = Allocator(AllocationService(model, POLICY, device="cuda"),
                      n_shards=2)
    alloc.warmup(trace=trace, config=WarmupConfig(max_bucket=1024))
    cc = ClusterConfig(capacity=2048, epoch_s=8.0, n_shards=2,
                       admission="edf", elastic=True, pricing="elastic",
                       fused=True)
    one = alloc.run_cluster(trace, cc)
    two = alloc.run_streaming(trace, cc, chunk=16, backlog=64)
    assert one.metrics == two.metrics
    np.testing.assert_array_equal(one.alloc_errors, two.alloc_errors)
    assert one.service_stats["compiles"] == two.service_stats["compiles"] == 0
