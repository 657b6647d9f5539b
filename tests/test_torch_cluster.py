"""The cluster slice's modules on the CPU: pool, router, PCC cache, sharded
fabric and the simulator's fused/unfused identity, held to the reference
where it imports in this process (its ``cluster`` package needs
``jax.experimental.enable_x64``; see ``test_torch_cluster_slice.py``)."""
import importlib.util
import pathlib

import numpy as np
import pytest

from repro.core.arepas import simulate_runtime as ref_simulate_runtime
from repro.core.dataset import PCC_FRACTIONS as REF_PCC_FRACTIONS
from repro.core.pcc import fit_pcc as ref_fit_pcc
from repro_torch.api import (AllocationRequest, Allocator, DecisionContext)
from repro_torch.cluster import (ClusterConfig, ClusterSimulator, PCCCache,
                                 PoolShards, Router, ShardedPCCCache,
                                 TokenPool)
from repro_torch.cluster import pool as pool_mod
from repro_torch.core.allocator import build_policy
from repro_torch.core.models import NNConfig
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.kernels import ops
from repro_torch.mlops import MLOpsLoop, RetrainController
from repro_torch.serve import AllocationService, ShardedAllocationService
from repro_torch.workloads import TraceGenerator

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _reference_router_module():
    """``repro/cluster/router.py`` loaded by path: it needs only numpy and
    ``repro.obs``, while its package's ``__init__`` imports the simulator,
    which fails under the installed jax."""
    spec = importlib.util.spec_from_file_location(
        "reference_router", ROOT / "src" / "repro" / "cluster" / "router.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mirror_equals_device(pool: PoolShards) -> None:
    d_end, d_tok = pool.device_tables
    np.testing.assert_array_equal(d_tok.cpu().numpy(), pool._tokens)
    np.testing.assert_array_equal(d_end.cpu().numpy(), pool._end_s)


@pytest.fixture(scope="module")
def services():
    pipe = TasqPipeline(TasqConfig(n_train=120, n_eval=40, gnn_epochs=2,
                                   nn=NNConfig(epochs=3)),
                        device="cpu").build()
    policy = build_policy("bounded_slowdown")
    return {f: AllocationService(pipe.train(f), policy, device="cpu")
            for f in ("gbdt", "nn")}


@pytest.fixture(scope="module")
def trace():
    return TraceGenerator(seed=33, n_unique=24, rate_qps=1.0).generate(400)


# -------------------------------------------------------------------- pool --
def test_token_pool_lease_cycle():
    pool = TokenPool(capacity=100, max_leases=8, device="cpu")
    pool.acquire_batch(np.array([1, 2, 3]), np.array([40, 30, 20]),
                       np.array([10.0, 20.0, 30.0]))
    assert pool.free == 10 and pool.n_active == 3
    assert pool.next_expiry() == 10.0
    qids, toks = pool.expire(15.0)
    assert list(qids) == [1] and list(toks) == [40]
    assert pool.free == 50
    qids, _ = pool.expire(100.0)
    assert sorted(qids.tolist()) == [2, 3]
    assert pool.free == 100 and pool.n_active == 0
    _mirror_equals_device(pool._shards)
    with pytest.raises(AssertionError):        # over-commit is a bug
        pool.acquire_batch(np.array([9]), np.array([101]), np.array([1.0]))


def test_pool_shards_cross_shard_expiry_resize_and_preempt():
    pool = PoolShards(capacity_per_shard=100, n_shards=3, max_leases=8,
                      device="cpu")
    pool.acquire_batch(0, np.array([1, 2]), np.array([40, 30]),
                       np.array([10.0, 50.0]))
    pool.acquire_batch(2, np.array([3]), np.array([70]), np.array([10.0]))
    assert pool.free.tolist() == [30, 100, 30]
    sh, qids, toks = pool.expire(15.0)
    assert sorted(zip(sh.tolist(), qids.tolist())) == [(0, 1), (2, 3)]
    assert sorted(toks.tolist()) == [40, 70]
    assert pool.free.tolist() == [70, 100, 100]
    _mirror_equals_device(pool)
    pool.acquire_batch(1, np.array([7, 8]), np.array([50, 5]),
                       np.array([90.0, 91.0]))
    pool.resize_batch(np.array([0, 1]), np.array([2, 7]),
                      np.array([10, 80]), np.array([60.0, 95.0]))
    assert pool.free.tolist() == [90, 15, 100]
    _mirror_equals_device(pool)
    freed = pool.preempt_batch(np.array([1, 0]), np.array([8, 2]))
    assert freed.tolist() == [5, 10]
    assert pool.free.tolist() == [100, 20, 100] and pool.n_active == 1
    _mirror_equals_device(pool)
    with pytest.raises(AssertionError):          # per-shard over-commit
        pool.acquire_batch(1, np.array([9]), np.array([21]), np.array([1.0]))


def test_admit_epoch_equals_per_shard_acquire():
    """The fused admission (K2's plain version here) fills the same slots
    as per-shard ``acquire_batch`` calls, capped by open slots."""
    rng = np.random.RandomState(0)
    fused = PoolShards(100, 2, max_leases=6, device="cpu")
    loop = PoolShards(100, 2, max_leases=6, device="cpu")
    for p in (fused, loop):
        p.acquire_batch(0, np.array([1, 2]), np.array([20, 30]),
                        np.array([5.0, 50.0]))
        p.acquire_batch(1, np.array([3]), np.array([60]), np.array([9.0]))
        p.expire(10.0)
    q_ids = np.array([[10, 11, 12, 13, 14, 15, 16], [20, 21, -1, -1, -1, -1,
                                                        -1]])
    q_tok = np.array([[10, 10, 10, 10, 10, 10, 10], [70, 40, 0, 0, 0, 0, 0]])
    q_end = 10.0 + rng.randint(1, 99, q_tok.shape).astype(np.float64)
    n_adm = fused.admit_epoch(10.0, q_ids, q_tok, q_end)
    # shard 0: 5 open slots bind before its 70 free tokens; shard 1: 70 fits
    assert n_adm.tolist() == [5, 1]
    for k in range(2):
        j = int(n_adm[k])
        loop.acquire_batch(k, q_ids[k, :j], q_tok[k, :j], q_end[k, :j])
    for name in ("_tokens", "_end_s", "_query", "in_use"):
        np.testing.assert_array_equal(getattr(fused, name),
                                      getattr(loop, name))
    _mirror_equals_device(fused)


def test_fused_simulator_keeps_device_tables_equal_to_mirrors(
        services, trace, monkeypatch):
    pools = []
    orig_init = pool_mod.PoolShards.__init__

    def init_spy(self, *a, **k):
        orig_init(self, *a, **k)
        pools.append(self)

    monkeypatch.setattr(pool_mod.PoolShards, "__init__", init_spy)
    rep = ClusterSimulator(services["gbdt"], ClusterConfig(
        capacity=1024, epoch_s=4.0, n_shards=2, admission="edf",
        elastic=True, pricing="elastic", fused=True)).run(trace)
    assert rep.metrics["n_completed"] + rep.metrics["n_rejected"] == len(trace)
    assert rep.metrics["resize_shrinks"] > 0
    assert pools
    _mirror_equals_device(pools[-1])


# ------------------------------------------------------------------ router --
@pytest.mark.parametrize("n_shards,seed", [(1, 0), (4, 2), (8, 1)])
def test_router_equals_reference(n_shards, seed):
    ref_mod = _reference_router_module()
    keys = np.arange(3000)
    rng = np.random.RandomState(seed)
    load = rng.uniform(0.0, 2.0, n_shards)
    drain = rng.rand(n_shards) < 0.3
    mine = Router(n_shards, seed=seed, load_factor=1.25)
    ref = ref_mod.Router(n_shards, seed=seed, load_factor=1.25)
    np.testing.assert_array_equal(mine.home(keys), ref.home(keys))
    np.testing.assert_array_equal(mine.second(keys), ref.second(keys))
    np.testing.assert_array_equal(mine.assign(keys), ref.assign(keys))
    np.testing.assert_array_equal(mine.rank(mine.home(keys)),
                                  ref.rank(ref.home(keys)))
    for d in (None, drain):
        got, want = mine.route(keys, load, drain=d), ref.route(keys, load,
                                                               drain=d)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    minus = Router(shard_ids=[0, 2, 3], seed=seed)
    np.testing.assert_array_equal(
        minus.home(keys), ref_mod.Router(shard_ids=[0, 2, 3],
                                         seed=seed).home(keys))


# ------------------------------------------------------------------- cache --
def test_pcc_cache_refine_equals_reference_fit():
    """Each key's cached (a, b) is the reference's scalar ``fit_pcc`` on
    the same grid of numpy-oracle AREPAS runtimes; the row-index form over
    a resident pool gives the same entries."""
    trace = TraceGenerator(seed=9, n_unique=6, rate_qps=2.0).generate(6)
    U = len(trace.jobs)
    smax = max(len(s) for s in trace.skylines)
    sky = np.zeros((U, smax), np.float32)
    lens = np.array([len(s) for s in trace.skylines], np.int32)
    for u, s in enumerate(trace.skylines):
        sky[u, :len(s)] = s
    obs = np.array([j.default_tokens for j in trace.jobs], np.int64)
    peaks = sky.max(axis=1).astype(np.int64)
    cache = PCCCache(device="cpu")
    a, b = cache.refine_batch(np.arange(U), sky, lens, obs, peaks)
    fr = np.asarray(sorted(REF_PCC_FRACTIONS, reverse=True))
    for u in range(U):
        s = trace.skylines[u]
        allocs = np.maximum(1, np.round(fr * obs[u])).astype(np.int64)
        rts = np.array([len(s) if al >= peaks[u]
                        else ref_simulate_runtime(s, al) for al in allocs])
        a_ref, b_ref = ref_fit_pcc(allocs, np.maximum(rts, 1))
        assert a[u] == pytest.approx(min(a_ref, -1e-4), rel=1e-9)
        assert b[u] == pytest.approx(b_ref, rel=1e-9)
    import torch
    sharded = ShardedPCCCache(2, device="cpu")
    home = np.arange(U) % 2
    a2, b2 = sharded.refine_batch(
        home, np.arange(U), torch.from_numpy(sky.astype(np.int32)),
        torch.from_numpy(lens), obs, peaks, rows=np.arange(U),
        areas=sky.sum(axis=1, dtype=np.float64))
    np.testing.assert_array_equal(a2, a)
    np.testing.assert_array_equal(b2, b)
    hit, a_l, _ = sharded.lookup(home, np.arange(U))
    assert hit.all() and np.array_equal(a_l, a)


class _DictTable:
    """The cache's table as a dict rebuilt into a sorted view after every
    change: the semantics ``PCCCache`` keeps, fed the (a, b) it fitted."""

    def __init__(self, max_entries, drift_tol):
        self.max_entries, self.drift_tol = max_entries, drift_tol
        self.model_version, self.tick = 0, 0
        self.entries, self.used = {}, {}
        self.stats = dict.fromkeys(("hits", "misses", "refined",
                                    "refine_calls", "stale", "evicted",
                                    "version_stale"), 0)

    def _view(self):
        keys = np.array(sorted(self.entries), np.int64)
        vals = np.array([self.entries[k] for k in keys.tolist()],
                        np.float64).reshape(-1, 4)
        return keys, vals

    def _find(self, keys):
        dk, vals = self._view()
        idx = np.minimum(np.searchsorted(dk, keys), max(dk.size - 1, 0))
        hit = (dk[idx] == keys) if dk.size else np.zeros(keys.size, bool)
        return hit, idx, vals

    def _evict(self, k):
        del self.entries[k], self.used[k]
        self.stats["evicted"] += 1

    def refine(self, keys, a, b, areas):
        self.stats["refine_calls"] += 1
        self.tick += 1
        for k, ai, bi, ar in zip(keys.tolist(), a, b, areas):
            self.stats["refined"] += k not in self.entries
            self.entries[k] = (ai, bi, ar, float(self.model_version))
            self.used[k] = self.tick
        if self.max_entries is not None \
                and len(self.entries) > self.max_entries:
            by_age = sorted(self.used, key=self.used.get)
            for k in by_age[:len(self.entries) - self.max_entries]:
                self._evict(k)

    def lookup(self, keys, areas):
        hit, idx, vals = self._find(keys)
        if self.model_version and hit.any():
            vstale = hit & (np.where(hit, vals[idx, 3], self.model_version)
                            < self.model_version)
            self.stats["version_stale"] += int(vstale.sum())
            for k in np.unique(keys[vstale]).tolist():
                self._evict(k)
            hit, idx, vals = self._find(keys)
        if areas is not None and hit.any():
            cached = np.where(hit, vals[idx, 2], 0.0)
            stale = hit & (np.abs(areas - cached)
                           > self.drift_tol * np.maximum(cached, 1e-9))
            self.stats["stale"] += int(stale.sum())
            for k in np.unique(keys[stale]).tolist():
                self._evict(k)
            hit, idx, vals = self._find(keys)
        a = np.where(hit, vals[idx, 0] if len(vals) else 0.0, 0.0)
        b = np.where(hit, vals[idx, 1] if len(vals) else 0.0, 0.0)
        self.tick += 1
        if self.max_entries is not None and hit.any():
            self.used.update(dict.fromkeys(np.unique(keys[hit]).tolist(),
                                           self.tick))
        self.stats["hits"] += int(hit.sum())
        self.stats["misses"] += int((~hit).sum())
        return hit, a, b


@pytest.mark.parametrize("max_entries,seed", [(None, 0), (None, 1), (6, 2),
                                              (12, 3)])
def test_pcc_cache_table_equals_dict_model(max_entries, seed):
    """A seeded random sequence of refits (new, present and repeated keys;
    resident-pool and padded rows), lookups with drifted areas, model
    swaps, ``missing``, ``len`` and ``in`` gives every result and count the
    dict model gives. Only a refit into an empty table sorts it whole
    (``dense_rebuilds`` / ``cache_rebuilds``); every other refit merges
    its rows in place (``cache_rows_merged``)."""
    import torch
    from repro_torch.obs import Obs
    rng = np.random.RandomState(seed)
    U, smax = 40, 24
    lens = rng.randint(1, smax + 1, U).astype(np.int32)
    sky = np.zeros((U, smax), np.int32)
    for u in range(U):
        sky[u, :lens[u]] = rng.randint(1, 60, lens[u])
    area = sky.sum(axis=1, dtype=np.float64)
    obs_tok = rng.randint(1, 80, U)
    peaks = sky.max(axis=1).astype(np.int64)
    pool, pool_lens = torch.from_numpy(sky), torch.from_numpy(lens)
    o = Obs.enabled()
    cache = PCCCache(max_entries=max_entries, device="cpu", obs=o)
    model = _DictTable(max_entries, cache.drift_tol)
    merged = rebuilds = 0
    for step in range(300):
        op = rng.choice(["refine", "lookup", "missing", "bump"],
                        p=[0.4, 0.45, 0.1, 0.05])
        keys = rng.randint(0, U, rng.randint(1, 7)).astype(np.int64)
        drift = rng.choice([1.0, 1.1, 1.6], keys.size)
        if op == "refine":
            was = len(cache)
            if rng.rand() < 0.8:
                a, b = cache.refine_batch(keys, pool, pool_lens,
                                          obs_tok[keys], peaks[keys],
                                          rows=keys, areas=area[keys] * drift)
                row_area = area[keys] * drift
            else:
                a, b = cache.refine_batch(keys, sky[keys], lens[keys],
                                          obs_tok[keys], peaks[keys])
                row_area = area[keys]
            model.refine(keys, a, b, row_area)
            if was:
                merged += np.unique(keys).size
            else:
                rebuilds += 1
        elif op == "lookup":
            areas = None if rng.rand() < 0.3 else area[keys] * drift
            for got, want in zip(cache.lookup(keys, areas),
                                 model.lookup(keys, areas)):
                np.testing.assert_array_equal(got, want, err_msg=str(step))
        elif op == "missing":
            np.testing.assert_array_equal(
                cache.missing(keys), [k not in model.entries
                                      for k in keys.tolist()])
        else:
            assert cache.bump_model_version() == model.model_version + 1
            model.model_version += 1
        assert len(cache) == len(model.entries), step
        assert [k in cache for k in range(U)] == [k in model.entries
                                                  for k in range(U)]
        assert {k: v for k, v in cache.stats.items()
                if k != "dense_rebuilds"} == model.stats, step
        assert cache.stats["dense_rebuilds"] == rebuilds, step
    counters = o.metrics.snapshot()
    assert counters.get("cache_rebuilds", 0) == rebuilds
    assert counters["cache_rows_merged"] == merged > 0
    assert rebuilds < model.stats["refine_calls"] // 4


# ------------------------------------------------------------------ fabric --
@pytest.mark.parametrize("path", ["history", "priced", "model"])
def test_sharded_fabric_equals_single_shard_services(services, path):
    """K=4 fabric tokens equal four single-shard services fed the routed
    partitions (the reference's test_sharded_decisions_match_single_shard_
    oracles), on the history, priced and model paths."""
    service = services["nn"]
    rng = np.random.RandomState(4)
    n = 200
    a = rng.uniform(-2.5, -0.01, n)
    b = np.exp(rng.uniform(0.0, 8.0, n))
    obs = rng.randint(1, 7000, n)
    price = rng.choice([1.0, 1.5, 4.0], n) if path == "priced" else None
    feats = rng.normal(size=(n, service.model.std.mu.size)).astype(np.float32)
    router = Router(4, seed=2)
    shard_of = router.rank(router.home(rng.randint(0, 500, n)))
    fabric = ShardedAllocationService(service, n_shards=4)
    req = (AllocationRequest(model_in={"features": feats},
                             observed_tokens=obs) if path == "model"
           else AllocationRequest(a=a, b=b, observed_tokens=obs))
    got = fabric.decide(req, DecisionContext(price=price, shard_of=shard_of))
    assert np.array_equal(got.shard, shard_of)
    for k in range(4):
        m = shard_of == k
        solo = AllocationService(service.model, service.policy, device="cpu")
        want = solo.decide(req.narrow(m), DecisionContext(
            price=None if price is None else price[m]))
        np.testing.assert_array_equal(got.tokens[m], want.tokens)
        np.testing.assert_array_equal(got.a[m], want.a)
        assert fabric.replica_stats()[k]["queries"] == int(m.sum())
    assert fabric.stats["calls"] >= 1


# --------------------------------------------------------------- simulator --
@pytest.mark.parametrize("kw", [
    dict(capacity=2048, epoch_s=8.0),
    dict(capacity=1024, epoch_s=4.0, admission="edf", elastic=True,
         pricing="elastic"),
    dict(capacity=2048, epoch_s=8.0, n_shards=4)],
    ids=["fixed", "edf_elastic", "k4"])
def test_fused_equals_unfused(services, trace, kw):
    ops.reset_launch_counts()
    base = ClusterSimulator(services["gbdt"], ClusterConfig(**kw)).run(trace)
    fused = ClusterSimulator(services["gbdt"],
                             ClusterConfig(fused=True, **kw)).run(trace)
    assert dict(base.metrics) == dict(fused.metrics)
    np.testing.assert_array_equal(base.alloc_errors, fused.alloc_errors)
    np.testing.assert_array_equal(base.cache_hits, fused.cache_hits)
    assert base.cache_stats == fused.cache_stats
    assert np.array_equal(base.error_series[1], fused.error_series[1],
                          equal_nan=True)
    # CPU tensors take the plain versions: no kernel launched
    assert set(ops.launch_counts().values()) == {0}


def test_allocator_run_cluster_overrides(services, trace):
    alloc = Allocator(services["gbdt"], n_shards=2)
    assert alloc.place(np.arange(50)).max() <= 1
    rep = alloc.run_cluster(trace, admission="edf", elastic=True,
                            pricing="elastic", load_factor=1.5)
    want = ClusterSimulator(services["gbdt"], ClusterConfig(
        n_shards=2, admission="edf", elastic=True, pricing="elastic",
        load_factor=1.5)).run(trace)
    assert dict(rep.metrics) == dict(want.metrics)
    assert len(rep.replica_stats) == 2
    # an explicit config is authoritative: its n_shards stands
    one = alloc.run_cluster(trace, ClusterConfig(capacity=4096))
    assert len(one.replica_stats) == 1
    # the drift loop attaches through the same call; an "off" loop only
    # observes, so the replay decides as it does without one
    loop = MLOpsLoop(alloc, RetrainController(policy="off", device="cpu"))
    looped = alloc.run_cluster(trace, admission="edf", elastic=True,
                               pricing="elastic", load_factor=1.5,
                               mlops=loop)
    assert dict(looped.metrics) == dict(rep.metrics)
    assert loop.report()["n_swaps"] == 0 and loop.error_points
