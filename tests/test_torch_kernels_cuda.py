"""Kernels K1, K2 and K3 on the card against their plain PyTorch versions.

Needs an NVIDIA card and nvcc: marked ``cuda``, and each test decides
inside itself whether a card is present, so it skips on CPU-only hosts.
Run on the card with ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.arepas import simulate_runtime, simulate_runtime_batch
from repro_torch.kernels import ops


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _random_batch(seed, J=64, smax=3000, K=8):
    rng = np.random.RandomState(seed)
    sky = np.zeros((J, smax), np.int32)
    lens = rng.randint(1, smax + 1, size=J).astype(np.int32)
    lens[:5] = [1, smax, 1024, 2048, 2000]    # edges: 1 s, full row, tiles
    allocs = np.zeros((J, K), np.int32)
    for j in range(J):
        blk = rng.choice([1, 7, 32, 256])
        row = np.repeat(rng.randint(0, 400, size=lens[j] // blk + 1),
                        blk)[:lens[j]]
        sky[j, :lens[j]] = row
        peak = max(1, int(row.max()))
        allocs[j] = np.maximum(1, (np.linspace(1.2, 0.05, K) * peak).astype(int))
        allocs[j, 0] = max(1, int(row[0]))     # seconds equal to the cap
    # a run that ends exactly at a tile edge: over for [0, 1024), then under
    sky[4, :1024], sky[4, 1024:lens[4]] = 300, 1
    allocs[5, 1] = 0                           # invalid allocation -> -1
    return sky, lens, allocs


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_k1_equals_plain_version(seed):
    _need_card()
    sky, lens, allocs = _random_batch(seed)
    dev = torch.device("cuda")
    args = [torch.from_numpy(x).to(dev) for x in (sky, lens, allocs)]
    before = ops.launch_counts()["arepas_runtimes"]
    got = ops.arepas_runtimes(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["arepas_runtimes"] == before + 1
    want = simulate_runtime_batch(*args)
    assert torch.equal(got, want)
    for j in range(0, sky.shape[0], 9):
        for k in range(allocs.shape[1]):
            if allocs[j, k] >= 1:
                assert int(got[j, k]) == simulate_runtime(sky[j, :lens[j]],
                                                          int(allocs[j, k]))
            else:
                assert int(got[j, k]) == -1


@pytest.mark.cuda
def test_k1_rejects_bad_inputs():
    _need_card()
    dev = torch.device("cuda")
    sky = torch.ones((4, 16), dtype=torch.int32, device=dev)
    lens = torch.full((4,), 16, dtype=torch.int32, device=dev)
    allocs = torch.ones((4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ops.arepas_runtimes(sky.float(), lens, allocs)
    with pytest.raises(ValueError):
        ops.arepas_runtimes(sky[:, ::2], lens, allocs)
    with pytest.raises(ValueError):
        ops.arepas_runtimes(sky, lens.cpu(), allocs)


@pytest.mark.cuda
@pytest.mark.parametrize("price", [1.0, 1.5, 4.0])
@pytest.mark.parametrize("policy_name", ["default", "bounded_slowdown"])
def test_policy_on_card_equals_numpy_oracle(policy_name, price):
    """The float64 bisection on the card, held bitwise to the oracle.
    CUDA's double ``pow`` is not correctly rounded: a tie within an ulp of
    the limit could flip a decision; none is allowed here."""
    _need_card()
    from repro_torch.core.allocator import (build_policy, choose_tokens_priced,
                                            choose_tokens_priced_torch)
    policy = build_policy(policy_name)
    rng = np.random.RandomState(int(price * 10))
    a = -rng.uniform(0.0, 2.5, size=4000)
    b = np.exp(rng.uniform(0, 12, size=4000))
    obs = rng.randint(1, 7000, size=4000).astype(np.int64)
    dev = torch.device("cuda")
    at = torch.from_numpy(a).to(dev)
    got = choose_tokens_priced_torch(
        at, torch.from_numpy(b).to(dev), policy, torch.full_like(at, price),
        torch.from_numpy(obs).to(dev)).cpu().numpy()
    want = [choose_tokens_priced(a[i], b[i], policy, price, int(obs[i]))
            for i in range(len(a))]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- K2 and K3 ---
def _epoch_tables(seed, K=4, L=8192, Q=4096):
    """Random lease tables with one edge case per shard: 0 random, 1 all
    expired, 2 a full table (open slots bind), 3 ends == now and few free
    tokens (free tokens bind)."""
    rng = np.random.RandomState(seed)
    now = 1000.0
    live = rng.rand(K, L) < 0.7
    tokens = np.where(live, rng.randint(1, 64, (K, L)), 0).astype(np.int64)
    end = np.where(live, now + rng.randint(-200, 400, (K, L)) * 0.5, np.inf)
    end[1] = np.where(live[1], now - 1.0, np.inf)
    tokens[2] = rng.randint(1, 64, L)
    end[2] = now + 5.0
    end[2, :37] = now - 3.0
    end[3] = np.where(live[3], now + 10.0, np.inf)
    end[3, :20] = np.where(live[3, :20], now, np.inf)
    free = np.array([5000, 0, 10 ** 9, 3], np.int64)[:K]
    q_tok = rng.randint(1, 64, (K, Q)).astype(np.int64)
    q_tok[:, Q - 100:] = 0
    q_end = now + rng.randint(1, 5000, (K, Q)).astype(np.float64)
    return end, tokens, free, q_tok, q_end, now


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_k2_equals_plain_version(seed):
    _need_card()
    from repro_torch.kernels.cluster_step import epoch_step_ref
    end, tokens, free, q_tok, q_end, now = _epoch_tables(seed)
    args = [torch.from_numpy(x).cuda() for x in (end, tokens, free, q_tok,
                                                  q_end)]
    before = ops.launch_counts()["cluster_epoch_step"]
    got = ops.cluster_epoch_step(*args, now)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cluster_epoch_step"] == before + 1
    want = epoch_step_ref(*args, now)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[3][2]) == 37 and int(got[6][1]) == int(np.isfinite(end[1]).sum())
    assert 0 < int(got[3][3]) < q_tok.shape[1] - 100


def _resize_batch(seed, C=700, smax=5000):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, smax + 1, C).astype(np.int32)
    lens[:4] = [1, smax, 8192 % smax, 256]
    sky = np.zeros((C, smax), np.int32)
    for c in range(C):
        blk = rng.choice([1, 33, 500])
        sky[c, :lens[c]] = np.repeat(rng.randint(0, 900, lens[c] // blk + 1),
                                     blk)[:lens[c]]
    a = -rng.uniform(0.0, 2.5, C)
    a[:2] = [0.0, 0.2]
    vecs = dict(a=a, b=np.exp(rng.uniform(0, 12, C)),
                price=rng.choice([1.0, 1.5, 4.0], C),
                obs=rng.randint(1, 7000, C).astype(np.int64),
                floor=np.where(rng.rand(C) < 0.2, rng.randint(1, 3000, C),
                               1).astype(np.int64),
                done=rng.choice([0.0, 0.5, 0.999], C),
                cand_tok=rng.randint(1, 7000, C).astype(np.int64),
                cand_end=50.0 + rng.randint(0, 30, C).astype(np.float64))
    return vecs, sky, lens


@pytest.mark.cuda
@pytest.mark.parametrize("policy_name", ["default", "bounded_slowdown"])
def test_k3_equals_plain_version(policy_name):
    _need_card()
    from repro_torch.core.allocator import build_policy
    from repro_torch.kernels.cluster_step import resize_step_ref
    vecs, sky, lens = _resize_batch(len(policy_name))
    dev = torch.device("cuda")
    v = [torch.from_numpy(vecs[k]).to(dev) for k in
         ("a", "b", "price", "obs", "floor", "done", "cand_tok", "cand_end")]
    sky_t, lens_t = torch.from_numpy(sky).to(dev), torch.from_numpy(lens).to(dev)
    policy = build_policy(policy_name)
    before = ops.launch_counts()["cluster_resize_step"]
    ident = torch.arange(sky.shape[0], device=dev)
    got = ops.cluster_resize_step(*v, sky_t, lens_t, 50.0, 8.0,
                                  policy=policy, cap=4000, rows=ident)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cluster_resize_step"] == before + 1
    want = resize_step_ref(*v, sky_t, lens_t, 50.0, 8.0, policy=policy,
                           cap=4000)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # through a row index into a resident pool (reversed order)
    rows = torch.arange(sky.shape[0] - 1, -1, -1, device=dev)
    got_r = ops.cluster_resize_step(
        *[t.flip(0) for t in v], sky_t, lens_t, 50.0, 8.0, policy=policy,
        cap=4000, rows=rows)
    for g, w in zip(got_r, want):
        assert torch.equal(g.flip(0), w)
    rt1 = ops.arepas_runtimes(sky_t, lens_t,
                              want[0].clamp(min=1).int()[:, None], rows=ident)
    assert torch.equal(rt1[:, 0].long().clamp(min=1), want[2])


@pytest.mark.cuda
def test_fused_simulator_on_card_equals_unfused():
    """The cluster path on the card: K2 and K3 launch in the fused run and
    the report equals the unfused run's (K1 only)."""
    _need_card()
    from repro_torch.api import Allocator, AllocatorConfig
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.workloads import TraceGenerator
    alloc = Allocator.from_config(AllocatorConfig(
        family="gbdt", n_shards=4, pipeline=TasqConfig(n_train=120,
                                                       n_eval=40)),
        device="cuda")
    trace = TraceGenerator(seed=33, n_unique=24, rate_qps=1.0).generate(500)
    cfg = ClusterConfig(capacity=1024, epoch_s=4.0, n_shards=4,
                        admission="edf", elastic=True, pricing="elastic")
    reports, counts = {}, {}
    for fused in (False, True):
        ops.reset_launch_counts()
        reports[fused] = alloc.run_cluster(
            trace, ClusterConfig(**{**cfg.__dict__, "fused": fused}))
        counts[fused] = ops.launch_counts()
    assert dict(reports[False].metrics) == dict(reports[True].metrics)
    np.testing.assert_array_equal(reports[False].alloc_errors,
                                  reports[True].alloc_errors)
    assert reports[False].cache_stats == reports[True].cache_stats
    assert counts[True]["cluster_epoch_step"] > 0
    assert counts[True]["cluster_resize_step"] > 0
    assert counts[False]["cluster_epoch_step"] == 0
    assert counts[False]["cluster_resize_step"] == 0
    assert counts[False]["arepas_runtimes"] > 0
