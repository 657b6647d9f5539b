"""Kernels K1 to K5 on the card against their plain PyTorch versions (K1
in its ragged and pool layouts and in Figure 2's bisection, K2 at every
cluster size), the gradients of the two differentiable kernel wrappers
(K4, K5), the LM server (dense, MoE, SSM and hybrid), one LM training
step and a bf16 checkpoint round trip on the card.

Needs an NVIDIA card and nvcc: marked ``cuda``, and each test decides
inside itself whether a card is present, so it skips on CPU-only hosts.
Run on the card with ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
"""
import sys

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


def _ragged(sky, lens):
    """The ragged layout of padded rows: flat values and (J + 1) offsets."""
    from repro_torch.core.dataset import ragged_skylines
    return ragged_skylines([row[:n] for row, n in zip(sky, lens)])


def _long_jobs(seed, longest, n_long, J=300, K=8):
    """J short jobs (up to 3,000 s) with n_long jobs of up to ``longest``
    seconds among them (the first exactly that long), allocations from the
    peak down with the dataset grid's repeats, one allocation below 1."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, 3000, J)
    where = rng.choice(J, n_long, replace=False)
    lens[where] = rng.randint(longest // 2, longest + 1, n_long)
    lens[where[0]] = longest
    skylines, allocs = [], np.zeros((J, K), np.int32)
    for j, n in enumerate(lens):
        blk = rng.choice([1, 9, 300])
        row = np.repeat(rng.randint(0, 500, n // blk + 1), blk)[:n]
        skylines.append(row.astype(np.int32))
        peak = max(1, int(row.max(initial=0)))
        fr = np.resize([1.0, 0.8, 0.6, 0.4, 0.2], K)
        allocs[j] = np.maximum(1, np.round(fr * peak)).astype(np.int32)
    allocs[where[-1], K - 1] = 0
    return skylines, allocs


def _k1_both_forms(skylines, allocs):
    """K1 in the ragged form and in the pool + rows form (rows reversed),
    each against the ragged plain version: returns the ragged output."""
    from repro_torch.core.arepas import simulate_runtime_ragged
    from repro_torch.core.dataset import pad_skylines, ragged_skylines
    values, offsets = ragged_skylines(skylines)
    a = torch.from_numpy(allocs).cuda()
    v, o = torch.from_numpy(values).cuda(), torch.from_numpy(offsets).cuda()
    got = ops.arepas_runtimes_ragged(v, o, a)
    want = simulate_runtime_ragged(v, o, a, max_elems=1 << 27)
    assert torch.equal(got, want)
    sky, lens = pad_skylines(skylines)
    rows = torch.arange(len(skylines) - 1, -1, -1, device="cuda")
    pooled = ops.arepas_runtimes(torch.from_numpy(sky).cuda(),
                                 torch.from_numpy(lens).cuda(), a.flip(0),
                                 rows=rows)
    assert torch.equal(pooled.flip(0), want)
    return got


@pytest.mark.cuda
def test_k1_long_job_among_short_ones():
    """The main path's longest job (193,305 s, 48 segments) among short
    ones, in both layouts, bitwise to the plain version; one launch each."""
    _need_card()
    skylines, allocs = _long_jobs(3, 193_305, 1, J=200)
    before = ops.launch_counts()["arepas_runtimes"]
    got = _k1_both_forms(skylines, allocs)
    assert ops.launch_counts()["arepas_runtimes"] == before + 2
    j = int(np.argmax([len(s) for s in skylines]))
    for k in range(allocs.shape[1]):
        want = (simulate_runtime(skylines[j], int(allocs[j, k]))
                if allocs[j, k] >= 1 else -1)
        assert int(got[j, k]) == want


@pytest.mark.cuda
def test_k1_split_jobs_are_deterministic():
    """Several long jobs whose segments finish in no fixed order: 20
    launches give the same bits, equal to the plain version."""
    _need_card()
    skylines, allocs = _long_jobs(4, 60_000, 12, J=2000, K=13)
    from repro_torch.core.dataset import ragged_skylines
    first = _k1_both_forms(skylines, allocs)
    values, offsets = (torch.from_numpy(x).cuda()
                       for x in ragged_skylines(skylines))
    a = torch.from_numpy(allocs).cuda()
    for _ in range(20):
        assert torch.equal(ops.arepas_runtimes_ragged(values, offsets, a),
                           first)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8, 40])
def test_k1_forms_at_the_cluster_shape(K):
    """K = 1 as the cluster path launches it (and K over one warp's 32
    lanes): every job one segment or several, through a row index."""
    _need_card()
    skylines, allocs = _long_jobs(K, 15_325, 5, J=64, K=K)
    _k1_both_forms(skylines, allocs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["closing run", "lanes combined"])
def test_k1_excess_past_2_32_takes_the_exact_path(case):
    """An over-cap run whose excess passes 2^32 (the kernel's 32-bit
    summaries cannot hold it) goes through the exact 64-bit fold: equal to
    the plain version. "closing run": one lane's run closed by an under-cap
    second; "lanes combined": every lane's excess fits, their sum does not."""
    _need_card()
    from repro_torch.core.arepas import simulate_runtime_ragged
    from repro_torch.core.dataset import ragged_skylines
    big = 2**31 - 1
    if case == "closing run":
        skylines = [np.array([0, big, big, big, 0, 5], np.int32)]
        allocs = np.array([[2**20, 7, big]], np.int32)
    else:
        skylines = [np.array([2**27 + 1000] * 64 + [0], np.int32)]
        allocs = np.array([[1000, 2**26, 5000]], np.int32)
    skylines += [np.arange(1, 300, dtype=np.int32)]       # an ordinary job
    allocs = np.concatenate([allocs, [[50, 100, 200]]]).astype(np.int32)
    values, offsets = (torch.from_numpy(x).cuda()
                       for x in ragged_skylines(skylines))
    a = torch.from_numpy(allocs).cuda()
    got = ops.arepas_runtimes_ragged(values, offsets, a)
    assert torch.equal(got, simulate_runtime_ragged(values, offsets, a))


@pytest.mark.cuda
def test_k1_refused_launch_raises(monkeypatch):
    """A launch the C interface refuses (scratch for fewer work items than
    jobs): the wrapper raises and counts no launch."""
    _need_card()
    sky = _skyline_module()
    monkeypatch.setattr(sky, "max_segments", lambda J, *_: J - 1)
    args = [torch.ones(64, dtype=torch.int32, device="cuda"),
            torch.tensor([0, 16, 40, 64], device="cuda"),
            torch.ones((3, 3), dtype=torch.int32, device="cuda")]
    before = ops.launch_counts()["arepas_runtimes"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.arepas_runtimes_ragged(*args)
    assert ops.launch_counts()["arepas_runtimes"] == before


def _skyline_module():
    return sys.modules["repro_torch.kernels.skyline"]


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


# (K, L, Q, case): L and Q that the cluster's 8 CTAs do not divide; Q > L;
# every lease expired; a full table; an empty queue (every position
# zero-padded, as the simulator pads a shard's queue past its end) and no
# queue at all (Q = 0); the cluster path's largest shape (L = max_leases
# 8,192, Q up to cap_shard 6,144); tables wider than a CTA holds in
# registers
K2_CASES = [(4, 8191, 4093, "random"), (3, 1000, 3000, "random"),
            (2, 4096, 2048, "expired"), (2, 4096, 2048, "full"),
            (2, 4096, 2048, "empty"), (2, 4096, 0, "empty"),
            (4, 8192, 6144, "random"), (1, 40_000, 70_000, "random")]


def _k2_case(K, L, Q, case, seed=0):
    rng = np.random.RandomState(seed)
    now = 500.0
    live = rng.rand(K, L) < 0.6
    tokens = np.where(live, rng.randint(1, 64, (K, L)), 0).astype(np.int64)
    end = np.where(live, now + rng.randint(-100, 200, (K, L)) * 0.5, np.inf)
    if case == "expired":
        end = np.where(live, now - 1.0, np.inf)
    if case == "full":
        tokens = rng.randint(1, 64, (K, L)).astype(np.int64)
        end = np.full((K, L), now + 10.0)
        end[:, :11] = now - 1.0
    free = rng.randint(0, 20 * max(Q, 1), K).astype(np.int64)
    q_tok = rng.randint(1, 64, (K, Q)).astype(np.int64)
    q_tok[:, rng.randint(0, Q + 1):] = 0
    if case == "empty":
        q_tok[:] = 0
    q_end = now + rng.randint(1, 999, (K, Q)).astype(np.float64)
    return [torch.from_numpy(x).cuda()
            for x in (end, tokens, free, q_tok, q_end)], now


@pytest.mark.cuda
@pytest.mark.parametrize("K,L,Q,case", K2_CASES)
def test_k2_edge_shapes_equal_plain_version(K, L, Q, case):
    """K2 as built (clusters of 8 CTAs), bitwise to the plain version, one
    launch a call (the last case takes the kernel's chunked walk)."""
    _need_card()
    from repro_torch.kernels.cluster_step import cluster_ctas, epoch_step_ref
    assert cluster_ctas() == 8
    args, now = _k2_case(K, L, Q, case, seed=L + Q)
    before = ops.launch_counts()["cluster_epoch_step"]
    got = ops.cluster_epoch_step(*args, now)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cluster_epoch_step"] == before + 1
    want = epoch_step_ref(*args, now)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if case == "expired":
        assert torch.equal(got[6], (args[1] > 0).sum(1))
    if case == "full":
        assert (got[3] <= 11).all()
    if case == "empty":
        assert int(got[3].sum()) == 0


@pytest.mark.cuda
def test_k2_refused_cluster_launch_raises(monkeypatch):
    """K2 built for clusters of 32 CTAs, beyond any card's limit: the
    launch is refused and the wrapper raises, with no fallback and no
    launch counted."""
    _need_card()
    from repro_torch.kernels import _build
    from repro_torch.kernels import cluster_step as cs
    monkeypatch.setattr(cs, "_loaded", cs._bind(
        _build.load("cluster_step", ("K2_CLUSTER_CTAS=32",))))
    args, now = _k2_case(2, 1024, 512, "random")
    before = ops.launch_counts()["cluster_epoch_step"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.cluster_epoch_step(*args, now)
    assert ops.launch_counts()["cluster_epoch_step"] == before


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


_K3_KEYS = ("a", "b", "price", "obs", "floor", "done", "cand_tok",
            "cand_end")


def _k3_against_plain(vecs, sky, lens, rows, policy, cap, now=50.0,
                      epoch_s=8.0):
    """K3 on the card (one launch, counted) against ``resize_step_ref`` on
    the gathered rows, bitwise; returns the kernel's (tgt, sel, rt,
    new_end)."""
    from repro_torch.kernels.cluster_step import (pack_resize,
                                                  resize_step_ref,
                                                  unpack_resize)
    dev = torch.device("cuda")
    rows = np.ascontiguousarray(rows, np.int64)
    packed = torch.from_numpy(pack_resize(*(vecs[k] for k in _K3_KEYS),
                                          rows)).to(dev)
    sky_t = torch.from_numpy(sky).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    before = ops.launch_counts()["cluster_resize_step"]
    got = unpack_resize(ops.cluster_resize_step(packed, sky_t, lens_t, now,
                                                epoch_s, policy=policy,
                                                cap=cap))
    torch.cuda.synchronize()
    assert ops.launch_counts()["cluster_resize_step"] == \
        before + (len(rows) > 0)
    r = torch.from_numpy(rows).to(dev)
    want = resize_step_ref(*(torch.from_numpy(np.asarray(vecs[k])).to(dev)
                             for k in _K3_KEYS), sky_t[r], lens_t[r], now,
                           epoch_s, policy=policy, cap=cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("policy_name", ["default", "bounded_slowdown"])
def test_k3_equals_plain_version(policy_name):
    _need_card()
    from repro_torch.core.allocator import build_policy
    vecs, sky, lens = _resize_batch(len(policy_name))
    policy = build_policy(policy_name)
    C = sky.shape[0]
    got = _k3_against_plain(vecs, sky, lens, np.arange(C), policy, 4000)
    # through a row index into a resident pool (reversed order)
    flipped = {k: np.ascontiguousarray(v[::-1]) for k, v in vecs.items()}
    got_r = _k3_against_plain(flipped, sky, lens, np.arange(C)[::-1],
                              policy, 4000)
    for g, w in zip(got_r, got):
        assert torch.equal(g.flip(0), w)
    rt1 = ops.arepas_runtimes(torch.from_numpy(sky).cuda(),
                              torch.from_numpy(lens).cuda(),
                              got[0].clamp(min=1).int()[:, None],
                              rows=torch.arange(C, device="cuda"))
    assert torch.equal(rt1[:, 0].long().clamp(min=1), got[2])


def _k3_edge(case):
    """(vecs, sky, lens, rows, policy, cap) for one edge of K3."""
    from repro_torch.core.allocator import AllocationPolicy
    vecs, sky, lens = _resize_batch(7, C=300, smax=2000)
    C = sky.shape[0]
    rows = np.arange(C)
    policy, cap = AllocationPolicy(max_slowdown=0.05), 4000
    if case == "max_slowdown 0":
        policy = AllocationPolicy(max_slowdown=0.0)
    elif case == "a >= 0":
        vecs["a"] = np.where(np.arange(C) % 2 == 0, 0.0, 0.3 + vecs["a"] ** 2)
    elif case == "obs < min_tokens":
        policy = AllocationPolicy(max_slowdown=0.05, min_tokens=50)
        vecs["obs"] = np.random.RandomState(1).randint(-3, 50, C).astype(
            np.int64)
    elif case == "obs to 2^40":
        # intervals past 2^13 up to 2^40: ten rounds, and 48 levels do not
        # close the widest
        vecs["obs"] = (2 ** np.random.RandomState(2).uniform(13, 40, C)
                       ).astype(np.int64)
        vecs["obs"][:3] = [2 ** 40, 2 ** 40 - 1, 2 ** 39 + 12345]
        cap = 2 ** 45
    elif case == "floor above cap":
        vecs["floor"] = cap + 1 + np.arange(C, dtype=np.int64) % 17
    elif case == "vlen 0 and Smax":
        lens = lens.copy()
        lens[::3], lens[1::3] = 0, sky.shape[1]
        lens[2], lens[5] = -4, sky.shape[1] + 9     # outside [0, Smax]
        sky = sky.copy()
        sky[1::3] = np.random.RandomState(3).randint(0, 900, sky[1::3].shape)
    elif case == "skyline of 65,536 s":
        sky = np.zeros((3, 65_536), np.int32)
        rng = np.random.RandomState(4)
        sky[0] = np.repeat(rng.randint(0, 5000, 65_536 // 64), 64)
        sky[1] = rng.randint(0, 5000, 65_536)
        sky[2, :1000] = 7
        lens = np.array([65_536, 65_536, 1000], np.int32)
        rows = np.random.RandomState(5).randint(0, 3, C)
    elif case == "excess past 2^32":
        # over-cap runs whose excess passes 2^32 (the exact 64-bit path):
        # a run inside one lane's span; runs that fit each lane but not
        # their sum; every second over. Allocations of 2^20 and more keep
        # the runtimes within int32, as the plain version's are.
        # The last row is long, its lanes' summaries within 32 bits and
        # their sum past them.
        big = 2 ** 31 - 1
        sky = np.zeros((5, 6000), np.int32)
        sky[0, 10:13] = big
        sky[1, :1500] = 2 ** 26 + 1000
        sky[2, :2000] = big
        sky[3, :2000] = np.arange(2000) % 300       # an ordinary one
        sky[4, :6000] = 2 ** 26 + 1000
        lens = np.array([2000, 1600, 2000, 2000, 6000], np.int32)
        rows = np.arange(C) % 5
        vecs["floor"] = 2 ** 20 + np.arange(C, dtype=np.int64) % 1000
        cap = 2 ** 21
    elif case == "long skylines":
        # long skylines (up to the cluster path's longest, 15,325 s) in
        # the same blocks as short ones, step functions and noise, at caps
        # that cut them
        rng = np.random.RandomState(6)
        lens = np.array([2047, 2048, 2049, 2050, 4097, 9800, 15_325, 100, 1,
                         0], np.int32)
        sky = np.zeros((len(lens), 15_325), np.int32)
        for u, n in enumerate(lens):
            blk = [1, 60][u % 2]
            sky[u, :n] = np.repeat(rng.randint(0, 600, n // blk + 1), blk)[:n]
        rows = rng.randint(0, len(lens), C)
        vecs["obs"] = rng.randint(1, 700, C).astype(np.int64)
    elif case == "C 0":
        vecs = {k: v[:0] for k, v in vecs.items()}
        rows = rows[:0]
    elif case == "C 1":
        vecs = {k: v[5:6] for k, v in vecs.items()}
        rows = rows[5:6]
    elif case == "reversed rows":
        vecs = {k: np.ascontiguousarray(v[::-1]) for k, v in vecs.items()}
        rows = rows[::-1].copy()
    return vecs, sky, lens, rows, policy, cap


K3_EDGES = ["max_slowdown 0", "a >= 0", "obs < min_tokens", "obs to 2^40",
            "floor above cap", "vlen 0 and Smax", "skyline of 65,536 s",
            "excess past 2^32", "long skylines", "C 0", "C 1",
            "reversed rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_EDGES)
def test_k3_edges_equal_plain_version(case):
    """K3 bitwise to its plain version at the edges of its contract."""
    _need_card()
    vecs, sky, lens, rows, policy, cap = _k3_edge(case)
    tgt, sel, rt, new_end = _k3_against_plain(vecs, sky, lens, rows, policy,
                                              cap)
    if case == "floor above cap":
        assert torch.equal(tgt.cpu(), torch.from_numpy(vecs["floor"]))
    if case == "obs to 2^40":
        assert int(tgt.max()) > 2 ** 20          # wide intervals stay wide
    if case == "C 0":
        assert tgt.numel() == 0


@pytest.mark.cuda
def test_k3_refused_launch_raises(monkeypatch):
    """K3 built with blocks of 33 warps (1,056 threads, past any card's
    1,024; steps of 8 seconds keep its tiles within 48 KB): the launch is
    refused and the wrapper raises, with no fallback and no launch
    counted."""
    _need_card()
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.kernels import _build
    from repro_torch.kernels import cluster_step as cs
    from repro_torch.kernels.cluster_step import pack_resize
    monkeypatch.setattr(cs, "_loaded", cs._bind(
        _build.load("cluster_step", ("K3_BLOCK_WARPS=33", "K3_CHUNK=8"))))
    vecs, sky, lens = _resize_batch(3, C=40, smax=300)
    packed = torch.from_numpy(pack_resize(*(vecs[k] for k in _K3_KEYS),
                                          np.arange(40))).cuda()
    before = ops.launch_counts()["cluster_resize_step"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.cluster_resize_step(packed, torch.from_numpy(sky).cuda(),
                                torch.from_numpy(lens).cuda(), 50.0, 8.0,
                                policy=AllocationPolicy(max_slowdown=0.05),
                                cap=4000)
    assert ops.launch_counts()["cluster_resize_step"] == before


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


# ------------------------------------------------------------------- K4 ---
# (B, Hq, Hkv, S, D): the CPU tests' shapes (the reference test's MHA, GQA,
# MQA and rectangular cases and a minitron-8b head shape), then a ragged
# sequence and a one-token one
K4_SHAPES = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 256, 128),
             (2, 4, 4, 512, 32), (1, 32, 8, 512, 128), (2, 4, 2, 100, 16),
             (1, 2, 1, 1, 64),
             # zamba2-2.7b's shared attention: D 80, Hq == Hkv
             (1, 32, 32, 512, 80), (2, 4, 4, 100, 80), (1, 4, 2, 256, 80),
             # ragged: GQA 4:1 at D 128, and D 80 one short of a 128-row tile
             (2, 4, 1, 1000, 128), (1, 4, 4, 2047, 80)]
K4_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _attn_args(shape, dtype, seed):
    B, Hq, Hkv, S, D = shape
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(
        np.float32)).to("cuda", getattr(torch, dtype)) for h in (Hq, Hkv, Hkv)]


def _attn_plain(q, k, v, causal):
    from repro_torch.kernels.ref import attention_ref_bhsd
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return attention_ref_bhsd(qt, kt, vt, causal=causal).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_equals_plain_version(shape, causal, dtype):
    _need_card()
    q, k, v = _attn_args(shape, dtype, sum(shape))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), _attn_plain(q, k, v, causal)
                               .float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_k4_and_k5_bf16_are_deterministic():
    """The same bf16 inputs twice give bitwise-equal outputs (no atomics,
    a fixed order of sums), at the LM shapes' head dims."""
    _need_card()
    q, k, v = _attn_args((2, 8, 2, 1000, 128), "bfloat16", 11)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       ops.flash_attention(q, k, v, causal=True))
    q, k, v = _attn_args((1, 4, 4, 2047, 80), "bfloat16", 12)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       ops.flash_attention(q, k, v, causal=True))
    args = _ssd_args((2, 512, 8, 64, 64, 128), "bfloat16", 13)
    assert torch.equal(ops.ssd_scan(*args, chunk=128),
                       ops.ssd_scan(*args, chunk=128))


@pytest.mark.cuda
def test_k4_at_the_lm_prefill_shape():
    """B 8, Hq 32, Hkv 8, S 2,048, D 128, bf16, causal: minitron-8b's
    prefill at the serving slice's batch."""
    _need_card()
    q, k, v = _attn_args((8, 32, 8, 2048, 128), "bfloat16", 5)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), _attn_plain(q, k, v, True)
                               .float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(8, 16, 16, 2048, 128),
                                   (8, 64, 4, 2048, 128)])
def test_k4_at_the_moe_prefill_shapes(shape, dtype):
    """The MoE family's prefill at batch 8 x 2,048, causal: moonshot's
    16 heads over 16 kv heads and qwen3-moe's 64 over 4 (a GQA group of
    16), D 128."""
    _need_card()
    q, k, v = _attn_args(shape, dtype, 6)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    tol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), _attn_plain(q, k, v, True)
                               .float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_k4_refused_launch_raises(monkeypatch):
    """A head dim the library has no instance for: the launch function
    refuses it, and the wrapper raises instead of returning garbage."""
    _need_card()
    # the package's ``flash_attention`` attribute is the ops function, so
    # the kernel module is read from sys.modules
    fa = sys.modules["repro_torch.kernels.flash_attention"]
    monkeypatch.setattr(fa, "HEAD_DIMS", fa.HEAD_DIMS + (48,))
    q, k, v = _attn_args((1, 2, 1, 64, 48), "float32", 0)
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before


@pytest.mark.cuda
def test_k4_rejects_bad_inputs():
    _need_card()
    q, k, v = _attn_args((1, 4, 2, 64, 32), "float32", 1)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                            v[..., :24].contiguous())


def _offset_view(t):
    """A contiguous copy of ``t`` that starts one element past a fresh
    allocation: not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_takes_an_offset_view(dtype):
    """q, k, v at an offset that is not 16-byte aligned: copied once, the
    kernel launches (no plain version) and equals the plain version."""
    _need_card()
    q, k, v = _attn_args((2, 4, 2, 256, 128), dtype, 8)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(*(_offset_view(t) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    tol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), _attn_plain(q, k, v, True)
                               .float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_server_on_card_launches_k4_once_a_layer_per_prefill():
    """``Server.run`` on minitron-8b-smoke with ``attention_impl="pallas"``:
    K4 runs in every layer of every prefill, and the tokens equal the
    port's CPU run on the same weights (float32; a flip would need two
    logits within ~1e-5)."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import model_api
    cfg = dataclasses.replace(get_config("minitron-8b-smoke"),
                              attention_impl="pallas")
    params = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(21)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                    int(rng.randint(1, 8)))
            for i, n in enumerate([5, 16, 30, 1, 12, 16, 40, 9])]
    sc = ServeConfig(batch_size=3, prompt_len=16)
    ops.reset_launch_counts()
    on_card = Server(cfg, sc, {k: _to(v, "cuda") for k, v in params.items()},
                     device="cuda").run(reqs)
    assert ops.launch_counts()["flash_attention"] == 3 * cfg.num_layers
    assert on_card == Server(cfg, sc, params, device="cpu").run(reqs)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b-smoke", "mamba2-1.3b-smoke"])
def test_ssm_and_hybrid_server_on_card_equals_the_cpu(arch):
    """``Server.run`` on the SSM and hybrid smoke configs with
    ``attention_impl="pallas"``: K4 runs once a shared-attention
    application a prefill (never in decode, never for mamba2), and the
    tokens equal the port's CPU run on the same weights (float32)."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import model_api
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
    params = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(22)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                    int(rng.randint(1, 8)))
            for i, n in enumerate([5, 32, 50, 1, 12, 32, 40, 9])]
    sc = ServeConfig(batch_size=3, prompt_len=32)
    ops.reset_launch_counts()
    on_card = Server(cfg, sc, _to(params, "cuda"), device="cuda").run(reqs)
    apps = (cfg.num_layers // cfg.attn_period if cfg.family == "hybrid"
            else 0)
    assert ops.launch_counts()["flash_attention"] == 3 * apps
    assert ops.launch_counts()["ssd_scan"] == 0
    assert on_card == Server(cfg, sc, params, device="cpu").run(reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b-smoke",
                                  "qwen3-moe-235b-a22b-smoke"])
def test_moe_server_on_card_equals_the_cpu(arch):
    """``Server.run`` on the MoE smoke configs with
    ``attention_impl="pallas"``: K4 runs in every layer of every prefill,
    and the tokens equal the port's CPU run on the same weights (float32;
    the routing's stable sort picks the same experts on both)."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import model_api
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
    params = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(23)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                    int(rng.randint(1, 8)))
            for i, n in enumerate([5, 16, 30, 1, 12, 16, 40, 9])]
    sc = ServeConfig(batch_size=3, prompt_len=16)
    ops.reset_launch_counts()
    on_card = Server(cfg, sc, _to(params, "cuda"), device="cuda").run(reqs)
    assert ops.launch_counts()["flash_attention"] == 3 * cfg.num_layers
    assert on_card == Server(cfg, sc, params, device="cpu").run(reqs)


@pytest.mark.cuda
def test_bf16_train_state_checkpoint_round_trip_on_card(tmp_path):
    """A bf16 train state on the card (zamba2-smoke's tree in bf16, m and
    v float32 after one step) saved and restored: every leaf back on the
    card, of its type, bitwise."""
    _need_card()
    import dataclasses
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         state_from_leaves, state_leaves)
    cfg = dataclasses.replace(get_config("zamba2-2.7b-smoke"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    state = init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    state, _ = make_train_step(cfg)(state, model_api.smoke_batch(
        cfg, "train", seq=64, device="cuda"))
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, state_leaves(state), blocking=True)
    saved = state_leaves(state)
    leaves, step = cm.restore(state_leaves(init_train_state(
        cfg, torch.Generator("cuda").manual_seed(1), "cuda")))
    restored = state_from_leaves(leaves, state)
    assert step == 1 and restored.step == 1 and restored.opt.count == 1
    got = state_leaves(restored)
    assert any(t.dtype == torch.bfloat16 for t in got)
    for a, b in zip(got, saved):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.detach().view(torch.int16)
                           if b.dtype == torch.bfloat16 else b.detach())


@pytest.mark.cuda
def test_hybrid_prefill_k4_route_on_left_padded_prompts_equals_plain():
    """A hybrid prefill of left-padded prompts (the server's zero padding,
    unmasked) on the card: the K4 route against the plain route, float32,
    logits and every cache within 1e-4 of their scale; the prompts' padded
    keys reach K4 as ordinary rows."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm, model_api
    cfg = get_config("zamba2-2.7b-smoke")
    params = _to(model_api.init(cfg, torch.Generator().manual_seed(1),
                                "cpu"), "cuda")
    rng = np.random.RandomState(23)
    tokens = np.zeros((4, 128), np.int32)
    for i, n in enumerate([128, 100, 7, 64]):
        tokens[i, 128 - n:] = rng.randint(1, cfg.vocab_size, n)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    out = {}
    for impl in ("pallas", "xla"):
        ops.reset_launch_counts()
        out[impl] = lm.prefill(params, batch, dataclasses.replace(
            cfg, attention_impl=impl))
        assert ops.launch_counts()["flash_attention"] == (
            cfg.num_layers // cfg.attn_period if impl == "pallas" else 0)
    (lk, ck), (lx, cx) = out["pallas"], out["xla"]
    for got, want in [(lk, lx)] + [(getattr(ck, n), getattr(cx, n))
                                   for n in ("ssm", "shared_k",
                                             "shared_v")]:
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, atol=tol, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("slowdown", [0.0, 0.05, 0.5])
def test_fig2_bisection_on_card_equals_the_cpu_twin(slowdown):
    """``min_tokens_within_slowdown_torch`` on the card (K1 one launch a
    round) against the same bisection on the CPU (the plain AREPAS), on a
    seed-21 corpus in the ragged layout; ``token_reduction_cdf`` equal
    bitwise on both devices."""
    _need_card()
    from repro_torch.core.allocator import (min_tokens_within_slowdown_torch,
                                            token_reduction_cdf)
    from repro_torch.core.dataset import ragged_skylines
    from repro_torch.workloads.executor import observed_skyline
    from repro_torch.workloads.generator import build_corpus
    jobs = build_corpus(300, seed=21)
    sky = [observed_skyline(j) for j in jobs]
    toks = np.array([j.default_tokens for j in jobs], np.int64)
    toks[:3] = [1, 0, int(sky[3].max()) // 4]       # closed, clamped, short
    values, offsets = ragged_skylines(sky)
    args = [torch.from_numpy(x) for x in (values, offsets, toks)]
    ops.reset_launch_counts()
    got = min_tokens_within_slowdown_torch(*(a.cuda() for a in args),
                                           slowdown)
    launches = ops.launch_counts()["arepas_runtimes"]
    assert 1 <= launches <= int(np.ceil(np.log2(toks.max())))
    want = min_tokens_within_slowdown_torch(*args, slowdown)
    assert torch.equal(got.cpu(), want)
    r, frac = token_reduction_cdf(sky, toks, slowdown, device="cuda")
    rc, fc = token_reduction_cdf(sky, toks, slowdown, device="cpu")
    assert np.array_equal(r, rc) and np.array_equal(frac, fc)


# ------------------------------------------------------------------ K5 ---
# (B, S, H, P, N, chunk): the reference test's SSD_SHAPES, zamba2-2.7b's
# and mamba2-1.3b's training shapes, the smoke configs' head shape, a
# chunk (Q = S = 48) that fills no 64-row tile, and every (P, N) the
# kernel is compiled for
K5_SHAPES = [(1, 128, 2, 32, 64, 64), (2, 256, 4, 64, 128, 128),
             (2, 512, 1, 16, 32, 128), (1, 256, 3, 64, 64, 256),
             (8, 2048, 80, 64, 64, 128), (8, 2048, 64, 64, 128, 128),
             (2, 64, 8, 16, 16, 32), (1, 48, 2, 16, 16, 128)] + [
    (2, 256, 3, P, N, 128) for P in (16, 32, 64) for N in (16, 32, 64, 128)]
K5_TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _ssd_args(shape, dtype, seed):
    B, S, H, P, N, _ = shape
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    dt = getattr(torch, dtype)
    return [rnd(B, S, H, P).to(dt), torch.nn.functional.softplus(rnd(B, S, H)),
            -torch.exp(rnd(H) * 0.5), (rnd(B, S, N) / N ** 0.5).to(dt),
            (rnd(B, S, N) / N ** 0.5).to(dt)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_equals_plain_version(shape, dtype):
    _need_card()
    from repro_torch.models.layers import ssd_chunked
    args = _ssd_args(shape, dtype, sum(shape))
    before = ops.launch_counts()["ssd_scan"]
    got = ops.ssd_scan(*args, chunk=shape[5])
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    want = ssd_chunked(*args, min(shape[5], shape[1]))[0]
    tol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_k5_refused_launch_raises(monkeypatch):
    """A head dim the library has no instance for: the launch function
    refuses it, and the wrapper raises instead of returning garbage."""
    _need_card()
    ssd = sys.modules["repro_torch.kernels.ssd"]
    monkeypatch.setattr(ssd, "HEAD_DIMS", ssd.HEAD_DIMS + (48,))
    args = _ssd_args((1, 64, 2, 48, 16, 64), "float32", 0)
    before = ops.launch_counts()["ssd_scan"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.ssd_scan(*args, chunk=64)
    assert ops.launch_counts()["ssd_scan"] == before


@pytest.mark.cuda
def test_k5_rejects_bad_inputs():
    _need_card()
    x, dt, A, Bm, Cm = _ssd_args((1, 64, 2, 16, 16, 64), "float32", 1)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt, A, Bm.bfloat16(), Cm)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt.double(), A, Bm, Cm)
    with pytest.raises(ValueError):
        ops.ssd_scan(x.transpose(1, 2), dt, A, Bm, Cm)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A.cpu(), Bm, Cm)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)       # 64 % 48 != 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1024, 2, 64, 64, 512),
                                   (2, 512, 3, 32, 128, 512)])
def test_k5_bf16_chunk_over_256_rows(shape):
    """bf16 chunks of 512 rows (more than the tensor-core kernel's one TMA
    box): the CUDA-core kernel in bf16 launches, within the bf16
    tolerance of the plain version."""
    _need_card()
    from repro_torch.models.layers import ssd_chunked
    args = _ssd_args(shape, "bfloat16", sum(shape))
    before = ops.launch_counts()["ssd_scan"]
    got = ops.ssd_scan(*args, chunk=shape[5])
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    want = ssd_chunked(*args, shape[5])[0]
    torch.testing.assert_close(got.float(), want.float(),
                               atol=K5_TOL["bfloat16"],
                               rtol=K5_TOL["bfloat16"])


@pytest.mark.cuda
def test_k5_takes_an_offset_view():
    """x, B, C at an offset that is not 16-byte aligned (bf16, the TMA
    path): copied once, the kernel launches and equals the plain version."""
    _need_card()
    from repro_torch.models.layers import ssd_chunked
    args = _ssd_args((2, 256, 4, 64, 64, 128), "bfloat16", 17)
    moved = [_offset_view(t) if i in (0, 3, 4) else t
             for i, t in enumerate(args)]
    before = ops.launch_counts()["ssd_scan"]
    got = ops.ssd_scan(*moved, chunk=128)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    torch.testing.assert_close(got.float(),
                               ssd_chunked(*args, 128)[0].float(),
                               atol=K5_TOL["bfloat16"],
                               rtol=K5_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash_attention", "ssd_scan"])
def test_autograd_functions_equal_autograd_of_the_plain_version(which):
    """float32: the forward is the kernel's, the backward recomputes the
    plain version, so the input gradients equal plain autograd's to the
    kernel's forward tolerance carried through the backward."""
    _need_card()
    from repro_torch.models.layers import ssd_chunked
    if which == "flash_attention":
        inputs = _attn_args((2, 4, 4, 256, 80), "float32", 3)
        fn = lambda q, k, v: ops.flash_attention(q, k, v, causal=True)
        plain = lambda q, k, v: _attn_plain(q, k, v, True)
    else:
        inputs = _ssd_args((2, 256, 4, 64, 64, 128), "float32", 4)
        fn = lambda *a: ops.ssd_scan(*a, chunk=128)
        plain = lambda *a: ssd_chunked(*a, 128)[0]
    got = []
    for f in (fn, plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        y = f(*leaves)
        w = torch.randn(y.shape, generator=torch.Generator(
            "cuda").manual_seed(9), device="cuda")
        got.append((y.detach(), torch.autograd.grad((y * w).sum(), leaves)))
    (yk, gk), (yp, gp) = got
    torch.testing.assert_close(yk, yp, atol=2e-5, rtol=2e-5)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_train_step_on_card_launches_k5_and_k4_and_equals_the_cpu():
    """One train step of zamba2-smoke with both kernel routes, remat
    "full": K5 runs 2 x layers and K4 2 x applications times, and loss and
    grad norm equal the port's CPU step on the same weights (float32)."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    from repro_torch.train.steps import make_train_step, train_state_from_params
    cfg = dataclasses.replace(get_config("zamba2-2.7b-smoke"),
                              attention_impl="pallas", ssd_impl="pallas")
    params = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = model_api.smoke_batch(cfg, "train", seq=64, device="cpu")
    metrics = {}
    for dev in ("cuda", "cpu"):
        state = train_state_from_params(_to(params, dev))
        ops.reset_launch_counts()
        _, metrics[dev] = make_train_step(cfg)(state, _to(batch, dev))
        counts = ops.launch_counts()
        if dev == "cuda":
            assert counts["ssd_scan"] == 2 * cfg.num_layers
            assert counts["flash_attention"] == \
                2 * cfg.num_layers // cfg.attn_period
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics["cuda"][k]),
                                   float(metrics["cpu"][k]), rtol=1e-4)
