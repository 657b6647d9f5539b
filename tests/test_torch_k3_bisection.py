"""Kernel K3's warp-wide bisection, modelled in numpy: the speculative walk
of the bisection tree that ``priced_decision`` in
``src/repro_torch/csrc/cluster_step.cu`` takes (rounds of ``kTreeLevels``
levels, one node a lane, the true path walked through the predicates,
stopping where the interval closes or at ``kBisectIters`` levels) against
the plain version's serial 48-step bisection (``choose_tokens_priced_torch``),
on monotone and non-monotone predicates, empty and one-token intervals and
intervals wider than 2^48; and the rounds of ``pow`` the walk takes. The
round shape is read from the CUDA source."""
import re

import numpy as np
import pytest

from repro_torch.kernels import _build

SRC = (_build.CSRC / "cluster_step.cu").read_text()
TREE_LEVELS = int(re.search(r"constexpr int kTreeLevels = (\d+);", SRC)[1])
BISECT_ITERS = int(re.search(r"constexpr int kBisectIters = (\d+);", SRC)[1])
LANES = 32


def serial(pred, lo, hs, iters=48):
    """The plain version's loop on one candidate: (lo, hs, the mids it
    branches on, in order)."""
    mids = []
    for _ in range(iters):
        cond = lo < hs
        mid = (lo + hs) // 2                  # floor, as torch's // on int64
        if cond:
            mids.append(mid)
            if pred(mid):
                hs = mid
            else:
                lo = mid + 1
    return lo, hs, mids


def warp_walk(pred, lo, hs, levels=TREE_LEVELS, max_levels=BISECT_ITERS):
    """The kernel's walk: (lo, hs, the mids on the walked path, rounds).
    In a round every lane derives its node's interval from the round's
    (lo, hs) and the bits of its heap index alone, and evaluates the
    predicate at the node's mid (lane 31 evaluates the base in the kernel,
    no node); the walk then follows the predicates of the 31 nodes."""
    nodes = (1 << levels) - 1
    path, rounds, level = [], 0, 0
    while lo < hs and level < max_levels:
        rounds += 1
        ok = 0
        for lane in range(nodes):
            n = lane + 1
            l, h = lo, hs
            for k in range(n.bit_length() - 2, -1, -1):
                m = (l + h) // 2
                if (n >> k) & 1:
                    h = m
                else:
                    l = m + 1
            if pred((l + h) // 2):
                ok |= 1 << lane
        node = 1
        for _ in range(levels):
            if not (lo < hs and level < max_levels):
                break
            m = (lo + hs) // 2
            bit = (ok >> (node - 1)) & 1
            path.append(m)
            if bit:
                hs = m
            else:
                lo = m + 1
            node = 2 * node + bit
            level += 1
    return lo, hs, path, rounds


def _same(pred, lo, hs):
    want_lo, want_hs, mids = serial(pred, lo, hs)
    got_lo, got_hs, path, rounds = warp_walk(pred, lo, hs)
    assert (got_lo, got_hs) == (want_lo, want_hs)
    assert path == mids
    assert rounds == -(-len(mids) // TREE_LEVELS)
    return rounds


def test_round_shape_fits_a_warp():
    assert (1 << TREE_LEVELS) - 1 < LANES       # lane 31 is left for the base
    assert BISECT_ITERS == 48                   # the plain version's count


@pytest.mark.parametrize("seed", range(4))
def test_monotone_predicates(seed):
    """b * mid^a <= limit is monotone in exact arithmetic: a threshold."""
    rng = np.random.RandomState(seed)
    for _ in range(300):
        lo = int(rng.randint(-5, 40))
        hs = lo + int(rng.randint(0, 2 ** int(rng.randint(1, 30))))
        t = int(rng.randint(lo - 3, hs + 4))
        _same(lambda m, t=t: m >= t, lo, hs)


# non-monotone predicate tables: what a pow that is not monotone in floating
# point could give; the walk must follow the serial loop's path anyway
def _table(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "random bits":
        bits = rng.rand(4096) < 0.5
        return lambda m: bool(bits[m % 4096])
    if kind == "alternating":
        return lambda m: m % 2 == 1
    if kind == "flips near the threshold":
        t = int(rng.randint(100, 5000))
        flips = set(int(x) for x in rng.randint(t - 8, t + 8, 6))
        return lambda m: (m >= t) != (m in flips)
    if kind == "true below, false above":
        t = int(rng.randint(100, 5000))
        return lambda m: m < t
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random bits", "alternating",
                                  "flips near the threshold",
                                  "true below, false above"])
def test_non_monotone_predicates(kind):
    rng = np.random.RandomState(len(kind))
    for seed in range(40):
        pred = _table(kind, seed)
        lo = int(rng.randint(1, 20))
        hs = int(rng.randint(lo, 6288 * 2))
        _same(pred, lo, hs)


@pytest.mark.parametrize("lo,hs", [(5, 4), (1, 0), (7, -3), (5, 5), (1, 1)])
def test_closed_intervals_take_no_round(lo, hs):
    """hi < lo0 and hi == lo0: the serial loop changes nothing, the walk
    evaluates nothing (the kernel computes no pow)."""
    got_lo, got_hs, path, rounds = warp_walk(lambda m: True, lo, hs)
    assert (got_lo, got_hs, path, rounds) == (lo, hs, [], 0)
    assert serial(lambda m: True, lo, hs)[:2] == (lo, hs)


@pytest.mark.parametrize("width_log2", [47, 48, 49, 50])
def test_wide_intervals_stop_at_48_levels(width_log2):
    """Past 2^48 tokens 48 levels do not close the interval; the walk ends
    where the serial loop ends, after ceil(48 / 5) rounds."""
    rng = np.random.RandomState(width_log2)
    for kind in ("monotone", "random bits"):
        t = int(rng.randint(1, 2 ** width_log2))
        pred = ((lambda m: m >= t) if kind == "monotone"
                else _table("random bits", width_log2))
        lo, hs = 1, 2 ** width_log2
        rounds = _same(pred, lo, hs)
        lo_s, hs_s, mids = serial(pred, lo, hs)
        assert len(mids) <= BISECT_ITERS
        if width_log2 >= 49:
            assert len(mids) == BISECT_ITERS and lo_s < hs_s
            assert rounds == -(-BISECT_ITERS // TREE_LEVELS)


def test_at_most_three_rounds_up_to_2_13():
    """An interval of at most 2^13 tokens (the cluster path's: observed
    tokens of the order of max_tokens, 6,287) closes in at most 14 levels:
    3 rounds, 3 pow latencies instead of the serial loop's 49."""
    rng = np.random.RandomState(13)
    worst = 0
    for width in list(range(0, 64)) + [2 ** 13 - 1, 2 ** 13] + list(
            rng.randint(64, 2 ** 13, 400)):
        t = int(rng.randint(0, width + 2))
        for pred in (lambda m: m >= t, _table("random bits", int(width))):
            worst = max(worst, _same(pred, 1, 1 + int(width)))
    assert worst == 3
