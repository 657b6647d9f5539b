"""Kernel K1 on the card against its plain PyTorch version.

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
