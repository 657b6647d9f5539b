"""AREPAS in the PyTorch port: the plain version of kernel K1 against the
numpy oracle and the reference's Pallas kernel (interpret mode), and the
device rule of the port's entry points."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.arepas import simulate_runtime as ref_simulate_runtime
from repro.kernels import arepas_runtimes as ref_arepas_runtimes
from repro_torch.core import arepas as port_arepas
from repro_torch.core.arepas import simulate_runtime_batch
from repro_torch.kernels import ops


def _batch(seed, J=24, smax=2048, K=6):
    """Random integer skylines with the edge cases K1's tiling must get
    right: a one-second job, a job filling the row, an over-cap section
    ending exactly at a 1024-second tile edge, and seconds equal to the
    allocation."""
    rng = np.random.RandomState(seed)
    sky = np.zeros((J, smax), np.int32)
    lens = rng.randint(1, smax + 1, size=J).astype(np.int32)
    lens[:3] = [1, smax, min(1500, smax)]
    allocs = np.zeros((J, K), np.int32)
    for j in range(J):
        blk = rng.choice([1, 5, 64])
        row = np.repeat(rng.randint(0, 120, size=lens[j] // blk + 1),
                        blk)[:lens[j]]
        sky[j, :lens[j]] = row
        peak = max(1, int(row.max()))
        allocs[j] = np.maximum(
            1, np.round(np.linspace(1.0, 0.1, K) * peak)).astype(np.int32)
        allocs[j, -1] = max(1, int(row[0]))      # seconds equal the cap
    if smax >= 1500:                             # run closes at the tile edge
        sky[2, :1024], sky[2, 1024:1500] = 100, 3
        allocs[2, 0] = 50
    return sky, lens, allocs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_batch_equals_numpy_oracle(seed):
    sky, lens, allocs = _batch(seed)
    got = simulate_runtime_batch(*map(torch.from_numpy, (sky, lens, allocs)))
    assert got.dtype == torch.int32 and got.shape == allocs.shape
    for j in range(sky.shape[0]):
        for k in range(allocs.shape[1]):
            want = ref_simulate_runtime(sky[j, :lens[j]], int(allocs[j, k]))
            assert int(got[j, k]) == want, (j, k)
            assert port_arepas.simulate_runtime(
                sky[j, :lens[j]], int(allocs[j, k])) == want


def test_plain_batch_equals_reference_pallas_kernel():
    # the reference kernel tiles time in 512-second blocks: Smax % 512 == 0
    sky, lens, allocs = _batch(5, J=12, smax=1024, K=4)
    ref = np.asarray(ref_arepas_runtimes(jnp.asarray(sky, jnp.float32),
                                         jnp.asarray(lens),
                                         jnp.asarray(allocs, jnp.float32),
                                         interpret=True))
    got = simulate_runtime_batch(*map(torch.from_numpy, (sky, lens, allocs)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_batch_large_areas_exact():
    # areas past 2^24, where the reference's f32 arithmetic stops being
    # exact; the port's int64 arithmetic must still equal the oracle
    sky = np.full((1, 3000), 9000, np.int32)
    sky[0, 1500:] = 7001
    lens = np.array([3000], np.int32)
    allocs = np.array([[7000, 4097, 1]], np.int32)
    got = simulate_runtime_batch(*map(torch.from_numpy, (sky, lens, allocs)))
    for k in range(3):
        assert int(got[0, k]) == ref_simulate_runtime(sky[0], int(allocs[0, k]))


def test_wrapper_on_cpu_uses_plain_version_and_counts_no_launch():
    sky, lens, allocs = _batch(7, J=40, smax=3000, K=8)
    ops.reset_launch_counts()
    args = list(map(torch.from_numpy, (sky, lens, allocs)))
    got = ops.arepas_runtimes(*args)
    assert torch.equal(got, simulate_runtime_batch(*args))
    assert ops.launch_counts() == {"arepas_runtimes": 0,
                                   "cluster_epoch_step": 0,
                                   "cluster_resize_step": 0,
                                   "flash_attention": 0, "ssd_scan": 0}


def test_invalid_allocation_yields_minus_one():
    sky = np.array([[5, 5, 1]], np.int32)
    out = simulate_runtime_batch(torch.from_numpy(sky),
                                 torch.tensor([3], dtype=torch.int32),
                                 torch.tensor([[0, 2]], dtype=torch.int32))
    assert out.tolist() == [[-1, ref_simulate_runtime(sky[0], 2)]]


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.api import Allocator, AllocatorConfig
    from repro_torch.core.pipeline import TasqConfig, TasqPipeline
    from repro_torch.serve import AllocationService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TasqConfig(n_train=8, n_eval=4)
    with pytest.raises(RuntimeError, match="CUDA card"):
        TasqPipeline(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA card"):
        TasqPipeline(cfg)                       # the default is the card
    with pytest.raises(RuntimeError, match="CUDA card"):
        Allocator.from_config(AllocatorConfig(pipeline=cfg))
    with pytest.raises(RuntimeError, match="CUDA card"):
        AllocationService(model=None)
