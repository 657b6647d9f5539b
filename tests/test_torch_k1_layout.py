"""Kernel K1's ragged layout on the CPU: the plain version on flat values
and offsets against the padded plain version and the reference's Pallas
kernel (interpret mode), the chunking of the ragged plain route, the work
items the kernel's wrapper provides for, the dataset's ragged input, and
the alignment copy of the K4 / K5 wrappers."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import arepas_runtimes as ref_arepas_runtimes
from repro_torch.core import dataset as port_dataset
from repro_torch.core.arepas import (ragged_chunks, simulate_runtime,
                                     simulate_runtime_batch,
                                     simulate_runtime_ragged)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import skyline as k1

TIME_BLOCK = 512              # the reference kernel's default time tile
# the segment length csrc/skyline.cu builds with by default
K1_SEGMENT = int(re.search(r"#define K1_SEGMENT (\d+)",
                           (_build.CSRC / "skyline.cu").read_text())[1])


def _ragged_batch(seed, K):
    """Seeded skylines: one job longer than three of K1's segments, empty
    jobs, a one-second job, seconds equal to the cap, an allocation below
    1; allocations from the peak down, as the dataset's grid."""
    rng = np.random.RandomState(seed)
    lens = list(rng.randint(1, 900, size=9))
    lens[2] = 3 * K1_SEGMENT + 123           # four segments on the card
    lens[4] = lens[7] = 0                    # empty jobs
    lens[5] = 1
    skylines, allocs = [], np.zeros((len(lens), K), np.int32)
    for j, n in enumerate(lens):
        blk = rng.choice([1, 7, 64])
        row = np.repeat(rng.randint(0, 150, size=n // blk + 1), blk)[:n]
        skylines.append(row.astype(np.int32))
        peak = max(1, int(row.max(initial=0)))
        allocs[j] = np.maximum(
            1, np.round(np.linspace(1.1, 0.1, K) * peak)).astype(np.int32)
        if n:
            allocs[j, -1] = max(1, int(row[0]))  # seconds equal to the cap
    allocs[3, 0] = 0                             # no runtime: -1
    return skylines, allocs


def _padded(skylines):
    smax = -(-max(len(s) for s in skylines) // TIME_BLOCK) * TIME_BLOCK
    sky = np.zeros((len(skylines), smax), np.int32)
    for j, s in enumerate(skylines):
        sky[j, :len(s)] = s
    return sky, np.array([len(s) for s in skylines], np.int32)


@pytest.mark.parametrize("K", [1, 8, 13])
def test_ragged_plain_equals_padded_plain_and_reference(K):
    skylines, allocs = _ragged_batch(K, K)
    values, offsets = port_dataset.ragged_skylines(skylines)
    ragged = simulate_runtime_ragged(torch.from_numpy(values),
                                     torch.from_numpy(offsets),
                                     torch.from_numpy(allocs))
    sky, lens = _padded(skylines)
    padded = simulate_runtime_batch(*map(torch.from_numpy,
                                         (sky, lens, allocs)))
    assert ragged.dtype == torch.int32 and ragged.shape == allocs.shape
    assert torch.equal(ragged, padded)
    ref = np.asarray(ref_arepas_runtimes(
        jnp.asarray(sky, jnp.float32), jnp.asarray(lens),
        jnp.asarray(allocs, jnp.float32), time_block=TIME_BLOCK,
        interpret=True))
    valid = allocs >= 1        # the reference has no runtime below 1 token
    np.testing.assert_array_equal(ragged.numpy()[valid], ref[valid])
    assert (ragged.numpy()[~valid] == -1).all() and (~valid).any()
    for j in (2, 4, 5):
        for k in range(K):
            if allocs[j, k] >= 1 and len(skylines[j]):
                assert int(ragged[j, k]) == simulate_runtime(
                    skylines[j], int(allocs[j, k]))
    assert (ragged.numpy()[[4, 7]][valid[[4, 7]]] == 0).all()  # empty jobs


def test_ragged_cpu_route_counts_no_launch():
    skylines, allocs = _ragged_batch(3, 8)
    values, offsets = port_dataset.ragged_skylines(skylines)
    args = (torch.from_numpy(values), torch.from_numpy(offsets),
            torch.from_numpy(allocs))
    ops.reset_launch_counts()
    got = ops.arepas_runtimes_ragged(*args)
    assert torch.equal(got, simulate_runtime_ragged(*args))
    assert set(ops.launch_counts().values()) == {0}


def test_ragged_plain_chunks_agree_with_one_chunk():
    """A budget small enough that the long job stands alone and the short
    ones share chunks gives the same runtimes as one chunk."""
    skylines, allocs = _ragged_batch(5, 4)
    values, offsets = port_dataset.ragged_skylines(skylines)
    lens = [len(s) for s in skylines]
    small = 4 * 2 * 900
    chunks = ragged_chunks(lens, 4, small)
    assert len(chunks) > 3 and (2, 3) in chunks
    assert [a for a, _ in chunks] == [0] + [b for _, b in chunks[:-1]]
    assert chunks[-1][1] == len(lens)
    args = (torch.from_numpy(values), torch.from_numpy(offsets),
            torch.from_numpy(allocs))
    assert torch.equal(simulate_runtime_ragged(*args, max_elems=small),
                       simulate_runtime_ragged(*args, max_elems=1 << 40))


@pytest.mark.parametrize("segment", [32, 1024, 2048, K1_SEGMENT])
def test_max_segments_bounds_the_kernels_work_items(segment):
    """The wrapper sizes K1's scratch by ``max_segments``: at least the
    segments the kernel cuts (ceil(len / segment), at least one a job),
    in both layouts."""
    rng = np.random.RandomState(segment)
    lens = np.concatenate([[0, 1, segment, segment + 1, 5 * segment],
                           rng.randint(0, 3 * segment, 40)])
    items = sum(max(1, -(-int(n) // segment)) for n in lens)
    bound = k1.max_segments(len(lens), int(lens.sum()), False, segment)
    assert items <= bound <= len(lens) + lens.sum() // segment
    assert items <= k1.max_segments(len(lens), int(lens.max()), True, segment)


def test_build_dataset_takes_the_ragged_layout(monkeypatch):
    """No (J, Smax) padding on the dataset's path: the skylines go to K1's
    wrapper as flat values and offsets, which give every skyline back."""
    from repro_torch.workloads import build_corpus

    def refuse(*_):
        raise AssertionError("build_dataset padded its skylines")

    seen = {}
    ragged = ops.arepas_runtimes_ragged

    def spy(values, offsets, allocs):
        seen["args"] = (values, offsets, allocs)
        return ragged(values, offsets, allocs)

    monkeypatch.setattr(port_dataset, "pad_skylines", refuse)
    monkeypatch.setattr(port_dataset.kernel_ops, "arepas_runtimes_ragged", spy)
    timings = {}
    ds = port_dataset.build_dataset(build_corpus(12, seed=2), device="cpu",
                                    timings=timings)
    values, offsets, allocs = seen["args"]
    assert values.dtype == torch.int32 and offsets.dtype == torch.int64
    assert values.numel() == sum(len(r.skyline) for r in ds.records)
    for j, r in enumerate(ds.records):
        np.testing.assert_array_equal(
            values[offsets[j]:offsets[j + 1]].numpy(), r.skyline)
    assert allocs.shape == (12, len(port_dataset.AREPAS_FRACTIONS))
    assert {"skylines_s", "pack_s", "arepas_s", "assemble_s"} <= set(timings)


def test_aligned16_copies_only_misaligned_tensors():
    """K4's and K5's wrappers take a contiguous view at an offset that is
    not 16-byte aligned: it is copied once into a fresh allocation."""
    base = torch.arange(65, dtype=torch.float32)
    view = base[1:]                              # 4 bytes off the block
    assert view.is_contiguous() and view.data_ptr() % 16
    fixed = _build.aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and fixed.is_contiguous()
    assert torch.equal(fixed, view) and fixed.data_ptr() != view.data_ptr()
    assert _build.aligned16(base) is base
