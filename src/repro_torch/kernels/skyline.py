"""Kernel K1 — bulk AREPAS runtimes on the card (CUDA C++, ``sm_90a``).

Replaces the Pallas TPU kernel ``repro/kernels/skyline.py::skyline_runtimes``
(``_skyline_kernel``): every job x every allocation grid point needs an
Algorithm-1 runtime, a segmented reduction over the job's skyline. The
source is ``repro_torch/csrc/skyline.cu``; its header says what bounds the
kernel (the bytes of each skyline's valid prefix) and how the design splits
long jobs into segments of ``segment()`` seconds, one warp each. Its plain
PyTorch version is ``repro_torch.core.arepas.simulate_runtime_batch``.

Two layouts, one kernel: ``skyline_runtimes`` takes a padded (U, Smax)
pool (with an optional row index), ``skyline_runtimes_ragged`` the valid
seconds only, as flat values and (J + 1) offsets. Both take CUDA tensors
only, check them, allocate the output and the scratch of the long jobs'
segment summaries, launch once on the current stream and raise if the
launch was refused; they never compute on the host. ``launches`` counts
the launches of both.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["skyline_runtimes", "skyline_runtimes_ragged", "max_segments",
           "segment", "launches"]

launches = 0

_RUN_BYTES = 24                 # sizeof(arepas::Run)

_kernel = None                  # (launch function, segment length)
# per (device, stream): the (J,) int32 arrival counters of the long jobs'
# segments; each launch leaves them 0 for the next one on its stream
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}


def _launcher():
    global _kernel
    if _kernel is None:
        _kernel = _bind(_build.load("skyline"))
    return _kernel


def _bind(lib: ctypes.CDLL):
    """(launch function, segment length) of ``lib``: ``csrc/skyline.cu``
    as built, perhaps with another ``K1_SEGMENT``."""
    fn = lib.arepas_runtimes_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, int(lib.arepas_segment())


def segment() -> int:
    """The seconds of a job that one warp folds in K1's built library
    (``K1_SEGMENT`` in ``csrc/skyline.cu``, 4,096 by default)."""
    return _launcher()[1]


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device,
           dtype: torch.dtype = torch.int32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, skylines on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def max_segments(J: int, seconds: int, per_job: bool, seg: int) -> int:
    """An upper bound on the work items of J jobs cut into ``seg``-second
    segments (at least one a job): ``seconds`` is the valid seconds of all
    jobs together (ragged) or the longest a job can be (pool,
    ``per_job``)."""
    if per_job:
        return J * max(1, -(-seconds // seg))
    return J + seconds // seg


def _launch(values, offsets, lens, rows, allocs, smax, seconds, per_job):
    global launches
    dev = values.device
    J, K = allocs.shape
    fn, seg = _launcher()
    max_items = max_segments(J, seconds, per_job, seg)
    if max(J, K, smax, max_items) >= 2**31:
        raise ValueError("dimensions too large for kernel K1")
    out = torch.empty((J, K), dtype=torch.int32, device=dev)
    # summaries of every segment, where some job may have more than one
    n_runs = max_items * K if max_items > J else 0
    scratch = torch.empty(n_runs * _RUN_BYTES, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    arrivals = _arrivals.get(key)
    if arrivals is None or arrivals.numel() < J:
        arrivals = _arrivals[key] = torch.zeros(
            max(J, 1024), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = fn(ptr(values), ptr(offsets), ptr(lens), ptr(rows),
                 allocs.data_ptr(), out.data_ptr(), ptr(scratch),
                 arrivals.data_ptr(), J, smax, K, max_items,
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"arepas_runtimes_kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def skyline_runtimes(skylines: torch.Tensor, valid_lens: torch.Tensor,
                     allocs: torch.Tensor,
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(J, Smax) int32 x (J,) int32 x (J, K) int32 -> (J, K) int32 runtimes.

    Lengths are clamped to [0, Smax]; an allocation below 1 yields -1.
    With ``rows`` ((J,) int64), ``skylines``/``valid_lens`` are a (U, Smax)
    / (U,) pool and output row j reads pool row ``rows[j]`` (the
    caller keeps every index inside the pool: the launch does not check).
    """
    dev = skylines.device
    if dev.type != "cuda":
        raise ValueError(f"skyline_runtimes runs on the card; got {dev}")
    _check("skylines", skylines, 2, dev)
    _check("valid_lens", valid_lens, 1, dev)
    _check("allocs", allocs, 2, dev)
    U, smax = skylines.shape
    J, K = allocs.shape
    if rows is not None:
        _check("rows", rows, 1, dev, torch.int64)
    if valid_lens.shape[0] != U or (rows if rows is not None
                                    else skylines).shape[0] != J:
        raise ValueError(f"shapes disagree: skylines {tuple(skylines.shape)}, "
                         f"valid_lens {tuple(valid_lens.shape)}, "
                         f"allocs {tuple(allocs.shape)}")
    return _launch(skylines, None, valid_lens, rows, allocs, smax, smax,
                   per_job=True)


def skyline_runtimes_ragged(values: torch.Tensor, offsets: torch.Tensor,
                            allocs: torch.Tensor) -> torch.Tensor:
    """Flat int32 ``values`` x (J + 1,) int64 ``offsets`` x (J, K) int32
    allocations -> (J, K) int32 runtimes; job j's skyline is
    ``values[offsets[j]:offsets[j + 1]]``.

    ``offsets`` must be non-decreasing within [0, len(values)] (the launch
    does not check: that would read them back to the host); an allocation
    below 1 yields -1.
    """
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"skyline_runtimes_ragged runs on the card; got {dev}")
    _check("values", values, 1, dev)
    _check("offsets", offsets, 1, dev, torch.int64)
    _check("allocs", allocs, 2, dev)
    J = allocs.shape[0]
    if offsets.shape[0] != J + 1:
        raise ValueError(f"offsets must have J + 1 = {J + 1} entries, got "
                         f"{offsets.shape[0]}")
    return _launch(values, offsets, None, None, allocs, 0, values.numel(),
                   per_job=False)
