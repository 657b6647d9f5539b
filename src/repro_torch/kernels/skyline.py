"""Kernel K1 — bulk AREPAS runtimes on the card (CUDA C++, ``sm_90a``).

Replaces the Pallas TPU kernel ``repro/kernels/skyline.py::skyline_runtimes``
(``_skyline_kernel``): every job x every allocation grid point needs an
Algorithm-1 runtime, a segmented reduction over the job's skyline. The
source is ``repro_torch/csrc/skyline.cu``; its header says what bounds the
kernel (the bytes of each skyline's valid prefix) and how the design reads
that prefix once for all allocations. Its plain PyTorch version is
``repro_torch.core.arepas.simulate_runtime_batch``.

``skyline_runtimes`` takes CUDA tensors only. It checks them, allocates the
output, launches on the current stream and raises if the launch was
refused; it never computes on the host. ``launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["skyline_runtimes", "launches"]

launches = 0


def _launcher():
    fn = _build.load("skyline").arepas_runtimes_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, skylines on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def skyline_runtimes(skylines: torch.Tensor, valid_lens: torch.Tensor,
                     allocs: torch.Tensor) -> torch.Tensor:
    """(J, Smax) int32 x (J,) int32 x (J, K) int32 -> (J, K) int32 runtimes.

    Lengths are clamped to [0, Smax]; an allocation below 1 yields -1.
    """
    global launches
    dev = skylines.device
    if dev.type != "cuda":
        raise ValueError(f"skyline_runtimes runs on the card; got {dev}")
    _check("skylines", skylines, 2, dev)
    _check("valid_lens", valid_lens, 1, dev)
    _check("allocs", allocs, 2, dev)
    J, smax = skylines.shape
    K = allocs.shape[1]
    if valid_lens.shape[0] != J or allocs.shape[0] != J:
        raise ValueError(f"shapes disagree: skylines {tuple(skylines.shape)}, "
                         f"valid_lens {tuple(valid_lens.shape)}, "
                         f"allocs {tuple(allocs.shape)}")
    if max(J, smax, K) >= 2**31:
        raise ValueError("dimensions must fit in int32")
    out = torch.empty((J, K), dtype=torch.int32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(skylines.data_ptr(), valid_lens.data_ptr(),
                     allocs.data_ptr(), out.data_ptr(), J, smax, K,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"arepas_runtimes_kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
