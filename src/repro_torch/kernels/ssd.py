"""Kernel K5 — the Mamba-2 SSD chunk scan, forward, on the card (CUDA C++,
``sm_90a``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py::ssd_chunk_scan``
(``_ssd_kernel``): the chunked dual form of the gated linear recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, with the (P, N)
float32 state carried from chunk to chunk on chip. The source is
``repro_torch/csrc/ssd.cu``: bf16 runs on the tensor cores (wgmma, TMA),
float32 on the CUDA cores; its header says what bounds the kernel and how
its tiles are laid out. Its plain PyTorch version is
``repro_torch.models.layers.ssd_chunked``.

``ssd_chunk_scan`` takes CUDA tensors only. It checks them, allocates the
output, launches on the current stream and raises if the launch was
refused; it never computes on the host. ``launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_chunk_scan", "launches", "HEAD_DIMS", "STATE_DIMS"]

launches = 0

HEAD_DIMS = (16, 32, 64)           # P the kernel is compiled for
STATE_DIMS = (16, 32, 64, 128)     # N the kernel is compiled for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = _build.load("ssd").ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *,
                   chunk: int = 128, final_state: bool = False):
    """x: (B, S, H, P); dt: (B, S, H) float32; A: (H,) float32; Bm/Cm:
    (B, S, N) in x's type -> y: (B, S, H, P) in x's type; with
    ``final_state`` (y, the (B, H, P, N) float32 state after the last
    chunk), which the kernel carries on chip and writes once.

    x float32 or bf16; all contiguous, on one card (a tensor that is not
    16-byte aligned is copied once into a fresh allocation); P in
    ``HEAD_DIMS``, N in ``STATE_DIMS``; chunks of min(chunk, S) rows,
    which must divide S (bf16 chunks over 256 rows, more than the
    tensor-core kernel's one TMA box, run its CUDA-core kernel in bf16).
    """
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on the card; got {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the SSD scan takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"x": (x, x.dtype, (B, S, H, P)),
            "dt": (dt, torch.float32, (B, S, H)),
            "A": (A, torch.float32, (H,)),
            "Bm": (Bm, x.dtype, (B, S, N)),
            "Cm": (Cm, x.dtype, (B, S, N))}
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, must be {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, must be {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    x, dt, A, Bm, Cm = (_build.aligned16(t) for t in (x, dt, A, Bm, Cm))
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not in {STATE_DIMS}")
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"sequence {S} is not a multiple of chunk {Q}")
    if B * S * H * P >= 2**62 or max(B * H, S) >= 2**31:
        raise ValueError("dimensions too large")
    y = torch.empty_like(x)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
         if final_state else None)
    if x.numel() == 0:
        return (y, h) if final_state else y
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                     Cm.data_ptr(), y.data_ptr(),
                     None if h is None else h.data_ptr(), B, S, H, P, N, Q,
                     _DTYPES[x.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_kernel launch failed: cudaError {err}")
    launches += 1
    return (y, h) if final_state else y
