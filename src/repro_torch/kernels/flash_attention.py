"""Kernel K4 — causal GQA flash attention forward on the card (CUDA C++,
``sm_90a``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_bhsd`` (``_flash_kernel``): online-softmax attention that
never writes the (S, S) scores to device memory and skips key tiles wholly
in the causal future. The source is ``repro_torch/csrc/flash_attention.cu``:
bf16 runs on the tensor cores (wgmma, TMA), float32 on the CUDA cores; its
header says what bounds the kernel and how its tiles are laid out. Its
plain PyTorch version is ``repro_torch.kernels.ref.attention_ref_bhsd``.

``flash_attention_bshd`` takes CUDA tensors only, in the model's
(B, S, H, D) layout (the kernel reads the strides; no transposes). It
checks them, allocates the output, launches on the current stream and
raises if the launch was refused; it never computes on the host.
``launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_bshd", "launches", "HEAD_DIMS"]

launches = 0

HEAD_DIMS = (16, 32, 64, 80, 128)  # head dims the kernel is compiled for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's type.

    float32 or bf16, all three of one type, contiguous, on one card (a
    tensor that is not 16-byte aligned is copied once into a fresh
    allocation); Hq % Hkv == 0 and D in ``HEAD_DIMS``; any S >= 1.
    """
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bshd runs on the card; got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape != v.shape or k.shape != (B, S, Hkv, D):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if max(B, S, Hq) >= 2**31:
        raise ValueError("dimensions must fit in int32")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out)
        for s in (t.stride(0), t.stride(1), t.stride(2))])
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     strides, B, Hq, Hkv, S, D, int(causal),
                     _DTYPES[q.dtype], 1.0 / math.sqrt(D),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
