"""Padded/bucketed batching.

``batch_bucket`` rounds a batch up to a power of two (min 8), so the
service runs a small, fixed set of shapes across nearby batch sizes
(padded rows are inert and sliced off). ``pad_to`` zero-pads one axis.
The reference's ``MicroBatcher`` request queue is not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["batch_bucket", "pad_to"]


def _next_pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def batch_bucket(n: int, floor: int = 8, cap: int = 4096) -> int:
    """Padded batch size for ``n`` queries: next power of two >= floor."""
    return min(_next_pow2(max(n, 1), floor), max(cap, floor))


def pad_to(x: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``x`` along ``axis`` up to ``size`` (no-op if already there)."""
    if x.shape[axis] == size:
        return x
    if x.shape[axis] > size:
        raise ValueError(f"cannot pad axis {axis} of {x.shape} down to {size}")
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - x.shape[axis])
    return np.pad(x, widths)
