"""Padded/bucketed batching.

``batch_bucket`` rounds a batch up to a power of two (min 8), so the
service runs a small, fixed set of shapes across nearby batch sizes
(padded rows are inert and sliced off). ``node_bucket`` does the same for
a dimension that cannot be chunked (a lease table). ``pad_to`` zero-pads
one axis. The reference's ``MicroBatcher`` request queue belongs to the
serving-plane slice, and its ``shard_positions`` has no caller here: the
sharded fabric decides a flat batch (``serve/service.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["batch_bucket", "node_bucket", "pad_to"]


def _next_pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def batch_bucket(n: int, floor: int = 8, cap: int = 4096) -> int:
    """Padded batch size for ``n`` queries: next power of two >= floor."""
    return min(_next_pow2(max(n, 1), floor), max(cap, floor))


def node_bucket(n: int, floor: int = 8) -> int:
    """Padded size of a dimension that cannot be chunked (a lease table):
    the next power of two >= floor."""
    return _next_pow2(max(n, 1), floor)


def pad_to(x: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``x`` along ``axis`` up to ``size`` (no-op if already there)."""
    if x.shape[axis] == size:
        return x
    if x.shape[axis] > size:
        raise ValueError(f"cannot pad axis {axis} of {x.shape} down to {size}")
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - x.shape[axis])
    return np.pad(x, widths)
