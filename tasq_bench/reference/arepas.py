"""AREPAS (paper Algorithm 1) runtimes in numpy integer arithmetic.

Sections of the skyline over the allocation ``nt`` are flattened to ``nt``
and stretched to ``area // nt`` seconds; sections at or under it are
copied. The runtime is the length of the result.
"""
from __future__ import annotations

import numpy as np

__all__ = ["runtime", "runtimes"]


def runtime(skyline: np.ndarray, nt: int) -> int:
    """Simulated runtime of one (S,) integer skyline at allocation ``nt``
    (>= 1)."""
    s = np.asarray(skyline, np.int64)
    nt = int(nt)
    if nt < 1:
        raise ValueError(f"allocation {nt} < 1")
    over = s > nt
    if not over.any():
        return int(s.size)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(over)) + 1])
    sums = np.add.reduceat(s, starts)
    return int((~over).sum() + (sums[over[starts]] // nt).sum())


def runtimes(skyline: np.ndarray, allocs) -> np.ndarray:
    """(K,) int64 runtimes of one skyline at each allocation."""
    return np.array([runtime(skyline, a) for a in np.asarray(allocs)],
                    np.int64)
