"""Dependency-free vectorized splitmix64 (shared by the consistent-hash
router and the flight recorder's deterministic sampler).

Lives under ``repro_torch.obs`` — the one package with no intra-repo imports —
so both the serving plane (service -> obs) and the cluster plane
(router -> obs) can hash without an import cycle.
"""
from __future__ import annotations

import numpy as np

__all__ = ["splitmix64"]

_U64 = np.uint64


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 -> well-mixed uint64."""
    x = np.asarray(x).astype(_U64)
    x = (x + _U64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))
