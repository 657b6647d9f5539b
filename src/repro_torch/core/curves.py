"""PCC construction from XGBoost point predictions (paper §4.4).

XGBoost predicts runtime at individual (features, tokens) points; a curve
must be assembled from a fan of predictions around the reference allocation
(+-40%):

  * XGBoost SS — smoothing-"spline": a ridge-regularized cubic polynomial in
    log-tokens through the predicted points (no scipy dependency; a
    smoothed cubic has the same role: a flexible, shape-unconstrained curve).
  * XGBoost PL — power-law least-squares fit through the predicted points
    (shape-constrained but sign-unconstrained: 'a' may come out positive,
    which is exactly the failure mode Tables 4-6 report for 27% of jobs).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from repro_torch.core.pcc import fit_pcc

__all__ = ["prediction_fan", "fit_ss_curve", "fit_pl_curve",
           "ss_non_increasing"]


def prediction_fan(reference_alloc: float, n: int = 9,
                   spread: float = 0.4) -> np.ndarray:
    """Token grid spanning +-spread around the reference allocation."""
    fr = np.linspace(1.0 - spread, 1.0 + spread, n)
    return np.maximum(1, np.round(fr * reference_alloc)).astype(np.int64)


def fit_ss_curve(allocs: np.ndarray, runtimes: np.ndarray, ridge: float = 1e-3
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """Smoothed cubic in log-token space through XGBoost point predictions."""
    x = np.log(np.asarray(allocs, np.float64))
    y = np.log(np.maximum(np.asarray(runtimes, np.float64), 1e-9))
    xm, xs = x.mean(), x.std() + 1e-9
    xn = (x - xm) / xs
    V = np.vander(xn, 4)                       # cubic
    coef = np.linalg.solve(V.T @ V + ridge * np.eye(4), V.T @ y)

    def curve(a: np.ndarray) -> np.ndarray:
        xn_ = (np.log(np.asarray(a, np.float64)) - xm) / xs
        return np.exp(np.vander(xn_, 4) @ coef)

    return curve


def fit_pl_curve(allocs: np.ndarray, runtimes: np.ndarray
                 ) -> Tuple[float, float]:
    """Power-law through XGBoost point predictions. Returns (a, b)."""
    return fit_pcc(allocs, runtimes)


def ss_non_increasing(curve: Callable, reference_alloc: float,
                      spread: float = 0.4, n_check: int = 33) -> bool:
    """Is the SS curve monotone non-increasing within +-spread of the ref?"""
    grid = prediction_fan(reference_alloc, n_check, spread).astype(np.float64)
    vals = curve(grid)
    return bool(np.all(np.diff(vals) <= 1e-9 * np.maximum(vals[:-1], 1e-9)))
