"""The bounded-slowdown allocation policy, vectorized in numpy.

The same arithmetic as the paper's scalar policy: the marginal-gain
cut-off ``round(|a| / (min_gain * price))`` and the smallest allocation
whose predicted runtime ``b * t**a`` stays within ``(1 + max_slowdown *
price)`` of the runtime at the hint, by a 48-step integer bisection.
``dtype`` is float64 for the reference and float32 for the control.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Policy", "choose_tokens", "bisection_levels", "tie_rows"]

_ITERS = 48


@dataclasses.dataclass(frozen=True)
class Policy:
    min_gain: float = 0.01
    max_slowdown: float = 0.05
    min_tokens: int = 1
    max_tokens: int = 6287


def _limit(a, b, hi, price, policy, dtype):
    return (dtype(1.0) + dtype(policy.max_slowdown) * price) * (
        b * hi.astype(dtype) ** a)


def choose_tokens(a, b, observed, policy: Policy, price=None,
                  dtype=np.float64) -> np.ndarray:
    """(B,) int64 tokens for (B,) PCC parameters, hints and prices."""
    a = np.asarray(a, dtype)
    b = np.asarray(b, dtype)
    hi = np.asarray(observed, np.int64)
    price = (np.ones_like(a) if price is None
             else np.asarray(price, dtype))
    eff_gain = dtype(max(policy.min_gain, 1e-9)) * price
    t_gain = np.minimum(np.maximum(np.rint(np.abs(a) / eff_gain),
                                   policy.min_tokens), hi.astype(dtype))
    t_gain = np.where(a >= 0, policy.min_tokens, t_gain.astype(np.int64))
    if policy.max_slowdown <= 0:
        return t_gain
    limit = _limit(a, b, hi, price, policy, dtype)
    lo = np.full(a.shape, policy.min_tokens, np.int64)
    hs = hi.copy()
    for _ in range(_ITERS):
        cond = lo < hs
        if not cond.any():
            break
        mid = (lo + hs) // 2
        ok = b * mid.astype(dtype) ** a <= limit
        lo = np.where(cond & ~ok, mid + 1, lo)
        hs = np.where(cond & ok, mid, hs)
    return np.maximum(np.minimum(t_gain, policy.max_tokens), lo)


def bisection_levels(a, b, observed, policy: Policy, price=None) -> np.ndarray:
    """(B,) int64: the bisection steps in which each row's interval is
    still open, the steps that evaluate a ``pow``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    hi = np.asarray(observed, np.int64)
    price = np.ones_like(a) if price is None else np.asarray(price, np.float64)
    levels = np.zeros(a.shape, np.int64)
    if policy.max_slowdown <= 0:
        return levels
    limit = _limit(a, b, hi, price, policy, np.float64)
    lo = np.full(a.shape, policy.min_tokens, np.int64)
    hs = hi.copy()
    for _ in range(_ITERS):
        cond = lo < hs
        if not cond.any():
            break
        levels += cond
        mid = (lo + hs) // 2
        ok = b * mid.astype(np.float64) ** a <= limit
        lo = np.where(cond & ~ok, mid + 1, lo)
        hs = np.where(cond & ok, mid, hs)
    return levels


def tie_rows(got, want, a, b, observed, policy: Policy, price=None,
             ulps: int = 4) -> np.ndarray:
    """(B,) bool: rows where ``got != want`` only because ``b * t**a`` lies
    within ``ulps`` units in the last place of the slowdown limit at one of
    the two decisions, so that the last bit of a ``pow`` decides it."""
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    hi = np.asarray(observed, np.int64)
    price = np.ones_like(a) if price is None else np.asarray(price, np.float64)
    out = np.zeros(got.shape, bool)
    for i in np.flatnonzero(got != want):
        limit = (1.0 + policy.max_slowdown * price[i]) * (
            b[i] * float(hi[i]) ** a[i])
        t1, t2 = sorted((int(got[i]), int(want[i])))
        out[i] = any(abs(b[i] * float(t) ** a[i] - limit)
                     <= ulps * np.spacing(limit) for t in (t1, t2 - 1))
    return out
