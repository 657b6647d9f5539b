"""The comparisons that decide ``correct``, shared by the window kinds.

Each returns one number that a cell holds against its limit:

* ``ab_gap``: the widest relative gap between decoded PCC parameters
  (a, b) and the reference's, over the rows compared;
* ``policy_misses``: decisions that differ from the float64 policy applied
  to the same (a, b), hint and price, other than where the last bit of a
  ``pow`` decides (``reference.policy.tie_rows``);
* ``band_misses``: decisions outside every decision the reference's
  policy makes for an (a, b) within a relative ``delta`` of its own.
"""
from __future__ import annotations

import itertools

import numpy as np

from tasq_bench.reference import policy as pol

__all__ = ["policy_of", "ab_gap", "policy_misses", "token_band",
           "band_misses"]


def policy_of(config) -> pol.Policy:
    p = config["policy"]
    return pol.Policy(min_gain=p["min_gain"], max_slowdown=p["max_slowdown"],
                      min_tokens=p["min_tokens"], max_tokens=p["max_tokens"])


def ab_gap(a_p, b_p, a_r, b_r) -> float:
    a_p, b_p, a_r, b_r = (np.asarray(x, np.float64)
                          for x in (a_p, b_p, a_r, b_r))
    if a_p.size == 0:
        return 0.0
    ga = np.abs(a_p - a_r) / np.maximum(np.abs(a_r), 1e-300)
    gb = np.abs(b_p - b_r) / np.maximum(np.abs(b_r), 1e-300)
    return float(max(ga.max(), gb.max()))


def policy_misses(tokens, a, b, obs, policy: pol.Policy, price=None,
                  cap=None, floor=None) -> int:
    """Rows whose ``tokens`` differ from the float64 policy on their own
    (a, b), hint and price (then ``min(cap)``, ``max(floor)``), ties
    excepted."""
    tokens = np.asarray(tokens, np.int64)
    if tokens.size == 0:
        return 0
    want = pol.choose_tokens(a, b, obs, policy, price)
    if cap is not None:
        want = np.minimum(want, cap)
    if floor is not None:
        want = np.maximum(want, np.asarray(floor, np.int64))
    ties = pol.tie_rows(tokens, want, a, b, obs, policy, price)
    return int(np.sum((tokens != want) & ~ties))


def token_band(a, b, obs, policy: pol.Policy, delta: float, price=None):
    """(lowest, highest) decision over (a, b) each moved by a relative
    ``-delta``, 0 or ``+delta``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    outs = [pol.choose_tokens(a * (1 + da), b * (1 + db), obs, policy, price)
            for da, db in itertools.product((-delta, 0.0, delta), repeat=2)]
    return np.min(outs, axis=0), np.max(outs, axis=0)


def band_misses(tokens, lo, hi) -> int:
    tokens = np.asarray(tokens, np.int64)
    return int(np.sum((tokens < lo) | (tokens > hi)))
