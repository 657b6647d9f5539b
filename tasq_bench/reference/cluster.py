"""The cluster control's device steps, worked out again on the host.

``epoch_step``: expire, release, admit and scatter over (K, L) lease
tables (kernel K2's contract). ``resize``: the priced shrink decision,
its AREPAS re-simulation and the repriced lease end (kernel K3's).
``refit``: the PCC cache's exact-history fit of a completed query (its
AREPAS runtimes at the standard grid, floored at the observed peak, and
the log-log least-squares fit).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tasq_bench.reference import arepas, policy as pol

__all__ = ["epoch_step", "resize", "refit", "PCC_FRACTIONS"]

PCC_FRACTIONS = (1.0, 0.8, 0.6, 0.4, 0.2)


def epoch_step(end_s, tokens, free, q_tok, q_end, now: float):
    """(K, L) float64 / int64 tables, (K,) free tokens, (K, Q) queue heads
    -> (new_end, new_tok, slot_of, n_admit, adm_tok, freed, n_expired), as
    host tensors. Position i of a shard's queue is admitted iff its token
    prefix sum fits the free pool after expiry, it asks for tokens, and i
    is below the open lease slots; the i-th admitted takes the i-th open
    slot."""
    end_s, tokens, free, q_tok, q_end = (
        torch.as_tensor(x).cpu() for x in (end_s, tokens, free, q_tok,
                                           q_end))
    K, L = end_s.shape
    Q = q_tok.shape[1]
    if Q == 0:
        q_tok, q_end = q_tok.new_zeros((K, 1)), q_end.new_zeros((K, 1))
    expired = (tokens > 0) & (end_s <= now)
    freed = torch.where(expired, tokens, 0).sum(1)
    n_expired = expired.sum(1)
    tok1 = torch.where(expired, 0, tokens)
    end1 = torch.where(expired, math.inf, end_s)
    free_after = free + freed
    open_slots = (tok1 == 0).sum(1)
    csum = torch.cumsum(q_tok, 1)
    qidx = torch.arange(q_tok.shape[1])
    adm = ((csum <= free_after[:, None]) & (q_tok > 0)
           & (qidx[None, :] < open_slots[:, None]))
    n_admit = adm.sum(1)
    adm_tok = torch.where(adm, q_tok, 0).sum(1)
    free_slot = tok1 == 0
    rank = torch.cumsum(free_slot.to(torch.int64), 1) - 1
    take = free_slot & (rank < n_admit[:, None])
    src = rank.clamp(0, max(Q - 1, 0))
    new_tok = torch.where(take, torch.gather(q_tok, 1, src), tok1)
    new_end = torch.where(take, torch.gather(q_end, 1, src), end1)
    slot_of = torch.full((K, Q), -1, dtype=torch.int32)
    for k in range(K):
        slots = torch.nonzero(take[k])[:, 0]
        slot_of[k, src[k, slots]] = slots.to(torch.int32)
    return (new_end, new_tok, slot_of, n_admit, adm_tok, freed, n_expired)


def resize(a, b, price, obs, floor, done, cand_tok, cand_end, skylines,
           now: float, epoch_s: float, policy: pol.Policy, cap: int,
           dtype=np.float64, runtime=arepas.runtime):
    """Per candidate: (tgt, sel, rt, new_end) of the priced shrink to
    ``min(policy tokens, cap)`` floored at the deadline floor, whether it
    shrinks a lease that runs on past this epoch, the AREPAS runtime at
    the target and the lease end repriced from the work still to do.
    ``runtime(skyline, tokens)`` is AREPAS, or a memo of it that takes
    whatever ``skylines`` holds for each candidate."""
    tgt = np.minimum(pol.choose_tokens(a, b, obs, policy, price, dtype), cap)
    tgt = np.maximum(tgt, np.asarray(floor, np.int64))
    sel = (tgt < np.asarray(cand_tok)) & ((np.asarray(cand_end) - now)
                                          > epoch_s)
    rt = np.array([max(runtime(s, max(int(t), 1)), 1)
                   for s, t in zip(skylines, tgt)], np.int64)
    remaining = np.maximum(np.rint(rt.astype(np.float64)
                                   * (1.0 - np.asarray(done))), 1.0)
    return tgt, sel, rt, now + remaining


def _fit(allocs, runtimes):
    A = np.log(np.asarray(allocs, np.float64))
    R = np.log(np.maximum(np.asarray(runtimes, np.float64), 1e-9))
    w = np.ones_like(A)
    wm = w / np.sum(w, axis=-1, keepdims=True)
    Am = np.sum(wm * A, -1, keepdims=True)
    Rm = np.sum(wm * R, -1, keepdims=True)
    var = np.sum(wm * (A - Am) ** 2, -1)
    cov = np.sum(wm * (A - Am) * (R - Rm), -1)
    a = np.where(var < 1e-12, 0.0, cov / np.maximum(var, 1e-300))
    b = np.where(var < 1e-12, np.exp(Rm[..., 0]),
                 np.exp(Rm[..., 0] - a * Am[..., 0]))
    return a, b


def refit(skylines, observed, peaks):
    """(a, b) of each completed query's exact-history PCC."""
    obs = np.asarray(observed, np.float64)
    fr = np.asarray(sorted(PCC_FRACTIONS, reverse=True), np.float64)
    allocs = np.maximum(1, np.round(fr[None, :] * obs[:, None])).astype(
        np.int64)
    rts = np.stack([arepas.runtimes(s, al) for s, al in zip(skylines,
                                                            allocs)])
    base = np.array([len(s) for s in skylines], np.int64)
    rts = np.where(allocs >= np.asarray(peaks, np.int64)[:, None],
                   base[:, None], rts)
    a, b = _fit(allocs, np.maximum(rts, 1))
    return np.minimum(a, -1e-4), b
