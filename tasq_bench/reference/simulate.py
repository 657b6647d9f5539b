"""A whole pass of the cluster control, worked out again on the host.

The same semantics as the port's ``Allocator.run_cluster`` for an EDF,
elastic, priced fabric of K shards, written plainly in numpy: epochs of
``EPOCH_S`` seconds (or a jump over an idle gap to the next arrival or
lease end); lease expiry and the completions it records; each completed
template's exact-history PCC refitted into the cache; per-shard,
per-SLA-class prices from leased and queued demand; arrivals rejected
past ``MAX_QUEUE`` queued queries; consistent-hash routing with a second
choice for a saturated home shard; the bounded-slowdown decision from the
cache's PCC or the model's, re-priced and floored at the deadline; the
elastic shrink of running leases where a shard's queue outgrows its free
tokens; the re-pricing of queued decisions whose price moved; EDF
admission of each shard's longest fitting queue prefix into its open
lease slots; and the elastic grow of leases that would miss their
deadline on a shard with idle tokens.

The settings the configuration file does not state are the reference's
own (the constants below), not read from the program. The one input
taken from the program is the model's decoded (a, b) for the queries the
cache does not hold: ``model_ab`` hands them over, and the caller judges
them against the reference's own forward pass of its own features.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from tasq_bench.reference import arepas, cluster, policy as pol

__all__ = ["Diverged", "Pass", "simulate", "COMPLETION_FIELDS"]

EPOCH_S = 15.0            # decision-batching window, simulated seconds
MAX_QUEUE = 100_000       # queued queries past which arrivals are rejected
MAX_LEASES = 8192         # lease slots a shard
PRICE_GAMMA = 16.0        # price slope over a class's demand share
PRICE_CAP = 16.0          # ceiling of a class's price
SPILL_THRESHOLD = 1.0     # home load at which the second choice is offered
N_VNODES = 64             # ring points a shard
ROUTER_SEED = 0
REPRICE_MOVE = 0.25       # relative price move that re-decides a queued query

# one row a completion, in this order, as the port's metrics record it
COMPLETION_FIELDS = ("arrival_s", "start_s", "finish_s", "tokens",
                     "default_tokens", "runtime_s", "ideal_runtime_s", "sla",
                     "tenant", "cache_hit", "repeat", "alloc_error",
                     "cost_token_s", "price", "slack_s", "shard", "spilled")


class Diverged(Exception):
    """The program's model-path calls no longer line up with the pass."""


@dataclasses.dataclass
class Pass:
    completions: np.ndarray        # (n, len(COMPLETION_FIELDS)) float64
    n_epochs: int
    n_rejected: int


# ---------------------------------------------------------------- routing --
_U64 = np.uint64


def _splitmix64(x) -> np.ndarray:
    x = np.asarray(x).astype(_U64)
    x = x + _U64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


class _Ring:
    """Consistent hashing over shards 0..K-1: a template's home is the
    owner of the first ring point at or after its hash; its second choice
    is the owner of the point after a salted hash, or, where that is the
    home, of the next point clockwise owned by another shard."""

    def __init__(self, K: int):
        sv = ((np.arange(K, dtype=_U64)[:, None] << _U64(20))
              + np.arange(N_VNODES, dtype=_U64)[None, :])
        pos = _splitmix64(sv ^ _splitmix64(np.full_like(sv, ROUTER_SEED)))
        pos = pos.reshape(-1)
        owner = np.repeat(np.arange(K), N_VNODES)
        order = np.argsort(pos, kind="stable")
        self.pos, self.owner = pos[order], owner[order]
        n = self.owner.size
        self.next_other = self.owner.copy()
        for i in range(n):
            for j in range(1, n):
                o = self.owner[(i + j) % n]
                if o != self.owner[i]:
                    self.next_other[i] = o
                    break
        self.K = K

    def _slot(self, h):
        i = np.searchsorted(self.pos, h, side="left")
        return np.where(i == self.pos.size, 0, i)

    def home(self, keys) -> np.ndarray:
        return self.owner[self._slot(_splitmix64(np.asarray(keys, np.int64)
                                                 .astype(_U64)))]

    def route(self, keys, load):
        """(shard, spilled) of each key under (K,) loads."""
        home = self.home(keys)
        if self.K == 1:
            return home, np.zeros(home.size, bool)
        slot = self._slot(_splitmix64(np.asarray(keys, np.int64).astype(_U64)
                                      ^ _U64(0xD6E8FEB86659FD93)))
        alt = self.owner[slot]
        alt = np.where(alt == home, self.next_other[slot], alt)
        spill = (load[home] >= SPILL_THRESHOLD) & (load[alt] < load[home])
        return np.where(spill, alt, home), spill


def _deadline_floor(a, b, slack, cap):
    """Smallest allocation whose power-law runtime fits ``slack`` (1 where
    the deadline has passed), at most ``cap``."""
    a = np.minimum(np.asarray(a, np.float64), -1e-4)
    b = np.maximum(np.asarray(b, np.float64), 1e-9)
    slack = np.asarray(slack, np.float64)
    missed = ~(slack > 0)
    slack = np.maximum(slack, 1e-9)
    with np.errstate(over="ignore"):
        floor = np.ceil((slack / b) ** (1.0 / a))
    floor = np.where(np.isfinite(floor), floor, np.inf)
    floor = np.where(missed, 1.0, floor)
    return np.minimum(np.maximum(floor, 1), cap).astype(np.int64)


# ------------------------------------------------------------------ pass --
def simulate(cols: Dict[str, np.ndarray], repeat: np.ndarray,
             skylines: Sequence[np.ndarray], defaults: np.ndarray,
             n_classes: int, cfg: Dict, policy: pol.Policy,
             model_ab: Callable[[np.ndarray], tuple]) -> Pass:
    """One pass over a trace's columns (``arrival_s``, ``job_index``,
    ``tenant``, ``sla``, ``deadline_s``) with the configuration's
    ``cluster`` settings. ``model_ab(job_rows)`` gives (a, b) for the
    queries of one epoch that miss the cache, in their order."""
    if cfg["admission"] != "edf":
        raise ValueError(f"admission {cfg['admission']!r}: only edf here")
    K = int(cfg["n_shards"])
    cap = int(cfg["capacity"]) // K
    elastic = bool(cfg.get("elastic", False))
    priced = cfg.get("pricing", "fixed") == "elastic"
    arrival, jb_all = cols["arrival_s"], cols["job_index"]
    sla_all, tenant_all = cols["sla"], cols["tenant"]
    deadline_all = cols["deadline_s"]
    n, C = arrival.size, n_classes
    lens = np.array([len(s) for s in skylines], np.int64)
    peaks = np.array([int(np.max(s)) for s in skylines], np.int64)
    ring = _Ring(K)
    memo: Dict[tuple, int] = {}

    def runtime(u, t: int) -> int:
        key = (int(u), int(t))
        if key not in memo:
            memo[key] = arepas.runtime(skylines[key[0]], key[1])
        return memo[key]

    def runtimes(jb, tokens):
        return np.array([max(runtime(u, max(int(t), 1)), 1)
                         for u, t in zip(jb, tokens)], np.int64)

    def resize(q, price, floor, done, now):
        """K3's shrink decision for queries ``q``, their skylines read by
        job index."""
        jb = jb_all[q]
        return cluster.resize(a_q[q], b_q[q], price, defaults[jb], floor,
                              done, tok_q[q], end_q[q], jb, now, EPOCH_S,
                              policy, cap, runtime=runtime)

    a_ex, b_ex = cluster.refit(skylines, defaults, peaks)
    oracle = np.minimum(pol.choose_tokens(a_ex, b_ex, defaults, policy), cap)
    cache: Dict[int, tuple] = {}

    tok_q, perf_q, rt_q = (np.zeros(n, np.int64) for _ in range(3))
    a_q, b_q = np.zeros(n), np.zeros(n)
    price_q = np.ones(n)
    err_q, start_q, end_q, cost_q, mark_q, done_q = (np.zeros(n)
                                                     for _ in range(6))
    hit_q, spill_q = np.zeros(n, bool), np.zeros(n, bool)
    shard_q = np.zeros(n, np.int64)
    lease_end = np.full((K, MAX_LEASES), np.inf)
    lease_tok = np.zeros((K, MAX_LEASES), np.int64)
    lease_q = np.full((K, MAX_LEASES), -1, np.int64)
    in_use = np.zeros(K, np.int64)
    queues: List[np.ndarray] = [np.zeros(0, np.int64) for _ in range(K)]
    rows: List[np.ndarray] = []
    next_ev, now, n_epochs, n_rejected = 0, 0.0, 0, 0

    def active(k):
        m = lease_tok[k] > 0
        return lease_q[k, m], lease_tok[k, m], lease_end[k, m]

    def work_done(q, now):
        return np.clip(done_q[q] + (now - mark_q[q]) / np.maximum(rt_q[q], 1),
                       0.0, 0.999)

    def set_leases(sh, q, tok, end):
        """New tokens and end of live leases ``q`` on shards ``sh``."""
        for k, i, t, e in zip(sh, q, tok, end):
            slot = int(np.flatnonzero(lease_q[k] == i)[0])
            in_use[k] += int(t) - int(lease_tok[k, slot])
            lease_tok[k, slot], lease_end[k, slot] = t, e

    def apply_resize(sh, q, new_tok, now, rt_new=None, new_end=None):
        if rt_new is None:
            rt_new = runtimes(jb_all[q], new_tok)
        done = work_done(q, now)
        if new_end is None:
            new_end = now + np.maximum(np.round(rt_new * (1.0 - done)), 1.0)
        cost_q[q] += tok_q[q] * (now - mark_q[q])
        done_q[q], mark_q[q] = done, now
        tok_q[q], rt_q[q], end_q[q] = new_tok, rt_new, new_end
        set_leases(sh, q, new_tok, new_end)

    while (any(q.size for q in queues) or np.any(lease_tok > 0)
           or next_ev < n):
        targets = [arrival[next_ev]] if next_ev < n else []
        if np.any(lease_tok > 0):
            targets.append(float(np.min(lease_end)))
        now = max(now + EPOCH_S, min(targets) if targets else now)
        n_epochs += 1

        # 1. expiry, completions, cache refits
        sh, slot = np.nonzero((lease_tok > 0) & (lease_end <= now))
        if sh.size:
            done_ids = lease_q[sh, slot]
            in_use -= np.bincount(sh, weights=lease_tok[sh, slot],
                                  minlength=K).astype(np.int64)
            lease_end[sh, slot], lease_tok[sh, slot] = np.inf, 0
            lease_q[sh, slot] = -1
            jb = jb_all[done_ids]
            fin = end_q[done_ids]
            start = start_q[done_ids]
            rows.append(np.stack([
                arrival[done_ids], start, fin, tok_q[done_ids], defaults[jb],
                np.round(fin - start).astype(np.int64), lens[jb],
                sla_all[done_ids], tenant_all[done_ids], hit_q[done_ids],
                repeat[done_ids], err_q[done_ids],
                cost_q[done_ids] + tok_q[done_ids] * (fin - mark_q[done_ids]),
                price_q[done_ids], deadline_all[done_ids] - fin, sh,
                spill_q[done_ids]], axis=1).astype(np.float64))
            fresh = np.unique(jb[[int(u) not in cache for u in jb]])
            if fresh.size:
                a_f, b_f = cluster.refit([skylines[u] for u in fresh],
                                         defaults[fresh], peaks[fresh])
                cache.update(zip(fresh.tolist(), zip(a_f, b_f)))

        # 2. prices from leased and queued demand, per shard and class
        act = [active(k) for k in range(K)]
        if priced or elastic:
            demand = np.stack([
                np.bincount(sla_all[act[k][0]], weights=act[k][1],
                            minlength=C)
                + np.bincount(sla_all[queues[k]], weights=tok_q[queues[k]],
                              minlength=C) for k in range(K)])
            prices = 1.0 + np.minimum(PRICE_GAMMA * demand / cap,
                                      PRICE_CAP - 1.0)

        # 3. arrivals: rejection, routing, decisions
        hi = int(np.searchsorted(arrival, now, side="right"))
        ids = np.arange(next_ev, hi)
        next_ev = hi
        queued = sum(q.size for q in queues)
        if ids.size and queued + ids.size > MAX_QUEUE:
            keep = max(MAX_QUEUE - queued, 0)
            n_rejected += ids.size - keep
            ids = ids[:keep]
        if ids.size:
            jb = jb_all[ids]
            obs = defaults[jb]
            load = (in_use + np.array([float(np.sum(tok_q[q]))
                                       for q in queues])) / cap
            exec_r, spilled = ring.route(jb, load)
            shard_q[ids], spill_q[ids] = exec_r, spilled
            hit = np.array([int(u) in cache for u in jb], bool)
            a_dec, b_dec = np.zeros(ids.size), np.zeros(ids.size)
            for i in np.flatnonzero(hit):
                a_dec[i], b_dec[i] = cache[int(jb[i])]
            if np.any(~hit):
                a_m, b_m = model_ab(jb[~hit])
                a_dec[~hit], b_dec[~hit] = a_m, b_m
            perf = np.minimum(pol.choose_tokens(a_dec, b_dec, obs, policy),
                              cap)
            tokens = perf
            if priced:
                p = prices[exec_r, sla_all[ids]]
                tokens = np.minimum(pol.choose_tokens(a_dec, b_dec, obs,
                                                      policy, p), cap)
                tokens = np.maximum(tokens, _deadline_floor(
                    a_dec, b_dec, deadline_all[ids] - now, perf))
                price_q[ids] = p
            tok_q[ids], perf_q[ids] = tokens, perf
            a_q[ids], b_q[ids], hit_q[ids] = a_dec, b_dec, hit
            err_q[ids] = (np.abs(perf - oracle[jb])
                          / np.maximum(oracle[jb], 1))
            rt_q[ids] = runtimes(jb, tokens)
            for k in np.unique(exec_r):
                queues[k] = np.concatenate([queues[k], ids[exec_r == k]])

        # 4. elastic shrink where a shard's queue outgrows its free tokens
        if elastic:
            shrink = [k for k in range(K) if act[k][0].size and queues[k].size
                      and int(np.sum(tok_q[queues[k]])) > cap - in_use[k]]
            if shrink:
                cand = np.concatenate([act[k][0] for k in shrink])
                cand_sh = np.concatenate([np.full(act[k][0].size, k)
                                          for k in shrink])
                done = work_done(cand, now)
                floor = _deadline_floor(
                    a_q[cand], b_q[cand],
                    (deadline_all[cand] - now) / (1.0 - done), tok_q[cand])
                cand_p = prices[cand_sh, sla_all[cand]]
                tgt, sel, rt_new, new_end = resize(cand, cand_p, floor, done,
                                                   now)
                if np.any(sel):
                    apply_resize(cand_sh[sel], cand[sel], tgt[sel], now,
                                 rt_new[sel], new_end[sel])
                    if priced:
                        price_q[cand[sel]] = cand_p[sel]

        # 5. re-price queued decisions whose price moved
        if priced and any(q.size for q in queues):
            all_q = np.concatenate([q for q in queues if q.size])
            pq = prices[shard_q[all_q], sla_all[all_q]]
            moved = np.abs(pq - price_q[all_q]) > REPRICE_MOVE * price_q[all_q]
            if np.any(moved):
                rq, p = all_q[moved], pq[moved]
                floor = _deadline_floor(a_q[rq], b_q[rq],
                                        deadline_all[rq] - now, perf_q[rq])
                toks, _, rts, _ = resize(rq, p, floor, np.zeros(rq.size), now)
                tok_q[rq], rt_q[rq], price_q[rq] = toks, rts, p

        # 6. EDF admission into open lease slots
        for k in range(K):
            if not queues[k].size or cap - in_use[k] <= 0:
                continue
            q = queues[k]
            slack = deadline_all[q] - (now + rt_q[q].astype(np.float64))
            q = queues[k] = q[np.lexsort((q, arrival[q], slack))]
            open_slots = np.flatnonzero(lease_tok[k] == 0)
            fits = np.cumsum(tok_q[q]) <= cap - in_use[k]
            j = min(int(np.searchsorted(~fits, True)), open_slots.size)
            if j:
                adm, slots = q[:j], open_slots[:j]
                start_q[adm], mark_q[adm], done_q[adm] = now, now, 0.0
                end_q[adm] = now + rt_q[adm]
                lease_q[k, slots], lease_tok[k, slots] = adm, tok_q[adm]
                lease_end[k, slots] = end_q[adm]
                in_use[k] += int(np.sum(tok_q[adm]))
                queues[k] = q[j:]

        # 7. elastic grow of leases that would miss their deadline
        if elastic:
            g_sh, g_ids, g_tok = [], [], []
            for k in range(K):
                if queues[k].size or cap - in_use[k] <= 0:
                    continue
                ids_k, tok_k, end_k = active(k)
                want = perf_q[ids_k] - tok_k
                c = ((want > 0) & ((end_k - now) > EPOCH_S)
                     & (end_k > deadline_all[ids_k]))
                if not np.any(c):
                    continue
                order = np.argsort(deadline_all[ids_k[c]] - end_k[c],
                                   kind="stable")
                cids, cwant = ids_k[c][order], want[c][order]
                fits = np.cumsum(cwant) <= cap - in_use[k]
                j = int(np.searchsorted(~fits, True))
                if j:
                    g_sh.append(np.full(j, k))
                    g_ids.append(cids[:j])
                    g_tok.append(tok_q[cids[:j]] + cwant[:j])
            if g_ids:
                apply_resize(np.concatenate(g_sh), np.concatenate(g_ids),
                             np.concatenate(g_tok), now)

    done_rows = (np.concatenate(rows) if rows
                 else np.zeros((0, len(COMPLETION_FIELDS))))
    return Pass(done_rows, n_epochs, n_rejected)
