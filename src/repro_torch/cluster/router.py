"""Consistent-hash routing over the sharded serving fabric.

Queries are routed by *template identity* (the trace's unique-query index),
so every recurrence of a script lands on the shard whose ``PCCCache``
already holds its exact PCC — the cache-affinity property the whole sharded
fabric exists to preserve. Three routing surfaces:

  * ``home(keys)`` — classic consistent hashing: each shard owns
    ``n_vnodes`` pseudo-random points on a uint64 ring; a key maps to the
    first vnode clockwise of its hash. Adding or removing a shard only
    moves the keys adjacent to that shard's vnodes (stability property,
    tests/test_router.py);
  * ``assign(keys)`` — consistent hashing *with bounded loads* (the
    rebalancing used for static partitioning): walk the ring past shards
    that already hold ``ceil(load_factor * n / K)`` keys, so no shard is
    ever loaded beyond ``load_factor`` times its fair share while keys keep
    as much ring affinity as the bound allows;
  * ``route(keys, load)`` — the online spill policy: a query whose home
    shard is saturated (``load >= spill_threshold``) is offered a second
    hash-independent candidate and takes it iff it is strictly less loaded
    (power-of-two-choices); everything else sticks to its home shard so
    repeat traffic keeps hitting the warm cache.

Everything is deterministic in (seed, shard ids): routing is replayable and
two replicas of the router agree without coordination. Hashing is a
vectorized splitmix64 over numpy uint64 — no Python hashing in the hot path.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# canonical home is repro_torch.obs._hash (dependency-free) so the flight
# recorder's sampler shares the exact hash without an import cycle;
# re-exported here because routing is where most callers reach for it
from repro_torch.obs import NULL_OBS, Obs
from repro_torch.obs._hash import splitmix64

__all__ = ["Router", "splitmix64"]

_U64 = np.uint64


class Router:
    """Consistent-hash router over ``n_shards`` (or explicit ``shard_ids``).

    ``shard_ids`` exists so removal keeps the survivors' vnodes bitwise in
    place: ``Router(shard_ids=[0, 2, 3])`` is "shard 1 drained", and every
    key that was not on shard 1 keeps its home (consistent-hashing
    stability). ``load_factor`` bounds ``assign``; ``spill_threshold`` is
    the saturation point at which ``route`` consults the second choice.
    """

    def __init__(self, n_shards: Optional[int] = None, *,
                 shard_ids: Optional[Sequence[int]] = None,
                 n_vnodes: int = 64, load_factor: float = 1.25,
                 spill_threshold: float = 1.0, seed: int = 0,
                 obs: Optional[Obs] = None):
        self.obs = NULL_OBS if obs is None else obs
        assert (n_shards is None) != (shard_ids is None), \
            "pass exactly one of n_shards / shard_ids"
        ids = (np.arange(n_shards, dtype=np.int64) if shard_ids is None
               else np.asarray(sorted(shard_ids), np.int64))
        assert ids.size >= 1 and np.unique(ids).size == ids.size
        assert load_factor >= 1.0, load_factor
        self.shard_ids = ids
        self.n_shards = int(ids.size)
        self.n_vnodes = int(n_vnodes)
        self.load_factor = float(load_factor)
        self.spill_threshold = float(spill_threshold)
        self.seed = int(seed)

        # vnode positions depend only on (seed, shard id, vnode index), so a
        # shard's points never move when other shards come or go
        sv = (ids[:, None].astype(np.uint64) << _U64(20)) \
            + np.arange(n_vnodes, dtype=np.uint64)[None, :]
        pos = splitmix64(sv ^ splitmix64(np.full_like(sv, self.seed)))
        pos = pos.reshape(-1)
        shard_of_vnode = np.repeat(ids, n_vnodes)
        order = np.argsort(pos, kind="stable")
        self._ring_pos = pos[order]
        self._ring_shard = shard_of_vnode[order]
        # per ring slot: the shard of the next vnode clockwise owned by a
        # *different* shard (the power-of-two alternative when the salted
        # second hash collides with the home shard); == own shard iff K == 1
        self._next_diff = self._build_next_diff()
        # dense rank per shard id (ids need not be contiguous); one LUT
        # shared by rank() and assign()
        self._rank_lut = np.full(int(ids.max()) + 1, -1, np.int64)
        self._rank_lut[ids] = np.arange(self.n_shards)

    def _build_next_diff(self) -> np.ndarray:
        """Per ring slot: the owner of the first clockwise vnode belonging to
        a different shard — one backward pass over the doubled ring (the
        doubling resolves the wrap-around). == own shard iff K == 1."""
        ring = self._ring_shard
        n = ring.size
        doubled = np.concatenate([ring, ring])
        nd = np.empty(2 * n, np.int64)
        nxt_shard, nxt_val = int(ring[0]), -1
        for i in range(2 * n - 1, -1, -1):
            if doubled[i] != nxt_shard:
                nxt_val = nxt_shard
            nxt_shard = int(doubled[i])
            nd[i] = nxt_val
        out = nd[:n]
        out[out < 0] = ring[out < 0]          # K == 1: no different shard
        return out

    # -------------------------------------------------------------- lookup --
    def _slot(self, h: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self._ring_pos, h, side="left")
        return np.where(idx == self._ring_pos.size, 0, idx)

    def home(self, keys: np.ndarray) -> np.ndarray:
        """(N,) shard id per key — pure consistent hashing."""
        h = splitmix64(np.asarray(keys, np.int64).astype(np.uint64))
        return self._ring_shard[self._slot(h)]

    def second(self, keys: np.ndarray,
               home: Optional[np.ndarray] = None) -> np.ndarray:
        """(N,) independent second candidate, != home whenever K > 1.

        ``home`` short-circuits the recomputation of ``home(keys)`` when the
        caller (e.g. ``route``) already holds it.
        """
        keys = np.asarray(keys, np.int64).astype(np.uint64)
        h = splitmix64(keys ^ _U64(0xD6E8FEB86659FD93))
        slot = self._slot(h)
        alt = self._ring_shard[slot]
        if home is None:
            home = self.home(keys.astype(np.int64))
        return np.where(alt == home, self._next_diff[slot], alt)

    def rank(self, shards: np.ndarray) -> np.ndarray:
        """Dense 0..K-1 rank of shard ids (for bincount-style accounting)."""
        return self._rank_lut[np.asarray(shards, np.int64)]

    # ---------------------------------------------------------- assignment --
    def assign(self, keys: np.ndarray) -> np.ndarray:
        """Bounded-load assignment: per-shard count <= ceil(lf * N / K).

        Keys are processed in input order (deterministic); a key whose home
        shard is at capacity walks the ring to the next shard below the
        bound — the Mirrokni et al. "consistent hashing with bounded loads"
        construction.
        """
        keys = np.asarray(keys, np.int64)
        n = keys.size
        if n == 0:
            return np.zeros(0, np.int64)
        cap = int(np.ceil(self.load_factor * n / self.n_shards))
        h = splitmix64(keys.astype(np.uint64))
        slots = self._slot(h)
        ring_shard = self._ring_shard
        ring_n = ring_shard.size
        counts = np.zeros(self.n_shards, np.int64)
        rank = self._rank_lut
        out = np.empty(n, np.int64)
        for i in range(n):
            j = int(slots[i])
            s = int(ring_shard[j])
            while counts[rank[s]] >= cap:
                j = (j + 1) % ring_n
                s = int(ring_shard[j])
            out[i] = s
            counts[rank[s]] += 1
        return out

    # ------------------------------------------------------------- spilling --
    def route(self, keys: np.ndarray, load: np.ndarray,
              drain: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Online placement: home shard, spilling only under saturation.

        ``load`` is the caller's (K,) load metric indexed by shard *rank*
        (demand fraction of per-shard capacity, by convention). A key whose
        home load is >= ``spill_threshold`` is offered ``second(key)`` and
        takes it iff strictly less loaded — power-of-two-choices, bounded to
        saturated homes so cache affinity is the common case. Returns
        (shard ids, spilled mask).

        ``drain`` is an optional (K,) bool mask by shard rank: shards
        actively shedding load — e.g. a rack that just preempted leases and
        is re-queueing the checkpointed remainders. A key homed on a drained
        shard consults its second choice regardless of ``spill_threshold``
        (the preemption itself proved the home saturated) and still takes it
        only iff strictly less loaded, so remainders can cross shards while
        cache affinity stays the tie-break.
        """
        keys = np.asarray(keys, np.int64)
        load = np.asarray(load, np.float64)
        assert load.shape == (self.n_shards,), load.shape
        o = self.obs
        with o.tracer.span("router.route", n=int(keys.size)) as sp:
            hm = self.home(keys)
            if self.n_shards == 1:
                shards = hm
                spill = np.zeros(keys.size, bool)
            else:
                alt = self.second(keys, home=hm)
                hm_r, alt_r = self.rank(hm), self.rank(alt)
                saturated = load[hm_r] >= self.spill_threshold
                if drain is not None:
                    drain = np.asarray(drain, bool)
                    assert drain.shape == (self.n_shards,), drain.shape
                    saturated = saturated | drain[hm_r]
                spill = saturated & (load[alt_r] < load[hm_r])
                shards = np.where(spill, alt, hm)
            if sp is not None:
                sp.attrs["spilled"] = int(spill.sum())
        o.metrics.counter("routed").inc(int(keys.size))
        o.metrics.counter("route_spills").inc(int(spill.sum()))
        return shards, spill
