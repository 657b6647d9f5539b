"""PCCCache — the paper's "past observed" allocation path, refined online.

A query seen before needs no model: its exact PCC is fitted from the
observed skyline of its own production run. The cache maps query identity
(the trace's unique-query index) to exact power-law parameters (a, b); the
cluster simulator populates it from completed queries, so the cache warms as
traffic repeats and repeat queries bypass the learned model entirely.

Refinement is fully batched: completed skylines are AREPAS-simulated at
the standard allocation grid in one ``arepas_runtimes`` call on the
cache's device (kernel K1 on the card), and the grid is fitted with the
vectorized float64 ``fit_pcc_batch_np`` — the same math the training set
uses (``core/dataset.py``), so a cache entry is the exact-history fit. A
caller that keeps every skyline on the device (the cluster simulator)
passes the resident pool and a row index instead of padded rows, so only
(B,) vectors cross to the card.

Staleness: recurring templates drift (the same script over a fresh, larger
day of data). Each entry remembers the skyline area (total work) it was
fitted from; a lookup that passes the query's *current* area demotes an
entry whose cached area drifted beyond ``drift_tol`` to a miss and evicts
it, so the completion path refits the curve instead of serving the stale
one. ``max_entries`` bounds the table with LRU eviction.

A refit over the resident pool waits for the card once: its rows and
allocations go up in one copy from a pinned host stage, and K1's runtimes
come back with the rows' lengths in one read-back, which the cache's
``obs`` counts (``device_syncs.refit.out``, its seconds in
``device_wait_s.refit.out``; padded host rows add ``refit.in``, three
pageable uploads). Refits merge their rows into the sorted table in
place; while recording, ``obs`` counts them (``cache_rows_merged``) and
the refits that filled an empty table (``cache_rebuilds``).

``ShardedPCCCache`` spreads the table over K shards by query-template hash
(the ``Router``'s home assignment): each shard warms only its own slice of
the template population, and the sharded fabric's cache-affinity routing
keeps repeat traffic on the shard that already holds its exact PCC. The
single-shard ``PCCCache`` is its K=1 unit, not a separate code path.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.dataset import PCC_FRACTIONS
from repro_torch.core.pcc import fit_pcc_batch_np
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import arepas_runtimes
from repro_torch.obs import NULL_OBS, Obs

__all__ = ["HostStage", "PCCCache", "ShardedPCCCache"]


class HostStage:
    """The refit's int32 upload buffer on the host: pinned where the device
    is a card, so an upload does not wait for it, grown geometrically, and
    reused by every refit that shares it (a simulator hands one to the
    caches of all its runs, the oracle's among them: pinning memory is
    slow). A refit's blocking read-back finishes the copy out of it before
    the next refit writes it again."""

    def __init__(self, device: Union[str, torch.device, None] = None):
        self.pinned = resolve_device(device).type == "cuda"
        self._buf: Optional[torch.Tensor] = None

    def take(self, n: int) -> torch.Tensor:
        """A 1-D host view of ``n`` int32 elements."""
        buf = self._buf
        if buf is None or buf.numel() < n:
            buf = self._buf = torch.empty(
                max(n, 2 * (0 if buf is None else buf.numel())),
                dtype=torch.int32, pin_memory=self.pinned)
        return buf[:n]


class PCCCache:
    """Exact per-query PCC parameters keyed by unique-query id.

    The table is sorted columns: ``keys`` (int64) beside one (4, capacity)
    float64 block of (a, b, area, version), of which the first ``_n`` are
    live; capacity grows geometrically. A refit merges its rows in place,
    shifting each run of old rows right by the new keys before it, so it
    costs its own rows and one pass of memory moves, not a rebuild of the
    table. ``stats["dense_rebuilds"]`` counts the refits that filled an
    empty table, the only ones that sort it whole."""

    def __init__(self, fractions: Sequence[float] = PCC_FRACTIONS,
                 max_entries: Optional[int] = None,
                 drift_tol: float = 0.25,
                 device: Union[str, torch.device, None] = None,
                 obs: Optional[Obs] = None,
                 stage: Optional[HostStage] = None):
        self.device = resolve_device(device)
        self.obs = NULL_OBS if obs is None else obs
        self.stage = HostStage(self.device) if stage is None else stage
        self.fractions = np.asarray(sorted(fractions, reverse=True),
                                    np.float64)
        assert np.all(self.fractions > 0)
        assert max_entries is None or max_entries >= 1
        self.max_entries = max_entries
        self.drift_tol = drift_tol
        # the serving model's version at refine time; a hot-swap bumps it
        # (``bump_model_version``) and lookups demote older entries — a
        # post-swap cache hit can never serve a curve refined under the
        # retired model
        self.model_version = 0
        # one block so (a, b, area, version) can never desynchronize
        self._keys = np.empty(0, np.int64)
        self._vals = np.empty((4, 0), np.float64)
        self._n = 0
        self._used: Dict[int, int] = {}       # LRU tick per key
        self._tick = 0
        self.stats = {"hits": 0, "misses": 0, "refined": 0, "refine_calls": 0,
                      "stale": 0, "evicted": 0, "dense_rebuilds": 0,
                      "version_stale": 0}

    def __len__(self) -> int:
        return self._n

    def __contains__(self, key: int) -> bool:
        return not self.missing([key])[0]

    def _find(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(hit mask, table row) per key — vectorized searchsorted."""
        dk = self._keys[:self._n]
        idx = np.searchsorted(dk, keys)
        idx = np.minimum(idx, max(dk.size - 1, 0))
        hit = (dk[idx] == keys) if dk.size else np.zeros(keys.size, bool)
        return hit, idx

    def missing(self, keys: np.ndarray) -> np.ndarray:
        """(K,) bool: key has no cache entry (vectorized, no stats)."""
        hit, _ = self._find(np.asarray(keys, np.int64))
        return ~hit

    def _merge(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Write ``keys`` and their (4, B) ``vals`` into the table in place:
        present keys are overwritten, new ones inserted at their sorted
        places; a key repeated in the batch keeps its last row, as a dict's
        would."""
        if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
            uk, first = np.unique(keys[::-1], return_index=True)
            keys, vals = uk, vals[:, keys.size - 1 - first]
        n, m = self._n, keys.size
        if n == 0:      # the batch's sort is the table's
            self.stats["dense_rebuilds"] += 1
            self.obs.metrics.counter("cache_rebuilds").inc()
            pos = np.zeros(m, np.int64)
        else:
            self.obs.metrics.counter("cache_rows_merged").inc(m)
            pos = np.searchsorted(self._keys[:n], keys)
            have = pos < n
            have[have] = self._keys[pos[have]] == keys[have]
            if have.any():
                self._vals[:, pos[have]] = vals[:, have]
                new = ~have
                keys, vals, pos = keys[new], vals[:, new], pos[new]
                m = keys.size
        if m == 0:
            return
        self.stats["refined"] += m
        if n + m > self._keys.size:
            cap = max(n + m, 2 * self._keys.size)
            self._keys = np.concatenate(
                [self._keys[:n], np.empty(cap - n, np.int64)])
            self._vals = np.concatenate(
                [self._vals[:, :n], np.empty((4, cap - n))], axis=1)
        # old rows [at[j], at[j + 1]) move right by the j + 1 new keys at or
        # before them; last run first, so no run lands on one not yet moved
        at = pos.tolist() + [n]
        for j in range(m - 1, -1, -1):
            lo, hi = at[j], at[j + 1]
            if lo < hi:
                self._keys[lo + j + 1:hi + j + 1] = self._keys[lo:hi]
                self._vals[:, lo + j + 1:hi + j + 1] = self._vals[:, lo:hi]
        at = pos + np.arange(m)
        self._keys[at] = keys
        self._vals[:, at] = vals
        self._n = n + m

    def _evict(self, keys: np.ndarray) -> None:
        """Delete the rows of these present, unique keys in place."""
        n = self._n
        keep = np.ones(n, bool)
        keep[np.searchsorted(self._keys[:n], keys)] = False
        self._n = int(keep.sum())
        self._keys[:self._n] = self._keys[:n][keep]
        self._vals[:, :self._n] = self._vals[:, :n][:, keep]
        for k in keys.tolist():
            del self._used[k]
        self.stats["evicted"] += keys.size

    def bump_model_version(self, version: Optional[int] = None) -> int:
        """A model hot-swap happened: entries refined under the old model
        become stale (next lookup demotes them to misses and evicts, so
        the completion path refits them under the new regime)."""
        self.model_version = int(version) if version is not None \
            else self.model_version + 1
        return self.model_version

    # -------------------------------------------------------------- lookup --
    def lookup(self, keys: np.ndarray, areas: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch lookup: (hit mask, a, b); (a, b) are 0 where missed.

        ``areas`` — the queries' current skyline areas — enables drift
        detection: an entry fitted from work that differs from the current
        volume by more than ``drift_tol`` (relative) is stale, counts as a
        miss, and is evicted so the next completion refits it.
        """
        keys = np.asarray(keys, np.int64)
        hit, idx = self._find(keys)
        if self.model_version and np.any(hit):
            ver = np.where(hit, self._vals[3, idx], self.model_version)
            vstale = hit & (ver < self.model_version)
            if np.any(vstale):
                self.stats["version_stale"] += int(vstale.sum())
                self._evict(np.unique(keys[vstale]))
                hit, idx = self._find(keys)
        if areas is not None and np.any(hit):
            cached = np.where(hit, self._vals[2, idx], 0.0)
            cur = np.asarray(areas, np.float64)
            stale = hit & (np.abs(cur - cached)
                           > self.drift_tol * np.maximum(cached, 1e-9))
            if np.any(stale):
                self.stats["stale"] += int(stale.sum())
                self._evict(np.unique(keys[stale]))
                # re-resolve from scratch: eviction removes the key for
                # *every* row that references it (a duplicate key with a
                # fresh area must not resolve to a neighboring entry)
                hit, idx = self._find(keys)
        live = self._n > 0
        a = np.where(hit, self._vals[0, idx] if live else 0.0, 0.0)
        b = np.where(hit, self._vals[1, idx] if live else 0.0, 0.0)
        self._tick += 1
        if self.max_entries is not None and np.any(hit):   # LRU bookkeeping
            self._used.update(
                dict.fromkeys(np.unique(keys[hit]).tolist(), self._tick))
        self.stats["hits"] += int(hit.sum())
        self.stats["misses"] += int((~hit).sum())
        return hit, a, b

    # ---------------------------------------------------------- refinement --
    def refine_batch(self, keys: np.ndarray, skylines, valid_lens,
                     observed_tokens: np.ndarray, peaks: np.ndarray, *,
                     rows: Optional[np.ndarray] = None,
                     areas: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Fit exact PCCs for a batch of completed queries and cache them.

        skylines: (B, Smax) padded observed skylines; valid_lens: (B,) true
        lengths (== observed runtimes); observed_tokens/peaks: (B,) the run's
        allocation and peak usage. Returns the fitted (a, b) arrays.

        With ``rows`` ((B,) indices), ``skylines``/``valid_lens`` are a
        resident (U, Smax) int32 / (U,) int32 pool of tensors on the cache's
        device and query i's skyline is pool row ``rows[i]``; ``areas``
        then gives each query's skyline area (its token-seconds). The rows
        and allocations go up in one copy from the host stage, and K1's
        runtimes come back with the rows' lengths in one read-back.

        Keys already refined are refitted — drifted reruns of a recurring
        template overwrite the stale curve with the fresh one (the executor
        is deterministic, so a refit from identical data is identical); a
        key repeated in the batch keeps its last row.
        """
        keys = np.asarray(keys, np.int64)
        B = keys.shape[0]
        if B == 0:
            return np.zeros(0), np.zeros(0)
        self.stats["refine_calls"] += 1

        obs = np.asarray(observed_tokens, np.float64)
        allocs = np.maximum(1, np.round(self.fractions[None, :] * obs[:, None])
                            ).astype(np.int64)                       # (B, K)
        K = allocs.shape[1]
        dev = self.device
        wait = self.obs.device_wait
        if rows is None:
            sky_np = np.asarray(skylines)
            row_area = sky_np.astype(np.float64).sum(axis=1)
            with wait("refit.in", 3):
                pool = torch.from_numpy(sky_np.astype(np.int32)).to(dev)
                pool_lens = torch.from_numpy(
                    np.asarray(valid_lens, np.int32)).to(dev)
                d_allocs = torch.from_numpy(allocs.astype(np.int32)).to(dev)
            idx, lens = None, pool_lens
        else:
            row_area = np.asarray(areas, np.float64)
            pool, pool_lens = skylines, valid_lens
            # (B,) int64 rows as 2B int32 words, then the (B, K) allocations:
            # fresh device tensors every call, one copy that waits for nothing
            host = self.stage.take(B * (2 + K))
            words = host.numpy()
            words[:2 * B].view(np.int64)[:] = rows
            words[2 * B:].reshape(B, K)[:] = allocs
            up = host.to(dev, non_blocking=True, copy=True)
            idx = up[:2 * B].view(torch.int64)
            d_allocs = up[2 * B:].view(B, K)
            lens = pool_lens.index_select(0, idx)
        # one AREPAS call over the batch (kernel K1 on the card)
        sim_rt = arepas_runtimes(pool, pool_lens, d_allocs, rows=idx)
        with wait("refit.out"):
            out = torch.cat([sim_rt, lens[:, None]], 1
                            ).cpu().numpy().astype(np.int64)     # (B, K + 1)
        sim_rt, base_rt = out[:, :K], out[:, K]

        # at/above the observed peak the skyline cannot change (§4.4 floor)
        runtimes = np.where(allocs >= np.asarray(peaks, np.int64)[:, None],
                            base_rt[:, None], sim_rt)
        runtimes = np.maximum(runtimes, 1)

        a, b = fit_pcc_batch_np(allocs, runtimes)
        a = np.minimum(a, -1e-4)      # deterministic runs are monotone
        self._tick += 1
        self._used.update(dict.fromkeys(keys.tolist(), self._tick))
        self._merge(keys, np.stack([a, b, row_area,
                                    np.full(B, float(self.model_version))]))
        if self.max_entries is not None and self._n > self.max_entries:
            by_age = sorted(self._used, key=self._used.get)
            self._evict(np.asarray(by_age[:self._n - self.max_entries],
                                   np.int64))
        return a, b


class ShardedPCCCache:
    """K per-shard ``PCCCache`` units addressed by precomputed shard ranks.

    The caller (the simulator / serving fabric) routes once per batch —
    ``shard_of = router.rank(router.home(keys))`` — and every cache
    operation takes that (N,) rank vector alongside the keys, grouping rows
    per shard and delegating to the owning unit. Results come back in input
    order. K=1 degenerates to a single ``PCCCache`` fed whole batches.
    ``cache_kwargs`` (``obs`` and a ``stage`` to share among them) go to
    every shard's unit.
    """

    def __init__(self, n_shards: int = 1, **cache_kwargs):
        assert n_shards >= 1
        self.n_shards = int(n_shards)
        self.shards = [PCCCache(**cache_kwargs) for _ in range(n_shards)]
        self.device = self.shards[0].device

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def bump_model_version(self, version: Optional[int] = None) -> int:
        """Propagate a model hot-swap to every shard's cache."""
        return max(s.bump_model_version(version) for s in self.shards)

    @property
    def stats(self) -> Dict[str, int]:
        """Fabric-wide stats: the per-shard counters summed."""
        out: Dict[str, int] = dict.fromkeys(self.shards[0].stats, 0)
        for s in self.shards:
            for k, v in s.stats.items():
                out[k] += v
        return out

    def _grouped(self, shard_of: np.ndarray):
        shard_of = np.asarray(shard_of, np.int64)
        if self.n_shards == 1:
            yield 0, slice(None)
            return
        for s in np.unique(shard_of):
            yield int(s), shard_of == s

    def lookup(self, shard_of: np.ndarray, keys: np.ndarray,
               areas: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch lookup across shards: (hit mask, a, b) in input order."""
        keys = np.asarray(keys, np.int64)
        hit = np.zeros(keys.size, bool)
        a = np.zeros(keys.size, np.float64)
        b = np.zeros(keys.size, np.float64)
        for s, m in self._grouped(shard_of):
            hit[m], a[m], b[m] = self.shards[s].lookup(
                keys[m], None if areas is None else np.asarray(areas)[m])
        return hit, a, b

    def missing(self, shard_of: np.ndarray, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        out = np.ones(keys.size, bool)
        for s, m in self._grouped(shard_of):
            out[m] = self.shards[s].missing(keys[m])
        return out

    def refine_batch(self, shard_of: np.ndarray, keys: np.ndarray,
                     skylines, valid_lens, observed_tokens: np.ndarray,
                     peaks: np.ndarray, *, rows: Optional[np.ndarray] = None,
                     areas: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Fit and cache exact PCCs, each key on its home shard. With
        ``rows``, ``skylines``/``valid_lens`` are the resident pool (see
        ``PCCCache.refine_batch``) and every shard reads from it."""
        keys = np.asarray(keys, np.int64)
        a = np.zeros(keys.size, np.float64)
        b = np.zeros(keys.size, np.float64)
        for s, m in self._grouped(shard_of):
            if rows is None:
                a[m], b[m] = self.shards[s].refine_batch(
                    keys[m], np.asarray(skylines)[m],
                    np.asarray(valid_lens)[m],
                    np.asarray(observed_tokens)[m], np.asarray(peaks)[m])
            else:
                a[m], b[m] = self.shards[s].refine_batch(
                    keys[m], skylines, valid_lens,
                    np.asarray(observed_tokens)[m], np.asarray(peaks)[m],
                    rows=np.asarray(rows)[m], areas=np.asarray(areas)[m])
        return a, b
