"""Sharded token pools with lease-based accounting.

The cluster's shared resource, generalized to K racks: each shard owns a
fixed ``capacity_per_shard`` tokens out of which admitted queries lease
their allocation for the duration of their (simulated) execution. Lease
state lives in one stacked (K, max_leases) table per column, so the
per-epoch expiry scan — find every lease on *any* shard that ended by
``now`` — is a single vectorized sweep over the whole fabric, and
cross-shard lease resizing is one scatter into the flattened table.

Device residency: the (K, L) lease tables ``_d_end`` (float64) and
``_d_tok`` (int64) are uploaded to the pool's device *once* at
construction. Expiry and acquire/resize/preempt writes then update them in
place on the device (``_expire_tables`` / ``_scatter_tables``, plain torch:
the reference's are jnp, not Pallas kernels), where the reference builds
new immutable arrays; only the changed slots travel. The host keeps a
numpy mirror for metadata queries (``active``/``next_expiry``/slot
search), which tests assert stays bitwise-equal to the device tables. The
fused epoch step (``admit_epoch``) runs kernel K2 on the resident tables:
expire -> release -> admit -> lease scatter in one launch.

``TokenPool`` (the single-pool API) is the K=1 special case: a thin view
over a one-shard ``PoolShards`` — not a parallel implementation.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import cluster_epoch_step

__all__ = ["PoolShards", "TokenPool"]


def _expire_tables(end_s: torch.Tensor, tokens: torch.Tensor,
                   now: float) -> None:
    """Device-resident expiry sweep over the stacked (K, L) lease tables,
    in place: clears every lease that ended by ``now``. The host mirror
    applies the identical predicate on its copy, so the two stay
    bitwise-equal without any table transfer."""
    expired = (tokens > 0) & (end_s <= now)
    end_s.masked_fill_(expired, math.inf)
    tokens.masked_fill_(expired, 0)


def _scatter_tables(end_s: torch.Tensor, tokens: torch.Tensor,
                    slots: torch.Tensor, new_tokens: torch.Tensor,
                    new_end_s: torch.Tensor) -> None:
    """Cross-shard lease write, in place: one scatter over the flattened
    (K*L,) lease tables (``slots`` are flat shard*L + slot indices).
    Acquire, resize and preempt are the same scatter — only the caller's
    bookkeeping differs."""
    end_s.view(-1).index_put_((slots,), new_end_s)
    tokens.view(-1).index_put_((slots,), new_tokens)


class PoolShards:
    """K token pools behind one stacked lease table.

    Each shard holds ``capacity_per_shard`` tokens shared by up to
    ``max_leases`` concurrently running queries. Expiry runs over every
    shard in one kernel call; acquire/resize take explicit shard *ranks*
    (0..K-1). ``in_use`` / ``free`` are (K,) vectors.
    """

    def __init__(self, capacity_per_shard: int, n_shards: int = 1,
                 max_leases: int = 4096,
                 device: Union[str, torch.device, None] = None):
        assert capacity_per_shard >= 1 and n_shards >= 1
        self.device = resolve_device(device)
        self.capacity = int(capacity_per_shard)
        self.n_shards = int(n_shards)
        self.max_leases = int(max_leases)
        K = self.n_shards
        self._end_s = np.full((K, max_leases), np.inf)
        self._tokens = np.zeros((K, max_leases), np.int64)
        self._query = np.full((K, max_leases), -1, np.int64)
        self.in_use = np.zeros(K, np.int64)
        # one-time upload; afterwards the device tables are only mutated by
        # resident kernels / small scatters of the changed slots
        self._d_end = torch.from_numpy(self._end_s).to(self.device, copy=True)
        self._d_tok = torch.from_numpy(self._tokens).to(self.device,
                                                        copy=True)

    @property
    def free(self) -> np.ndarray:
        """(K,) free tokens per shard."""
        return self.capacity - self.in_use

    @property
    def n_active(self) -> int:
        """Live leases across every shard."""
        return int(np.count_nonzero(self._tokens))

    @property
    def device_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The resident (end_s, tokens) device tables (read-only views)."""
        return self._d_end, self._d_tok

    def next_expiry(self) -> float:
        """Earliest lease end time on any shard (inf if the fabric is idle)."""
        return float(np.min(self._end_s))

    def _scatter_device(self, flat_slots: np.ndarray, new_tokens: np.ndarray,
                        new_end_s: np.ndarray) -> None:
        """Mirror a host-side slot write onto the resident device tables:
        only the changed slots travel."""
        dev = self.device
        _scatter_tables(
            self._d_end, self._d_tok,
            torch.from_numpy(np.asarray(flat_slots, np.int64)).to(dev),
            torch.from_numpy(np.asarray(new_tokens, np.int64)).to(dev),
            torch.from_numpy(np.asarray(new_end_s, np.float64)).to(dev))

    def expire(self, now: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Release every lease on every shard that ended by ``now``.

        One resident device sweep plus the same predicate on the host
        mirror — no table crosses the boundary. Returns (shard ranks,
        query ids, token counts) of the released leases, in (shard, slot)
        order.
        """
        expired = (self._tokens > 0) & (self._end_s <= now)
        sh, slot = np.nonzero(expired)
        qids = self._query[sh, slot]
        toks = self._tokens[sh, slot]
        freed = np.bincount(sh, weights=toks,
                            minlength=self.n_shards).astype(np.int64)
        self._end_s[sh, slot] = np.inf
        self._tokens[sh, slot] = 0
        self._query[sh, slot] = -1
        self.in_use -= freed
        assert np.all(self.in_use >= 0), self.in_use
        _expire_tables(self._d_end, self._d_tok, float(now))
        return sh, qids, toks

    def active(self, shard: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Live leases as (query ids, tokens, end times), slot order.

        ``shard`` restricts the view to one shard; ``None`` spans the fabric
        in (shard, slot) order.
        """
        if shard is None:
            m = self._tokens > 0
            return (self._query[m].copy(), self._tokens[m].copy(),
                    self._end_s[m].copy())
        m = self._tokens[shard] > 0
        return (self._query[shard, m].copy(), self._tokens[shard, m].copy(),
                self._end_s[shard, m].copy())

    def _slots_of(self, shard_of: np.ndarray, query_ids: np.ndarray
                  ) -> np.ndarray:
        """Flat (shard*L + slot) index of each live (shard, query) lease."""
        flat = np.empty(query_ids.size, np.int64)
        for s in np.unique(shard_of):
            m = shard_of == s
            live = np.flatnonzero(self._tokens[s] > 0)
            order = np.argsort(self._query[s][live])
            pos = np.searchsorted(self._query[s][live], query_ids[m],
                                  sorter=order)
            assert np.all(pos < live.size), "resize of an unknown query id"
            slots = live[order[pos]]
            assert np.array_equal(self._query[s][slots], query_ids[m]), \
                "resize of an expired / unknown lease"
            flat[m] = s * self.max_leases + slots
        return flat

    def preempt_batch(self, shard_of: np.ndarray, query_ids: np.ndarray
                      ) -> np.ndarray:
        """Forcibly release live leases before their end time.

        The fairness primitive: unlike ``expire`` (which sweeps by end
        time) this clears an explicit (shard, query) selection — the
        scheduler's chosen victims — returning each lease's token count so
        the caller can checkpoint its remaining work and re-queue the
        remainder. Host mirror and resident device tables are updated with
        the same slot writes (one small scatter; no table transfer), so
        the two stay bitwise-equal exactly as for ``expire``/``resize``.
        Preempting an id with no live lease is a caller bug.
        """
        k = len(query_ids)
        if k == 0:
            return np.zeros(0, np.int64)
        shard_of = np.asarray(shard_of, np.int64)
        query_ids = np.asarray(query_ids, np.int64)
        flat = self._slots_of(shard_of, query_ids)
        toks = self._tokens.reshape(-1)[flat].copy()
        assert np.all(toks > 0), "preempting a lease that is not live"
        self._end_s.reshape(-1)[flat] = np.inf
        self._tokens.reshape(-1)[flat] = 0
        self._query.reshape(-1)[flat] = -1
        self._scatter_device(flat, np.zeros(k, np.int64),
                             np.full(k, np.inf))
        freed = np.bincount(shard_of, weights=toks,
                            minlength=self.n_shards).astype(np.int64)
        self.in_use -= freed
        assert np.all(self.in_use >= 0), self.in_use
        return toks

    def resize_batch(self, shard_of: np.ndarray, query_ids: np.ndarray,
                     new_tokens: np.ndarray, new_end_s: np.ndarray) -> None:
        """Shrink or grow live leases in place across shards.

        ``new_tokens[i]`` (>= 1) replaces query ``query_ids[i]``'s lease on
        shard ``shard_of[i]`` and its end time becomes ``new_end_s[i]`` —
        a host mirror write plus one small scatter onto the resident device
        tables (only the changed slots travel). Net growth must fit each
        shard's free pool; resizing an id with no live lease is a caller
        bug.
        """
        k = len(query_ids)
        if k == 0:
            return
        shard_of = np.asarray(shard_of, np.int64)
        query_ids = np.asarray(query_ids, np.int64)
        new_tokens = np.asarray(new_tokens, np.int64)
        new_end_s = np.asarray(new_end_s, np.float64)
        assert np.all(new_tokens >= 1), "shrink-to-zero is a release"
        flat = self._slots_of(shard_of, query_ids)
        old = self._tokens.reshape(-1)[flat]
        delta = np.bincount(shard_of, weights=new_tokens - old,
                            minlength=self.n_shards).astype(np.int64)
        assert np.all(delta <= self.free), (delta, self.free)
        self._end_s.reshape(-1)[flat] = new_end_s
        self._tokens.reshape(-1)[flat] = new_tokens
        self._scatter_device(flat, new_tokens, new_end_s)
        self.in_use += delta
        assert np.all((0 <= self.in_use) & (self.in_use <= self.capacity)), \
            self.in_use

    def acquire_batch(self, shard: int, query_ids: np.ndarray,
                      tokens: np.ndarray, end_s: np.ndarray) -> None:
        """Lease ``tokens[i]`` for query ``query_ids[i]`` until ``end_s[i]``
        on shard rank ``shard``.

        The caller guarantees the batch fits (sum(tokens) <= free[shard]).
        """
        k = len(query_ids)
        if k == 0:
            return
        total = int(np.sum(tokens))
        assert total <= self.free[shard], (total, self.free[shard])
        slots = np.flatnonzero(self._tokens[shard] == 0)[:k]
        assert len(slots) == k, "lease table full; raise max_leases"
        self._end_s[shard, slots] = end_s
        self._tokens[shard, slots] = tokens
        self._query[shard, slots] = query_ids
        self._scatter_device(shard * self.max_leases + slots,
                             np.asarray(tokens, np.int64),
                             np.asarray(end_s, np.float64))
        self.in_use[shard] += total

    def admit_epoch(self, now: float, q_ids: np.ndarray, q_tok: np.ndarray,
                    q_end: np.ndarray) -> np.ndarray:
        """Fused admission over every shard: one kernel launch scatters the
        longest fitting prefix of each shard's policy-ordered queue into
        free lease slots on the resident device tables.

        q_ids/q_tok/q_end: (K, Q) queue heads, zero-padded past each
        shard's queue end (ids pad with -1). The caller must have called
        ``expire(now)`` first — admission must not race lease expiry, so
        the kernel's built-in expiry stage is required to find nothing.
        Returns the (K,) admitted-prefix lengths; admitted leases land in
        free slots in slot order, exactly like per-shard
        ``acquire_batch`` calls. The launch is kernel K2 on the card (its
        plain version on the CPU); only (K, Q) queue heads go in and (K,)
        vectors plus the admitted slots come back.

        The admitted prefix is capped by BOTH free tokens and open lease
        slots (the kernel counts free slots after expiry and truncates the
        prefix to that count), so every admitted entry is guaranteed a
        scatter target: ``slot_of[k, :n_admit[k]] >= 0`` is an invariant,
        not a hope — admitting past the slot table would leak the
        overflow's tokens from the host ``free`` mirror.
        """
        q_tok = np.ascontiguousarray(q_tok, np.int64)
        q_end = np.ascontiguousarray(q_end, np.float64)
        dev = self.device
        out = cluster_epoch_step(
            self._d_end, self._d_tok, torch.from_numpy(self.free).to(dev),
            torch.from_numpy(q_tok).to(dev), torch.from_numpy(q_end).to(dev),
            float(now))
        new_end, new_tok, slot_of, n_admit, adm_tok, freed, n_expired = out
        # one copy back for the (K,) vectors, one for the admitted slots
        n_admit, adm_tok, n_expired = torch.stack(
            [n_admit, adm_tok, n_expired]).cpu().numpy()
        assert int(n_expired.sum()) == 0, \
            "admit_epoch requires expire(now) to run first"
        self._d_end, self._d_tok = new_end, new_tok
        jmax = int(n_admit.max(initial=0))
        slot_of = slot_of[:, :jmax].cpu().numpy()
        for k in range(self.n_shards):
            j = int(n_admit[k])
            if j == 0:
                continue
            sl = slot_of[k, :j]
            assert np.all(sl >= 0), "lease table full; raise max_leases"
            self._end_s[k, sl] = q_end[k, :j]
            self._tokens[k, sl] = q_tok[k, :j]
            self._query[k, sl] = q_ids[k, :j]
        self.in_use += adm_tok
        assert np.all(self.in_use <= self.capacity), self.in_use
        return n_admit


class TokenPool:
    """Single global token pool — the K=1 view over ``PoolShards``.

    Keeps the PR-2 scalar API (``free``/``in_use`` ints, two-tuple
    ``expire``) for callers that think in one rack.
    """

    def __init__(self, capacity: int, max_leases: int = 4096,
                 device: Union[str, torch.device, None] = None):
        assert capacity >= 1
        self._shards = PoolShards(capacity, 1, max_leases, device=device)

    @property
    def capacity(self) -> int:
        return self._shards.capacity

    @property
    def max_leases(self) -> int:
        return self._shards.max_leases

    @property
    def in_use(self) -> int:
        return int(self._shards.in_use[0])

    @property
    def free(self) -> int:
        return self._shards.capacity - int(self._shards.in_use[0])

    @property
    def n_active(self) -> int:
        return self._shards.n_active

    @property
    def _tokens(self) -> np.ndarray:
        """(max_leases,) lease-table view (invariant checks in tests)."""
        return self._shards._tokens[0]

    @property
    def _end_s(self) -> np.ndarray:
        return self._shards._end_s[0]

    @property
    def _query(self) -> np.ndarray:
        return self._shards._query[0]

    def next_expiry(self) -> float:
        return self._shards.next_expiry()

    def expire(self, now: float) -> Tuple[np.ndarray, np.ndarray]:
        """Release every lease that ended by ``now`` -> (query ids, tokens)."""
        _, qids, toks = self._shards.expire(now)
        return qids, toks

    def active(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._shards.active(0)

    def resize_batch(self, query_ids: np.ndarray, new_tokens: np.ndarray,
                     new_end_s: np.ndarray) -> None:
        self._shards.resize_batch(
            np.zeros(len(query_ids), np.int64), query_ids, new_tokens,
            new_end_s)

    def preempt_batch(self, query_ids: np.ndarray) -> np.ndarray:
        """Forcibly release live leases -> (tokens reclaimed per lease)."""
        return self._shards.preempt_batch(
            np.zeros(len(query_ids), np.int64), query_ids)

    def acquire_batch(self, query_ids: np.ndarray, tokens: np.ndarray,
                      end_s: np.ndarray) -> None:
        self._shards.acquire_batch(0, query_ids, tokens, end_s)
