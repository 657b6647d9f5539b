"""Deterministic sharded synthetic token pipeline.

A copy of ``repro/data/pipeline.py`` (numpy and a thread; the reference's
unused ``import jax`` is dropped), so that the port imports nothing of
``repro`` and both packages draw the same batches from the same seed.

Production posture on 1000+ nodes:
  * determinism — batch t on host h is a pure function of (seed, t, h):
    any re-scheduled or replacement host reconstructs its shard without
    coordination (straggler mitigation / elastic restart);
  * skip-ahead — O(1) seek to any step (restore from checkpoint step N
    without replaying N batches);
  * prefetch — a background thread keeps ``prefetch`` batches ready so host
    input never stalls the device step;
  * resharding — the host shard count is a constructor argument, so an
    elastic resize re-partitions the stream deterministically.

The token stream itself is synthetic (structured pseudo-text: repeated
n-gram processes so the ~100M-param example has learnable statistics), which
is the honest option in an offline container — the pipeline machinery
(sharding, determinism, prefetch) is the deliverable, the bytes are not.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2
    ngram_order: int = 3     # synthetic text structure


class TokenPipeline:
    """Iterator of {'tokens': (B_host, S), 'labels': (B_host, S)} int32."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.num_hosts
        self._step = 0
        # fixed n-gram transition structure (same on every host)
        rng = np.random.RandomState(cfg.seed)
        self._trans = rng.randint(
            0, cfg.vocab_size, size=(min(cfg.vocab_size, 4096), 8))
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ batches --
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host_id) — the skip-ahead contract."""
        c = self.cfg
        rng = np.random.RandomState(
            (c.seed * 1_000_003 + step * 65_537 + c.host_id) % (2**31 - 1))
        B, S = self.host_batch, c.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.randint(0, c.vocab_size, size=B)
        noise = rng.randint(0, 8, size=(B, S))
        flip = rng.rand(B, S) < 0.1
        rand = rng.randint(0, c.vocab_size, size=(B, S))
        T = self._trans
        for t in range(S):
            nxt = T[toks[:, t] % T.shape[0], noise[:, t]]
            toks[:, t + 1] = np.where(flip[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def seek(self, step: int) -> None:
        self._step = step

    @property
    def step(self) -> int:
        return self._step

    # ----------------------------------------------------------- prefetch --
    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self) -> "TokenPipeline":
        self._q = queue.Queue(maxsize=self.cfg.prefetch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            batch = self.batch_at(self._step)
            self._step += 1
            return batch
        step, batch = self._q.get()
        self._step = step + 1
        return batch
