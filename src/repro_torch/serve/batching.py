"""Padded/bucketed batching + request-queue micro-batching.

Serving traffic arrives one query at a time with variable-size plan graphs;
a pre-built decision executable (a CUDA graph on the card) serves one fixed
shape, so the service keeps the set of shapes small. Two levers:

  * ``batch_bucket``: round the batch dimension up to a power of two (min 8)
    so every executable is reused across nearby batch sizes;
  * ``node_bucket``: round a GNN graph's node count up to a power of two
    (min 8). Padded nodes carry mask 0, which the GCN provably ignores
    (tests/test_models_tasq.py::test_gnn_padding_invariance).

``MicroBatcher`` is the request queue: submit single-job requests, then
``flush()`` groups them by input signature (same node bucket -> same
executable), pads each group to its batch bucket, and issues one
``AllocationService.decide`` call per group.

``AllocationRequest`` here IS the typed protocol request
(``repro_torch.api.types.AllocationRequest``, re-exported):
the micro-batcher's single-query submissions are scalar-field instances of
the same dataclass the columnar ``decide`` batches use.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.types import AllocationRequest
from repro_torch.obs import NULL_OBS, Obs

__all__ = ["AllocationRequest", "MicroBatcher", "batch_bucket", "node_bucket",
           "pad_to", "shard_positions"]


def _next_pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def batch_bucket(n: int, floor: int = 8, cap: int = 4096) -> int:
    """Padded batch size for ``n`` queries: next power of two >= floor."""
    return min(_next_pow2(max(n, 1), floor), max(cap, floor))


def node_bucket(n: int, floor: int = 8, cap: Optional[int] = None) -> int:
    """Padded node-dimension size for an ``n``-operator plan graph.

    ``batch_bucket`` has always had a cap (bigger batches are chunked), but
    the node dimension cannot be chunked — a graph is one query — so a
    ``cap`` here bounds the *bucketed* executable grid instead: a plan with
    more than ``cap`` operators is served at its exact node count (no
    padding, a one-off executable) with a loud ``RuntimeWarning``, rather
    than silently doubling the bucket grid past the cap for a single
    pathological 100k-operator plan. ``cap=None`` (the default for
    non-serving callers: lease tables, queue blocks) keeps the historical
    uncapped power-of-two behavior.
    """
    n = max(n, 1)
    p = _next_pow2(n, floor)
    if cap is not None and p > max(cap, floor):
        warnings.warn(
            f"node_bucket: a {n}-operator plan exceeds the {cap}-node "
            f"bucket cap; serving it with a one-off exact-size executable "
            f"(this is built fresh and never AOT-warmed — check the "
            f"plan, or raise the cap)", RuntimeWarning, stacklevel=2)
        return n
    return p


def pad_to(x: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``x`` along ``axis`` up to ``size`` (no-op if already there)."""
    if x.shape[axis] == size:
        return x
    if x.shape[axis] > size:
        raise ValueError(f"cannot pad axis {axis} of {x.shape} down to {size}")
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - x.shape[axis])
    return np.pad(x, widths)


def shard_positions(shard_of: np.ndarray, n_shards: int, floor: int = 8
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row placement for stacking a flat batch into (K, Bp) shard blocks.

    Row ``i`` of the flat batch lands at block position
    ``(shard_of[i], pos[i])``, rows of one shard keeping their relative
    input order. Returns (pos, per-shard counts, Bp) where ``Bp`` is the
    common padded block width: the batch bucket of the fullest shard, so
    the whole fabric shares one (K, Bp) executable per epoch.
    """
    shard_of = np.asarray(shard_of, np.int64)
    counts = np.bincount(shard_of, minlength=n_shards)
    assert counts.size == n_shards, (counts.size, n_shards)
    order = np.argsort(shard_of, kind="stable")
    pos_sorted = np.arange(shard_of.size) - np.repeat(
        np.cumsum(counts) - counts, counts)
    pos = np.empty(shard_of.size, np.int64)
    pos[order] = pos_sorted
    return pos, counts, batch_bucket(int(counts.max(initial=1)), floor)


def pad_graph_inputs(model_in: Dict[str, np.ndarray], n_nodes: int
                     ) -> Dict[str, np.ndarray]:
    """Pad graph inputs' node dimension(s) to ``n_nodes`` (mask-safe).

    Handles both single-job inputs (features (N, P), adj (N, N), mask (N,))
    and batched ones (leading batch axis on each).
    """
    out = dict(model_in)
    if "mask" in out:
        out["mask"] = pad_to(out["mask"], n_nodes, axis=-1)
    if "adj" in out:
        out["adj"] = pad_to(pad_to(out["adj"], n_nodes, axis=-1),
                            n_nodes, axis=-2)
    if "features" in out:
        # node axis is second-to-last: (N, P) single job, (B, N, P) batched
        out["features"] = pad_to(out["features"], n_nodes, axis=-2)
    return out


class MicroBatcher:
    """Queue single-job allocation requests; drain them in padded batches.

    ``max_wait_s`` bounds request latency: once the oldest queued request
    has waited that long, ``due()`` turns true and ``poll()`` flushes even a
    partial batch. The clock is injectable so callers (and tests) can run on
    simulated time; when none is passed it is *the tracer's clock* — queue
    timestamps, queue-wait histograms, and span timings all read one
    timebase, so a fake-clock test sees consistent waits everywhere (they
    used to diverge: queue entries on ``time.monotonic``, spans on the
    tracer clock). Submission order is preserved within each input
    signature across both full-batch and timeout flushes.
    """

    # largest bucketed node dimension: plans beyond this are served at
    # exact size with a RuntimeWarning (see node_bucket) instead of
    # growing the executable grid unboundedly
    NODE_CAP = 4096

    def __init__(self, service, max_batch: int = 256,
                 max_wait_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 obs: Optional[Obs] = None,
                 node_cap: Optional[int] = None):
        self.service = service
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.node_cap = self.NODE_CAP if node_cap is None else node_cap
        self.obs = NULL_OBS if obs is None else obs
        # explicit clock wins; otherwise share the tracer's timebase
        self._clock = self.obs.tracer.clock if clock is None else clock
        self._queue: List[AllocationRequest] = []
        self._t_submit: List[float] = []     # same clock as the tracer

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, request: AllocationRequest) -> None:
        self._t_submit.append(self._clock())
        self._queue.append(request)
        self.obs.tracer.point("frontend.submit", id=request.request_id)

    def due(self, now: Optional[float] = None) -> bool:
        """True once the queue is full or the oldest request timed out."""
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        if self.max_wait_s is None:
            return False
        now = self._clock() if now is None else now
        return now - self._t_submit[0] >= self.max_wait_s

    def poll(self, now: Optional[float] = None) -> Dict[int, int]:
        """Flush if ``due()``; otherwise keep queueing and return {}."""
        return self.flush() if self.due(now) else {}

    def _signature(self, req: AllocationRequest) -> Tuple:
        # graphs in the same node bucket share an executable
        feats = req.model_in.get("features")
        if feats is not None and feats.ndim >= 2:   # (N, P) graph input
            return ("graph", node_bucket(feats.shape[0], cap=self.node_cap))
        return ("flat",)

    def flush(self) -> Dict[int, int]:
        """Drain the queue: one service call per (signature, chunk).

        Returns {request_id: allocated tokens} in global submission order —
        not signature-group order — so callers that zip results against
        their submissions see them aligned even when signatures interleave.
        Also clears the timeout epoch: requests submitted after a flush
        start a fresh ``max_wait_s`` window, including a request submitted
        at the exact instant the previous window expired.
        """
        queue, self._queue = self._queue, []
        t_submit, self._t_submit = self._t_submit, []
        if not queue:
            return {}
        o = self.obs
        groups: Dict[Tuple, List[AllocationRequest]] = {}
        for r in queue:
            groups.setdefault(self._signature(r), []).append(r)
        results: Dict[int, int] = {}
        with o.tracer.span("microbatch.flush", n=len(queue),
                           groups=len(groups)):
            now = self._clock()
            for sig, reqs in groups.items():
                for i in range(0, len(reqs), self.max_batch):
                    chunk = reqs[i:i + self.max_batch]
                    results.update(self._dispatch(sig, chunk))
        # queue wait per request, on the same clock the timestamps used
        o.metrics.histogram("queue_wait_s").record_many(
            now - np.asarray(t_submit, np.float64))
        return {r.request_id: results[r.request_id] for r in queue}

    def _dispatch(self, sig: Tuple, reqs: Sequence[AllocationRequest]
                  ) -> Dict[int, int]:
        """Stack single-query requests into one columnar protocol request
        and decide it in one executable call."""
        if sig[0] == "graph":
            n_nodes = sig[1]
            padded = [pad_graph_inputs(r.model_in, n_nodes) for r in reqs]
            stacked = {k: np.stack([p[k] for p in padded])
                       for k in reqs[0].model_in}
        else:
            stacked = {k: np.stack([r.model_in[k] for r in reqs])
                       for k in reqs[0].model_in}
        observed = None
        if any(r.observed_tokens is not None for r in reqs):
            observed = np.array(
                [r.observed_tokens if r.observed_tokens is not None
                 else self.service.policy.max_tokens for r in reqs], np.int64)
        decision = self.service.decide(AllocationRequest(
            model_in=stacked, observed_tokens=observed))
        return {r.request_id: int(t)
                for r, t in zip(reqs, decision.tokens)}
