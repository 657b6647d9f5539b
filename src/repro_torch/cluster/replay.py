"""Fused 1M-event cluster replay: one kernel launch per epoch.

``FusedReplay`` answers a different question than ``ClusterSimulator``.
The simulator measures *decision quality* — every epoch consults the
learned model, the PCC cache, the price signal — and its throughput is
bounded by those decision paths.  The replay measures the *mechanical*
ceiling of the cluster fabric itself: given pre-decided allocations (the
fixed point a fully warmed PCC cache converges to — each template's
policy decision from its exact observed skyline), how fast can the
epoch machinery — lease expiry, free-token release, policy-ordered
admission, lease scatter — actually run?

The answer is the tentpole fusion: the whole epoch step is ONE
``cluster_epoch_step`` launch (kernels/cluster_step.py) over the pool's
device-resident (K, L) lease tables.  Per epoch the host:

  * drains arrivals from a streamed trace (``TraceGenerator.stream``)
    into per-shard columnar queues — no per-event Python objects,
  * packs the queue heads into fixed-shape (K, Q) token/end matrices
    (fixed Q == one jit trace for the whole replay),
  * fires the fused kernel and downloads only (K,) admission vectors —
    the lease tables never cross the device boundary,
  * pops the admitted prefixes and accumulates counters.

Idle gaps fast-forward to the next arrival or the device-side
``min`` of the lease end-times (one scalar download).  The per-launch
byte traffic is analytic (table reads/writes + queue head), feeding the
``KernelRoofline`` row that the fused_cluster benchmark publishes and
gates on.

In the port the epoch launch is kernel K2 (``kernels/cluster_step.py``)
on the card's resident tables, and the pre-decision's AREPAS runtimes
come from one kernel K1 launch. Per epoch the (K, Q) queue head goes in
and four (K,) vectors plus one scalar ``min`` come back.

The replay is strictly non-preemptive: the fused epoch kernel has no
preempt phase (``kernels.cluster_step.EPOCH_STEP_SUPPORTS_PREEMPTION``),
and pre-decided allocations leave nothing to re-decide for a checkpointed
remainder anyway.  Preemptive runs belong to ``ClusterSimulator``, which
falls back to its unfused admission loop for them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.allocator import AllocationPolicy, choose_tokens_torch
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import arepas_runtimes, cluster_epoch_step
from repro_torch.obs import NULL_OBS, Obs, device_profile, fence
from repro_torch.roofline.analysis import KernelRoofline, kernel_roofline
from repro_torch.serve.batching import node_bucket

__all__ = ["ReplayConfig", "ReplayReport", "FusedReplay"]


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 65536             # fabric-wide tokens, split over K
    n_shards: int = 4
    epoch_s: float = 4.0
    max_leases: int = 4096            # L: lease slots per shard
    queue_block: int = 1024           # Q: fixed queue-head width per shard
    max_queue: int = 200_000          # backpressure: reject beyond this
    max_slowdown: float = 0.05        # policy for the pre-decided targets


@dataclasses.dataclass
class ReplayReport:
    n_events: int
    n_admitted: int
    n_completed: int
    n_rejected: int
    n_epochs: int
    launches: int
    wall_s: float
    events_per_s: float
    mean_utilization: float
    roofline: KernelRoofline

    def summary(self) -> str:
        r = self.roofline
        return (f"{self.n_events} events in {self.n_epochs} epochs "
                f"({self.launches} launches) | "
                f"{self.events_per_s:,.0f} ev/s | "
                f"util {self.mean_utilization:.2f} | "
                f"{r.achieved_bw / 1e9:.2f} GB/s streamed "
                f"({r.total_bytes / 1e9:.2f} GB total)")


class _ShardQueue:
    """Columnar FIFO of (tokens, end-duration) pairs: chunk appends are
    O(1), head reads and admitted-prefix pops are O(Q) — no concatenation
    of the whole backlog per epoch."""

    __slots__ = ("_chunks", "_head", "size")

    def __init__(self) -> None:
        self._chunks: List[np.ndarray] = []   # (m, 2) columns [tok, rt]
        self._head = 0                        # consumed rows of chunk 0
        self.size = 0

    def push(self, tok: np.ndarray, rt: np.ndarray) -> None:
        if tok.size:
            self._chunks.append(np.stack([tok, rt], axis=1))
            self.size += tok.size

    def head(self, q: int) -> np.ndarray:
        """First min(q, size) rows, without consuming them."""
        out, need, skip = [], min(q, self.size), self._head
        for c in self._chunks:
            if need <= 0:
                break
            take = min(need, c.shape[0] - skip)
            out.append(c[skip:skip + take])
            need -= take
            skip = 0
        return (np.concatenate(out) if out
                else np.zeros((0, 2), np.int64))

    def pop(self, j: int) -> None:
        self.size -= j
        j += self._head
        while self._chunks and j >= self._chunks[0].shape[0]:
            j -= self._chunks[0].shape[0]
            self._chunks.pop(0)
        self._head = j


def _epoch_launch_bytes(k: int, n_leases: int, q: int) -> float:
    """Analytic traffic of one fused epoch launch (kernel K2, float64 /
    int64 tables): the two (K, L) lease tables are read and written, the
    (K, Q) queue head is read, slot_of is written; the (K,) vectors are
    noise but counted."""
    tables = 4 * k * n_leases * 8          # end+tok, read+write
    queue = 2 * k * q * 8 + k * q * 4      # q_tok+q_end in, slot_of out
    small = 6 * k * 8
    return float(tables + queue + small)


class FusedReplay:
    """Replay a streamed trace through the fused epoch kernel."""

    def __init__(self, cfg: ReplayConfig = ReplayConfig(),
                 obs: Optional[Obs] = None,
                 device: Union[str, torch.device, None] = None):
        assert cfg.capacity % cfg.n_shards == 0, \
            (cfg.capacity, cfg.n_shards)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.obs = NULL_OBS if obs is None else obs
        self._dec_cache = None         # (stream, decisions) single-slot

    # ------------------------------------------------------ pre-decision --
    def _decide_pool(self, stream) -> Dict[str, np.ndarray]:
        """Per-unique-template allocation + runtime: the policy decision
        from each template's exact PCC (areas are conserved, so the
        observed skyline parameterizes the curve) — what the simulator's
        cache path converges to once every template has history.

        Deterministic per (config, stream), so repeat replays of the same
        stream (benchmark loops, overhead A/B runs) reuse the decisions."""
        if self._dec_cache is not None and self._dec_cache[0] is stream:
            return self._dec_cache[1]
        cfg = self.cfg
        cap = cfg.capacity // cfg.n_shards
        sky_list = stream.skylines
        U = len(sky_list)
        smax = max(len(s) for s in sky_list)
        sky = np.zeros((U, smax), np.float32)
        lens = np.zeros(U, np.int32)
        for u, s in enumerate(sky_list):
            sky[u, :len(s)] = s
            lens[u] = len(s)
        obs = np.array([j.default_tokens for j in stream.jobs], np.int64)
        # exact-PCC fit: runtime(n) = b * n^a through the observed point
        # and the serial extreme — same two-point fit the cache refines to
        area = sky.sum(axis=1, dtype=np.float64)
        t_obs = np.maximum(lens.astype(np.float64), 1.0)
        t_serial = np.maximum(area, t_obs)
        n_obs = np.maximum(obs.astype(np.float64), 2.0)
        a = np.minimum(np.log(t_obs / t_serial) / np.log(n_obs), -1e-4)
        b = np.maximum(t_serial, 1e-3)
        policy = AllocationPolicy(max_slowdown=cfg.max_slowdown)
        dev = self.device
        tok = choose_tokens_torch(torch.from_numpy(a).to(dev),
                                  torch.from_numpy(b).to(dev), policy,
                                  torch.from_numpy(obs).to(dev)).cpu().numpy()
        tok = np.maximum(np.minimum(tok, cap), 1)
        rt = arepas_runtimes(
            torch.from_numpy(sky.astype(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev),
            torch.from_numpy(tok[:, None].astype(np.int32)).to(dev)
        ).cpu().numpy()[:, 0]
        dec = {"tokens": tok.astype(np.int64),
               "runtime_s": np.maximum(rt.astype(np.int64), 1)}
        self._dec_cache = (stream, dec)
        return dec

    # ------------------------------------------------------------- warmup --
    def warm(self) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """Warm start: make the empty (K, L) lease tables on the device and
        launch the fused epoch kernel once on them (on the card this loads,
        and at first use builds, the kernel library) *before* the timed
        window opens. Returns the device tables and the cold-start seconds
        paid, which land in the ``decision_cold_start_s`` histogram and an
        ``aot.warmup`` span."""
        cfg = self.cfg
        K = cfg.n_shards
        L = node_bucket(cfg.max_leases)
        Q = node_bucket(min(cfg.queue_block, cfg.capacity // K))
        t0 = time.perf_counter()
        dev = self.device
        with self.obs.tracer.span("aot.warmup", scope="replay", K=K):
            d_end = torch.full((K, L), float("inf"), dtype=torch.float64,
                               device=dev)
            d_tok = torch.zeros((K, L), dtype=torch.int64, device=dev)
            warm = cluster_epoch_step(
                d_end, d_tok, torch.zeros(K, dtype=torch.int64, device=dev),
                torch.zeros((K, Q), dtype=torch.int64, device=dev),
                torch.zeros((K, Q), dtype=torch.float64, device=dev), 0.0)
            fence(warm)
        cold_start_s = time.perf_counter() - t0
        self.obs.metrics.histogram("decision_cold_start_s").record(
            cold_start_s)
        return d_end, d_tok, cold_start_s

    # -------------------------------------------------------------- run --
    def run(self, stream) -> ReplayReport:
        cfg = self.cfg
        K = cfg.n_shards
        Q = node_bucket(min(cfg.queue_block, cfg.capacity // K))
        dec = self._decide_pool(stream)
        tok_u, rt_u = dec["tokens"], dec["runtime_s"]

        d_end, d_tok, _ = self.warm()
        dev = self.device
        L = node_bucket(cfg.max_leases)
        t_wall = time.time()
        free = np.full(K, cfg.capacity // K, np.int64)
        queues = [_ShardQueue() for _ in range(K)]
        q_tok_m = np.zeros((K, Q), np.int64)
        q_end_m = np.zeros((K, Q), np.float64)

        chunks = stream.chunks()
        buf = None                       # pending chunk (tok, rt, arrival)
        buf_at = 0
        n_admitted = n_completed = n_rejected = 0
        n_epochs = launches = 0
        util_sum = 0.0
        kernel_s = 0.0
        now = 0.0
        events_left = len(stream)

        def refill():
            nonlocal buf, buf_at
            if buf is not None and buf_at < buf[0].size:
                return True
            ch = next(chunks, None)
            if ch is None:
                buf = None
                return False
            u = ch.job_index
            buf = (tok_u[u], rt_u[u].astype(np.float64), ch.arrival_s)
            buf_at = 0
            return True

        in_use = 0
        o, tr = self.obs, self.obs.tracer
        # optional torch.profiler capture alongside the host spans; entered
        # manually so the (long) replay loop keeps its indentation
        _prof = device_profile(o.profile_dir)
        _prof.__enter__()
        while events_left or any(q.size for q in queues) or in_use:
            # idle fast-forward: nothing queued, nothing arriving this
            # epoch -> jump to the next arrival or the earliest lease end
            # (a device-side min; only the scalar crosses the boundary)
            targets = []
            if refill():
                targets.append(float(buf[2][buf_at]))
            if in_use:
                targets.append(float(d_end.min()))
            now = max(now + cfg.epoch_s, min(targets) if targets else now)
            n_epochs += 1

            # drain arrivals <= now into per-shard queues, columnar
            while refill():
                arr = buf[2]
                hi = int(np.searchsorted(arr[buf_at:], now, side="right"))
                if hi == 0:
                    break
                sl = slice(buf_at, buf_at + hi)
                backlog = sum(q.size for q in queues)
                keep = hi
                if backlog + hi > cfg.max_queue:
                    keep = max(cfg.max_queue - backlog, 0)
                    n_rejected += hi - keep
                if keep:
                    sl = slice(buf_at, buf_at + keep)
                    sh = np.arange(sl.start, sl.stop) % K   # decision-free
                    for k in range(K):
                        m = sh == k
                        queues[k].push(buf[0][sl][m], buf[1][sl][m])
                buf_at += hi
                events_left -= hi

            # one fused launch: expire -> release -> admit -> scatter
            q_tok_m[:] = 0
            q_end_m[:] = 0
            heads = [q.head(Q) for q in queues]
            for k, h in enumerate(heads):
                m = h.shape[0]
                if m:
                    q_tok_m[k, :m] = h[:, 0]
                    q_end_m[k, :m] = now + h[:, 1]
            t0 = time.perf_counter()
            with tr.span("cluster_epoch_step") as sp:
                d_end, d_tok, _, n_admit, adm_tok, freed, n_exp = \
                    cluster_epoch_step(
                        d_end, d_tok, torch.from_numpy(free).to(dev),
                        torch.from_numpy(q_tok_m).to(dev),
                        torch.from_numpy(q_end_m).to(dev), now)
                # one copy back for the four (K,) vectors
                n_admit, adm_tok, freed, n_exp = torch.stack(
                    [n_admit, adm_tok, freed, n_exp]).cpu().numpy()
                if sp is not None:
                    # fence the resident tables too, so the span measures
                    # device completion of the whole launch, not dispatch
                    fence((d_end, d_tok))
                    sp.attrs.update(admitted=int(n_admit.sum()),
                                    expired=int(n_exp.sum()))
            dt = time.perf_counter() - t0
            kernel_s += dt
            o.metrics.histogram("epoch_launch_s").record(dt)
            launches += 1
            for k in range(K):
                queues[k].pop(int(n_admit[k]))
            free += freed.astype(np.int64) - adm_tok.astype(np.int64)
            n_admitted += int(n_admit.sum())
            n_completed += int(n_exp.sum())
            in_use = cfg.capacity - int(free.sum())
            util_sum += in_use / cfg.capacity
            if tr.enabled:   # per-shard lanes for the Perfetto timeline
                tr.sample("pool_in_use",
                          **{f"shard{k}": int(cfg.capacity // K - free[k])
                             for k in range(K)})
                tr.sample("queue_depth", **{f"shard{k}": queues[k].size
                                            for k in range(K)})
                tr.point("epoch", t_sim=now, admitted=int(n_admit.sum()))

        _prof.__exit__(None, None, None)
        wall = time.time() - t_wall
        o.metrics.counter("replay_admitted").inc(n_admitted)
        o.metrics.counter("replay_completed").inc(n_completed)
        o.metrics.counter("replay_rejected").inc(n_rejected)
        o.metrics.counter("replay_epochs").inc(n_epochs)
        n_events = len(stream)
        roofline = kernel_roofline(
            "cluster_epoch_step", launches=launches,
            bytes_per_launch=_epoch_launch_bytes(K, L, Q),
            wall_s=kernel_s, items=n_events)
        return ReplayReport(
            n_events=n_events, n_admitted=n_admitted,
            n_completed=n_completed, n_rejected=n_rejected,
            n_epochs=n_epochs, launches=launches, wall_s=round(wall, 3),
            events_per_s=round(n_events / max(wall, 1e-9), 1),
            mean_utilization=round(util_sum / max(n_epochs, 1), 4),
            roofline=roofline)
