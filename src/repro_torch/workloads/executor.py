"""Cluster executor: wave-based list scheduler producing resource skylines.

This is the synthetic stand-in for *actually running* a SCOPE job on Cosmos:
given a Job (stage DAG) and a token budget, it simulates a work-conserving
FIFO list scheduler at 1-second granularity and returns the per-second token
usage skyline. It supplies:

  * the "observed" production run (job at its default allocation),
  * the paper's §5.1 ground-truth re-executions at 100/80/60/20% tokens,
  * optional per-wave multiplicative noise (noisy neighbors, stragglers) so
    §5.2's outlier analysis has something to find.

Scheduling model: a stage becomes ready when all deps complete; ready stages
queue FIFO; free tokens are granted to the queue head in waves of
min(pending_tasks, free_tokens); each wave occupies its tokens for the stage
task duration (x noise). Deterministic for noise_sigma == 0 (AREPAS's
determinism assumption).
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.workloads.generator import Job

__all__ = ["execute", "observed_skyline", "reexecute_fractions"]


def execute(job: Job, tokens: int, *, noise_sigma: float = 0.0,
            seed: int = 0) -> np.ndarray:
    """Run ``job`` under a hard cap of ``tokens``; return the skyline.

    Returns int32 (runtime_seconds,) — tokens in use at each second.
    """
    assert tokens >= 1
    nstages = len(job.stages)
    rng = np.random.RandomState((seed * 1_000_003 + job.job_id) % (2**31 - 1))

    pending = [s.num_tasks for s in job.stages]          # tasks not yet started
    unfinished = [s.num_tasks for s in job.stages]       # tasks not yet done
    ndeps = [len(s.deps) for s in job.stages]
    children: List[List[int]] = [[] for _ in range(nstages)]
    for sid, s in enumerate(job.stages):
        for d in s.deps:
            children[d].append(sid)

    ready: List[int] = [sid for sid in range(nstages) if ndeps[sid] == 0]
    free = tokens
    # event heap: (end_time, seq, stage_id, wave_size)
    events: List[Tuple[int, int, int, int]] = []
    seq = 0
    t = 0
    intervals: List[Tuple[int, int, int]] = []           # (start, end, n_tokens)

    def schedule(now: int) -> None:
        nonlocal free, seq
        i = 0
        while free > 0 and i < len(ready):
            sid = ready[i]
            if pending[sid] == 0:
                i += 1
                continue
            n = min(pending[sid], free)
            pending[sid] -= n
            free -= n
            dur = job.stages[sid].task_duration
            if noise_sigma > 0:
                dur = max(1, int(round(dur * rng.lognormal(0.0, noise_sigma))))
            heapq.heappush(events, (now + dur, seq, sid, n))
            seq += 1
            intervals.append((now, now + dur, n))
            if pending[sid] == 0:
                i += 1

    schedule(0)
    while events:
        t, _, sid, n = heapq.heappop(events)
        free += n
        unfinished[sid] -= n
        if unfinished[sid] == 0:
            for c in children[sid]:
                ndeps[c] -= 1
                if ndeps[c] == 0:
                    ready.append(c)
        # batch all completions at the same second before rescheduling
        if not events or events[0][0] != t:
            ready[:] = [s for s in ready if pending[s] > 0]
            schedule(t)

    runtime = max(end for _, end, _ in intervals)
    diff = np.zeros(runtime + 1, np.int64)
    for s, e, n in intervals:
        diff[s] += n
        diff[e] -= n
    skyline = np.cumsum(diff)[:runtime].astype(np.int32)
    assert skyline.max() <= tokens
    return skyline


def observed_skyline(job: Job, *, noise_sigma: float = 0.0,
                     seed: int = 0) -> np.ndarray:
    """The single production run TASQ trains from: job at its default tokens."""
    return execute(job, job.default_tokens, noise_sigma=noise_sigma, seed=seed)


def reexecute_fractions(job: Job, fractions=(1.0, 0.8, 0.6, 0.2), *,
                        noise_sigma: float = 0.0, seed: int = 0
                        ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """§5.1 ground-truth gathering: re-execute at fractions of default tokens.

    Returns (allocs (K,), [skylines]) — seeds differ per execution so
    noise_sigma > 0 yields genuinely independent re-runs.
    """
    allocs, skylines = [], []
    for i, f in enumerate(fractions):
        a = max(1, int(round(f * job.default_tokens)))
        allocs.append(a)
        skylines.append(execute(job, a, noise_sigma=noise_sigma, seed=seed + i))
    return np.asarray(allocs, np.int64), skylines
