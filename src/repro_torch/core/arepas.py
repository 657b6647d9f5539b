"""AREPAS — Area-Preserving Allocation Simulator (paper §3, Algorithm 1).

Given one observed resource-consumption skyline (token usage per second),
synthesize the skyline — and hence the runtime — the same job would have at a
*lower* token allocation, under the core assumption that total work
(token-seconds = area under the skyline) is conserved.

Algorithm 1, faithfully:
  1. find the timestamps where the skyline crosses the new allocation ``Nt``;
  2. split the skyline into contiguous sections entirely over / under ``Nt``;
  3. under-cap sections are copied unchanged;
  4. over-cap sections are flattened to height ``Nt`` and stretched to
     ``int(area / Nt)`` seconds (area-preserving up to integer truncation);
  5. concatenate sections in order.

Two implementations:
  * ``simulate_skyline`` / ``simulate_runtime``: exact numpy oracle
    (reference semantics, returns the full simulated skyline), copied from
    the JAX package unchanged;
  * ``simulate_runtime_batch``: the plain PyTorch version of kernel K1
    (``repro_torch.kernels.ops.arepas_runtimes``) — section ids by cumsum,
    section areas by ``scatter_add`` — in integer arithmetic: int64 areas and
    ``area // nt`` for the stretched length. That equals the oracle's
    ``int(area / nt)`` for every integer skyline, with no f32 nudge and no
    bound on the area;
  * ``simulate_runtime_ragged``: the same on the ragged layout (flat values
    and offsets, ``ops.arepas_runtimes_ragged``), padding a chunk of jobs at
    a time to that chunk's longest skyline.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "simulate_skyline",
    "simulate_runtime",
    "simulate_runtime_batch",
    "simulate_runtime_ragged",
    "ragged_chunks",
    "augmentation_grid",
    "augment_job",
    "skyline_area",
    "peak_allocation",
]


# ------------------------------------------------------------- numpy oracle --
def simulate_skyline(skyline: np.ndarray, new_alloc: int) -> np.ndarray:
    """Algorithm 1: simulate the skyline at allocation ``new_alloc``.

    skyline: (S,) non-negative per-second token usage of the observed run.
    Returns the simulated per-second skyline (length = simulated runtime).
    """
    sog = np.asarray(skyline, dtype=np.float64)
    assert sog.ndim == 1 and sog.size > 0, sog.shape
    nt = float(new_alloc)
    assert nt > 0, new_alloc

    # sectionStartIDs: crossings of the allocation threshold.
    sign = np.sign(sog - nt)
    starts = [0] + [i for i in range(1, len(sog)) if sign[i] != sign[i - 1]]
    starts.append(len(sog))

    out = []
    for lo, hi in zip(starts[:-1], starts[1:]):
        sec = sog[lo:hi]
        if sec[0] > nt:  # over-allocated: flatten at Nt, stretch to area/Nt
            sec_area = float(np.sum(sec))
            new_len = int(sec_area / nt)
            out.append(np.full(new_len, nt))
        else:            # under the new cap: copy verbatim
            out.append(sec)
    return np.concatenate(out) if out else np.zeros(0)


def simulate_runtime(skyline: np.ndarray, new_alloc: int) -> int:
    """Simulated runtime (seconds) at ``new_alloc`` — len of Algorithm 1 output."""
    return int(simulate_skyline(skyline, new_alloc).size)


def skyline_area(skyline: np.ndarray) -> float:
    """Total work in token-seconds (the conserved quantity)."""
    return float(np.sum(np.asarray(skyline, dtype=np.float64)))


def peak_allocation(skyline: np.ndarray) -> int:
    return int(np.max(np.asarray(skyline)))


# ------------------------------------------------------- plain torch batch --
def simulate_runtime_batch(skylines: torch.Tensor, valid_lens: torch.Tensor,
                           allocs: torch.Tensor) -> torch.Tensor:
    """(J, Smax) skylines x (J, K) allocations -> (J, K) int32 runtimes.

    Only the first ``valid_lens[j]`` seconds of row ``j`` count (lengths
    beyond ``Smax`` mean the whole row). Seconds with ``s > nt`` are over the
    cap; ``s == nt`` counts as under, as in the oracle. Runtime = under
    seconds + sum over over-cap sections of ``area // nt``. An allocation
    below 1 has no Algorithm-1 runtime and yields -1, as kernel K1 does.

    Memory is (J, K, Smax) int64 per intermediate: callers chunk jobs.
    """
    J, smax = skylines.shape
    s = skylines.to(torch.int64)[:, None, :]                     # (J, 1, S)
    nt = allocs.to(torch.int64)[:, :, None]                      # (J, K, 1)
    idx = torch.arange(smax, device=skylines.device)
    valid = idx < valid_lens.to(torch.int64)[:, None, None]      # (J, 1, S)
    over = (s > nt) & valid                                      # (J, K, S)
    under = valid & ~over
    # a new section starts wherever the over flag changes
    prev = torch.cat([over[..., :1], over[..., :-1]], dim=-1)
    seg_id = torch.cumsum((over != prev).to(torch.int64), dim=-1)
    area = torch.zeros(over.shape, dtype=torch.int64, device=s.device)
    area.scatter_add_(-1, seg_id, torch.where(over, s, 0))
    # under sections carry area 0, so area // nt adds nothing for them
    nt_safe = nt.clamp(min=1)
    rt = under.sum(-1) + (area // nt_safe).sum(-1)
    return torch.where(allocs >= 1, rt, -1).to(torch.int32)


def ragged_chunks(lens, per_second: int, max_elems: int):
    """Consecutive row ranges [a, b) of jobs with valid lengths ``lens``
    (host ints) such that rows x ``per_second`` x the range's longest
    length stays within ``max_elems`` (a longer job alone excepted)."""
    chunks, a, longest = [], 0, 1
    for j, n in enumerate(lens):
        longest_j = max(longest, int(n))
        if j > a and (j + 1 - a) * per_second * longest_j > max_elems:
            chunks.append((a, j))
            a, longest_j = j, max(1, int(n))
        longest = longest_j
    if a < len(lens):
        chunks.append((a, len(lens)))
    return chunks


def simulate_runtime_ragged(values: torch.Tensor, offsets: torch.Tensor,
                            allocs: torch.Tensor,
                            max_elems: int = 1 << 24) -> torch.Tensor:
    """Flat ``values`` x (J + 1) int64 ``offsets`` x (J, K) allocations ->
    (J, K) int32 runtimes, job j's skyline being
    ``values[offsets[j]:offsets[j + 1]]``.

    ``simulate_runtime_batch`` on consecutive chunks of jobs, each padded
    to its own longest skyline (``ragged_chunks``), so no (J, Smax) array
    is ever built; ``max_elems`` bounds a chunk's (rows, K, Smax) int64
    intermediates. Runs where the tensors lie.
    """
    J, K = allocs.shape
    dev = values.device
    lens = (offsets[1:] - offsets[:-1]).clamp(min=0)
    parts = []
    for a, b in ragged_chunks(lens.tolist(), max(K, 1), max_elems):
        ln = lens[a:b]
        pos = torch.arange(max(int(ln.max()), 1), device=dev)
        valid = pos[None, :] < ln[:, None]
        sky = torch.zeros(valid.shape, dtype=torch.int32, device=dev)
        if values.numel():
            src = (offsets[a:b, None] + pos[None, :]).clamp(
                max=values.numel() - 1)
            sky = torch.where(valid, values[src].to(torch.int32), sky)
        parts.append(simulate_runtime_batch(sky, ln.to(torch.int32),
                                            allocs[a:b]))
    if not parts:
        return torch.empty((0, K), dtype=torch.int32, device=dev)
    return torch.cat(parts)


# -------------------------------------------------------- augmentation grid --
def augmentation_grid(observed_tokens: int,
                      fractions: Sequence[float] = (1.0, 0.8, 0.6, 0.2),
                      ) -> np.ndarray:
    """Token allocations to synthesize for one job (paper re-executes at
    100/80/60/20% and trains XGBoost with 80/60% + over-allocated 120/140%)."""
    allocs = np.unique(np.maximum(
        1, np.round(np.asarray(fractions) * observed_tokens)).astype(np.int64))
    return allocs[::-1]  # descending: full allocation first


def augment_job(skyline: np.ndarray,
                observed_tokens: int,
                fractions: Sequence[float] = (1.0, 0.8, 0.6, 0.4, 0.2),
                over_fractions: Sequence[float] = (1.2, 1.4),
                ) -> Tuple[np.ndarray, np.ndarray]:
    """AREPAS-augment one job: returns (allocs, runtimes).

    Below the observed allocation runtimes come from Algorithm 1; above it
    ("over-allocated jobs") the runtime is floored at the peak-allocation
    runtime (paper §4.4) — more tokens than the peak cannot help.
    """
    base_runtime = len(skyline)
    allocs, runtimes = [], []
    for f in sorted(set(fractions) | set(over_fractions)):
        a = max(1, int(round(f * observed_tokens)))
        if f >= 1.0:
            r = base_runtime if f == 1.0 else base_runtime  # floored at peak
        else:
            r = simulate_runtime(skyline, a)
        allocs.append(a)
        runtimes.append(r)
    return np.asarray(allocs, np.int64), np.asarray(runtimes, np.int64)
