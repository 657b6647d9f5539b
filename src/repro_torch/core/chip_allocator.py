"""PCC-driven chip allocation for training/serving jobs.

The port of ``repro.core.chip_allocator``, on the port's
``fit_pcc_batch_np`` and ``choose_tokens_batch`` (the float64 policy, on
the card unless ``device="cpu"``), reading the port's dry-run records
(``launch.dryrun``), whose roofline terms are H100 data-sheet
projections.

This is the paper's contribution operating as a first-class feature of the
framework's launcher: a submitted job (architecture x input shape) gets a
*performance characteristic curve* — step time as a function of chip count —
and the launcher allocates the optimal (not peak) number of chips under the
paper's §2.1 marginal-gain policy.

Where SCOPE-TASQ learns the PCC from compile-time plan features, the
launcher derives it from the dry run's traced step (launch/dryrun.py):
per-chip roofline terms measured at a reference mesh are rescaled across
candidate chip counts with the standard scaling model —

  compute(c)    = compute(c0) * c0 / c          (perfectly sharded FLOPs)
  memory(c)     = memory(c0)  * c0 / c          (weights/activations shard)
  collective(c) = collective(c0) * r(c) / r(c0),  r(c) = (c-1)/c
                  (ring all-reduce/all-gather per-chip wire bytes are nearly
                   size-invariant in c; r captures the small-c advantage)

— then step_time(c) = max of the three terms, a power-law-shaped decaying
curve that `fit_pcc` compresses to (a, b) exactly as in the paper. The same
(a, b) then drives `optimal_tokens` (here: optimal chips). Like AREPAS, the
scaling model is a deterministic area-preserving simulator: total work is
conserved, only its distribution over chips changes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.core.allocator import AllocationPolicy, choose_tokens_batch
from repro_torch.core.pcc import fit_pcc_batch_np, pcc_runtime
from repro_torch.roofline.analysis import HW, Hardware

__all__ = ["ChipAllocation", "allocate_chips", "allocate_chips_batch",
           "step_time_curve", "load_dryrun_record"]

DEFAULT_CANDIDATES = (16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass
class ChipAllocation:
    chips: int
    pcc_a: float
    pcc_b: float
    candidates: np.ndarray
    step_times_s: np.ndarray
    predicted_step_s: float
    reference_chips: int
    dominant_at_choice: str

    def summary(self) -> Dict:
        return {
            "chips": self.chips,
            "pcc": (round(self.pcc_a, 4), round(self.pcc_b, 6)),
            "predicted_step_s": round(self.predicted_step_s, 6),
            "dominant": self.dominant_at_choice,
        }


def load_dryrun_record(path_or_dir: str, arch: str = "", shape: str = "",
                       mesh: str = "16x16") -> Dict:
    p = path_or_dir
    if os.path.isdir(p):
        p = os.path.join(p, f"{arch}_{shape}_{mesh}.json")
    with open(p) as f:
        rec = json.load(f)
    if "error" in rec or "skipped" in rec:
        raise ValueError(f"unusable dry-run record {p}: "
                         f"{rec.get('error', rec.get('skipped'))}")
    return rec


def _terms_from_record(rec: Dict) -> Tuple[float, float, float, int]:
    r = rec["roofline"]
    return (r["compute_ms"] / 1e3, r["memory_ms"] / 1e3,
            r["collective_ms"] / 1e3, int(rec["chips"]))


def step_time_curve(rec: Dict, candidates: Sequence[int] = DEFAULT_CANDIDATES,
                    hw: Hardware = HW) -> Tuple[np.ndarray, np.ndarray, list]:
    """(chips, step_time_s, dominant term) across candidate chip counts."""
    comp0, mem0, coll0, c0 = _terms_from_record(rec)
    r0 = (c0 - 1) / c0
    cand = np.asarray(sorted(candidates), np.int64)
    times, doms = [], []
    for c in cand:
        comp = comp0 * c0 / c
        mem = mem0 * c0 / c
        coll = coll0 * ((c - 1) / c) / r0 if c > 1 else 0.0
        terms = {"compute": comp, "memory": mem, "collective": coll}
        dom = max(terms, key=terms.get)
        times.append(terms[dom])
        doms.append(dom)
    return cand, np.asarray(times), doms


def allocate_chips_batch(recs: Sequence[Dict], *, min_gain: float = 0.005,
                         candidates: Sequence[int] = DEFAULT_CANDIDATES,
                         max_chips: int = 4096,
                         device: Union[str, torch.device, None] = None
                         ) -> list:
    """Paper §2.1 policy over many chip-count PCCs at once.

    min_gain: required relative step-time improvement per extra *chip
    fraction*; the marginal-gain cut-off A* = |a| / min_gain, clipped to
    the candidate range. All curves are fitted in one vectorized float64
    pass and all decisions come from one batched float64 policy call (on
    the card unless ``device="cpu"``), the same stage that serves
    query-token allocations.
    """
    curves = [step_time_curve(rec, candidates) for rec in recs]
    cand = np.stack([c[0] for c in curves]).astype(np.float64)
    times = np.stack([np.maximum(c[1], 1e-9) for c in curves])
    a, b = fit_pcc_batch_np(cand, times)
    policy = AllocationPolicy(min_gain=min_gain,
                              min_tokens=int(cand[0, 0]),
                              max_tokens=max_chips)
    chips_star = choose_tokens_batch(a, b, policy, device=device)
    out = []
    for rec, (cands, ts, doms), ai, bi, star in zip(recs, curves, a, b,
                                                    chips_star):
        # snap to the nearest candidate (mesh shapes are discrete)
        snap = int(cands[np.argmin(np.abs(cands - int(star)))])
        idx = int(np.nonzero(cands == snap)[0][0])
        out.append(ChipAllocation(
            chips=snap, pcc_a=float(ai), pcc_b=float(bi),
            candidates=cands, step_times_s=ts,
            predicted_step_s=float(pcc_runtime(ai, bi, snap)),
            reference_chips=_terms_from_record(rec)[3],
            dominant_at_choice=doms[idx],
        ))
    return out


def allocate_chips(rec: Dict, *, min_gain: float = 0.005,
                   candidates: Sequence[int] = DEFAULT_CANDIDATES,
                   max_chips: int = 4096,
                   device: Union[str, torch.device, None] = None
                   ) -> ChipAllocation:
    """Single-record convenience over ``allocate_chips_batch``."""
    return allocate_chips_batch([rec], min_gain=min_gain,
                                candidates=candidates,
                                max_chips=max_chips, device=device)[0]
