"""Training-data assembly: corpus -> observed runs -> AREPAS augmentation ->
PCC targets + model-ready tensors (paper §3, §4.3-4.4).

Per job, the single observed production run (executor at the job's default
tokens) is AREPAS-augmented into runtimes at a grid of lower allocations; a
power-law PCC is fitted to those points and its (a, b) become the NN/GNN
targets. XGBoost instead gets *rows* — (job features ++ token count) ->
runtime — at 100/80/60% of the observed allocation, plus 120/140% rows
(runtime floored) for jobs that observed their peak (paper §4.4).

Where the reference simulates one job at one allocation at a time, this
module concatenates every observed skyline into one flat int32 tensor with
(J + 1) offsets (the ragged layout: the valid seconds and nothing else, no
(J, Smax) padding) and makes ONE ``arepas_runtimes_ragged`` call (kernel K1
on the card) for the PCC and XGBoost allocations of every job. The
reference's rules are then applied unchanged on the host, so the returned
``TasqDataset`` equals the reference's field by field.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.featurize import batch_graphs, batch_job_features
from repro_torch.core.pcc import fit_pcc
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.workloads.executor import observed_skyline
from repro_torch.workloads.generator import Job

PCC_FRACTIONS = (1.0, 0.8, 0.6, 0.4, 0.2)   # AREPAS grid for PCC targets
XGB_FRACTIONS = (1.0, 0.8, 0.6)             # below-observed XGBoost rows
XGB_OVER_FRACTIONS = (1.2, 1.4)             # over-allocated rows (floored)
# the columns of the one bulk AREPAS call: PCC grid, then XGBoost grid
AREPAS_FRACTIONS = PCC_FRACTIONS + XGB_FRACTIONS

__all__ = ["JobRecord", "TasqDataset", "build_dataset", "PCC_FRACTIONS",
           "XGB_FRACTIONS", "AREPAS_FRACTIONS", "pad_skylines",
           "ragged_skylines"]


@dataclasses.dataclass
class JobRecord:
    job: Job
    skyline: np.ndarray
    observed_tokens: int
    observed_runtime: int
    peak_usage: int
    aug_allocs: np.ndarray       # AREPAS grid allocations (descending fracs)
    aug_runtimes: np.ndarray     # simulated runtimes at aug_allocs
    pcc_a: float                 # power-law targets fitted to the grid
    pcc_b: float


@dataclasses.dataclass
class TasqDataset:
    records: List[JobRecord]
    features: np.ndarray               # (J, P_J) job-level
    graph_features: np.ndarray         # (J, N, P_O)
    graph_adj: np.ndarray              # (J, N, N)
    graph_mask: np.ndarray             # (J, N)
    observed_alloc: np.ndarray         # (J,)
    observed_runtime: np.ndarray       # (J,)
    target_a: np.ndarray               # (J,)
    target_b: np.ndarray               # (J,)
    xgb_X: np.ndarray                  # (R, P_J + 1) features ++ alloc
    xgb_y: np.ndarray                  # (R,) runtimes
    xgb_job: np.ndarray                # (R,) job row index

    def __len__(self) -> int:
        return len(self.records)


class _StageClock:
    """Adds the seconds since the previous stage to ``timings[name]``."""

    def __init__(self, timings: Optional[Dict[str, float]]):
        self.timings = timings
        self.t = time.perf_counter()

    def stage(self, name: str) -> None:
        now = time.perf_counter()
        if self.timings is not None:
            self.timings[name] = self.timings.get(name, 0.0) + now - self.t
        self.t = now


def ragged_skylines(skylines: Sequence[np.ndarray]):
    """Host flat int32 values (every skyline's seconds, one after another)
    and (J + 1,) int64 offsets: skyline j is ``values[offsets[j]:offsets[j
    + 1]]``."""
    offsets = np.zeros(len(skylines) + 1, np.int64)
    np.cumsum([len(s) for s in skylines], out=offsets[1:])
    values = (np.concatenate(skylines).astype(np.int32, copy=False)
              if len(skylines) else np.zeros(0, np.int32))
    return values, offsets


def pad_skylines(skylines: Sequence[np.ndarray]):
    """Host (J, Smax) int32 padded skylines and (J,) int32 valid lengths."""
    lens = np.array([len(s) for s in skylines], np.int32)
    sky = np.zeros((len(skylines), int(lens.max(initial=1))), np.int32)
    for j, s in enumerate(skylines):
        sky[j, :len(s)] = s
    return sky, lens


def build_dataset(jobs: Sequence[Job], *, noise_sigma: float = 0.0,
                  seed: int = 0, n_max_nodes: int = 0,
                  device: Union[str, torch.device, None] = None,
                  timings: Optional[Dict[str, float]] = None
                  ) -> TasqDataset:
    """``timings``, if given, accumulates the seconds of each stage:
    ``skylines_s`` (host executor), ``pack_s`` (host concatenation into
    the ragged layout, allocation grid), ``arepas_s`` (copies to the
    device, the bulk AREPAS call, the copy back), ``assemble_s`` (fits,
    features, graphs, XGBoost rows)."""
    dev = resolve_device(device)
    clock = _StageClock(timings)
    skylines = [observed_skyline(j, noise_sigma=noise_sigma, seed=seed)
                for j in jobs]
    clock.stage("skylines_s")
    tokens = [j.default_tokens for j in jobs]
    values, offsets = ragged_skylines(skylines)
    # max(1, round(f * tokens)) for every job and fraction at once (the
    # reference's per-job loop): the same float64 product, rounded half to
    # even
    allocs = np.maximum(1, np.round(
        np.asarray(tokens, np.float64)[:, None]
        * np.asarray(AREPAS_FRACTIONS)[None, :])).astype(np.int32)
    clock.stage("pack_s")
    runtimes = kernel_ops.arepas_runtimes_ragged(
        torch.from_numpy(values).to(dev), torch.from_numpy(offsets).to(dev),
        torch.from_numpy(allocs).to(dev)).cpu().numpy()
    del values
    clock.stage("arepas_s")
    n_pcc = len(PCC_FRACTIONS)

    records = []
    for j, (job, s) in enumerate(zip(jobs, skylines)):
        obs_rt, peak = int(len(s)), int(s.max())
        al = allocs[j, :n_pcc].astype(np.int64)
        # allocation at/above observed peak cannot change the skyline
        rt = np.where(al >= peak, obs_rt, runtimes[j, :n_pcc])
        rt = np.maximum(rt, 1).astype(np.int64)
        a, b = fit_pcc(al, rt)
        a = min(a, -1e-4)  # executor runs are monotone; guard exact-flat fits
        records.append(JobRecord(
            job=job, skyline=s, observed_tokens=job.default_tokens,
            observed_runtime=obs_rt, peak_usage=peak, aug_allocs=al,
            aug_runtimes=rt, pcc_a=float(a), pcc_b=float(b)))

    features = batch_job_features(jobs)
    gf, ga, gm = batch_graphs(jobs, n_max_nodes)

    xgb_X, xgb_y, xgb_job = [], [], []
    for ji, r in enumerate(records):
        base = features[ji]
        for c in range(n_pcc, len(AREPAS_FRACTIONS)):
            a = int(allocs[ji, c])
            rt = (r.observed_runtime if a >= r.peak_usage
                  else int(runtimes[ji, c]))
            xgb_X.append(np.concatenate([base, [np.log1p(a)]]))
            xgb_y.append(max(rt, 1))
            xgb_job.append(ji)
        if r.observed_tokens >= r.peak_usage:   # "over-allocated" job
            for f in XGB_OVER_FRACTIONS:
                a = int(round(f * r.observed_tokens))
                xgb_X.append(np.concatenate([base, [np.log1p(a)]]))
                xgb_y.append(r.observed_runtime)  # floored at peak runtime
                xgb_job.append(ji)

    clock.stage("assemble_s")
    return TasqDataset(
        records=records,
        features=features,
        graph_features=gf, graph_adj=ga, graph_mask=gm,
        observed_alloc=np.array([r.observed_tokens for r in records], np.float32),
        observed_runtime=np.array([r.observed_runtime for r in records], np.float32),
        target_a=np.array([r.pcc_a for r in records], np.float32),
        target_b=np.array([r.pcc_b for r in records], np.float32),
        xgb_X=np.asarray(xgb_X, np.float32),
        xgb_y=np.asarray(xgb_y, np.float64),
        xgb_job=np.asarray(xgb_job, np.int64),
    )
