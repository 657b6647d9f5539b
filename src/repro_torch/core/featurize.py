"""Featurization (paper §4.3, Tables 1-2).

Three views of a job's query plan:
  * aggregated job-level vector (XGBoost, NN): continuous/count features
    aggregated by mean, categoricals by frequency count, plus #operators and
    #stages — a fixed-length (P_J,) vector per job;
  * operator-level matrix (GNN): one (Table 2) row per operator, (N, P_O);
  * graph representation (GNN): normalized adjacency from the operator DAG.

Graphs are padded to a fixed N_max with a node mask so batches stack.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.workloads.generator import (
    NUM_OP_TYPES,
    NUM_PARTITION_TYPES,
    OPERATOR_FEATURE_DIM,
    Job,
)

# job-level: 7 continuous means + 3 count means + 35 + 4 categorical
# frequencies + num_operators + num_stages
JOB_FEATURE_DIM = 7 + 3 + NUM_OP_TYPES + NUM_PARTITION_TYPES + 2  # = 51

__all__ = [
    "JOB_FEATURE_DIM",
    "OPERATOR_FEATURE_DIM",
    "job_features",
    "operator_features",
    "normalized_adjacency",
    "pad_graph",
    "batch_job_features",
    "batch_graphs",
]


def operator_features(job: Job) -> np.ndarray:
    """(N, P_O) operator-level feature matrix (GNN input)."""
    return np.stack([op.feature_row() for op in job.operators])


def job_features(job: Job) -> np.ndarray:
    """(P_J,) aggregated job-level features (XGBoost / NN input)."""
    rows = operator_features(job)
    cont_cnt_mean = rows[:, :10].mean(axis=0)          # means (continuous+count)
    cat_freq = rows[:, 10:].sum(axis=0)                # frequency counts
    extra = np.array([job.num_operators(), job.num_stages()], np.float32)
    return np.concatenate([cont_cnt_mean, cat_freq, extra]).astype(np.float32)


def normalized_adjacency(job: Job, n: int) -> np.ndarray:
    """Kipf-Welling GCN propagation matrix D^-1/2 (A + A^T + I) D^-1/2, (n, n).

    The plan DAG is treated as undirected for message passing (information
    flows both ways through the plan at equal hop cost), as in SimGNN.
    """
    N = len(job.operators)
    A = np.zeros((n, n), np.float32)
    for s, d in job.edges:
        A[s, d] = 1.0
        A[d, s] = 1.0
    idx = np.arange(N)
    A[idx, idx] = 1.0
    deg = A.sum(axis=1)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-9)), 0.0)
    return (A * dinv[:, None]) * dinv[None, :]


def pad_graph(job: Job, n_max: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(features (n_max, P_O), adj (n_max, n_max), mask (n_max,))."""
    N = len(job.operators)
    assert N <= n_max, (N, n_max)
    feat = np.zeros((n_max, OPERATOR_FEATURE_DIM), np.float32)
    feat[:N] = operator_features(job)
    adj = normalized_adjacency(job, n_max)
    mask = np.zeros((n_max,), np.float32)
    mask[:N] = 1.0
    return feat, adj, mask


def batch_job_features(jobs: Sequence[Job]) -> np.ndarray:
    return np.stack([job_features(j) for j in jobs])


def batch_graphs(jobs: Sequence[Job], n_max: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacked padded graphs: ((J,N,P), (J,N,N), (J,N))."""
    if n_max == 0:
        n_max = max(len(j.operators) for j in jobs)
    feats, adjs, masks = zip(*(pad_graph(j, n_max) for j in jobs))
    return np.stack(feats), np.stack(adjs), np.stack(masks)


class Standardizer:
    """Feature standardization fit on the training split only."""

    def __init__(self, x: np.ndarray):
        self.mu = x.mean(axis=0)
        self.sd = x.std(axis=0) + 1e-6

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mu) / self.sd).astype(np.float32)
