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

import operator
from itertools import chain
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


# the Operator fields a feature row reads: 7 continuous, 3 counts, then
# the two categoricals
_OPERATOR_FIELDS = operator.attrgetter(
    "est_cardinality", "input_cardinality", "input_children_cardinality",
    "avg_row_length", "est_cost", "est_exclusive_cost", "est_total_cost",
    "num_partitions", "num_partitioning_columns", "num_sort_columns",
    "op_type", "partition_type")


def _operator_rows(jobs: Sequence[Job]) -> Tuple[np.ndarray, np.ndarray]:
    """Every operator's feature row, job after job, bitwise
    ``operator_features``' ((Σ N, P_O) float32), and each job's operator
    count ((J,) int64): one pass over the operators' fields, then column
    work."""
    counts = np.fromiter((len(j.operators) for j in jobs), np.int64,
                         len(jobs))
    n = int(counts.sum())
    ops = chain.from_iterable(j.operators for j in jobs)
    raw = np.fromiter(chain.from_iterable(map(_OPERATOR_FIELDS, ops)),
                      np.float64, 12 * n).reshape(n, 12)
    rows = np.zeros((n, OPERATOR_FEATURE_DIM), np.float32)
    # float64 math as ``Operator.feature_row``, rounded to float32 once
    rows[:, :7] = np.log1p(np.ascontiguousarray(raw[:, :7]))
    rows[:, 7] = np.log2(1.0 + raw[:, 7])
    rows[:, 8:10] = raw[:, 8:10]
    i = np.arange(n)
    rows[i, 10 + raw[:, 10].astype(np.int64)] = 1.0
    rows[i, 10 + NUM_OP_TYPES + raw[:, 11].astype(np.int64)] = 1.0
    return rows, counts


def batch_job_features(jobs: Sequence[Job]) -> np.ndarray:
    """(J, P_J) ``job_features`` of every job, bitwise, built column-wise:
    each job's rows summed one operator after another, in float32, as its
    mean sums them (``np.add.reduceat`` adds in another order)."""
    rows, counts = _operator_rows(jobs)
    starts = np.cumsum(counts) - counts
    sums = rows[starts]
    for p in range(1, int(counts.max(initial=0))):
        more = np.flatnonzero(counts > p)
        sums[more] += rows[starts[more] + p]
    out = np.empty((len(jobs), JOB_FEATURE_DIM), np.float32)
    out[:, :10] = sums[:, :10] / counts[:, None]
    out[:, 10:-2] = sums[:, 10:]
    out[:, -2] = counts
    out[:, -1] = [j.num_stages() for j in jobs]
    return out


def batch_graphs(jobs: Sequence[Job], n_max: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacked padded graphs: ((J,N,P), (J,N,N), (J,N)), bitwise
    ``pad_graph`` of every job, built column-wise. The adjacency is
    scattered from the deduplicated undirected edges and the diagonal,
    each entry ``dinv_i · dinv_j`` as ``normalized_adjacency`` rounds it."""
    rows, counts = _operator_rows(jobs)
    J = len(jobs)
    if n_max == 0:
        n_max = int(counts.max())
    assert counts.max(initial=0) <= n_max, (int(counts.max()), n_max)
    job = np.repeat(np.arange(J), counts)
    node = job * n_max + np.arange(len(rows)) - np.repeat(
        np.cumsum(counts) - counts, counts)       # j * n_max + position
    feat = np.zeros((J, n_max, OPERATOR_FEATURE_DIM), np.float32)
    feat.reshape(-1, OPERATOR_FEATURE_DIM)[node] = rows
    mask = np.zeros((J, n_max), np.float32)
    mask.reshape(-1)[node] = 1.0

    n_edges = np.fromiter((len(j.edges) for j in jobs), np.int64, J)
    ends = np.fromiter(
        chain.from_iterable(chain.from_iterable(j.edges for j in jobs)),
        np.int64, 2 * int(n_edges.sum())).reshape(-1, 2)
    base = np.repeat(np.arange(J, dtype=np.int64) * n_max, n_edges)
    src, dst = ends[:, 0], ends[:, 1]
    # flat index of (job, row, column): row node * n_max + column
    key = np.unique(np.concatenate([
        (base + src) * n_max + dst, (base + dst) * n_max + src,
        node * n_max + node % n_max]))
    deg = np.bincount(key // n_max, minlength=J * n_max).astype(np.float32)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-9)), 0.0)
    adj = np.zeros((J, n_max, n_max), np.float32)
    adj.reshape(-1)[key] = (dinv[key // n_max]
                            * dinv[key // (n_max * n_max) * n_max
                                   + key % n_max])
    return feat, adj, mask


class Standardizer:
    """Feature standardization fit on the training split only."""

    def __init__(self, x: np.ndarray):
        self.mu = x.mean(axis=0)
        self.sd = x.std(axis=0) + 1e-6

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mu) / self.sd).astype(np.float32)
