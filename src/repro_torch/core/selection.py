"""Workload subset selection for ground-truth gathering (paper §5.1).

Production resources are scarce, so only a small set of jobs can be
re-executed at alternate token counts. The paper's stratified under-sampling:

  1. Job Filtering     — constrain the candidate pool (virtual cluster,
                         token range, time frame);
  2. Job Clustering    — k-means over the *population*, predict cluster for
                         every pool job;
  3. Stratified Sampling — under-sample each cluster proportional to its
                         population share (with a per-job-type cap);
  4. Quality Evaluation — two-sample Kolmogorov-Smirnov statistic before vs
                         after; lower = subset closer to the population.

Pure numpy; deterministic given seeds. Copied from the JAX package's
``repro.core.selection`` unchanged: it runs on the host in both packages
(a k-means on the card would reduce in another order and could move
labels at ties).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["kmeans", "assign_clusters", "stratified_sample", "ks_statistic",
           "select_jobs", "SelectionReport"]


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means. Returns (centroids (k,D), labels (N,))."""
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    cent = x[rng.choice(n, size=k, replace=False)].copy()
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        new_labels = d2.argmin(1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(k):
            sel = labels == c
            if sel.any():
                cent[c] = x[sel].mean(0)
            else:  # re-seed empty cluster at the farthest point
                cent[c] = x[d2.min(1).argmax()]
    return cent, labels


def assign_clusters(x: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    d2 = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    return d2.argmin(1)


def stratified_sample(pool_labels: np.ndarray, population_labels: np.ndarray,
                      n_target: int, *, job_types: Optional[np.ndarray] = None,
                      max_per_type: int = 0, seed: int = 0) -> np.ndarray:
    """Under-sample the pool so cluster proportions match the population.

    job_types/max_per_type: optional cap on how many times one job type
    (e.g. recurring job template) may be selected.
    Returns indices into the pool.
    """
    rng = np.random.RandomState(seed)
    k = int(population_labels.max()) + 1
    pop_frac = np.bincount(population_labels, minlength=k) / population_labels.size
    picked: List[int] = []
    type_count: dict = {}
    for c in np.argsort(-pop_frac):  # biggest clusters first
        want = int(round(pop_frac[c] * n_target))
        cand = np.nonzero(pool_labels == c)[0]
        rng.shuffle(cand)
        got = 0
        for i in cand:
            if got >= want:
                break
            if max_per_type and job_types is not None:
                t = job_types[i]
                if type_count.get(t, 0) >= max_per_type:
                    continue
                type_count[t] = type_count.get(t, 0) + 1
            picked.append(int(i))
            got += 1
    picked = picked[:n_target]          # rounding can overshoot by a few
    return np.asarray(sorted(picked), np.int64)


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample KS statistic: max |ECDF_a - ECDF_b|."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    grid = np.concatenate([a, b])
    ca = np.searchsorted(a, grid, side="right") / a.size
    cb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(ca - cb).max())


@dataclasses.dataclass
class SelectionReport:
    indices: np.ndarray            # into the pool
    ks_before: float               # pool vs population (1-d summary feature)
    ks_after: float                # selected vs population
    pop_cluster_frac: np.ndarray
    pool_cluster_frac: np.ndarray
    sel_cluster_frac: np.ndarray


def select_jobs(population_features: np.ndarray, pool_features: np.ndarray,
                pool_mask: np.ndarray, n_target: int, *, k: int = 8,
                summary_col: int = 0, seed: int = 0) -> SelectionReport:
    """End-to-end §5.1 procedure.

    population_features: (N, D) featurized historical population.
    pool_features:       (N, D) same array; ``pool_mask`` marks jobs meeting
                         the re-execution constraints (step 1 already applied).
    summary_col: feature used for the 1-d KS quality check.
    """
    mu = population_features.mean(0)
    sd = population_features.std(0) + 1e-9
    z = (population_features - mu) / sd
    cent, pop_labels = kmeans(z, k, seed=seed)
    pool_idx = np.nonzero(pool_mask)[0]
    pool_labels = assign_clusters(z[pool_idx], cent)
    sel_in_pool = stratified_sample(pool_labels, pop_labels, n_target,
                                    seed=seed)
    sel_idx = pool_idx[sel_in_pool]

    col = population_features[:, summary_col]
    report = SelectionReport(
        indices=sel_idx,
        ks_before=ks_statistic(col[pool_idx], col),
        ks_after=ks_statistic(col[sel_idx], col),
        pop_cluster_frac=np.bincount(pop_labels, minlength=k) / pop_labels.size,
        pool_cluster_frac=np.bincount(pool_labels, minlength=k) / max(pool_labels.size, 1),
        sel_cluster_frac=np.bincount(assign_clusters(z[sel_idx], cent),
                                     minlength=k) / max(sel_idx.size, 1),
    )
    return report
