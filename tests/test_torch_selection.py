"""§5.1 job selection, port against reference on the CPU: ``kmeans``,
``assign_clusters``, ``stratified_sample``, ``ks_statistic`` and
``select_jobs`` on the same numpy-seeded inputs, at the settings of the
reference runner's fig10 and table8 rows (``benchmarks/run.py``) at small n.

The port keeps its own copy of the numpy module, so every result must be
identical: labels, indices, centroids, KS statistics and cluster fractions.
"""
import numpy as np
import pytest

from repro.core import selection as ref
from repro.core.featurize import batch_job_features as ref_features
from repro.workloads.generator import build_corpus as ref_corpus
from repro_torch.core import selection
from repro_torch.core.featurize import batch_job_features
from repro_torch.workloads.generator import build_corpus

# (corpus size, corpus seed, token range of the pool, n_target, k, seed):
# fig10 (1,200 jobs at scale 1, seed 31, tokens 20-150, 200 picked, k 8,
# seed 0) and table8 (600 jobs, seed 61, tokens 10-500, 120 picked, the
# default k, seed 1), both at a quarter of their size
SETTINGS = {"fig10": (300, 31, (20, 150), 50, 8, 0),
            "table8": (150, 61, (10, 500), 30, 8, 1)}


def _blobs(seed, n=400, d=5, k=6):
    rng = np.random.RandomState(seed)
    centres = rng.standard_normal((k, d)) * 4
    return (centres[rng.randint(0, k, n)]
            + rng.standard_normal((n, d))).astype(np.float64)


@pytest.mark.parametrize("k", [1, 4, 9])
@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_and_assignment_match_reference(seed, k):
    x = _blobs(seed)
    cent, labels = selection.kmeans(x, k, seed=seed)
    rcent, rlabels = ref.kmeans(x, k, seed=seed)
    np.testing.assert_array_equal(cent, rcent)
    np.testing.assert_array_equal(labels, rlabels)
    other = _blobs(seed + 10, n=50)
    np.testing.assert_array_equal(selection.assign_clusters(other, cent),
                                  ref.assign_clusters(other, rcent))


def test_kmeans_reseeds_an_empty_cluster_as_the_reference():
    """Duplicate points leave a cluster empty after the first assignment;
    both re-seed it at the farthest point."""
    x = np.repeat(_blobs(5, n=20), 10, axis=0)
    for k in (15, 20):
        got, want = selection.kmeans(x, k, seed=2), ref.kmeans(x, k, seed=2)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("cap", [0, 2])
def test_stratified_sample_matches_reference(cap):
    rng = np.random.RandomState(4)
    pop = rng.randint(0, 7, 900)
    pool = rng.randint(0, 7, 240)
    types = rng.randint(0, 30, 240)
    for n_target in (10, 77, 500):
        got = selection.stratified_sample(pool, pop, n_target,
                                          job_types=types, max_per_type=cap,
                                          seed=9)
        want = ref.stratified_sample(pool, pop, n_target, job_types=types,
                                     max_per_type=cap, seed=9)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int64


def test_ks_statistic_matches_reference():
    rng = np.random.RandomState(6)
    for a, b in ((rng.standard_normal(100), rng.standard_normal(37) + 0.3),
                 (rng.randint(0, 5, 50), rng.randint(0, 5, 80)),
                 (np.ones(3), np.ones(4))):
        assert selection.ks_statistic(a, b) == ref.ks_statistic(a, b)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_select_jobs_matches_reference(name):
    """Each package's own corpus and features, then ``select_jobs``: the
    same indices, KS before and after, and cluster fractions."""
    n, cseed, (t_lo, t_hi), n_target, k, seed = SETTINGS[name]
    jobs, ref_jobs = build_corpus(n, seed=cseed), ref_corpus(n, seed=cseed)
    feats = batch_job_features(jobs)
    np.testing.assert_array_equal(feats, ref_features(ref_jobs))
    toks = np.array([j.default_tokens for j in jobs])
    mask = (toks >= t_lo) & (toks <= t_hi)
    got = selection.select_jobs(feats, feats, mask, n_target, k=k, seed=seed)
    want = ref.select_jobs(feats, feats, mask, n_target, k=k, seed=seed)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert 0 < got.indices.size <= n_target
    assert mask[got.indices].all()
    assert (got.ks_before, got.ks_after) == (want.ks_before, want.ks_after)
    for f in ("pop_cluster_frac", "pool_cluster_frac", "sel_cluster_frac"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
